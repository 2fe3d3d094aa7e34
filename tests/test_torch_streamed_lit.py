"""The port's streamed regime with a light, and on a random multi-bank
soup, on the CPU against the JAX package: whole renders of the port's
`Engine(streamed=True)` (B10 to winner rows, the streamed shadow pass with
B10's any-hit mode, B8; B9 for the soup) against JAX
`Engine(streamed=True, interpret=True)`, bitwise."""

import jax
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key

F32 = np.float32
P = 8
RB = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: with several test
    workers on one host, torch's intra-op threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(jscene):
    """A JAX-built scene, light included, as the port's."""
    t = jscene.tris
    fields = {k: getattr(t, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(t.materials, k) for k in MATERIAL_FIELDS})
    lights = jscene.lights
    return scene_from_arrays(fields, lights=None if lights is None else {
        "orig": lights.orig, "len2": lights.len2})


def _assert_renders_equal(eng, vp, ref_f, key, fixed_rng):
    """u8 image, float image (by bit pattern) and wave_rays of the port's
    CPU render equal the JAX float render's, with no kernel launched."""
    native.reset_launch_counts()
    mine_u8 = eng.render(vp, key=key, fixed_rng=fixed_rng)
    mine_f = eng.render(vp, key=key, fixed_rng=fixed_rng, quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(mine_f.image.view(np.uint32),
                                  ref_f.image.view(np.uint32))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref_f.image))


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_streamed_lit_render_equals_jax_engine(fixed_rng):
    """32x24 render with a light above the sphere: B10 rows, the streamed
    shadow pass (B10 any-hit with self-exclusion) and B8 at every wave."""
    jscene = assemble([make_sphere((0.0, 0.0, 6.0), 2.5, (40, 40),
                                   matte(m3.make_color((252, 119, 0)), 0.2),
                                   0.0),
                       make_triangles(np.asarray(
                           [[[-20, -3, -10], [20, -3, -10], [0, -3, 40]]],
                           F32), reflective(m3.make_color((120, 120, 120)),
                                            0.8, 0.1), 0.0)])
    jscene.lights = JLightSource(orig=np.asarray([0.0, 8.0, 0.0], F32),
                                 len2=0.5)
    vp = create_viewport((32, 24), (1.0, 24 / 32), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, -0.2, 1.0)), 90.0, 0.0, 3, 1)
    ref = JEngine(jscene, page_size=P, ray_chunk=RB, interpret=True,
                  streamed=True).render(vp, key=jax.random.PRNGKey(5),
                                        fixed_rng=fixed_rng, quantize=False)
    eng = Engine(carry(jscene), page_size=P, ray_chunk=RB, streamed=True,
                 device="cpu")
    _assert_renders_equal(eng, vp, ref, prng_key(5), fixed_rng)
    # the light shadowed part of the floor
    scene = carry(jscene)
    scene.lights = None
    unlit = Engine(scene, page_size=P, ray_chunk=RB, streamed=True,
                   device="cpu").render(vp, key=prng_key(5),
                                        fixed_rng=fixed_rng, quantize=False)
    assert ((unlit.image - ref.image).max(-1) > 1 / 255).any()


def _rand_surface(rng):
    color = m3.make_color(tuple(int(c) for c in rng.integers(10, 255, 3)))
    kind = rng.integers(0, 3)
    if kind == 0:
        return solid(color)
    if kind == 1:
        return matte(color, float(rng.uniform(0.05, 0.6)))
    return reflective(color, float(rng.uniform(0.1, 0.7)),
                      float(rng.uniform(0.0, 0.25)))


def test_random_multibank_soup_equals_jax_engine():
    """test_fuzz.py::test_random_streamed_scene's scene and view (seed 137:
    two soups and a 22x26 sphere, 2 banks at P = 8), fixed_rng."""
    rng = np.random.default_rng(137)
    parts = []
    for _ in range(2):
        n = int(rng.integers(4, 14))
        pts = (rng.uniform(-1.0, 1.0, (n, 3, 3)).astype(F32) * F32(0.35)
               + rng.uniform(-2.5, 2.5, (n, 1, 3)).astype(F32)
               + np.asarray([0, 0, 8], F32))
        parts.append(make_triangles(pts, _rand_surface(rng),
                                    float(rng.uniform(0.0, 0.1))))
    orig = rng.uniform(-2, 2, 3).astype(F32) + np.asarray([0, 0, 8], F32)
    parts.append(make_sphere(tuple(orig), float(rng.uniform(0.8, 2.0)),
                             (22, 26), _rand_surface(rng),
                             float(rng.uniform(0.0, 0.08))))
    jscene = assemble(parts)
    pos = rng.uniform(-0.4, 0.4, 3).astype(F32)
    aim = m3.unit(np.asarray([rng.uniform(-0.25, 0.25),
                              rng.uniform(-0.25, 0.25), 1.0], F32))
    vp = create_viewport((24, 16), (1.5, 1.0), pos, aim,
                         float(rng.uniform(60.0, 100.0)),
                         float(rng.uniform(-0.3, 0.3)), 3, 1)
    jeng = JEngine(jscene, page_size=P, ray_chunk=RB, interpret=True,
                   streamed=True)
    assert (jeng.pages.num_pages + 127) // 128 >= 2
    ref = jeng.render(vp, fixed_rng=True, quantize=False)
    eng = Engine(carry(jscene), page_size=P, ray_chunk=RB, streamed=True,
                 device="cpu")
    _assert_renders_equal(eng, vp, ref, None, True)
