"""The port's lights path on the CPU against the JAX package: the bulk
`jax.random.uniform` draw, the wave-0 shadow rays (`engine.shadow_mask`,
XLA's contractions and its 16-wide rsqrt, ROADMAP C7) and whole lit renders
of the port's Engine (plain versions of B1, B3-B6 and B8) against JAX
`Engine(interpret=True)`, bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jeng
from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_disk, make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import LightSource as JLightSource
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch import engine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           scene_from_arrays)
from rust_raytrace_tpu_torch.utils import native, png, rng
from rust_raytrace_tpu_torch.utils.rng import prng_key

F32 = np.float32
RB = 128
#: the teapot preset's light (models/teapot.py, with_light=True)
LIGHT = JLightSource(orig=np.asarray([-4.0, 8.0, 0.0], F32), len2=0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: with several test
    workers on one host, torch's intra-op threads contend for the cores
    (one thread each ran this file several times faster under xdist)."""
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


@pytest.mark.parametrize("shape", [(3, 400_000), (1, 1_048_576)])
def test_uniform_equals_jax_random(shape):
    """1.2M and 1M draws under the keys the shadow pass uses, bitwise."""
    for seed, wave, sub in ((0, 0, 0), (5, 3, 1)):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), 7_000_000 + wave), sub)
        ref = np.asarray(jax.random.uniform(key, shape, dtype=jnp.float32))
        mine = rng.uniform(rng.fold_in(rng.fold_in(
            prng_key(seed), 7_000_000 + wave), sub), shape, "cpu").numpy()
        assert mine.shape == shape
        np.testing.assert_array_equal(mine.view(np.uint32),
                                      ref.view(np.uint32))


@pytest.fixture(scope="module")
def lit():
    """circles at 48x27 lit by the teapot preset's light, 128-ray chunks:
    the JAX scene, its copy and the viewport."""
    jscene, vp = jcircles.build(resolution=(48, 27), maxdepth=5)
    jscene.lights = LIGHT
    return jscene, carry(jscene), vp


_JAX_RENDERS = {}


def jax_render(jscene, vp, ncompact, fixed_rng):
    """The JAX Engine's float render (interpret mode), once per case."""
    key = (id(jscene), vp.width, vp.maxdepth, ncompact, fixed_rng)
    if key not in _JAX_RENDERS:
        eng = JEngine(jscene, ray_chunk=RB, ncompact=ncompact, interpret=True)
        _JAX_RENDERS[key] = eng.render(vp, key=jax.random.PRNGKey(0),
                                       fixed_rng=fixed_rng, quantize=False)
    return _JAX_RENDERS[key]


@pytest.mark.parametrize("ncompact", [None, 0])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_lit_render_equals_jax_engine(lit, ncompact, fixed_rng):
    """u8 image, float image and wave_rays bitwise, with no kernel launched
    on the CPU; the light shadows a share of the pixels."""
    jscene, scene, vp = lit
    ref = jax_render(jscene, vp, ncompact, fixed_rng)
    eng = Engine(scene, ray_chunk=RB, ncompact=ncompact, device="cpu")
    native.reset_launch_counts()
    mine_u8 = eng.render(vp, key=prng_key(0), fixed_rng=fixed_rng)
    mine_f = eng.render(vp, key=prng_key(0), fixed_rng=fixed_rng,
                        quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_f.image.view(np.uint32),
                                  ref.image.view(np.uint32))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))
    unlit = Engine(carry(jcircles.build(resolution=(48, 27))[0]),
                   ray_chunk=RB, ncompact=ncompact, device="cpu").render(
        vp, key=prng_key(0), fixed_rng=fixed_rng)
    changed = (np.abs(unlit.image.astype(int) - mine_u8.image) > 1).any(-1)
    assert 0.1 < changed.mean() < 0.9


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_wave0_shadow_rays_equal_jax(lit, fixed_rng, monkeypatch):
    """The shadow rays `shadow_mask` hands to B6 (origins, directions and
    excluded ids) are the JAX engine's, read inside its jitted render."""
    jscene, scene, vp = lit
    got = {}
    real = jeng.trace_chunks_pallas

    def capture(OT, DT, *args, excl=None, **kw):
        out = real(OT, DT, *args, excl=excl, **kw)
        if excl is not None:
            jax.debug.callback(
                lambda o, d, e: got.setdefault("jax", (np.asarray(o),
                                                       np.asarray(d),
                                                       np.asarray(e)[0])),
                OT, DT, excl)
        return out

    monkeypatch.setattr(jeng, "trace_chunks_pallas", capture)
    _, vp1 = jcircles.build(resolution=(vp.width, vp.height), maxdepth=1)
    JEngine(jscene, ray_chunk=RB, interpret=True).render(
        vp1, key=jax.random.PRNGKey(0), fixed_rng=fixed_rng)
    real_port = engine.trace_chunks

    def capture_port(ot, dt, *args, excl=None, **kw):
        if excl is not None:
            got["port"] = (ot.numpy().copy(), dt.numpy().copy(),
                           excl.numpy().copy())
        return real_port(ot, dt, *args, excl=excl, **kw)

    monkeypatch.setattr(engine, "trace_chunks", capture_port)
    Engine(scene, ray_chunk=RB, device="cpu").render(
        vp1, key=prng_key(0), fixed_rng=fixed_rng)
    (jo, jd, je), (po, pd, pe) = got["jax"], got["port"]
    assert (je != 0).mean() > 0.3
    for mine, ref in ((po, jo), (pd, jd), (pe, je)):
        np.testing.assert_array_equal(mine.view(np.uint32),
                                      ref.view(np.uint32))


def _rand_surface(r):
    color = m3.make_color(tuple(int(c) for c in r.integers(10, 255, 3)))
    kind = r.integers(0, 3)
    if kind == 0:
        return solid(color)
    if kind == 1:
        return matte(color, float(r.uniform(0.05, 0.6)))
    return reflective(color, float(r.uniform(0.1, 0.7)),
                      float(r.uniform(0.0, 0.25)))


@pytest.mark.parametrize("seed", [59])
def test_random_lit_soup_equals_jax_engine(seed):
    """A seeded soup with a disk and a random light above it (the
    test_fuzz.py::test_random_lights_scene style), live RNG, the default
    schedule: bitwise."""
    r = np.random.default_rng(seed)
    parts = []
    for _ in range(3):
        n = int(r.integers(4, 14))
        pts = (r.uniform(-1, 1, (n, 3, 3)) * 0.35
               + r.uniform(-2.5, 2.5, (n, 1, 3)) + [0, 0, 8]).astype(F32)
        parts.append(make_triangles(pts, _rand_surface(r),
                                    float(r.uniform(0.0, 0.1))))
    parts.append(make_disk(tuple(r.uniform(-2, 2, 3) + [0, 0, 8]),
                           m3.unit(r.uniform(-1, 1, 3).astype(F32)),
                           float(r.uniform(0.7, 1.5)),
                           float(r.uniform(0.05, 0.3)), 4,
                           _rand_surface(r), _rand_surface(r),
                           float(r.uniform(0.0, 0.08))))
    parts.append(make_sphere(tuple(r.uniform(-2, 2, 3) + [0, 0, 8]),
                             float(r.uniform(0.8, 2.0)), (6, 8),
                             _rand_surface(r), 0.05))
    jscene = assemble(parts)
    jscene.lights = JLightSource(
        orig=(r.uniform(-4, 4, 3) * [1, 1, 0] + [0, 16, 8]).astype(F32),
        len2=float(r.uniform(0.0, 0.6)))
    pos = r.uniform(-0.4, 0.4, 3).astype(F32)
    aim = m3.unit(np.asarray([r.uniform(-0.25, 0.25),
                              r.uniform(-0.25, 0.25), 1.0], F32))
    vp = create_viewport((32, 24), (1.5, 1.125), pos, aim,
                         float(r.uniform(60.0, 100.0)),
                         float(r.uniform(-0.3, 0.3)), 3, 1)
    ref = JEngine(jscene, ray_chunk=RB, interpret=True).render(
        vp, key=jax.random.PRNGKey(seed), quantize=False)
    mine = Engine(carry(jscene), ray_chunk=RB, device="cpu").render(
        vp, key=prng_key(seed), quantize=False)
    assert ref.wave_rays[1] > 0
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  ref.image.view(np.uint32))
    # the light darkened some lit pixels: shadows were cast
    unlit = Engine(carry(assemble(parts)), ray_chunk=RB, device="cpu").render(
        vp, key=prng_key(seed), quantize=False)
    assert ((unlit.image - mine.image).max(-1) > 1 / 255).any()
