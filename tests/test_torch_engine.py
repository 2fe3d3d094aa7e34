"""The port end to end on the CPU: the port's Engine (plain versions of the
kernels) against the committed golden and, bitwise, against the JAX Engine
in interpret mode, on scenes the JAX package builds and `scene_from_arrays`
carries across."""

import os

import jax
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.engine as jeng
from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere, make_triangles
from rust_raytrace_tpu.materials import matte, reflective, solid
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch import engine
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.scene import (MATERIAL_FIELDS, TRIANGLE_FIELDS,
                                           LightSource, scene_from_arrays)
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
RB = 128
F32 = np.float32
SCHEDULES = [None, 0, (True, False)]


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
    """A JAX-built scene as the port's, through plain arrays."""
    t = jscene.tris
    fields = {k: getattr(t, k) for k in TRIANGLE_FIELDS}
    fields.update({k: getattr(t.materials, k) for k in MATERIAL_FIELDS})
    return scene_from_arrays(fields)


@pytest.fixture(scope="module")
def small():
    """circles at 48x27 with 128-ray chunks: 11 chunks, 5 waves; the JAX
    scene and its copy."""
    jscene, vp = jcircles.build(resolution=(48, 27), maxdepth=5)
    return jscene, carry(jscene), vp


_JAX_ENGINES = {}


def jax_engine(jscene, ncompact):
    key = (id(jscene), ncompact)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = JEngine(jscene, ray_chunk=RB, ncompact=ncompact,
                                    interpret=True)
    return _JAX_ENGINES[key]


def test_golden_circles_96x54():
    """The default (compacted) Engine on the CPU, with no kernel launched."""
    scene, vp = circles.build(resolution=(96, 54), maxdepth=5)
    native.reset_launch_counts()
    img = Engine(scene, device="cpu").render(vp, fixed_rng=True).image
    np.testing.assert_array_equal(
        img, png.read_png(os.path.join(GOLDENS, "circles_96x54.png")))
    assert all(k.launches == 0 for k in native.KERNELS)


def _assert_renders_equal(mine_u8, mine_f, ref_f):
    np.testing.assert_array_equal(mine_u8.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(mine_f.image.view(np.uint32),
                                  ref_f.image.view(np.uint32))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref_f.image))
    assert mine_u8.rays_traced == int(ref_f.wave_rays.sum())


@pytest.mark.parametrize("ncompact", SCHEDULES)
def test_fixed_rng_equals_jax_engine(small, ncompact):
    """u8 image, float image and wave_rays bitwise."""
    jscene, scene, vp = small
    eng = Engine(scene, ray_chunk=RB, ncompact=ncompact, device="cpu")
    ref = jax_engine(jscene, ncompact).render(vp, fixed_rng=True,
                                              quantize=False)
    _assert_renders_equal(eng.render(vp, fixed_rng=True),
                          eng.render(vp, fixed_rng=True, quantize=False), ref)


@pytest.mark.parametrize("ncompact", SCHEDULES)
def test_live_rng_close_to_jax_engine(small, ncompact):
    """Key 0: bitwise, since the wave seeds, the scatter hash over the
    compacted layout (ROADMAP C3) and the rsqrt (C1) are all exact."""
    jscene, scene, vp = small
    eng = Engine(scene, ray_chunk=RB, ncompact=ncompact, device="cpu")
    ref = jax_engine(jscene, ncompact).render(vp, key=jax.random.PRNGKey(0),
                                              quantize=False)
    _assert_renders_equal(eng.render(vp, key=prng_key(0)),
                          eng.render(vp, key=prng_key(0), quantize=False),
                          ref)


@pytest.mark.parametrize("ncompact", [-1, 3, (False, True, False, True)])
def test_every_schedule_renders_the_same_bits(small, ncompact):
    """Under fixed_rng compaction is a permutation: any schedule, the dead
    array's growth past 2R included, gives the uncompacted image."""
    _, scene, vp = small
    base = Engine(scene, ray_chunk=RB, ncompact=0, device="cpu").render(
        vp, fixed_rng=True, quantize=False)
    got = Engine(scene, ray_chunk=RB, ncompact=ncompact, device="cpu").render(
        vp, fixed_rng=True, quantize=False)
    np.testing.assert_array_equal(got.image.view(np.uint32),
                                  base.image.view(np.uint32))
    np.testing.assert_array_equal(got.wave_rays, base.wave_rays)


def _rand_surface(rng):
    color = m3.make_color(tuple(int(c) for c in rng.integers(10, 255, 3)))
    kind = rng.integers(0, 3)
    if kind == 0:
        return solid(color)
    if kind == 1:
        return matte(color, float(rng.uniform(0.05, 0.6)))
    return reflective(color, float(rng.uniform(0.1, 0.7)),
                      float(rng.uniform(0.0, 0.25)))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_soup_equals_jax_engine(seed):
    """A seeded triangle soup with a sphere (the test_fuzz style), random
    materials and camera, live RNG, default schedule: bitwise."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(3):
        n = int(rng.integers(4, 14))
        pts = (rng.uniform(-1, 1, (n, 3, 3)) * 0.35
               + rng.uniform(-2.5, 2.5, (n, 1, 3)) + [0, 0, 8]).astype(F32)
        parts.append(make_triangles(pts, _rand_surface(rng),
                                    float(rng.uniform(0.0, 0.1))))
    parts.append(make_sphere(tuple(rng.uniform(-2, 2, 3) + [0, 0, 8]),
                             float(rng.uniform(0.8, 2.0)), (6, 8),
                             _rand_surface(rng), 0.05))
    jscene = assemble(parts)
    pos = np.asarray([rng.uniform(-1, 1), rng.uniform(-1, 1), -2.0], F32)
    aim = m3.unit(np.asarray([rng.uniform(-0.25, 0.25),
                              rng.uniform(-0.25, 0.25), 1.0], F32))
    vp = create_viewport((40, 24), (1.5, 0.9), pos, aim,
                         float(rng.uniform(60.0, 100.0)),
                         float(rng.uniform(-0.3, 0.3)), 4, 1)
    ref = JEngine(jscene, ray_chunk=RB, interpret=True).render(
        vp, key=jax.random.PRNGKey(seed), quantize=False)
    eng = Engine(carry(jscene), ray_chunk=RB, device="cpu")
    mine = eng.render(vp, key=prng_key(seed), quantize=False)
    assert ref.wave_rays[1] > 0
    np.testing.assert_array_equal(mine.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine.image.view(np.uint32),
                                  ref.image.view(np.uint32))


@pytest.mark.parametrize("decay", [
    [3686400, 1857586, 1076073, 1022174, 798772],     # circles_2k, PR 1
    [3686400, 1240000, 600000, 465000, 120000],       # teapot
    [3686400, 818000, 410000, 409000, 0],
    [3686400, 2350000, 1090000, 731000, 252000],      # multi
    [1000, 990, 980, 970, 960],
    [1296, 649, 385, 368, 289],
    [0, 0, 0],
])
def test_plan_boundaries_equal_jax(decay):
    assert engine.plan_boundaries(decay) == jeng.plan_boundaries(decay)


def test_circles_2k_plan():
    """PR 1's circles_2k wave decay plans (True, True, False, False)."""
    assert engine.plan_boundaries([3686400, 1857586, 1076073, 1022174,
                                   798772]) == (True, True, False, False)


def test_cpu_engine_keeps_the_default_schedule(small):
    """The autotune replans only on a CUDA device, as the JAX Engine only
    on the TPU; on the CPU the default stays 'compact after waves 0, 1'."""
    _, scene, vp = small
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    eng.render(vp, fixed_rng=True)
    assert eng.ncompact == 2
    assert [eng._compacts_after(w, 5) for w in range(5)] == \
        [True, True, False, False, False]


def test_engine_rejects_what_the_slice_does_not_run(small):
    """bounce_chunk renders (ROADMAP A3, ported): under fixed_rng the
    chunking of the bounce waves changes no bit, so the image is the
    default Engine's."""
    _, scene, vp = small
    eng = Engine(scene, device="cpu", ray_chunk=256, bounce_chunk=128)
    res = eng.render(vp, fixed_rng=True)
    ref = Engine(scene, device="cpu", ray_chunk=256).render(vp,
                                                            fixed_rng=True)
    np.testing.assert_array_equal(res.image, ref.image)
    np.testing.assert_array_equal(res.wave_rays, ref.wave_rays)


def test_engine_rejects_streamed_regime(small):
    """A scene whose page tables pass the resident cap takes the streamed
    regime (ROADMAP A8, ported), with the bank-major sweep too (B12,
    ported); with streamed=False past the cap it keeps the union tables
    and its bounce waves run the union kernels (A3, ported), which under
    fixed_rng render the streamed regime's image."""
    _, scene, vp = small
    assert Engine(scene, table_slot_cap=1000, device="cpu").streamed
    union = Engine(scene, table_slot_cap=1000, streamed=False,
                   ray_chunk=RB, device="cpu")
    assert not union.streamed and union.ptables is None
    np.testing.assert_array_equal(
        union.render(vp, fixed_rng=True).image,
        Engine(scene, table_slot_cap=1000, ray_chunk=RB,
               device="cpu").render(vp, fixed_rng=True).image)
    eng = Engine(scene, streamed=True, bank_major=True, device="cpu")
    assert eng.streamed and eng.bank_major


def test_engine_rejects_lights():
    """A lit scene renders since the lights path (ROADMAP A5) was ported,
    and so does it at spp > 1 (A6), with debug buffers (A7) and in bands
    (A10), and sharded over image tiles (A11)."""
    scene, vp = circles.build(resolution=(8, 8))
    scene.lights = LightSource(orig=np.asarray([0.0, 5.0, 6.0], np.float32),
                               len2=0.5)
    eng = Engine(scene, device="cpu")
    assert eng.light == (0.0, 5.0, 6.0, 0.5)
    _, vp2 = circles.build(resolution=(8, 8), samples=2)
    img = eng.render(vp2, fixed_rng=True).image
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    dbg = eng.render(vp, fixed_rng=True, debug=True)
    assert dbg.primary_id.shape == (8, 8) and dbg.primary_t.shape == (8, 8)
    banded = eng.render_banded(vp, fixed_rng=True)
    np.testing.assert_array_equal(banded.image,
                                  eng.render(vp, fixed_rng=True).image)
    sharded = eng.render_sharded(vp, n_devices=2, fixed_rng=True)
    np.testing.assert_array_equal(sharded.image, banded.image)


def test_render_rejects_spp_and_debug(small):
    """spp > 1 (ROADMAP A6) and debug buffers (A7) render: u8 at
    spp 2 and 3 (host-quantized), the primary buffers and candidate sets;
    so do banded renders (A10) at spp 3, the bounce_chunk knob (A3) and
    sharded renders (A11), at spp 3 too."""
    _, scene, vp = small
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    for spp in (2, 3):
        _, vp2 = circles.build(resolution=(16, 16), samples=spp)
        res = eng.render(vp2, fixed_rng=True)
        assert res.image.shape == (16, 16, 3)
        assert res.image.dtype == np.uint8
        assert res.wave_rays[0] == 16 * 16 * spp
        if spp == 3:
            band = eng.render_banded(vp2, fixed_rng=True, band_rows=16)
            np.testing.assert_array_equal(band.image, res.image)
    dbg = eng.render(vp, fixed_rng=True, debug=True)
    assert dbg.primary_t.shape == (vp.height, vp.width)
    assert dbg.primary_chunk.shape == (vp.height, vp.width)
    assert len(dbg.chunk_tris) == -(-vp.width * vp.height // RB)
    bounced = Engine(scene, device="cpu", ray_chunk=RB,
                     bounce_chunk=RB // 2).render(vp2, fixed_rng=True)
    np.testing.assert_array_equal(bounced.image, res.image)
    sharded = eng.render_sharded(vp2, n_devices=2, fixed_rng=True)
    np.testing.assert_array_equal(sharded.image, res.image)
    np.testing.assert_array_equal(sharded.wave_rays, res.wave_rays)
