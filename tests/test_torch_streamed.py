"""The port's streamed regime on the CPU against the JAX package: the bank
tables, B10 (`trace_streamed`: nearest rows, with and without
self-exclusion, and the any-hit occlusion bit) and B9
(`trace_shade_streamed`) against `trace_streamed_pallas` and
`trace_shade_streamed_pallas` in interpret mode, and unlit renders of the
port's `Engine(streamed=True)` against JAX `Engine(streamed=True,
interpret=True)`, bitwise (lit renders and a random soup:
test_torch_streamed_lit.py); the choice of regime.  The sphere spans 4
banks at page size 8, so the bank worklist, the cross-bank cut and the
payload of a winner in a later bank all run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.ops.intersect_streamed import (
    build_streamed_tables as jbuild_streamed_tables, trace_shade_streamed_pallas,
    trace_streamed_pallas)
from rust_raytrace_tpu.ops.pages import build_pages_kd as jbuild_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.ops.intersect_streamed import (
    build_streamed_tables, trace_shade_streamed, trace_streamed,
    upload_streamed_tables)
from rust_raytrace_tpu_torch.ops.pages import build_pages_kd
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


def bits(x):
    return np.asarray(x, F32).view(np.uint32)


@pytest.fixture(scope="module")
def sphere():
    """tests/test_streamed.py's sphere: 4 banks of pages at P = 8."""
    return assemble([make_sphere((0.0, 0.0, 6.0), 2.5, (40, 40),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.0)])


@pytest.fixture(scope="module")
def tables(sphere):
    """(the port's tables as tensors, JAX's as arrays) of the sphere."""
    mine = upload_streamed_tables(build_pages_kd(carry(sphere).tris,
                                                 page_size=P), "cpu")
    ref = tuple(map(jnp.asarray, jbuild_streamed_tables(
        jbuild_pages_kd(sphere.tris, page_size=P))))
    assert mine[0].shape[0] == 4
    return mine, ref


@pytest.fixture(scope="module")
def rays():
    """tests/test_streamed.py's 256 rays (two chunks of 128)."""
    rng = np.random.default_rng(7)
    R = 256
    o = rng.normal(size=(3, R)).astype(F32) * 0.5
    d = rng.normal(size=(3, R)).astype(F32)
    d = d * 0.6 + np.array([[0.0], [0.0], [1.0]], F32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = (rng.random(R) > 0.1).astype(F32)
    return o, d, alive


def test_build_streamed_tables_equal_jax(sphere):
    mine = build_streamed_tables(build_pages_kd(carry(sphere).tris,
                                                page_size=P))
    ref = jbuild_streamed_tables(jbuild_pages_kd(sphere.tris, page_size=P))
    assert [a.shape for a in mine] == [a.shape for a in ref]
    assert ref[3].shape == (8, 128) and (ref[3][4:] == 0).all()
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.parametrize("mode", ["nearest", "excl", "dead_chunk",
                                  "any_hit"])
def test_trace_streamed_equals_jax(tables, rays, mode):
    """All 16 rows by bit pattern (nearest, with each ray's own nearest
    triangle excluded, and with the second chunk flagged dead: zero rows);
    any-hit with exclusion: the occlusion bit (ROADMAP C5)."""
    (si, ss, sab, sbab), jt = tables
    o, d, alive = rays
    excl = chunk_live = None
    if mode in ("excl", "any_hit"):
        excl = np.array(trace_streamed_pallas(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive), *jt, P, RB,
            interpret=True))[1]
    if mode == "dead_chunk":
        chunk_live = np.asarray([1, 0], np.int32)
    ref = np.asarray(trace_streamed_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive), *jt, P, RB,
        interpret=True, any_hit=mode == "any_hit",
        chunk_live=None if chunk_live is None else jnp.asarray(chunk_live),
        excl=None if excl is None else jnp.asarray(excl[None])))
    native.reset_launch_counts()
    mine = trace_streamed(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(alive),
        si, ss, sab, sbab, P, RB,
        chunk_live=None if chunk_live is None else torch.from_numpy(chunk_live),
        excl=None if excl is None else torch.from_numpy(excl),
        any_hit=mode == "any_hit").numpy()
    assert native.TRACE_STREAMED.launches == 0      # CPU: plain version
    live = alive != 0
    if mode == "dead_chunk":
        live[RB:] = False
    if mode == "any_hit":
        occluded = ref[1] != 0
        assert 0.05 < occluded[live].mean() < 0.95
        np.testing.assert_array_equal(mine[1] != 0, occluded)
        sel = live & (excl != 0)
        assert sel.any() and (mine[1][sel] != excl[sel]).all()
        return
    assert 0.2 < (ref[1][live] != 0).mean() < 0.95
    np.testing.assert_array_equal(bits(mine), bits(ref))
    if mode == "dead_chunk":
        assert (ref[:, RB:] == 0).all()


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_trace_shade_streamed_equals_jax(tables, rays, fixed_rng):
    """The new state bitwise, every chunk live and the second chunk dead
    (passed through)."""
    (si, ss, sab, sbab), jt = tables
    o, d, alive = rays
    R = o.shape[1]
    st = np.concatenate([o, d, alive[None], alive[None],
                         np.zeros((8, R), F32)])
    st[6] = np.linspace(0.2, 1.0, R, dtype=F32)
    seed = np.asarray([123, 456], np.uint32)
    wc = 0.0 if fixed_rng else 1 / 512
    for cl in ([1, 1], [1, 0]):
        cl = np.asarray(cl, np.int32)
        ref = np.asarray(trace_shade_streamed_pallas(
            jnp.asarray(st), *jt, jnp.asarray(seed), P, RB,
            fixed_rng=fixed_rng, weight_cutoff=wc,
            chunk_live=jnp.asarray(cl), interpret=True))
        mine = trace_shade_streamed(torch.from_numpy(st), si, ss, sab, sbab,
                                    seed, P, RB, fixed_rng, wc,
                                    torch.from_numpy(cl)).numpy()
        np.testing.assert_array_equal(mine[[7, 11]], ref[[7, 11]])
        np.testing.assert_array_equal(bits(mine), bits(ref))
    assert (ref[:, RB:] == st[:, RB:]).all()
    assert (ref[7, :RB] != st[7, :RB]).any()


def _assert_renders_equal(eng, vp, ref_f, key, fixed_rng):
    """u8 image, float image (by bit pattern) and wave_rays of the port's
    CPU render equal the JAX float render's, with no kernel launched."""
    native.reset_launch_counts()
    mine_u8 = eng.render(vp, key=key, fixed_rng=fixed_rng)
    mine_f = eng.render(vp, key=key, fixed_rng=fixed_rng, quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(mine_f.wave_rays, ref_f.wave_rays)
    np.testing.assert_array_equal(bits(mine_f.image), bits(ref_f.image))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref_f.image))


@pytest.mark.parametrize("ncompact", [None, 0])
@pytest.mark.parametrize("fixed_rng", [True, False])
def test_streamed_render_equals_jax_engine(sphere, ncompact, fixed_rng):
    """48x32 sphere render, 256-ray chunks: u8, float and wave_rays."""
    vp = create_viewport((48, 32), (1.0, 32 / 48), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 4, 1)
    jeng = JEngine(sphere, page_size=P, ray_chunk=256, ncompact=ncompact,
                   interpret=True, streamed=True)
    ref = jeng.render(vp, key=jax.random.PRNGKey(3), fixed_rng=fixed_rng,
                      quantize=False)
    eng = Engine(carry(sphere), page_size=P, ray_chunk=256,
                 ncompact=ncompact, streamed=True, device="cpu")
    assert eng.streamed and eng.page_size == jeng.page_size == P
    assert ref.wave_rays[1] > 0
    _assert_renders_equal(eng, vp, ref, prng_key(3), fixed_rng)


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_streamed_equals_resident(sphere, fixed_rng):
    """The port's own contract: the two regimes render the same bits."""
    vp = create_viewport((48, 32), (1.0, 32 / 48), (0.0, 0.0, 0.0),
                         m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 4, 1)
    scene = carry(sphere)
    got = [Engine(scene, page_size=P, ray_chunk=RB, streamed=s,
                  device="cpu").render(vp, key=prng_key(1),
                                       fixed_rng=fixed_rng, quantize=False)
           for s in (True, False)]
    np.testing.assert_array_equal(got[0].wave_rays, got[1].wave_rays)
    np.testing.assert_array_equal(bits(got[0].image), bits(got[1].image))


@pytest.mark.parametrize("cap,streamed", [
    (1000, None),     # more triangles than slots: pages of 224, streamed
    (2070, None),     # the adaptive pages (37 x 56) just pass the cap
    (2100, None),     # ... and just fit: resident
    (262144, True),   # forced
])
def test_regime_selection_equals_jax(cap, streamed):
    """circles (2,068 triangles): the port picks the JAX Engine's regime
    and page size for the same table_slot_cap and streamed."""
    jscene, _ = jcircles.build(resolution=(16, 9))
    jeng = JEngine(jscene, interpret=True, table_slot_cap=cap,
                   streamed=streamed)
    eng = Engine(carry(jscene), table_slot_cap=cap, streamed=streamed,
                 device="cpu")
    assert (eng.streamed, eng.page_size) == (jeng.streamed, jeng.page_size)
    assert (eng.stables is not None) == eng.streamed
    assert (eng.plt_i is None) == eng.streamed
