"""The port's bank-major streamed sweep (B12) on the CPU against the JAX
package: prep's winner init and group demand against `_kernel_bm_prep`,
the chained wave (`trace_shade_bankmajor`) against
`trace_shade_bankmajor_pallas(interpret=True, sort_lanes=False)`, under
fixed and live RNG with a dead chunk, and the port's plain B12 against its
plain B9 (the JAX package's own contract, tests/test_streamed.py); renders
of `Engine(streamed=True, bank_major=True)` against the JAX Engine's and
against the port's worklist Engine.  All bitwise.  The sphere spans 4
banks at page size 8; chunks of 256 rays hold two 128-lane groups, so the
demand bits, the per-bank chunk lists and the cross-bank cut all run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rust_raytrace_tpu import math3d as m3
from rust_raytrace_tpu.camera import create_viewport
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.geometry import make_sphere
from rust_raytrace_tpu.materials import matte
from rust_raytrace_tpu.ops import intersect_streamed as jstreamed
from rust_raytrace_tpu.ops.pages import build_pages_kd as jbuild_pages_kd
from rust_raytrace_tpu.scene import assemble
from rust_raytrace_tpu_torch.engine import Engine
from rust_raytrace_tpu_torch.ops.intersect_streamed import (
    WIN_ID, WIN_SLOT, WIN_T, bankmajor_finish, bankmajor_order,
    bankmajor_prep, bankmajor_sweep, trace_shade_bankmajor,
    trace_shade_streamed, trace_streamed_plain, upload_streamed_tables)
from rust_raytrace_tpu_torch.ops.pages import LANE_ID, build_pages_kd
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import prng_key

from test_torch_streamed import bits, carry

F32 = np.float32
P = 8
RB = 256          # two 128-lane groups a chunk
R = 3 * RB


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are many small torch ops: with several test
    workers on one host, torch's intra-op threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere():
    """tests/test_streamed.py's sphere: 4 banks of pages at P = 8."""
    return assemble([make_sphere((0.0, 0.0, 6.0), 2.5, (40, 40),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.0)])


@pytest.fixture(scope="module")
def tables(sphere):
    """(the port's pages, its tables as tensors, JAX's tables as arrays)."""
    pages = build_pages_kd(carry(sphere).tris, page_size=P)
    mine = upload_streamed_tables(pages, "cpu")
    ref = tuple(map(jnp.asarray, jstreamed.build_streamed_tables(
        jbuild_pages_kd(sphere.tris, page_size=P))))
    assert mine[0].shape[0] == 4
    return pages, mine, ref


@pytest.fixture(scope="module")
def state():
    """A [16, R] state of three chunks: camera-like rays from the origin in
    a cone across the sphere's rim; bounce-like rays from inside the
    sphere in scattered directions; a group of rays that miss everything
    beside a group of inside rays.  Retired lanes, weights below 1."""
    rng = np.random.default_rng(11)
    d = rng.normal(size=(3, R)).astype(F32)
    o = np.zeros((3, R), F32)
    d[:, :RB] = d[:, :RB] * 0.15 + np.array([[-0.3], [0.3], [1.0]], F32)
    inside = np.r_[RB:2 * RB, 2 * RB + 128:R]
    o[:, inside] = rng.normal(size=(3, inside.size)) * 0.5
    o[2, inside] += 6.0
    d[:, 2 * RB:2 * RB + 128] = np.array([[0.1], [0.2], [-1.0]], F32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    alive = (rng.random(R) > 0.1).astype(F32)
    st = np.concatenate([o, d, np.linspace(0.2, 1.0, R, dtype=F32)[None],
                         alive[None], np.zeros((8, R), F32)])
    st[11] = 1.0 - alive
    return st


def _jax_prep(st, bank_ab, chunk_live):
    """The TPU kernel's phase A alone (trace_shade_bankmajor_pallas's first
    pallas_call, sort_lanes=False): (win0 [16, R], gm [NB8, NCp])."""
    NC = R // RB
    NB8 = bank_ab.shape[0]
    NCp = -(-NC // 128) * 128
    flags = jnp.zeros((-(-NC // 8) * 8, 128), jnp.int32).at[:NC, 0].set(
        jnp.asarray(chunk_live))
    _, win0, gm = pl.pallas_call(
        functools.partial(jstreamed._kernel_bm_prep, ray_chunk=RB, nb8=NB8,
                          sort_lanes=False),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(NC,),
            in_specs=[
                pl.BlockSpec((8, 128), lambda i: (i // 8, 0),
                             memory_space=pltpu.SMEM),
                pl.BlockSpec((8, RB), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((NB8, 128), lambda i: (0, 0),
                             memory_space=pltpu.VMEM)],
            out_specs=[
                pl.BlockSpec((8, RB), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((jstreamed.WN_ROWS, RB), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((NB8, 128), lambda i: (0, i // 128),
                             memory_space=pltpu.VMEM)],
            scratch_shapes=[pltpu.VMEM((8, 128), jnp.bfloat16),
                            pltpu.VMEM((8, 128), jnp.float32)]),
        out_shape=[jax.ShapeDtypeStruct((8, R), jnp.float32),
                   jax.ShapeDtypeStruct((jstreamed.WN_ROWS, R), jnp.float32),
                   jax.ShapeDtypeStruct((NB8, NCp), jnp.int32)],
        interpret=True)(flags, jnp.asarray(st), bank_ab)
    return np.asarray(win0), np.asarray(gm)


@pytest.mark.parametrize("chunk_live", [(1, 1, 1), (1, 0, 1)])
def test_bankmajor_prep_equals_jax(tables, state, chunk_live):
    """Prep's winner init (t, id; the slot row is the TPU's page row, 0)
    on live chunks and the [NB, NC] group demand bitmask on every chunk;
    a dead chunk demands no bank."""
    _, (si, ss, sab, sbab), jt = tables
    cl = np.asarray(chunk_live, np.int32)
    NB = si.shape[0]
    native.reset_launch_counts()
    win, gm = bankmajor_prep(torch.from_numpy(state), sbab, NB, RB,
                             torch.from_numpy(cl))
    assert native.BM_PREP.launches == 0              # CPU: plain version
    jwin, jgm = _jax_prep(state, jt[3], cl)
    live = np.repeat(cl != 0, RB)
    win = win.numpy()
    np.testing.assert_array_equal(bits(win[[WIN_T, WIN_ID]][:, live]),
                                  bits(jwin[[0, 1]][:, live]))
    np.testing.assert_array_equal(bits(win[WIN_SLOT][live]),
                                  bits(jwin[jstreamed.WN_PG][live]))
    np.testing.assert_array_equal(gm.numpy(), jgm[:NB, :R // RB])
    # both groups' bits occur, and some (bank, chunk) pairs demand nothing
    g = gm.numpy()
    assert (g & 1).any() and (g & 2).any() and (g == 0).any()
    if cl[1] == 0:
        assert (g[:, 1] == 0).all()


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_bankmajor_equals_jax(tables, state, fixed_rng):
    """The chained wave (prep, glue, sweep, finish) against the TPU
    kernel's, the whole new state by bit pattern, every chunk live and
    the middle chunk dead (passed through)."""
    _, tabs, jt = tables
    seed = np.asarray([123, 456], np.uint32)
    wc = 0.0 if fixed_rng else 1 / 512
    for cl in ((1, 1, 1), (1, 0, 1)):
        cl = np.asarray(cl, np.int32)
        ref = np.asarray(jstreamed.trace_shade_bankmajor_pallas(
            jnp.asarray(state), *jt, jnp.asarray(seed), P, RB,
            fixed_rng=fixed_rng, weight_cutoff=wc,
            chunk_live=jnp.asarray(cl), interpret=True, sort_lanes=False))
        native.reset_launch_counts()
        mine = trace_shade_bankmajor(torch.from_numpy(state), *tabs, seed, P,
                                     RB, fixed_rng, wc,
                                     torch.from_numpy(cl)).numpy()
        assert all(k.launches == 0 for k in native.KERNELS)
        np.testing.assert_array_equal(mine[[7, 11]], ref[[7, 11]])
        np.testing.assert_array_equal(bits(mine), bits(ref))
    assert (mine[:, RB:2 * RB] == state[:, RB:2 * RB]).all()
    assert (mine[7] != state[7]).any() and (mine[8:11] != 0).any()


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_bankmajor_equals_worklist(tables, state, fixed_rng):
    """The port's plain B12 equals its plain B9 bit for bit, and the
    sweep's winner stream names B9's winners: the same (t, id), and a slot
    whose triangle is the winner."""
    pages, tabs, _ = tables
    st = torch.from_numpy(state)
    seed = np.asarray([9, 10], np.uint32)
    wc = 0.0 if fixed_rng else 1 / 512
    cl = torch.tensor([1, 0, 1], dtype=torch.int32)
    want = trace_shade_streamed(st, *tabs, seed, P, RB, fixed_rng, wc, cl)
    got = trace_shade_bankmajor(st, *tabs, seed, P, RB, fixed_rng, wc, cl)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))

    NB = tabs[0].shape[0]
    win, gm = bankmajor_prep(st, tabs[3], NB, RB, cl)
    count, order = bankmajor_order(gm)
    assert (count == (gm != 0).sum(dim=1)).all()
    win = bankmajor_sweep(st, win, gm, count, order, *tabs, P, RB)
    live = torch.repeat_interleave(cl != 0, RB)
    rows = trace_streamed_plain(st[0:3], st[3:6], st[7], *tabs, P, RB, cl)
    np.testing.assert_array_equal(bits(win[WIN_T][live].numpy()),
                                  bits(rows[0][live].numpy()))
    np.testing.assert_array_equal(win[WIN_ID].numpy(), rows[1].numpy())
    hit = (win[WIN_ID] != 0).numpy()
    assert 0.2 < hit[live.numpy()].mean() < 0.95
    slot = win[WIN_SLOT].view(torch.int32).numpy()[hit]
    ids = pages.PK[slot // P, slot % P, LANE_ID]
    np.testing.assert_array_equal(ids, win[WIN_ID].numpy()[hit])
    # the finish phase alone, on the swept stream, is the whole wave
    fin = bankmajor_finish(st, win, tabs[0], tabs[1], seed, P, RB, fixed_rng,
                           wc, cl)
    np.testing.assert_array_equal(bits(fin.numpy()), bits(want.numpy()))


def _view(maxdepth: int = 5):
    return create_viewport((32, 24), (1.0, 0.75), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0,
                           maxdepth, 1)


@pytest.mark.parametrize("fixed_rng", [True, False])
def test_bankmajor_render_equals_jax_engine(sphere, fixed_rng):
    """32x24 sphere render at maxdepth 5 (waves 2-4 through B12), 256-ray
    chunks: u8, float image by bit pattern and wave_rays against JAX
    `Engine(streamed=True, bank_major=True, interpret=True)`."""
    vp = _view()
    jeng = JEngine(sphere, page_size=P, ray_chunk=RB, interpret=True,
                   streamed=True, bank_major=True)
    ref = jeng.render(vp, key=jax.random.PRNGKey(3), fixed_rng=fixed_rng,
                      quantize=False)
    eng = Engine(carry(sphere), page_size=P, ray_chunk=RB, streamed=True,
                 bank_major=True, device="cpu")
    assert eng.bank_major and eng.streamed and eng.page_size == P
    assert ref.wave_rays[2] > 0
    native.reset_launch_counts()
    mine_u8 = eng.render(vp, key=prng_key(3), fixed_rng=fixed_rng)
    mine_f = eng.render(vp, key=prng_key(3), fixed_rng=fixed_rng,
                        quantize=False)
    assert all(k.launches == 0 for k in native.KERNELS)
    np.testing.assert_array_equal(mine_f.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(mine_u8.wave_rays, ref.wave_rays)
    np.testing.assert_array_equal(bits(mine_f.image), bits(ref.image))
    np.testing.assert_array_equal(mine_u8.image, png.quantize_u8(ref.image))


@pytest.mark.parametrize("ncompact", [None, 0])
def test_bankmajor_render_equals_worklist(sphere, ncompact):
    """The port's own contract: bank-major and worklist Engines render the
    same bits under live RNG, compacted or not; the bank-major waves
    really ran B12 (its plain phases, counted through the engine module)."""
    import rust_raytrace_tpu_torch.engine as eng_mod

    vp = _view()
    scene = carry(sphere)
    calls = []
    chained = eng_mod.trace_shade_bankmajor

    def counted(*a, **k):
        calls.append(1)
        return chained(*a, **k)

    got = []
    for bm in (True, False):
        eng = Engine(scene, page_size=P, ray_chunk=RB, streamed=True,
                     bank_major=bm, ncompact=ncompact, device="cpu")
        eng_mod.trace_shade_bankmajor = counted
        try:
            got.append(eng.render(vp, key=prng_key(5), quantize=False))
        finally:
            eng_mod.trace_shade_bankmajor = chained
        if bm:
            assert len(calls) == 3          # waves 2, 3 and 4
    assert len(calls) == 3
    np.testing.assert_array_equal(got[0].wave_rays, got[1].wave_rays)
    np.testing.assert_array_equal(bits(got[0].image), bits(got[1].image))


def test_bank_major_is_inert_in_the_resident_regime(sphere):
    """As in the JAX Engine, bank_major changes nothing for a scene whose
    tables fit: the same bits as the default Engine."""
    vp = _view(3)
    scene = carry(sphere)
    a, b = (Engine(scene, page_size=P, ray_chunk=RB, bank_major=bm,
                   device="cpu") for bm in (True, False))
    assert not a.streamed and a.bank_major and not b.bank_major
    ra = a.render(vp, key=prng_key(2), quantize=False)
    rb = b.render(vp, key=prng_key(2), quantize=False)
    np.testing.assert_array_equal(bits(ra.image), bits(rb.image))
