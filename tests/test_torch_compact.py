"""B3/B5: the port's compaction (`compact_meta`, `compact`, `expand`)
against the JAX package's: the numpy oracles widely, the interpret-mode
Pallas kernels at a few small shapes.  Both sides move bits only, so every
comparison is bitwise.

Where `compact_oracle` and the kernel part ways (an identity boundary's
chunks that hold neither a live nor a retired ray: the oracle copies them,
the kernel leaves zeros), the port follows the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_raytrace_tpu.ops.compact as jc
import rust_raytrace_tpu_torch.ops.compact as tc
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32


def _state(R, p_alive, p_dead, seed):
    """Random payload bits; alive and retired lanes exclusive; one chunk
    all alive, one all retired and one empty whose padding lanes hold
    data, where R allows."""
    rng = np.random.default_rng(seed)
    st = rng.normal(size=(16, R)).astype(F32)
    u = rng.uniform(size=R)
    alive = u < p_alive
    dead = ~alive & (u < p_alive + p_dead)
    st[7] = alive
    st[11] = dead
    if R >= 2048:
        st[7, 0:512], st[11, 0:512] = 1.0, 0.0
        st[7, 512:1024], st[11, 512:1024] = 0.0, 1.0
        st[7, 1024:1536], st[11, 1024:1536] = 0.0, 0.0
    return st


def _meta(st, cb, base):
    R = st.shape[1]
    return tc.compact_meta(torch.from_numpy(st[7]), torch.from_numpy(st[11]),
                           cb, torch.tensor(base, dtype=torch.int32), R)


def _bits(x):
    return np.asarray(x).view(np.uint32)


CASES = [  # (R, cb, p_alive, p_dead, dead_base)
    (1024, 128, 0.3, 0.3, 0),
    (1024, 128, 0.0, 0.0, 0),       # nothing to move
    (1024, 256, 1.0, 0.0, 0),       # everything survives
    (1536, 512, 0.0, 1.0, 384),     # everything retires
    (4096, 512, 0.2, 0.5, 256),
    (4096, 512, 0.6, 0.1, 1024),
    (4096, 128, 0.05, 0.9, 0),
]


@pytest.mark.parametrize("R,cb,pa,pd,base", CASES)
def test_compact_meta_equal_jax(R, cb, pa, pd, base):
    st = _state(R, pa, pd, R + cb)
    meta, total_a, skip, dead_end = _meta(st, cb, base)
    jm, jt, js, je = jc.compact_meta(jnp.asarray(st[7]), jnp.asarray(st[11]),
                                     cb, jnp.int32(base), R)
    np.testing.assert_array_equal(meta.numpy(), np.asarray(jm))
    assert meta.dtype == torch.int32
    assert (int(total_a), bool(skip), int(dead_end)) == (int(jt), bool(js),
                                                         int(je))


@pytest.mark.parametrize("R,cb,pa,pd,base", CASES)
def test_compact_and_expand_equal_oracles(R, cb, pa, pd, base):
    st = _state(R, pa, pd, 7 * R + cb)
    dead0 = np.zeros((8, tc.dead_capacity(R)), F32)
    dead0[:, :base] = 3.0                      # earlier boundaries' harvest
    meta, *_ = _meta(st, cb, base)
    ns, nd = tc.compact_plain(torch.from_numpy(st),
                              torch.from_numpy(dead0.copy()), meta, cb)
    os_, od, om, ot, oflow, oend = jc.compact_oracle(st, dead0, cb, base)
    assert not oflow
    np.testing.assert_array_equal(meta.numpy(), om)
    np.testing.assert_array_equal(_bits(ns.numpy()), _bits(os_))
    np.testing.assert_array_equal(_bits(nd.numpy()), _bits(od))
    masks = torch.from_numpy(np.stack([st[7], st[11]]))
    back = tc.expand_plain(ns[8:16].clone(), nd, masks, meta, cb)
    ref = jc.expand_oracle(ns[8:16].numpy(), nd.numpy(), st[7], st[11],
                           meta.numpy(), cb)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(ref))
    # every live and retired ray's color and flag is back at its lane, a
    # retired ray's spare rows too (survivors do not carry rows 12..15)
    keep = (st[7] != 0) | (st[11] != 0)
    np.testing.assert_array_equal(_bits(back.numpy()[:4, keep]),
                                  _bits(st[8:12, keep]))
    dead = st[11] != 0
    np.testing.assert_array_equal(_bits(back.numpy()[:, dead]),
                                  _bits(st[8:16, dead]))


@pytest.mark.parametrize("R,cb,pa,pd,base,ident", [
    (1024, 128, 0.3, 0.3, 0, False),
    (2048, 512, 0.3, 0.3, 128, False),
    (2048, 512, 0.3, 0.3, 128, True),          # identity (M_IDENT) boundary
])
def test_compact_and_expand_equal_interpret_kernels(R, cb, pa, pd, base,
                                                     ident):
    st = _state(R, pa, pd, 11 * R + cb)
    dead0 = np.zeros((8, 2 * R), F32)
    dead0[:, :base] = 7.0
    meta, *_ = _meta(st, cb, base)
    meta[:, tc.M_IDENT] = int(ident)
    native.reset_launch_counts()
    ns, nd = tc.compact(torch.from_numpy(st), torch.from_numpy(dead0.copy()),
                        meta, cb)
    js, jd = jc.compact_pallas(jnp.asarray(st), jnp.asarray(dead0),
                               jnp.asarray(meta.numpy()), cb=cb,
                               interpret=True)
    np.testing.assert_array_equal(_bits(ns.numpy()), _bits(js))
    np.testing.assert_array_equal(_bits(nd.numpy()), _bits(jd))
    masks = torch.from_numpy(np.stack([st[7], st[11]]))
    y = ns[8:12].clone()
    back = tc.expand(y, nd, masks, meta, cb)
    ref = jc.expand_pallas(jnp.asarray(y.numpy()), jnp.asarray(nd.numpy()),
                           jnp.asarray(masks.numpy()),
                           jnp.asarray(meta.numpy()), cb=cb, interpret=True)
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(ref))
    # CPU tensors take the plain versions
    assert native.COMPACT.launches == 0 and native.EXPAND.launches == 0


def test_identity_boundary_keeps_only_busy_chunks():
    """M_IDENT: chunks with a live or retired ray copy through whole (all 16
    rows), empty chunks stay zero even with data in their padding lanes,
    nothing is harvested; the oracle would copy the empty chunk too."""
    R, cb = 2048, 512
    st = _state(R, 0.3, 0.3, 5)
    meta, *_ = _meta(st, cb, 0)
    meta[:, tc.M_IDENT] = 1
    dead0 = torch.zeros((8, 2 * R))
    ns, nd = tc.compact_plain(torch.from_numpy(st), dead0, meta, cb)
    np.testing.assert_array_equal(ns[:, 1024:1536].numpy(), 0.0)
    keep = np.r_[0:1024, 1536:2048]
    np.testing.assert_array_equal(_bits(ns[:, keep].numpy()),
                                  _bits(st[:, keep]))
    assert not nd.any()


def test_two_boundary_round_trip():
    """Compact twice (the second with a dead_base and a prefix), change the
    survivors' payload between boundaries, expand backward: every ray's
    payload lands at its original lane, bitwise equal to the JAX oracles
    chained the same way."""
    R, cb = 4096, 512
    rng = np.random.default_rng(3)
    st = _state(R, 0.5, 0.4, 19)
    dead = tc.make_dead_array(R)
    jdead = np.zeros((8, 2 * R), F32)
    base = torch.zeros((), dtype=torch.int32)
    jbase = 0
    cur, jcur = torch.from_numpy(st), st
    metas, prefix = [], None
    for _ in range(2):
        meta, total_a, skip, dead_end = tc.compact_meta(cur[7], cur[11], cb,
                                                        base, R)
        masks = torch.stack([cur[7], cur[11]])
        new, dead = tc.compact(cur, dead, meta, cb, grid_live=prefix)
        jnew, jdead, jmeta, jtot, _, jend = jc.compact_oracle(jcur, jdead, cb,
                                                             jbase)
        np.testing.assert_array_equal(meta.numpy(), jmeta)
        np.testing.assert_array_equal(_bits(new.numpy()), _bits(jnew))
        metas.append((meta, masks, prefix))
        prefix = torch.where(skip, torch.tensor(R, dtype=torch.int32),
                             total_a)
        base = torch.where(skip, base, dead_end)
        jbase = jend
        # the next wave: some survivors retire, payloads change
        live = new[7] != 0
        die = live & torch.from_numpy(rng.uniform(size=R) < 0.4)
        new[7] = torch.where(die, 0.0, new[7])
        new[11] = torch.where(die, 1.0, new[11])
        new[8:11] = torch.where(live, new[8:11] + 1.0, new[8:11])
        cur, jcur = new, new.numpy().copy()
    np.testing.assert_array_equal(_bits(dead.numpy()[:, :2 * R]),
                                  _bits(jdead))
    y = cur[8:12].clone()
    jy = jcur[8:16]
    for meta, masks, before in reversed(metas):
        y = tc.expand(y, dead, masks, meta, cb, grid_live=before)
        jy = jc.expand_oracle(jy, jdead, masks[0].numpy(), masks[1].numpy(),
                              meta.numpy(), cb)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(jy[0:4]))
    # rays retired before the first boundary carry their payload back
    first = st[11] != 0
    np.testing.assert_array_equal(_bits(y.numpy()[:, first]),
                                  _bits(st[8:12, first]))


@pytest.mark.parametrize("R,boundaries,want", [
    (3_686_400, 2, 7_372_800),      # circles_2k: the JAX package's 2R
    (1408, 4, 7040),                # 11 chunks of 128: R + 4*11*127 lanes
])
def test_dead_capacity(R, boundaries, want):
    assert tc.dead_capacity(R, boundaries, tc.pick_cb(R)) == want
    assert tc.dead_capacity(R) == 2 * R == jc.dead_capacity(R)


def test_wrappers_reject_bad_arguments():
    st = torch.zeros((16, 1024))
    meta, *_ = tc.compact_meta(st[7], st[11], 128,
                               torch.zeros((), dtype=torch.int32), 1024)
    with pytest.raises(ValueError, match="no kernel"):
        tc.compact(st.to("meta"), torch.zeros((8, 2048), device="meta"),
                   meta.to("meta"), 128)
    with pytest.raises(ValueError, match="no kernel"):
        tc.expand(st[8:12].to("meta"), torch.zeros((8, 2048), device="meta"),
                  st[0:2].to("meta"), meta.to("meta"), 128)
