"""B13 on the CPU: the port's `cull_sorted` (its plain version on CPU
tensors) against the JAX package's `cull_sorted_pallas` in interpret mode,
bitwise, and against the split form both engines use (B1, then a stable
sort of its tmin)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.cull_pallas import cull_sorted_pallas
from rust_raytrace_tpu_torch.ops import cull
from rust_raytrace_tpu_torch.utils import native

F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(NP: int, R: int, seed: int):
    """Rays and page boxes with hits and misses, some invalid rays, rays
    with zero direction components, and flat pages whose plane holds the
    origin of a ray travelling against its normal: its slab entry is -0."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 1.0, (3, R)).astype(F32)
    d = rng.normal(size=(3, R)).astype(F32)
    d[0, :64] = 0.0
    d[1, 32:96] = 0.0
    c = rng.uniform(-24.0, 24.0, (NP, 3)).astype(F32)
    h = rng.uniform(0.2, 1.0, (NP, 3)).astype(F32)
    blo, bhi = c - h, c + h
    # origins on slab planes of the first pages
    o[0, 100:110] = blo[0, 0]
    o[1, 110:120] = bhi[1, 1]
    # flat pages 2..4 at x = o_x of rays 200..202, which travel toward -x
    for j, r in enumerate(range(200, 203)):
        p = 2 + j
        blo[p] = o[:, r] - 0.5
        bhi[p] = o[:, r] + 0.5
        blo[p, 0] = bhi[p, 0] = o[0, r]
        d[:, r] = (-1.0, 0.25, 0.5)
    valid = rng.uniform(size=R) > 0.2
    valid[200:203] = True
    return o, d, valid, blo, bhi


CASES = [(37, 1024), (37, 2048), (150, 1024), (150, 2048), (300, 1024),
         (300, 2048)]


@pytest.mark.parametrize("NP,RB", CASES)
def test_cull_sorted_equals_jax_interpret(NP, RB):
    R = 2 * RB
    o, d, valid, blo, bhi = make_case(NP, R, seed=NP + RB)
    live = np.asarray([1, 0], np.int32)          # chunk 1 is dead
    jc, jp, jt = cull_sorted_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid), jnp.asarray(blo),
        jnp.asarray(bhi), RB, jnp.asarray(live), interpret=True)
    native.reset_launch_counts()
    tc, tp, tt = cull.cull_sorted(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(valid),
        torch.from_numpy(blo), torch.from_numpy(bhi), RB,
        torch.from_numpy(live))
    assert native.CULL_SORTED.launches == 0
    NPpad = -(-NP // 128) * 128
    assert tp.shape == (2, NPpad) and tt.shape == (2, NPpad)
    assert tc.dtype == torch.int32 and tp.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy().view(np.int32),
                                  np.asarray(jt).view(np.int32))
    # the case reaches what it is made for: hits and misses in the live
    # chunk, a zero key, and the dead chunk's fill
    assert 0 < int(tc[0]) < NP
    assert (tt[0] == 0.0).any()
    assert int(tc[1]) == 0 and not tp[1].any() and (tt[1] == cull.BIGT).all()


@pytest.mark.parametrize("NP,RB", CASES)
def test_cull_sorted_agrees_with_the_split_form(NP, RB):
    """The engine's split form: B1's mask and tmin, then a stable sort.
    On the real pages the order is the same, counts are B1's row sums, and
    the hit pages' keys are B1's sorted tmin (B1 writes +inf for a miss,
    B13 BIGT)."""
    R = 2 * RB
    o, d, valid, blo, bhi = make_case(NP, R, seed=NP + RB)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(valid),
            torch.from_numpy(blo), torch.from_numpy(bhi), RB)
    counts, plist, ptmin = cull.cull_sorted(*args)
    mask, tmin = cull.cull_mask_exact(*args)
    np.testing.assert_array_equal(counts.numpy(),
                                  mask.sum(dim=1).numpy())
    order = torch.argsort(tmin, dim=1, stable=True)
    np.testing.assert_array_equal(plist[:, :NP].numpy(), order.numpy())
    s = torch.sort(tmin, dim=1, stable=True).values
    for c in range(R // RB):
        n = int(counts[c])
        assert torch.equal(ptmin[c, :n], s[c, :n])
        assert torch.isfinite(s[c, :n]).all()
        assert (ptmin[c, n:] == cull.BIGT).all()


def test_cull_sorted_branch_case_equals_jax_interpret():
    """tests/cull_sorted_cases.py: a chunk whose hit keys all lie below
    BIGT (the kernel's fast path: the plain plist is the fast rank), a
    chunk with a hit key equal to BIGT and one beyond it (the all-pairs
    branch: the fast rank would differ), a dead chunk and one with no
    valid ray, bitwise against the JAX package in interpret mode."""
    import cull_sorted_cases as C

    o, d, valid, blo, bhi, live = C.case()
    jc, jp, jt = cull_sorted_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid), jnp.asarray(blo),
        jnp.asarray(bhi), C.RB, jnp.asarray(live), interpret=True)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(valid),
            torch.from_numpy(blo), torch.from_numpy(bhi), C.RB)
    tc, tp, tt = cull.cull_sorted(*args, torch.from_numpy(live))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tt.numpy().view(np.int32),
                                  np.asarray(jt).view(np.int32))
    mask, _ = cull.cull_mask_exact_plain(*args)
    NPpad = tp.shape[1]
    for c in (C.FAST_CHUNK, C.ALL_PAIRS_CHUNK):
        key = np.empty(NPpad, np.float32)
        key[tp[c].numpy()] = tt[c].numpy()
        m = np.zeros(NPpad, bool)
        m[:C.NP] = mask[c].numpy()
        hit_keys = key[m]
        fast = C.fast_rank(m, key)
        if c == C.FAST_CHUNK:
            assert (hit_keys < cull.BIGT).all() and (hit_keys == 0).any()
            np.testing.assert_array_equal(tp[c].numpy(), fast)
        else:
            assert key[C.PAGE_A] == np.float32(cull.BIGT) and m[C.PAGE_A]
            assert key[C.PAGE_B] > np.float32(cull.BIGT) and m[C.PAGE_B]
            assert key[C.PAGE_C] == 0.0 and m[C.PAGE_C]
            assert not np.array_equal(tp[c].numpy(), fast)
    assert int(tc[C.DEAD_CHUNK]) == 0 and not tp[C.DEAD_CHUNK].any()
    assert int(tc[C.EMPTY_CHUNK]) == 0
    np.testing.assert_array_equal(tp[C.EMPTY_CHUNK].numpy(),
                                  np.arange(NPpad))
    assert (tt[[C.DEAD_CHUNK, C.EMPTY_CHUNK]] == cull.BIGT).all()
