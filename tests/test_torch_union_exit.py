"""B1, B2 and B6 on the inputs their page loops must keep exact: equal-t
ties between two copies of a triangle in two pages, rays that meet their
winner on the chunk's last page while their chunk mates finish early,
zero-normal slots in the middle of a page and the last page's padding, the
exclusion of the nearest triangle, a chunk whose count is 0, a chunk of
only invalid rays, 37 pages, and ray_chunk 1024 and 2048.

The inputs come from tests/union_exit_cases.py.  The port's wrappers on
CPU tensors (the plain versions) are held bitwise
against the JAX package's `trace_chunks_pallas`, `trace_shade_chunks_pallas`
and `cull_mask_exact_pallas` in interpret mode.  The CUDA kernels' order of
work is emulated on the same inputs and held to the plain versions: B2/B6's
pair test (t first; then t >= 0, the exclusion and the lexicographic test;
the plane distances last, stopping at the first past 1; the payload read
back from the winning slot) under the chunk-wide page exit, and B1's
transposed butterfly, which leaves lane l of a warp with page l's minimum.
tests/test_torch_cuda.py holds the kernels to the plain versions on the
same inputs on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_raytrace_tpu.ops.cull_pallas import cull_mask_exact_pallas
from rust_raytrace_tpu.ops.intersect_pallas import (trace_chunks_pallas,
                                                    trace_shade_chunks_pallas)
from rust_raytrace_tpu_torch.ops import intersect
from rust_raytrace_tpu_torch.ops.cull import cull_mask_exact
from rust_raytrace_tpu_torch.ops.intersect import (PAYLOAD_ROWS,
                                                   packed_hit_predicate,
                                                   payload_features,
                                                   trace_chunks,
                                                   trace_chunks_plain,
                                                   trace_shade_chunks)
from rust_raytrace_tpu_torch.ops.pages import (LANE_ID, LANE_N, LANE_NC,
                                               LANE_S0, LANE_S0C)
from rust_raytrace_tpu_torch.ops.shade import fma
from rust_raytrace_tpu_torch.utils import native
from union_exit_cases import (DEAD_CHUNK, EMPTY_CHUNK, F32, NC, NP, P,
                              SOLID_CHUNK, case as _case, rays as _rays,
                              scene as _scene)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rows(c, rc, zero_origin):
    excl = c["excl"]
    return np.asarray(trace_chunks_pallas(
        jnp.asarray(c["o"]), jnp.asarray(c["d"]), jnp.asarray(c["pk"].numpy()),
        jnp.asarray(c["counts"].numpy()), jnp.asarray(c["plist"].numpy()),
        jnp.asarray(c["ptmin"].numpy()), P, rc, interpret=True,
        zero_origin=zero_origin,
        excl=None if excl is None else jnp.asarray(excl.numpy()[None])))


CASES = [(rc, zo, ex) for rc in (1024, 2048) for zo, ex in
         ((True, False), (False, False), (False, True), (True, True))]


@pytest.mark.parametrize("rc,zero_origin,with_excl", CASES)
def test_trace_chunks_equals_pallas(rc, zero_origin, with_excl):
    """B6 through its wrapper, all 16 rows bitwise; the inputs hold what
    they are built for: a tie between a triangle and its copy, a chunk
    that visits more than one page and exits before its last, rays whose
    winner is on the chunk's last visited page, the dead and the empty
    chunk all misses."""
    c = _case(rc, zero_origin, with_excl)
    args = (c["ot"], c["dt"], c["pk"], c["counts"], c["plist"], c["ptmin"])
    native.reset_launch_counts()
    mine = trace_chunks(*args, P, rc, zero_origin, c["excl"]).numpy()
    assert native.TRACE_UNION_ROWS.launches == 0     # CPU: plain version
    ref = _jax_rows(c, rc, zero_origin)
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))

    rows, visits = trace_chunks_plain(*args, rc, zero_origin, c["excl"],
                                      return_visits=True)
    ids = rows[1].reshape(NC, rc)
    for ch in (DEAD_CHUNK, EMPTY_CHUNK):
        assert not ids[ch].any() and int(visits[ch]) == 0
    live = [ch for ch in range(NC) if ch not in (DEAD_CHUNK, EMPTY_CHUNK)]
    assert all(int(visits[ch]) > 1 for ch in live)
    if not with_excl:                 # excluded winners push rays on
        assert int(visits[SOLID_CHUNK]) < int(c["counts"][SOLID_CHUNK])
    # the page of every winning triangle, and where the chunk visited it
    page_of = torch.zeros(300, dtype=torch.long)
    pid = c["pk"][..., LANE_ID].long()
    page_of[pid.reshape(-1)] = torch.arange(NP).repeat_interleave(P)
    at_last = 0
    for ch in live:
        won = ids[ch][ids[ch] != 0].long()
        pos = (c["plist"][ch][None, :] == page_of[won][:, None]).float() \
            .argmax(dim=1)
        at_last += int((pos == int(visits[ch]) - 1).sum())
        assert (pos < int(visits[ch]) - 1).any()
    assert at_last > 0
    if not with_excl:
        assert _has_copy_tie(c, rows)


def _has_copy_tie(c, rows):
    """Whether some ray's winner has an equal-t copy in another page (the
    copies are the last 8 triangles, ids 282..289 of the near wall's)."""
    pk = c["PK"].reshape(-1, 128)
    ids = rows[1].long()
    won = ids[ids != 0]
    key = [tuple(pk[(pk[:, LANE_ID] == float(i))][0, :16].tolist())
           for i in range(282, 290)]
    base = {k: i for i, k in enumerate(key)}
    near_ids = [int(pk[r, LANE_ID]) for r in range(pk.shape[0])
                if tuple(pk[r, :16].tolist()) in base
                and pk[r, LANE_ID] < 282]
    return bool(np.isin(won.numpy(), near_ids).any())


@pytest.mark.parametrize("rc", [1024, 2048])
@pytest.mark.parametrize("zero_origin", [True, False])
def test_trace_shade_chunks_equals_pallas(rc, zero_origin):
    """B2 (live RNG: the scatter hash keys on the chunk and the lane)."""
    c = _case(rc, zero_origin)
    R = NC * rc
    rng = np.random.default_rng(rc)
    st = np.zeros((16, R), F32)
    st[0:3], st[3:6] = c["o"], c["d"]
    alive = (c["d"] != 0).any(axis=0)
    st[6] = rng.uniform(0.1, 1.0, R)
    st[7] = alive
    st[8:11] = rng.uniform(0, 0.5, (3, R))
    seed = np.asarray([9, 77], np.uint32)
    args = (torch.from_numpy(st), c["pk"], c["counts"], c["plist"],
            c["ptmin"], seed, P, rc, False, 1 / 512)
    native.reset_launch_counts()
    mine = trace_shade_chunks(*args, zero_origin=zero_origin).numpy()
    assert native.TRACE_SHADE_UNION.launches == 0
    ref = np.asarray(trace_shade_chunks_pallas(
        jnp.asarray(st), jnp.asarray(c["pk"].numpy()),
        jnp.asarray(c["counts"].numpy()), jnp.asarray(c["plist"].numpy()),
        jnp.asarray(c["ptmin"].numpy()), jnp.asarray(seed), P, rc,
        fixed_rng=False, weight_cutoff=1 / 512, interpret=True,
        zero_origin=zero_origin))
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("rc", [1024, 2048])
@pytest.mark.parametrize("zero_origin", [True, False])
def test_cull_equals_pallas(rc, zero_origin):
    """B1: mask and tmin bitwise; the chunk of only invalid rays gets mask
    0 and tmin +inf (the kernel skips it after one vote)."""
    pages, _ = _scene()
    o, d = _rays(rc, zero_origin)
    valid = (d != 0).any(axis=0)
    native.reset_launch_counts()
    mask, tmin = cull_mask_exact(torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(pages.aabb_lo),
                                 torch.from_numpy(pages.aabb_hi), rc)
    assert native.CULL.launches == 0
    jm, jt = cull_mask_exact_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        jnp.asarray(pages.aabb_lo), jnp.asarray(pages.aabb_hi), rc,
        interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tmin.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    assert not mask[DEAD_CHUNK].any()
    assert torch.isinf(tmin[DEAD_CHUNK]).all()
    assert mask.shape == (NC, NP) and mask.any(dim=1).sum() == NC - 1


def _kernel_order_rows(c, rc, zero_origin):
    """trace_union_kernel's order of work, emulated with torch ops one
    triangle at a time over a chunk's rays: t = (nc - n.o) / (n.d) first;
    then t >= 0, the exclusion and the lexicographic test; then the three
    plane distances, stopping at the first past 1; the update keeps (t, id,
    slot); after each page but the last the chunk-wide vote on ptmin.  The
    payload is read back from the winning slot and its hit terms
    recomputed.  Returns (rows [16, R], share of pairs stopped before any
    plane distance)."""
    ot, dt, pk = c["ot"], c["dt"], c["pk"]
    counts, plist, ptmin, excl = (c["counts"], c["plist"], c["ptmin"],
                                  c["excl"])
    R = ot.shape[1]
    rows = torch.zeros((16, R))
    flat = pk.reshape(-1, 128)
    pairs = stopped = 0
    for ch in range(R // rc):
        sl = slice(ch * rc, (ch + 1) * rc)
        o, d = ot[:, sl], dt[:, sl]
        ex = None if excl is None else excl[sl]
        valid = (d != 0).any(dim=0)
        bt = torch.where(valid, torch.inf, -torch.inf)
        bi = torch.zeros(rc)
        slot = torch.full((rc,), -1, dtype=torch.long)
        n = int(counts[ch])
        for k in range(n):
            page = int(plist[ch, k])
            for j in range(P):
                row = flat[page * P + j]

                def dot3(f, r, row=row):
                    return fma(row[f + 2], r[2],
                               fma(row[f], r[0], row[f + 1] * r[1]))

                md_n = dot3(LANE_N, d)
                t = (row[LANE_NC] / md_n if zero_origin else
                     (row[LANE_NC] - dot3(LANE_N, o)) / md_n)
                ids = row[LANE_ID]
                go = (t >= 0) & ((t < bt) | ((t == bt) & ~torch.isinf(t)
                                             & (ids < bi)))
                if ex is not None:
                    go = go & (ids != ex)
                pairs += rc
                stopped += int((~go).sum())
                for q in range(3):
                    f = LANE_S0 + 3 * q
                    sd = dot3(f, d)
                    dv = (fma(t, sd, -row[LANE_S0C + q]) if zero_origin else
                          fma(t, sd, dot3(f, o)) - row[LANE_S0C + q])
                    go = go & (dv <= 1.0)
                bt = torch.where(go, t, bt)
                bi = torch.where(go, ids, bi)
                slot = torch.where(go, page * P + j, slot)
            if k + 1 < n and bool((bt < ptmin[ch, k + 1]).all()):
                break
        rows[0, sl], rows[1, sl] = bt, bi
        won = slot >= 0
        g = flat[slot[won]]                                 # [w, 128]

        def col(f, g=g):
            return g[:, f]

        o3 = tuple(o[q, won] for q in range(3))
        d3 = tuple(d[q, won] for q in range(3))
        _, _, _, md_n, dv = packed_hit_predicate(col, o3, d3,
                                                 zero_origin=zero_origin)
        for r, v in zip(PAYLOAD_ROWS, payload_features(col, md_n, dv)):
            vals = torch.zeros(rc)
            vals[won] = torch.where(v == 0.0, 0.0, v)       # -0 stored +0
            rows[r, sl] = vals
    return rows, stopped / max(1, pairs)


@pytest.mark.parametrize("zero_origin,with_excl",
                         [(True, False), (False, False), (False, True)])
def test_kernel_order_equals_plain(zero_origin, with_excl):
    """The kernel's pair order and payload read-back give the plain
    version's rows bit for bit, and the order stops a share of the pairs
    before any plane distance (on the first visited pages every pair with
    t >= 0 beats +inf and goes on)."""
    c = _case(1024, zero_origin, with_excl)
    want = trace_chunks_plain(c["ot"], c["dt"], c["pk"], c["counts"],
                              c["plist"], c["ptmin"], 1024, zero_origin,
                              c["excl"])
    got, stopped = _kernel_order_rows(c, 1024, zero_origin)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert 0.1 < stopped < 1.0


def test_plain_trace_blocks_of_chunks(monkeypatch):
    """The plain trace in blocks of one chunk (as a card's budget cuts a
    whole wave) equals it in one block, rows and pages visited."""
    c = _case(1024, False, True)
    args = (c["ot"], c["dt"], c["pk"], c["counts"], c["plist"], c["ptmin"],
            1024, False, c["excl"])
    assert NC <= intersect.PLAIN_UNION_PAIRS // (1024 * P)   # one block
    whole, v_whole = trace_chunks_plain(*args, return_visits=True)
    monkeypatch.setattr(intersect, "PLAIN_UNION_PAIRS", 1)
    blocks, v_blocks = trace_chunks_plain(*args, return_visits=True)
    assert torch.equal(blocks.view(torch.int32), whole.view(torch.int32))
    assert torch.equal(v_blocks, v_whole)


def test_union_lists_want_aligned_pk():
    """B2's and B6's kernels copy PK's records 16 bytes at a time: their
    argument checks refuse a PK view off a 16-byte boundary and take one
    on it."""
    c = _case(1024, False)
    pk = c["pk"]
    cpu = torch.device("cpu")
    flat = torch.zeros(pk.numel() + 8, dtype=torch.float32)
    at = [k for k in range(4) if (flat.data_ptr() + 4 * k) % 16 == 0][0]
    lists = (c["counts"], c["plist"], c["ptmin"])
    for k in (at, at + 1, at + 2, at + 3):
        view = flat[k:k + pk.numel()].view(pk.shape)
        view.copy_(pk)
        if k == at:
            intersect._check_lists(view, *lists, P, NC, cpu)
        else:
            with pytest.raises(ValueError, match="16-byte alignment"):
                intersect._check_lists(view, *lists, P, NC, cpu)


def _butterfly(e):
    """cull.cu's warp reduction of 16 pages, emulated on e [32 lanes, 16]:
    lane l folds with lane l ^ 16, then a transposed butterfly over lane
    bits 3..0 (at bit b a lane sends the half it gives up and keeps the
    min of the other half and what it receives).  Returns each lane's e[0]."""
    e = e.copy()
    lane = np.arange(32)
    e = np.minimum(e, e[lane ^ 16])
    for b in (8, 4, 2, 1):
        up = (lane & b) != 0
        new = e.copy()
        for i in range(b):
            send = np.where(up, e[:, i], e[:, i + b])
            keep = np.where(up, e[:, i + b], e[:, i])
            new[:, i] = np.minimum(keep, send[lane ^ b])
        e = new
    return e[:, 0]


@pytest.mark.parametrize("seed", range(4))
def test_cull_butterfly_leaves_page_minima(seed):
    """Lane l (l < 16) ends with page l's minimum over the warp's 32
    lanes, lane l + 16 with the same, including +inf (no hit) pages."""
    rng = np.random.default_rng(seed)
    e = rng.uniform(0, 10, (32, 16)).astype(F32)
    e[rng.uniform(size=e.shape) < 0.3] = np.inf
    e[:, seed] = np.inf
    got = _butterfly(e)
    want = e.min(axis=0)
    np.testing.assert_array_equal(got[:16], want)
    np.testing.assert_array_equal(got[16:], want)

