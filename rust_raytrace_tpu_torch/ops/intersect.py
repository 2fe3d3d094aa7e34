"""The packed-triangle hit predicate, the union trace over culled page
lists (B2, the wave-0 trace + shade, and B6, the trace alone to winner
rows) and the dense brute-force nearest hit (B11).

Counterparts in `rust_raytrace_tpu/ops/intersect_pallas.py`:
`packed_hit_predicate`, `fold_pages_origin`, `trace_shade_chunks_pallas`
(inner `_kernel_trace_shade`, `_trace_pages`), `trace_chunks_pallas`
(inner `_kernel_trace`) and `nearest_hit_pallas` (inner `_kernel`,
`_predicate_update`).  `trace_shade_chunks` and `trace_chunks` run the
CUDA kernel `csrc/trace_shade_union.cu` on CUDA tensors and
`trace_shade_chunks_plain` and `trace_chunks_plain` on CPU tensors;
`nearest_hit` runs `csrc/nearest_hit.cu` or `nearest_hit_plain`.

The plain version computes what the TPU kernel computes, page by page: the
per-page (t, id) minimum, the lexicographic update of each ray's winner, the
winner payload as a one-hot masked sum over the page, and the chunk-wide
early exit on the next page's entry bound.  The CUDA kernel folds the same
lexicographic order one triangle at a time, which selects the same winner.
"""

import torch

from ..utils import native, xla_rsqrt
from .pages import (LANE_ALPHA, LANE_COLOR, LANE_ET, LANE_ID, LANE_KIND,
                    LANE_N, LANE_NC, LANE_S0, LANE_S0C, LANE_S1, LANE_S1C,
                    LANE_S2, LANE_S2C, LANE_SCAT)
from .shade import fma, scatter_rv, shade_state_rows
from .state import (ROW_ALPHA, ROW_COLOR, ROW_ENC, ROW_ID, ROW_NORM, ROW_SCAT,
                    ROW_T, STATE_ROWS, TRACE_ROWS)

#: lanes of a packed page that the kernels read (24..127 are zero)
USED_LANES = 24

#: winner payload rows and the page lanes they come from (ENC is computed)
PAYLOAD_ROWS = (ROW_NORM, ROW_NORM + 1, ROW_NORM + 2, ROW_ENC, ROW_COLOR,
                ROW_COLOR + 1, ROW_COLOR + 2, ROW_ALPHA, ROW_SCAT)


def packed_hit_predicate(col, o3, d3, has=None, excl=None, *,
                         zero_origin: bool = False):
    """Hit terms of packed triangles against rays (B0a).

    col(f): feature f of the triangles, broadcastable against the ray rows.
    o3/d3: (x, y, z) ray tensors.  has: optional mask AND-ed into ok.
    excl: optional per-ray triangle id that may not hit (a shadow ray's own
    triangle; 0 excludes nothing, since padding slots never hit).
    zero_origin: the o-dot terms were folded into the NC/S*C lanes
    (fold_pages_origin).  Returns (t, ok, ids, md_n, (dv0, dv1, dv2)).
    The multiply-adds are fused where XLA fuses them (ROADMAP C2), exactly
    as the CUDA `rt::hit_predicate` does.
    """
    o0, o1, o2 = o3
    d0, d1, d2 = d3

    def dot3(f, r0, r1, r2):
        return fma(col(f + 2), r2, fma(col(f), r0, col(f + 1) * r1))

    md_n = dot3(LANE_N, d0, d1, d2)
    if zero_origin:
        t = col(LANE_NC) / md_n
        dv = tuple(fma(t, dot3(s, d0, d1, d2), -col(c))
                   for s, c in ((LANE_S0, LANE_S0C), (LANE_S1, LANE_S1C),
                                (LANE_S2, LANE_S2C)))
    else:
        t = (col(LANE_NC) - dot3(LANE_N, o0, o1, o2)) / md_n
        dv = tuple(fma(t, dot3(s, d0, d1, d2), dot3(s, o0, o1, o2)) - col(c)
                   for s, c in ((LANE_S0, LANE_S0C), (LANE_S1, LANE_S1C),
                                (LANE_S2, LANE_S2C)))
    ok = (t >= 0.0) & (dv[0] <= 1.0) & (dv[1] <= 1.0) & (dv[2] <= 1.0)
    if has is not None:
        ok = ok & has
    if excl is not None:
        ok = ok & (col(LANE_ID) != excl)
    return t, ok, col(LANE_ID), md_n, dv


def encode_face(col, md_n, dv):
    """enc = kind + 4*edge + 8*back of each candidate triangle."""
    inv_et = 1.0 - col(LANE_ET)
    edge = (dv[0] > inv_et) | (dv[1] > inv_et) | (dv[2] > inv_et)
    back = md_n > 0.0
    return col(LANE_KIND) + 4.0 * edge.float() + 8.0 * back.float()


def payload_features(col, md_n, dv):
    """The nine payload values of each candidate, in PAYLOAD_ROWS order."""
    return (col(LANE_N), col(LANE_N + 1), col(LANE_N + 2),
            encode_face(col, md_n, dv), col(LANE_COLOR), col(LANE_COLOR + 1),
            col(LANE_COLOR + 2), col(LANE_ALPHA), col(LANE_SCAT))


def lex_update(tt, ids, best_t, best_id, dim: int):
    """Per-group (t, id) minimum of candidates tt/ids over `dim` and the
    lexicographic update against the running best: returns (upd, gmin, gid,
    onehot) where onehot marks the group winner among the candidates."""
    gmin = tt.amin(dim=dim, keepdim=True)
    gid = torch.where(tt == gmin, ids, torch.inf).amin(dim=dim, keepdim=True)
    onehot = (tt == gmin) & (ids == gid)
    gmin = gmin.squeeze(dim)
    gid = gid.squeeze(dim)
    upd = (gmin < best_t) | ((gmin == best_t) & ~torch.isinf(gmin)
                             & (gid < best_id))
    return upd, gmin, gid, onehot


def fold_pages_origin(PK: torch.Tensor, origin) -> torch.Tensor:
    """Fold a shared ray origin into the page plane/half-plane scalars.

    With o fixed, t = (n.c - n.o)/(n.d) and dist_k = t (d.s'k) - (s'k.c -
    s'k.o): the four o-dot terms become per-triangle constants.  Returns a
    copy of PK [NP, P, 128] with lanes NC/S0C/S1C/S2C adjusted so the trace
    can run with zero_origin=True and rays anchored at `origin`.
    """
    o = [float(x) for x in origin]
    out = PK.clone()
    for lane_c, lane_v in ((LANE_NC, LANE_N), (LANE_S0C, LANE_S0),
                           (LANE_S1C, LANE_S1), (LANE_S2C, LANE_S2)):
        adj = fma(PK[..., lane_v + 2], o[2],
                  fma(PK[..., lane_v], o[0], PK[..., lane_v + 1] * o[1]))
        out[..., lane_c] = PK[..., lane_c] - adj
    return out


#: (ray, triangle) pairs of one page step the plain union trace holds at
#: once: blocks of whole chunks (chunks are independent) keep the float64
#: temporaries of a whole 2560x1440 wave within device memory
PLAIN_UNION_PAIRS = 1 << 26


def trace_chunks_plain(ot, dt, PK, counts, plist, ptmin, ray_chunk: int,
                       zero_origin: bool = False, excl=None,
                       return_visits: bool = False):
    """Plain torch version of `trace_chunks`.  return_visits: also return
    the pages each chunk visited before its early exit ([NC] int32)."""
    RB = ray_chunk
    R = ot.shape[1]
    NC = R // RB
    dev = ot.device
    P = PK.shape[1]
    rows = torch.zeros((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    visits = torch.zeros(NC, dtype=torch.int32, device=dev)
    step = max(1, PLAIN_UNION_PAIRS // (RB * P))
    for c0 in range(0, NC, step):
        c1 = min(NC, c0 + step)
        rays = slice(c0 * RB, c1 * RB)
        rows[:, rays], visits[c0:c1] = _trace_chunk_block(
            ot[:, rays], dt[:, rays], PK, counts[c0:c1], plist[c0:c1],
            ptmin[c0:c1], RB, zero_origin,
            None if excl is None else excl[rays])
    return (rows, visits) if return_visits else rows


def _trace_chunk_block(ot, dt, PK, counts, plist, ptmin, RB: int,
                       zero_origin: bool, excl):
    """`trace_chunks_plain` of whole chunks: (rows, pages visited)."""
    R = ot.shape[1]
    NC = R // RB
    dev = ot.device
    o = ot.reshape(3, NC, 1, RB)
    d = dt.reshape(3, NC, 1, RB)
    ex = None if excl is None else excl.reshape(NC, 1, RB)
    valid = ((d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0))[:, 0]  # [NC, RB]
    best_t = torch.where(valid, torch.inf, -torch.inf)
    best_id = torch.zeros((NC, RB), dtype=torch.float32, device=dev)
    payload = torch.zeros((len(PAYLOAD_ROWS), NC, RB), dtype=torch.float32,
                          device=dev)
    done = torch.zeros(NC, dtype=torch.bool, device=dev)
    visits = torch.zeros(NC, dtype=torch.int32, device=dev)
    pk = PK[..., :USED_LANES]
    n_max = int(counts.max()) if NC else 0
    for k in range(n_max):
        c = torch.nonzero((counts > k) & ~done).squeeze(1)
        if c.numel() == 0:
            break
        visits[c] += 1
        page = pk[plist[c, k].long()]                     # [A, P, 24]

        def col(f, page=page):
            return page[:, :, f:f + 1]                    # [A, P, 1]

        o3 = (o[0, c], o[1, c], o[2, c])                   # [A, 1, RB]
        d3 = (d[0, c], d[1, c], d[2, c])
        t, ok, ids, md_n, dv = packed_hit_predicate(
            col, o3, d3, excl=None if ex is None else ex[c],
            zero_origin=zero_origin)
        tt = torch.where(ok, t, torch.inf)
        bt, bi = best_t[c], best_id[c]
        upd, gmin, gid, onehot = lex_update(tt, ids, bt, bi, dim=1)
        w = onehot.float()
        for i, v in enumerate(payload_features(col, md_n, dv)):
            payload[i, c] = torch.where(upd, (w * v).sum(dim=1), payload[i, c])
        best_t[c] = torch.where(upd, gmin, bt)
        best_id[c] = torch.where(upd, gid, bi)
        n = counts[c]
        nxt = torch.minimum(torch.full_like(n, k + 1), n - 1).long()
        done[c] = (k + 1 < n) & (best_t[c].amax(dim=1) < ptmin[c, nxt])
    rows = torch.zeros((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    rows[ROW_T] = best_t.reshape(R)
    rows[ROW_ID] = best_id.reshape(R)
    for i, r in enumerate(PAYLOAD_ROWS):
        rows[r] = payload[i].reshape(R)
    return rows, visits


def trace_shade_chunks_plain(state, PK, counts, plist, ptmin, seed,
                             page_size: int, ray_chunk: int, fixed_rng: bool,
                             weight_cutoff: float, zero_origin: bool = False):
    """Plain torch version of `trace_shade_chunks`."""
    rows = trace_chunks_plain(state[0:3], state[3:6], PK, counts, plist,
                              ptmin, ray_chunk, zero_origin)
    return shade_chunks_plain(state, rows, seed, ray_chunk, fixed_rng,
                              weight_cutoff)


def shade_chunks_plain(state, rows, seed, ray_chunk: int, fixed_rng: bool,
                       weight_cutoff: float):
    """`trace_shade_chunks_plain`'s shade step: the new state from the
    winner rows [16, R] of its trace step (`trace_chunks_plain`), the
    scatter hash keyed on each ray's lane within its chunk."""
    rays = torch.arange(state.shape[1], device=state.device)
    rv = scatter_rv(seed, rays, ray_chunk, fixed_rng)
    return shade_state_rows(state, rows, rv, weight_cutoff)


def _check_lists(PK, counts, plist, ptmin, page_size: int, NC: int, dev):
    """The pages and page lists B2 and B6 take; the kernel copies PK's
    records 16 bytes at a time, so PK must be 16-byte aligned."""
    NP = PK.shape[0]
    native.check_tensor("PK", PK, dev, (NP, page_size, 128), torch.float32)
    native.require(PK.data_ptr() % 16 == 0, "PK: want 16-byte alignment")
    native.check_tensor("counts", counts, dev, (NC,), torch.int32)
    native.check_tensor("plist", plist, dev, (NC, NP), torch.int32)
    native.check_tensor("ptmin", ptmin, dev, (NC, NP), torch.float32)


def trace_shade_chunks(state, PK, counts, plist, ptmin, seed,
                       page_size: int, ray_chunk: int, fixed_rng: bool,
                       weight_cutoff: float, zero_origin: bool = False):
    """One wave over culled page lists: trace, shade and state update.

    state: [16, R] float32 ray state (ops/state.py; with zero_origin, rows
    0..2 hold the true origin the shade needs, and PK is the folded copy);
    PK: [NP, P, 128] packed pages; counts: [NC] int32; plist: [NC, NP]
    int32, pages front to back; ptmin: [NC, NP] float32 matching entry
    bounds; seed: the wave's two uint32 key words.  Returns the new state.
    """
    dev = state.device
    if dev.type == "cpu":
        return trace_shade_chunks_plain(state, PK, counts, plist, ptmin, seed,
                                        page_size, ray_chunk, fixed_rng,
                                        weight_cutoff, zero_origin)
    native.require(dev.type == "cuda",
                   f"trace_shade_chunks: no kernel for device {dev}")
    R = state.shape[1]
    NP = PK.shape[0]
    NC = R // ray_chunk
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    _check_lists(PK, counts, plist, ptmin, page_size, NC, dev)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    native.TRACE_SHADE_UNION(
        state.data_ptr(), out.data_ptr(), R, PK.data_ptr(), page_size, NP,
        counts.data_ptr(), plist.data_ptr(), ptmin.data_ptr(), s0, s1,
        int(fixed_rng), float(weight_cutoff), int(zero_origin), ray_chunk,
        xla_rsqrt.device_table(dev).data_ptr(), native.stream(dev))
    return out


def trace_chunks(ot, dt, PK, counts, plist, ptmin, page_size: int,
                 ray_chunk: int, zero_origin: bool = False, excl=None):
    """Winner rows [16, R] (ops/state.py ROW_* layout) of the union trace
    over culled page lists, with no shade.

    ot/dt: [3, R] float32 ray origins and directions (rows of a larger
    tensor are fine: the last dim must be dense, one row stride for both);
    lanes with d = 0 are invalid (ROW_T -inf, the rest 0).  PK, counts,
    plist, ptmin: as `trace_shade_chunks`.  excl: optional [R] float32
    triangle id each ray may not hit (0: none).  Rows 11..15 are 0.
    """
    dev = ot.device
    if dev.type == "cpu":
        return trace_chunks_plain(ot, dt, PK, counts, plist, ptmin,
                                  ray_chunk, zero_origin, excl)
    native.require(dev.type == "cuda",
                   f"trace_chunks: no kernel for device {dev}")
    R = ot.shape[1]
    NP = PK.shape[0]
    NC = R // ray_chunk
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    _check_lists(PK, counts, plist, ptmin, page_size, NC, dev)
    if excl is not None:
        native.check_tensor("excl", excl, dev, (R,), torch.float32)
    out = torch.empty((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    native.TRACE_UNION_ROWS(
        ot.data_ptr(), dt.data_ptr(), ot.stride(0), R,
        0 if excl is None else excl.data_ptr(), PK.data_ptr(), page_size, NP,
        counts.data_ptr(), plist.data_ptr(), ptmin.data_ptr(),
        int(zero_origin), ray_chunk, out.data_ptr(), native.stream(dev))
    return out


#: (triangle, ray) pairs a block of the plain nearest hits
#: (`nearest_hit_plain`, `intersect_xla.nearest_hit_xla`) evaluates at once,
#: by device: on the host the float64 temporaries of the emulated fma stay
#: in its cache; on a card few large blocks keep the launches few
PLAIN_PAIRS = {"cpu": 1 << 16, "cuda": 1 << 26}


def nearest_hit_plain(O, D, PK, ray_chunk: int = 1024, alive=None):
    """Plain torch version of `nearest_hit`.  Each ray is independent of
    its chunk, so ray_chunk changes nothing here; a ray that `alive` marks
    dead gets (+inf, 0) and no test."""
    R = O.shape[0]
    dev = O.device
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    best_id = torch.zeros((R,), dtype=torch.float32, device=dev)
    live = None if alive is None else torch.nonzero(alive).squeeze(1)
    ot = (O if live is None else O[live]).T
    dt = (D if live is None else D[live]).T
    n = ot.shape[1]
    pk = PK[..., :USED_LANES]
    block = max(128, PLAIN_PAIRS.get(dev.type, 1 << 16) // PK.shape[1])
    for r0 in range(0, n, block):
        rays = slice(r0, min(n, r0 + block))
        o3 = tuple(ot[k, rays][None] for k in range(3))    # [1, n]
        d3 = tuple(dt[k, rays][None] for k in range(3))
        bt = torch.full((o3[0].shape[1],), torch.inf, dtype=torch.float32,
                        device=dev)
        bi = torch.zeros_like(bt)
        for page in pk:

            def col(f, page=page):
                return page[:, f:f + 1]                    # [P, 1]

            t, ok, ids, _, _ = packed_hit_predicate(col, o3, d3)
            tt = torch.where(ok, t, torch.inf)
            gmin = tt.amin(dim=0)
            gid = torch.where(tt == gmin, ids, torch.inf).amin(dim=0)
            upd = (gmin < bt) | ((gmin == bt) & ~torch.isinf(gmin)
                                 & (gid < bi))
            bt = torch.where(upd, gmin, bt)
            bi = torch.where(upd, gid, bi)
        if live is None:
            best_t[rays], best_id[rays] = bt, bi
        else:
            best_t[live[rays]], best_id[live[rays]] = bt, bi
    return best_t, best_id.to(torch.int32)


def nearest_hit(O, D, PK, page_size: int, ray_chunk: int = 1024,
                alive=None):
    """Nearest hit of every ray against every triangle (dense brute force).

    O, D: [R, 3] float32 ray origins and directions (d = 0: a padding ray,
    which never hits); PK: [NP, P, 128] packed pages; alive: optional [R]
    bool, rays marked False are dead: they get (+inf, 0) and cost no test.
    Returns (best_t [R] float32, +inf on a miss; best_id [R] int32, 0 on a
    miss): the lexicographic (t, id) minimum over all triangles, so the
    least t and, on a tie, the least id.  ray_chunk is the TPU kernel's
    block of rays; the winners do not depend on it."""
    dev = O.device
    if dev.type == "cpu":
        return nearest_hit_plain(O, D, PK, ray_chunk, alive)
    native.require(dev.type == "cuda",
                   f"nearest_hit: no kernel for device {dev}")
    R = O.shape[0]
    NP = PK.shape[0]
    native.check_tensor("O", O, dev, (R, 3), torch.float32)
    native.check_tensor("D", D, dev, (R, 3), torch.float32)
    native.check_tensor("PK", PK, dev, (NP, page_size, 128), torch.float32)
    native.require(R < 2 ** 31, f"nearest_hit: {R} rays, at most 2^31 - 1")
    best_t = torch.empty((R,), dtype=torch.float32, device=dev)
    best_id = torch.empty((R,), dtype=torch.int32, device=dev)
    live_list = count = None
    if alive is not None:
        native.check_tensor("alive", alive, dev, (R,), torch.bool)
        # scratch: the indices of the live rays and their count
        live_list = torch.empty((R,), dtype=torch.int32, device=dev)
        count = torch.empty((1,), dtype=torch.int32, device=dev)
    if R:
        native.NEAREST_HIT(O.data_ptr(), D.data_ptr(),
                           0 if alive is None else alive.data_ptr(), R,
                           PK.data_ptr(), page_size, NP, best_t.data_ptr(),
                           best_id.data_ptr(),
                           0 if live_list is None else live_list.data_ptr(),
                           0 if count is None else count.data_ptr(),
                           native.stream(dev))
    return best_t, best_id
