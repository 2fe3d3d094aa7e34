"""Traces and the shade of one wave, in plain torch.

The benchmark reference's frozen copy of the port's plain versions: the
exact packet cull of `ops/cull.py`, the union trace over each chunk's
sorted page list and the hit predicate of `ops/intersect.py`, the per-lane
bank walk of `ops/intersect_perlane.py` with its shadow feeler, the bank
worklists of `ops/intersect_streamed.py` (the streamed regime's plain B9
and B10) and the shade of `ops/shade.py`.  Only live RNG is carried.  The
blocks are larger than the port's, so that a whole 2560x1440 wave runs in
few steps on a card; the order in which a ray meets banks, pages and
triangles is the port's.
"""

import torch

from .arith import fma, norm2, rsqrt, scatter_rv, shadow_uvs, unit3
from .pages import (GROUP, LANE_ALPHA, LANE_COLOR, LANE_ET, LANE_ID,
                    LANE_KIND, LANE_N, LANE_NC, LANE_S0, LANE_S0C, LANE_S1,
                    LANE_S1C, LANE_S2, LANE_S2C, LANE_SCAT, N_INT, N_SHD,
                    USED_LANES)

BIG = 1e30
KIND_MATTE, KIND_REFLECTIVE = 1, 2
SKY = (128.0 / 255.0, 180.0 / 255.0, 255.0 / 255.0)

# state rows
ROW_W, ROW_ALIVE, ROW_ACC, ROW_DEAD, STATE_ROWS = 6, 7, 8, 11, 16
# winner rows
ROW_T, ROW_ID, ROW_NORM, ROW_ENC, ROW_COLOR, ROW_ALPHA, ROW_SCAT = \
    0, 1, 2, 5, 6, 9, 10
PAYLOAD_ROWS = (ROW_NORM, ROW_NORM + 1, ROW_NORM + 2, ROW_ENC, ROW_COLOR,
                ROW_COLOR + 1, ROW_COLOR + 2, ROW_ALPHA, ROW_SCAT)
#: |d . nf| per reflected component k: fma(d2, nf2, fma(d_i, nf_i, d_j*nf_j))
REFLECT_DOT = ((1, 0), (0, 1), (0, 1))

#: (chunk x page) pairs of one cull block, (ray x slot) pairs of one union
#: trace step, rays of one per-lane block and of one streamed block (a step
#: of the streamed walk gathers 24 * P table floats a ray: 21.5 KB at P = 224)
CULL_PAIRS = 1 << 25
UNION_PAIRS = 1 << 26
PERLANE_RAYS = 1 << 17
STREAMED_RAYS = 1 << 19


def slab_inv(d):
    return torch.where(d != 0.0, torch.reciprocal(d),
                       torch.where(d >= 0.0, BIG, -BIG))


def slab(lo, hi, o, inv):
    tlo = thi = None
    for k in range(3):
        t1 = (lo[k] - o[k]) * inv[k]
        t2 = (hi[k] - o[k]) * inv[k]
        alo, ahi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tlo = alo if tlo is None else torch.maximum(tlo, alo)
        thi = ahi if thi is None else torch.minimum(thi, ahi)
    return tlo, thi


def cull(ot, dt, valid, blo, bhi, ray_chunk: int):
    """Per (chunk, page): whether a valid ray of the chunk hits the page's
    box, and the least max(tlo, 0) of those rays (+inf elsewhere); a -0
    entry is +0."""
    RB = ray_chunk
    NC = ot.shape[1] // RB
    NP = blo.shape[0]
    mask = torch.empty((NC, NP), dtype=torch.bool, device=ot.device)
    emin = torch.empty((NC, NP), dtype=torch.float32, device=ot.device)
    step = max(1, CULL_PAIRS // (RB * NP))
    lo = [blo[:, k][None, :, None] for k in range(3)]
    hi = [bhi[:, k][None, :, None] for k in range(3)]
    for c0 in range(0, NC, step):
        c1 = min(NC, c0 + step)
        rays = slice(c0 * RB, c1 * RB)
        o = [ot[k, rays].reshape(c1 - c0, 1, RB) for k in range(3)]
        inv = [slab_inv(dt[k, rays]).reshape(c1 - c0, 1, RB)
               for k in range(3)]
        v = valid[rays].reshape(c1 - c0, 1, RB)
        tlo, thi = slab(lo, hi, o, inv)
        hit = (tlo <= thi) & (thi >= 0.0) & v
        entry = torch.where(hit, torch.clamp(tlo, min=0.0), torch.inf)
        mask[c0:c1] = hit.any(dim=2)
        emin[c0:c1] = entry.amin(dim=2)
    emin = torch.where(emin == 0.0, 0.0, emin)
    return mask, torch.where(mask, emin, torch.inf)


def page_lists(mask, tmin):
    """Each chunk's hit pages nearest entry first (a stable sort)."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    ptmin, plist = torch.sort(tmin, dim=1, stable=True)
    return counts, plist, ptmin


def hit_predicate(col, o3, d3, excl=None, zero_origin: bool = False):
    """(t, ok, ids, md_n, dv) of packed triangles against rays, the
    multiply-adds fused where XLA-CPU fuses them."""
    o0, o1, o2 = o3
    d0, d1, d2 = d3

    def dot3(f, r0, r1, r2):
        return fma(col(f + 2), r2, fma(col(f), r0, col(f + 1) * r1))

    md_n = dot3(LANE_N, d0, d1, d2)
    planes = ((LANE_S0, LANE_S0C), (LANE_S1, LANE_S1C), (LANE_S2, LANE_S2C))
    if zero_origin:
        t = col(LANE_NC) / md_n
        dv = tuple(fma(t, dot3(s, d0, d1, d2), -col(c)) for s, c in planes)
    else:
        t = (col(LANE_NC) - dot3(LANE_N, o0, o1, o2)) / md_n
        dv = tuple(fma(t, dot3(s, d0, d1, d2), dot3(s, o0, o1, o2)) - col(c)
                   for s, c in planes)
    ok = (t >= 0.0) & (dv[0] <= 1.0) & (dv[1] <= 1.0) & (dv[2] <= 1.0)
    if excl is not None:
        ok = ok & (col(LANE_ID) != excl)
    return t, ok, col(LANE_ID), md_n, dv


def payload_features(col, md_n, dv):
    inv_et = 1.0 - col(LANE_ET)
    edge = (dv[0] > inv_et) | (dv[1] > inv_et) | (dv[2] > inv_et)
    enc = col(LANE_KIND) + 4.0 * edge.float() + 8.0 * (md_n > 0.0).float()
    return (col(LANE_N), col(LANE_N + 1), col(LANE_N + 2), enc,
            col(LANE_COLOR), col(LANE_COLOR + 1), col(LANE_COLOR + 2),
            col(LANE_ALPHA), col(LANE_SCAT))


def lex_update(tt, ids, best_t, best_id, dim: int):
    """The (t, id) minimum of candidates over `dim` and whether it beats
    the running winner."""
    gmin = tt.amin(dim=dim, keepdim=True)
    gid = torch.where(tt == gmin, ids, torch.inf).amin(dim=dim, keepdim=True)
    onehot = (tt == gmin) & (ids == gid)
    gmin, gid = gmin.squeeze(dim), gid.squeeze(dim)
    upd = (gmin < best_t) | ((gmin == best_t) & ~torch.isinf(gmin)
                             & (gid < best_id))
    return upd, gmin, gid, onehot


def fold_pages_origin(PK, origin):
    """PK with the shared origin folded into the plane and half-plane
    offsets, for rays anchored at it (zero_origin)."""
    o = [float(x) for x in origin]
    out = PK.clone()
    for lane_c, lane_v in ((LANE_NC, LANE_N), (LANE_S0C, LANE_S0),
                           (LANE_S1C, LANE_S1), (LANE_S2C, LANE_S2)):
        adj = fma(PK[..., lane_v + 2], o[2],
                  fma(PK[..., lane_v], o[0], PK[..., lane_v + 1] * o[1]))
        out[..., lane_c] = PK[..., lane_c] - adj
    return out


def trace_chunks(ot, dt, PK, counts, plist, ptmin, ray_chunk: int,
                 zero_origin: bool = False, excl=None):
    """Winner rows [16, R] of the union trace: each chunk walks its page
    list, and stops once every ray's winner lies before the next page's
    entry."""
    RB = ray_chunk
    R = ot.shape[1]
    NC = R // RB
    rows = torch.zeros((16, R), dtype=torch.float32, device=ot.device)
    step = max(1, UNION_PAIRS // (RB * PK.shape[1]))
    for c0 in range(0, NC, step):
        c1 = min(NC, c0 + step)
        rays = slice(c0 * RB, c1 * RB)
        rows[:, rays] = _trace_chunk_block(
            ot[:, rays], dt[:, rays], PK, counts[c0:c1], plist[c0:c1],
            ptmin[c0:c1], RB, zero_origin,
            None if excl is None else excl[rays])
    return rows


def _trace_chunk_block(ot, dt, PK, counts, plist, ptmin, RB: int,
                       zero_origin: bool, excl):
    R = ot.shape[1]
    NC = R // RB
    dev = ot.device
    o = ot.reshape(3, NC, 1, RB)
    d = dt.reshape(3, NC, 1, RB)
    ex = None if excl is None else excl.reshape(NC, 1, RB)
    valid = ((d[0] != 0.0) | (d[1] != 0.0) | (d[2] != 0.0))[:, 0]
    best_t = torch.where(valid, torch.inf, -torch.inf)
    best_id = torch.zeros((NC, RB), dtype=torch.float32, device=dev)
    payload = torch.zeros((len(PAYLOAD_ROWS), NC, RB), dtype=torch.float32,
                          device=dev)
    done = torch.zeros(NC, dtype=torch.bool, device=dev)
    pk = PK[..., :USED_LANES]
    n_max = int(counts.max()) if NC else 0
    for k in range(n_max):
        c = torch.nonzero((counts > k) & ~done).squeeze(1)
        if c.numel() == 0:
            break
        page = pk[plist[c, k].long()]

        def col(f, page=page):
            return page[:, :, f:f + 1]

        t, ok, ids, md_n, dv = hit_predicate(
            col, (o[0, c], o[1, c], o[2, c]), (d[0, c], d[1, c], d[2, c]),
            None if ex is None else ex[c], zero_origin)
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
    return winner_rows(best_t.reshape(R), best_id.reshape(R),
                       payload.reshape(len(PAYLOAD_ROWS), R))


def winner_rows(best_t, best_id, payload):
    rows = torch.zeros((16, best_t.shape[0]), dtype=torch.float32,
                       device=best_t.device)
    rows[ROW_T] = best_t
    rows[ROW_ID] = best_id
    for i, r in enumerate(PAYLOAD_ROWS):
        rows[r] = payload[i]
    return rows


def shade_state_rows(st, rows, rv, weight_cutoff: float, shd=None):
    """One wave's shade, scatter and state update from the winner rows:
    terminal and scatter contributions, the matte and reflected
    directions, the new origin, retirement by the weight cutoff."""
    v, inv_v = rv
    weight = st[ROW_W]
    valid = st[ROW_ALIVE] != 0.0
    o = (st[0], st[1], st[2])
    d = (st[3], st[4], st[5])
    t = rows[ROW_T]
    miss = rows[ROW_ID] == 0.0
    n = (rows[ROW_NORM], rows[ROW_NORM + 1], rows[ROW_NORM + 2])
    enc = rows[ROW_ENC]
    back = enc >= 8.0
    e2 = enc - torch.where(back, 8.0, 0.0)
    edge = e2 >= 4.0
    kind = e2 - torch.where(edge, 4.0, 0.0)
    col = (rows[ROW_COLOR], rows[ROW_COLOR + 1], rows[ROW_COLOR + 2])
    if shd is not None:
        col = tuple(torch.where(shd != 0.0, 0.0, c) for c in col)
    alpha = rows[ROW_ALPHA]
    scat = rows[ROW_SCAT]
    nf = tuple(torch.where(back, -nk, nk) for nk in n)
    is_scatter = (~miss) & (~edge) & ((kind == KIND_MATTE)
                                      | (kind == KIND_REFLECTIVE))
    is_terminal = valid & ~is_scatter
    scatter_live = valid & is_scatter
    one_m_a = 1.0 - alpha
    contrib = []
    for c, sky in zip(col, SKY):
        tc = torch.where(miss, sky, torch.where(edge, 0.0, c))
        contrib.append(torch.where(is_terminal, weight * tc, 0.0)
                       + torch.where(scatter_live, weight * c * one_m_a, 0.0))
    new_w = torch.where(scatter_live, weight * alpha, weight)
    p = [fma(t, dk, ok) for dk, ok in zip(d, o)]
    rvs = [vk * inv_v for vk in v]
    m = unit3(*(fma(vk, inv_v, nk) for vk, nk in zip(v, nf)))
    rx = []
    for k in range(3):
        i, j = REFLECT_DOT[k]
        ddot = torch.abs(fma(d[2], nf[2], fma(d[i], nf[i], d[j] * nf[j])))
        rx.append(fma(rvs[k], scat, fma(2.0 * nf[k], ddot, d[k])))
    r = unit3(*rx)
    is_matte = kind == KIND_MATTE
    nd = [torch.where(is_matte, mk, rk) for mk, rk in zip(m, r)]
    no = [fma(torch.where(is_matte, rvk, rk), 0.001, pk)
          for rvk, rk, pk in zip(rvs, r, p)]
    alive2 = scatter_live
    if weight_cutoff > 0.0:
        alive2 = alive2 & (new_w > weight_cutoff)
    died = valid & ~alive2
    out = torch.empty((STATE_ROWS,) + weight.shape, dtype=st.dtype,
                      device=st.device)
    for k, (new, old) in enumerate(zip(no + nd, o + d)):
        out[k] = torch.where(alive2, new, old)
    out[ROW_W] = new_w
    out[ROW_ALIVE] = alive2.to(st.dtype)
    for k in range(3):
        out[ROW_ACC + k] = st[ROW_ACC + k] + contrib[k]
    out[ROW_DEAD] = torch.maximum(st[ROW_DEAD], died.to(st.dtype))
    out[ROW_DEAD + 1:] = st[ROW_DEAD + 1:]
    return out


def shade(state, rows, seed, ray_chunk: int, weight_cutoff: float,
          chunk_live, shd=None):
    """The shade after an unfused trace; chunks flagged 0 pass through."""
    rays = torch.arange(state.shape[1], device=state.device)
    new = shade_state_rows(state, rows, scatter_rv(seed, rays, ray_chunk),
                           weight_cutoff, shd)
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    return torch.where(live[None], new, state)


def bank_pass(views, bank, rays, o, d, inv, win, excl=None,
              any_hit: bool = False):
    """One bank's per-lane walk for the rays at `rays`, in place on the
    winner: each ray slab-tests the bank's pages, tests its nearest
    remaining page (ties to the lower index) and drops the pages entered
    beyond its winner; any_hit: the lowest page first, a ray stops at its
    first page with a hit.  bank: an int, or in the streamed regime a
    tensor holding each ray's bank."""
    if rays.numel() == 0:
        return
    tab_i, tab_s, boxes = views
    best_t, best_id, payload = win
    per_ray = not isinstance(bank, int)
    box = boxes[bank].transpose(0, 1) if per_ray else boxes[bank][:, None]
    tlo, thi = slab([box[..., k] for k in range(3)],
                    [box[..., k + 3] for k in range(3)],
                    [o[k, rays][None] for k in range(3)],
                    [inv[k, rays][None] for k in range(3)])
    hit = (tlo <= thi) & (thi >= 0.0) & (box[..., 6] != 0.0)
    if any_hit:
        hit &= (best_id[rays] == 0.0)[None]
    pages = torch.arange(GROUP, dtype=torch.float32, device=o.device)[:, None]
    while True:
        if any_hit:
            cols = torch.nonzero(hit.any(dim=0)).squeeze(1)
            if cols.numel() == 0:
                break
            pidx = torch.where(hit[:, cols], pages,
                               float(GROUP)).amin(dim=0).long()
        else:
            hit &= tlo <= best_t[rays][None]
            tkey = torch.where(hit, tlo, torch.inf)
            kmin = tkey.amin(dim=0)
            cols = torch.nonzero(kmin < torch.inf).squeeze(1)
            if cols.numel() == 0:
                break
            pidx = torch.where(tkey[:, cols] == kmin[cols], pages,
                               float(GROUP)).amin(dim=0).long()
        lanes = rays[cols]
        if per_ray:
            gi = tab_i[bank[cols], :, :, pidx].permute(1, 2, 0)
            gs = tab_s[bank[cols], :, :, pidx].permute(1, 2, 0)
        else:
            gi = tab_i[bank][:, :, pidx]
            gs = tab_s[bank][:, :, pidx]

        def col(f, gi=gi, gs=gs):
            return gi[f] if f < N_INT else gs[f - N_INT]

        t, ok, ids, md_n, dv = hit_predicate(
            col, tuple(o[k, lanes][None] for k in range(3)),
            tuple(d[k, lanes][None] for k in range(3)),
            None if excl is None else excl[lanes][None])
        tt = torch.where(ok, t, torch.inf)
        bt, bi = best_t[lanes], best_id[lanes]
        upd, gmin, gid, onehot = lex_update(tt, ids, bt, bi, dim=0)
        if not any_hit:
            w = onehot.float()
            for i, v in enumerate(payload_features(col, md_n, dv)):
                payload[i, lanes] = torch.where(upd, (w * v).sum(dim=0),
                                                payload[i, lanes])
        best_t[lanes] = torch.where(upd, gmin, bt)
        best_id[lanes] = torch.where(upd, gid, bi)
        hit[pidx, cols] = False
        if any_hit:
            hit[:, cols[best_id[lanes] != 0.0]] = False


def bank_views(tables, P: int):
    plt_i, plt_s, ab = tables
    NB = ab.shape[0] // GROUP
    return (plt_i.reshape(NB, N_INT, P, GROUP),
            plt_s.reshape(NB, N_SHD, P, GROUP),
            ab.reshape(NB, GROUP, ab.shape[1])[..., :7])


def winner_init(valid):
    return (torch.where(valid, torch.inf, -torch.inf),
            torch.zeros(valid.shape[0], dtype=torch.float32,
                        device=valid.device),
            torch.zeros((len(PAYLOAD_ROWS), valid.shape[0]),
                        dtype=torch.float32, device=valid.device))


def trace_perlane(o, d, alive, tables, P: int, excl=None,
                  any_hit: bool = False):
    """Winner rows [16, n] of the per-lane walk over every bank in index
    order (any_hit: only ROW_ID != 0 means anything, payload rows 0)."""
    valid = alive != 0.0
    win = winner_init(valid)
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    views = bank_views(tables, P)
    rays = torch.nonzero(valid).squeeze(1)
    for b in range(views[0].shape[0]):
        bank_pass(views, b, rays, o, d, inv, win, excl, any_hit)
    return winner_rows(*win)


def shadow_feeler(st, rows, seed, rays, ray_chunk: int, light, tables,
                  P: int):
    """The bounce waves' fused shadow test: from each hit a ray to a
    jittered point of the light, any-hit over the resident tables with the
    ray's own triangle excluded.  Returns the [n] float32 mask."""
    hitm = (st[ROW_ALIVE] != 0.0) & (rows[ROW_ID] != 0.0)
    tm = torch.where(hitm, rows[ROW_T], 0.0)
    p = [fma(tm, st[3 + k], st[k]) for k in range(3)]
    back = rows[ROW_ENC] >= 8.0
    nf = [torch.where(back, -rows[ROW_NORM + k], rows[ROW_NORM + k])
          for k in range(3)]
    u3, u1 = shadow_uvs(seed, rays, ray_chunk)
    lx, ly, lz, l2 = (float(x) for x in light)
    a = [fma(u3[k], l2, lk) - p[k] for k, lk in enumerate((lx, ly, lz))]
    inv = rsqrt(norm2(*a))
    off = 0.005 * (u1 + 1.0)
    so = torch.stack([torch.where(hitm, fma(nf[k], off, p[k]), 0.0)
                      for k in range(3)])
    sd = torch.stack([torch.where(hitm, a[k] * inv, 0.0) for k in range(3)])
    excl = torch.where(hitm, rows[ROW_ID], 0.0)
    srows = trace_perlane(so, sd, hitm.float(), tables, P, excl=excl,
                          any_hit=True)
    return (hitm & (srows[ROW_ID] != 0.0)).float()


def trace_shade_perlane(state, tables, seed, P: int, ray_chunk: int,
                        weight_cutoff: float, chunk_live, light=None):
    """One bounce wave: the per-lane trace, the shadow feeler where lit,
    the shade; chunks flagged 0 pass through."""
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    for i in range(0, rays.numel(), PERLANE_RAYS):
        idx = rays[i:i + PERLANE_RAYS]
        st = state[:, idx]
        rows = trace_perlane(st[0:3], st[3:6], st[ROW_ALIVE], tables, P)
        shd = None
        if light is not None:
            shd = shadow_feeler(st, rows, seed, idx, ray_chunk, light,
                                tables, P)
        rv = scatter_rv(seed, idx, ray_chunk)
        out[:, idx] = shade_state_rows(st, rows, rv, weight_cutoff, shd)
    return out


def _streamed_block(o, d, valid, views, bank_ab, excl, any_hit: bool):
    """The bank worklists of one block of rays: each ray walks the banks
    whose box it enters, the nearest remaining first (ties to the lower
    index), skips a bank entered beyond its winner (any_hit: stops at its
    first hit), and runs the per-lane walk inside.  Returns the winner."""
    win = winner_init(valid)
    best_t, best_id, _ = win
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    NB = views[0].shape[0]
    bb = bank_ab[:NB]
    btlo, bthi = slab([bb[:, k:k + 1] for k in range(3)],
                      [bb[:, k + 3:k + 4] for k in range(3)],
                      [o[k][None] for k in range(3)],
                      [inv[k][None] for k in range(3)])
    todo = ((btlo <= bthi) & (bthi >= 0.0) & (bb[:, 6:7] != 0.0)
            & valid[None])
    banks = torch.arange(NB, dtype=torch.float32, device=o.device)[:, None]
    while True:
        cand = todo & (btlo <= best_t[None])
        if any_hit:
            cand &= (best_id == 0.0)[None]
        tkey = torch.where(cand, btlo, torch.inf)
        kmin = tkey.amin(dim=0)
        rays = torch.nonzero(kmin < torch.inf).squeeze(1)
        if rays.numel() == 0:
            return win
        bsel = torch.where(tkey[:, rays] == kmin[rays], banks,
                           float(NB)).amin(dim=0).long()
        todo[bsel, rays] = False
        bank_pass(views, bsel, rays, o, d, inv, win, excl, any_hit)


def trace_streamed(ot, dt, alive, tables, P: int, ray_chunk: int = 0,
                   chunk_live=None, excl=None, any_hit: bool = False):
    """Winner rows [16, n] of the streamed trace (the plain B10) over the
    streamed tables (plt_i, plt_s, ab, bank_ab); chunks flagged 0 in
    chunk_live get all-zero rows (any_hit: only ROW_ID != 0 means
    anything, payload rows 0)."""
    n = ot.shape[1]
    valid = alive != 0.0
    if chunk_live is not None:
        live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
        valid = valid & live
    views = bank_views(tables[:3], P)
    rows = torch.empty((16, n), dtype=torch.float32, device=ot.device)
    for i in range(0, n, STREAMED_RAYS):
        sl = slice(i, min(n, i + STREAMED_RAYS))
        rows[:, sl] = winner_rows(*_streamed_block(
            ot[:, sl], dt[:, sl], valid[sl], views, tables[3],
            None if excl is None else excl[sl], any_hit))
    if any_hit:
        rows[ROW_ID + 1:] = 0.0
    if chunk_live is not None:
        rows = torch.where(live[None], rows, 0.0)
    return rows


def trace_shade_streamed(state, tables, seed, P: int, ray_chunk: int,
                         weight_cutoff: float, chunk_live):
    """One unlit wave of the streamed regime (the plain B9): the trace of
    the live chunks' rays and the shade; chunks flagged 0 pass through."""
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    st = state[:, rays]
    rows = trace_streamed(st[0:3], st[3:6], st[ROW_ALIVE], tables, P)
    rv = scatter_rv(seed, rays, ray_chunk)
    out[:, rays] = shade_state_rows(st, rows, rv, weight_cutoff)
    return out
