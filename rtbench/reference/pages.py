"""Pages of packed triangle features, their boxes and the per-lane tables.

The benchmark reference's frozen copy of the port's `ops/pages.py`
(`pack_features`, `build_pages`, the numpy `kd_order`) with the
`auto_page_size` of its `engine.py`, the `build_perlane_tables` of its
`ops/intersect_perlane.py` and the `build_streamed_tables` of its
`ops/intersect_streamed.py`.  The winner of a trace, the lexicographic
(t, id) minimum, does not depend on how triangles fall into pages; the
pages decide which pages a ray chunk visits, and the reference visits them
as the program does.
"""

import numpy as np

F32 = np.float32

LANE_N, LANE_S0, LANE_S1, LANE_S2 = 0, 3, 6, 9
LANE_NC, LANE_S0C, LANE_S1C, LANE_S2C = 12, 13, 14, 15
LANE_ID, LANE_ET, LANE_KIND = 16, 17, 18
LANE_COLOR, LANE_ALPHA, LANE_SCAT = 19, 22, 23
PACK_LANES = 128
#: lanes the traces read (24..127 are zero)
USED_LANES = 24

GROUP = 128           # pages per bank
N_INT = 17            # intersect features of the per-lane tables
N_SHD = 7             # shade features
MAX_BANKS = 16
#: page-table slots the resident regime holds
TABLE_SLOT_CAP = 262144
#: the streamed regime's least page size
STREAMED_PAGE_SIZE = 224


def pack_features(tris, indices) -> np.ndarray:
    """Packed feature rows [n, 128] of triangle indices."""
    sel = np.asarray(indices, dtype=np.int64)
    center = tris.incenter[sel]
    norm = tris.norm[sel]
    s = tris.sides[sel] / tris.side_lens[sel][..., None]
    pk = np.zeros((sel.shape[0], PACK_LANES), dtype=F32)
    pk[:, LANE_N:LANE_N + 3] = norm
    pk[:, LANE_S0:LANE_S0 + 3] = s[:, 0]
    pk[:, LANE_S1:LANE_S1 + 3] = s[:, 1]
    pk[:, LANE_S2:LANE_S2 + 3] = s[:, 2]
    pk[:, LANE_NC] = np.einsum("nc,nc->n", norm, center)
    pk[:, LANE_S0C] = np.einsum("nc,nc->n", s[:, 0], center)
    pk[:, LANE_S1C] = np.einsum("nc,nc->n", s[:, 1], center)
    pk[:, LANE_S2C] = np.einsum("nc,nc->n", s[:, 2], center)
    pk[:, LANE_ID] = sel.astype(F32)
    pk[:, LANE_ET] = tris.edge_thickness[sel]
    pk[:, LANE_KIND] = tris.materials.kind[sel].astype(F32)
    pk[:, LANE_COLOR:LANE_COLOR + 3] = tris.materials.color[sel]
    pk[:, LANE_ALPHA] = tris.materials.alpha[sel]
    pk[:, LANE_SCAT] = tris.materials.scattering[sel]
    return pk


def kd_order(tris, page_size: int) -> np.ndarray:
    """Triangle indices 1..N-1 by recursive page-aligned SAH splits of the
    centroids: per node the axis and page-multiple split minimizing
    SA(left)*n_left + SA(right)*n_right in float32, stable sorts, the first
    of equal costs."""
    c = tris.incenter
    out = []

    def rec(ids):
        n = len(ids)
        if n <= page_size:
            out.append(ids)
            return
        cc = c[ids]
        k = -(-n // page_size)
        best = None
        for ax in range(3):
            order = np.argsort(cc[:, ax], kind="stable")
            s = cc[order]
            pmin = np.minimum.accumulate(s, axis=0)
            pmax = np.maximum.accumulate(s, axis=0)
            smin = np.minimum.accumulate(s[::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(s[::-1], axis=0)[::-1]
            for kl in range(1, k):
                nl = kl * page_size
                if nl >= n:
                    break
                el = pmax[nl - 1] - pmin[nl - 1]
                sal = el[0] * el[1] + el[1] * el[2] + el[2] * el[0]
                er = smax[nl] - smin[nl]
                sar = er[0] * er[1] + er[1] * er[2] + er[2] * er[0]
                cost = sal * F32(nl) + sar * F32(n - nl)
                if best is None or cost < best[0]:
                    best = (cost, order, nl)
        _, order, nl = best
        rec(ids[order[:nl]])
        rec(ids[order[nl:]])

    rec(np.arange(1, len(tris), dtype=np.int64))
    return np.concatenate(out)


def build_pages_kd(tris, page_size: int):
    """(PK [NP, P, 128], aabb_lo [NP, 3], aabb_hi [NP, 3]) of the KD-split
    pages; a page's box spans its triangles' corners (+inf/-inf empty)."""
    order = kd_order(tris, page_size)
    n = order.shape[0]
    num_pages = max(1, -(-n // page_size))
    padded = num_pages * page_size
    pk = np.zeros((padded, PACK_LANES), dtype=F32)
    pk[:n] = pack_features(tris, order)
    lo = np.full((padded, 3), np.inf, dtype=F32)
    hi = np.full((padded, 3), -np.inf, dtype=F32)
    corners = tris.corners[order]
    lo[:n] = corners.min(axis=1)
    hi[:n] = corners.max(axis=1)
    lo = lo.reshape(num_pages, page_size, 3).min(axis=1)
    hi = hi.reshape(num_pages, page_size, 3).max(axis=1)
    return (np.ascontiguousarray(pk.reshape(num_pages, page_size,
                                            PACK_LANES)),
            lo.astype(F32), hi.astype(F32))


def auto_page_size(n_tris: int, page_size: int = 56) -> int:
    """The page size the program picks for n_tris triangles: grow the page
    past the 1-bank default only when the scene would need more than 8
    banks of 128 pages (target 7), and as far as needed to stay within
    MAX_BANKS banks."""
    def cdiv(a, b):
        return -(-a // b)

    if cdiv(cdiv(n_tris, page_size), GROUP) > 8:
        page_size = cdiv(cdiv(n_tris, 7 * GROUP), 8) * 8
    while cdiv(n_tris, page_size) > MAX_BANKS * GROUP:
        page_size += 8
    return page_size


def build_perlane_tables(PK, aabb_lo, aabb_hi, max_banks: int = MAX_BANKS):
    """PK [NP, P, 128] as pages-on-lanes tables of NB = ceil(NP/128) banks:
    (PLT_I [NB*17*P, 128], PLT_S [NB*7*P, 128], AB [NB*128, 128]), feature f
    of triangle j of bank-local page p at row b*N*P + f*P + j, column p; AB
    rows b*128.. hold bank b's page boxes (lanes 0..2 lo, 3..5 hi, 6
    page-valid)."""
    NP, P, _ = PK.shape
    NB = -(-NP // GROUP)
    if NB > max_banks:
        raise ValueError(f"{NP} pages: past the resident tables' "
                         f"{max_banks * GROUP}")
    plt_i = np.zeros((NB * N_INT * P, GROUP), np.float32)
    plt_s = np.zeros((NB * N_SHD * P, GROUP), np.float32)
    ab = np.zeros((NB * GROUP, PACK_LANES), np.float32)

    def table(pk_b, lane0, nf):
        t = np.transpose(pk_b[:, :, lane0:lane0 + nf], (2, 1, 0))
        return t.reshape(nf * P, pk_b.shape[0])

    for b in range(NB):
        pk_b = PK[b * GROUP:(b + 1) * GROUP]
        npb = pk_b.shape[0]
        rows = slice(b * GROUP, b * GROUP + npb)
        plt_i[b * N_INT * P:(b + 1) * N_INT * P, :npb] = table(pk_b, 0, N_INT)
        plt_s[b * N_SHD * P:(b + 1) * N_SHD * P, :npb] = \
            table(pk_b, N_INT, N_SHD)
        ab[rows, 0:3] = aabb_lo[rows]
        ab[rows, 3:6] = aabb_hi[rows]
        ab[rows, 6] = 1.0
    return plt_i, plt_s, ab


def build_streamed_tables(PK, aabb_lo, aabb_hi):
    """The streamed regime's tables: (PLT_I [NB, 17*P, 128], PLT_S
    [NB, 7*P, 128], AB [NB*128, 128], BANK_AB [NB8, 128]), the per-lane
    tables of every bank, the page boxes and each bank's box (the union of
    its valid pages' boxes, same lanes), NB8 = NB padded to a multiple of 8
    with zero rows (lane 6 invalid)."""
    NP, P, _ = PK.shape
    NB = -(-NP // GROUP)
    plt_i, plt_s, ab = build_perlane_tables(PK, aabb_lo, aabb_hi,
                                            max_banks=NB)
    bank_ab = np.zeros((-(-NB // 8) * 8, PACK_LANES), np.float32)
    for b in range(NB):
        lo = aabb_lo[b * GROUP:(b + 1) * GROUP]
        hi = aabb_hi[b * GROUP:(b + 1) * GROUP]
        ok = np.isfinite(lo).all(axis=1)
        if not ok.any():
            continue
        bank_ab[b, 0:3] = lo[ok].min(axis=0)
        bank_ab[b, 3:6] = hi[ok].max(axis=0)
        bank_ab[b, 6] = 1.0
    return (plt_i.reshape(NB, N_INT * P, GROUP),
            plt_s.reshape(NB, N_SHD * P, GROUP), ab, bank_ab)
