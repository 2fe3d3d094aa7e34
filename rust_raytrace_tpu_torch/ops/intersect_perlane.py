"""B4: per-lane (per-ray) page traversal fused with the shade — bounce waves.

Counterparts in `rust_raytrace_tpu/ops/intersect_perlane.py`:
`build_perlane_tables` (copied: the JAX module imports jax),
`trace_shade_perlane_pallas` (inner `_kernel_fused`, `_trace_chunk`,
`_group`), with its fused shadow feeler (`light=`), and B7
`trace_perlane_pallas` (inner `_kernel`), the trace alone to winner rows,
nearest or any-hit.  `trace_shade_perlane` and `trace_perlane` run the CUDA
kernels `csrc/trace_shade_perlane.cu` and `csrc/trace_perlane.cu` on CUDA
tensors and `trace_shade_perlane_plain` and `trace_perlane_plain` on CPU
tensors.  Both kernels read the same triangles page-major
(`PerlaneTables`: the records, page boxes and group boxes built on the
device beside the per-lane tables, which the plain versions and the CPU
tests read).

Each ray slab-tests the page AABBs of one bank (<= 128 pages) at a time,
tests its nearest remaining page (ties to the lower page index), then drops
every page whose entry lies beyond its best hit; the cut carries across
banks.  That is the visit order of the TPU kernel's one-page-per-step loop,
to which its two-pages-per-step form is equal.  The in-bank loop,
`bank_pass`, is also the streamed regime's (ops/intersect_streamed.py);
the CUDA walks keep its order (csrc/perlane.cuh).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils import native, xla_rsqrt
from .cull import slab, slab_inv
from .pages import LANE_SCAT, PACK_LANES, PageTables
from .intersect import (PAYLOAD_ROWS, lex_update, packed_hit_predicate,
                        payload_features)
from .shade import (fma, norm2, rsqrt, scatter_rv, shade_state_rows,
                    shadow_uvs)
from .state import (ROW_ALIVE, ROW_ENC, ROW_ID, ROW_NORM, ROW_T, STATE_ROWS,
                    TRACE_ROWS)

GROUP = 128           # pages per bank
N_INT = 17            # intersect features: n(3) s0..s2(9) nc(1) s*c(3) id(1)
N_SHD = 7             # shade features: et kind color(3) alpha scat
MAX_BANKS = 16

#: rays a plain-version block holds (its gathered tables are 17*P per ray)
_PLAIN_RAYS = 8192


def build_perlane_tables(pages: PageTables, max_banks: int = MAX_BANKS):
    """Rearrange PK [NP, P, 128] into pages-on-lanes tables.

    Pages are grouped into NB = ceil(NP/128) banks of <= 128 pages, at most
    max_banks of them (the resident traversal's cap; the streamed regime
    lifts it).  Returns numpy (PLT_I [NB*N_INT*P, 128], PLT_S [NB*N_SHD*P,
    128], AB [NB*128, 128]): feature f of triangle j of bank-local page p
    sits at row b*N*P + f*P + j, column p; AB rows b*128..b*128+127 hold
    bank b's page AABBs (lanes 0..2 lo, 3..5 hi, 6 page-valid).
    """
    PK = pages.PK
    NP, P, _ = PK.shape
    NB = -(-NP // GROUP)
    assert NB <= max_banks, \
        f"per-lane traversal caps at {max_banks * GROUP} pages, got {NP}"

    plt_i = np.zeros((NB * N_INT * P, GROUP), np.float32)
    plt_s = np.zeros((NB * N_SHD * P, GROUP), np.float32)
    ab = np.zeros((NB * GROUP, PACK_LANES), np.float32)

    def table(pk_b, lane0, nf):
        npb = pk_b.shape[0]
        t = np.transpose(pk_b[:, :, lane0:lane0 + nf], (2, 1, 0))
        return t.reshape(nf * P, npb)

    for b in range(NB):
        pk_b = PK[b * GROUP:(b + 1) * GROUP]
        npb = pk_b.shape[0]
        plt_i[b * N_INT * P:(b + 1) * N_INT * P, :npb] = table(pk_b, 0, N_INT)
        plt_s[b * N_SHD * P:(b + 1) * N_SHD * P, :npb] = \
            table(pk_b, N_INT, N_SHD)
        ab[b * GROUP:b * GROUP + npb, 0:3] = \
            pages.aabb_lo[b * GROUP:b * GROUP + npb]
        ab[b * GROUP:b * GROUP + npb, 3:6] = \
            pages.aabb_hi[b * GROUP:b * GROUP + npb]
        ab[b * GROUP:b * GROUP + npb, 6] = 1.0
    return plt_i, plt_s, ab


def upload_perlane_tables(pages: PageTables, device):
    """`build_perlane_tables` as float32 tensors on `device`."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in build_perlane_tables(pages))


#: floats of a triangle's page-major record (the packed lanes 0..23) and of
#: a page's AABB there (lanes 0..2 lo, 3..5 hi, 6 valid, 7 zero)
REC_LANES = LANE_SCAT + 1
PAB_LANES = 8


def page_records(plt_i, plt_s, ab):
    """The page-major records of per-lane tables of either layout
    ([NB*17P, 128] or [NB, 17P, 128]), on their device: rec [NB*128, P,
    24], where rec[b*128 + p, j] holds the packed lanes 0..23 of triangle j
    of bank b's page p (features 0..16 from plt_i, 17..23 from plt_s; a
    padding page is zero), and pab [NB*128, 8], each page's AABB row of
    `ab` cut to 8 lanes.  32-bit word copies: -0 and NaN bits survive."""
    NB = ab.shape[0] // GROUP
    P = plt_i.numel() // (NB * N_INT * GROUP)
    wi = plt_i.view(torch.int32).reshape(NB, N_INT, P, GROUP)
    ws = plt_s.view(torch.int32).reshape(NB, N_SHD, P, GROUP)
    rec = torch.cat([wi, ws], dim=1).permute(0, 3, 2, 1).reshape(
        NB * GROUP, P, REC_LANES)
    pab = ab.view(torch.int32)[:, :PAB_LANES]
    return (rec.contiguous().view(torch.float32),
            pab.contiguous().view(torch.float32))


#: pages a group box holds (consecutive pages of one bank)
PAGES_A_BOX = 8


def group_boxes(pab):
    """The group boxes of the page boxes pab [NB*128, 8] (lanes 0..2 lo,
    3..5 hi, 6 valid), on their device: [NB*128 / PAGES_A_BOX, 8], box g
    the exact float minimum of the lo lanes and maximum of the hi lanes of
    pages g * PAGES_A_BOX ... over the valid ones (a NaN bound counts as
    unbounded), lane 6 1.0 when one is valid (else lo +inf, hi -inf and
    lane 6 0), lane 7 0.  Slab arithmetic is monotone in the bounds under
    round to nearest, so a page (lo <= hi, as every page of the tables)
    whose slab test passes passes its group box's: B9's group walk and
    B7's walk skip the pages of a group that fails
    (tests/test_torch_streamed_walk.py holds it on -0, NaN and padding
    bounds)."""
    g = pab.reshape(-1, PAGES_A_BOX, PAB_LANES)
    valid = (g[..., 6] != 0.0)[..., None]
    inf = torch.tensor(torch.inf, dtype=pab.dtype, device=pab.device)
    lo, hi = g[..., 0:3], g[..., 3:6]
    lo = torch.where(valid, torch.where(torch.isnan(lo), -inf, lo), inf)
    hi = torch.where(valid, torch.where(torch.isnan(hi), inf, hi), -inf)
    out = torch.zeros((g.shape[0], PAB_LANES), dtype=pab.dtype,
                      device=pab.device)
    out[:, 0:3] = lo.amin(dim=1)
    out[:, 3:6] = hi.amax(dim=1)
    out[:, 6] = valid[:, :, 0].any(dim=1).to(pab.dtype)
    return out


class PerlaneTables(NamedTuple):
    """The resident regime's tables on one device, in both layouts.

    plt_i, plt_s, ab: `upload_perlane_tables` (pages on lanes, the JAX
    package's layout, which the plain versions read); rec [NB*128, P, 24]
    and pab [NB*128, 8]: `page_records` of them (page-major, the layout
    B4's and B7's kernels read); extent [NB] int32: each bank's last valid
    page + 1 (B4's walk slab-tests no page past it); gab [NB*128 /
    PAGES_A_BOX, 8]: `group_boxes(pab)`, B7's first level of page
    culling."""
    plt_i: torch.Tensor
    plt_s: torch.Tensor
    ab: torch.Tensor
    rec: torch.Tensor
    pab: torch.Tensor
    extent: torch.Tensor
    gab: torch.Tensor


def perlane_tables(plt_i, plt_s, ab) -> PerlaneTables:
    """The per-lane tables with their page-major records, bank extents and
    group boxes, built on their device."""
    valid = ab.reshape(-1, GROUP, ab.shape[-1])[..., 6] != 0.0
    pages = torch.arange(1, GROUP + 1, dtype=torch.int32, device=ab.device)
    extent = torch.where(valid, pages, 0).amax(dim=1).to(torch.int32)
    rec, pab = page_records(plt_i, plt_s, ab)
    return PerlaneTables(plt_i, plt_s, ab, rec, pab, extent,
                         group_boxes(pab))


def bank_views(plt_i, plt_s, ab, P: int):
    """The per-lane tables (either layout: [NB*17P, 128] or [NB, 17P, 128])
    as [NB, 17, P, 128] and [NB, 7, P, 128] views, and the page boxes as
    [NB, 128, 7] (lanes 0..2 lo, 3..5 hi, 6 page-valid)."""
    NB = ab.shape[0] // GROUP
    return (plt_i.reshape(NB, N_INT, P, GROUP),
            plt_s.reshape(NB, N_SHD, P, GROUP),
            ab.reshape(NB, GROUP, PACK_LANES)[..., :7])


def winner_init(valid):
    """(best_t, best_id, payload [9, n]) of rays with no hit yet: invalid
    rays start at -inf, so that no page is ever entered for them."""
    n = valid.shape[0]
    return (torch.where(valid, torch.inf, -torch.inf),
            torch.zeros(n, dtype=torch.float32, device=valid.device),
            torch.zeros((len(PAYLOAD_ROWS), n), dtype=torch.float32,
                        device=valid.device))


def winner_rows(best_t, best_id, payload):
    """[16, n] winner rows (ROW_* layout) of a winner; rows 11..15 are 0."""
    rows = torch.zeros((TRACE_ROWS, best_t.shape[0]), dtype=torch.float32,
                       device=best_t.device)
    rows[ROW_T] = best_t
    rows[ROW_ID] = best_id
    for i, r in enumerate(PAYLOAD_ROWS):
        rows[r] = payload[i]
    return rows


def bank_pass(views, bank, rays, o, d, inv, win, excl=None,
              any_hit: bool = False):
    """One bank's per-lane traversal (JAX: `_group`) for the rays at index
    `rays` of o/d/inv [3, n], in place on win = winner_init's triple, or
    the triple and an [n] int32 tensor of winner slots (page * P +
    triangle, the page counted over all banks), which B12's sweep keeps.

    views: bank_views; bank: the bank (an int, or a tensor holding each
    ray's).  Each ray slab-tests the bank's pages, then tests its nearest
    remaining page (ties to the lower index) and drops the pages entered
    beyond its best hit, until none is left; any_hit: the lowest page
    first, and a ray stops at its first page with a hit."""
    if rays.numel() == 0:
        return
    tab_i, tab_s, boxes = views
    best_t, best_id, payload = win[:3]
    slot = win[3] if len(win) > 3 else None
    P = tab_i.shape[2]
    box = boxes[bank]
    box = box[:, None] if box.dim() == 2 else box.transpose(0, 1)
    tlo, thi = slab([box[..., k] for k in range(3)],
                    [box[..., k + 3] for k in range(3)],
                    [o[k, rays][None] for k in range(3)],
                    [inv[k, rays][None] for k in range(3)])  # [128, m]
    hit = (tlo <= thi) & (thi >= 0.0) & (box[..., 6] != 0.0)
    if any_hit:
        hit &= (best_id[rays] == 0.0)[None]
    pages = torch.arange(GROUP, dtype=torch.float32, device=o.device)[:, None]
    while True:
        if any_hit:
            # occlusion: any order works; the lowest page index first
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
        if isinstance(bank, int):
            gi = tab_i[bank][:, :, pidx]                 # [17, P, m]
            gs = tab_s[bank][:, :, pidx]                 # [7, P, m]
        else:
            gi = tab_i[bank[cols], :, :, pidx].permute(1, 2, 0)
            gs = tab_s[bank[cols], :, :, pidx].permute(1, 2, 0)

        def col(f, gi=gi, gs=gs):
            return gi[f] if f < N_INT else gs[f - N_INT]

        o3 = tuple(o[k, lanes][None] for k in range(3))
        d3 = tuple(d[k, lanes][None] for k in range(3))
        t, ok, ids, md_n, dv = packed_hit_predicate(
            col, o3, d3, excl=None if excl is None else excl[lanes][None])
        tt = torch.where(ok, t, torch.inf)
        bt, bi = best_t[lanes], best_id[lanes]
        upd, gmin, gid, onehot = lex_update(tt, ids, bt, bi, dim=0)
        w = onehot.float()
        for i, v in enumerate(payload_features(col, md_n, dv)):
            payload[i, lanes] = torch.where(upd, (w * v).sum(dim=0),
                                            payload[i, lanes])
        if slot is not None:
            b = bank if isinstance(bank, int) else bank[cols]
            j = onehot.to(torch.int32).argmax(dim=0)
            slot[lanes] = torch.where(
                upd, ((b * GROUP + pidx) * P + j).to(torch.int32),
                slot[lanes])
        best_t[lanes] = torch.where(upd, gmin, bt)
        best_id[lanes] = torch.where(upd, gid, bi)
        hit[pidx, cols] = False
        if any_hit:
            hit[:, cols[best_id[lanes] != 0.0]] = False


def trace_perlane_plain(o, d, alive, plt_i, plt_s, ab, P: int, excl=None,
                        any_hit: bool = False, ray_chunk: int = 0,
                        chunk_live=None):
    """Winner rows [16, n] (ROW_* layout) of rays o/d [3, n] with alive [n]:
    the per-lane trace alone, plain torch (JAX: trace_perlane_pallas), banks
    in index order.

    excl: optional [n] triangle id each ray may not hit (0: none).
    any_hit: the occlusion query — each ray tests its slab-hit pages in
    index order and stops at its first page with a hit, so only
    ROW_ID != 0 ("some triangle hits") is meaningful (ROADMAP C5); the
    payload rows are 0, as the kernel leaves them.  chunk_live: optional
    [n // ray_chunk] flags; a chunk flagged 0 gets all-zero rows."""
    valid = alive != 0.0
    live = None
    if chunk_live is not None:
        live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
        valid = valid & live
    win = winner_init(valid)
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    views = bank_views(plt_i, plt_s, ab, P)
    rays = torch.nonzero(valid).squeeze(1)
    for b in range(views[0].shape[0]):
        bank_pass(views, b, rays, o, d, inv, win, excl, any_hit)
    rows = winner_rows(*win)
    if any_hit:
        rows[ROW_ID + 1:] = 0.0
    if live is not None:
        rows = torch.where(live[None], rows, 0.0)
    return rows


def trace_perlane(ot, dt, alive, tables: PerlaneTables, page_size: int,
                  ray_chunk: int, chunk_live=None, excl=None,
                  any_hit: bool = False):
    """Winner rows [16, R] (ops/state.py ROW_* layout) of the per-lane
    trace alone over the resident tables (B7).

    ot/dt: [3, R] float32 ray origins and directions (rows of a larger
    tensor are fine: the last dim must be dense, one row stride for both);
    alive: [R] float32, rays with alive == 0 are invalid (ROW_T -inf, the
    rest 0); tables: the resident tables and their records
    (`perlane_tables`); chunk_live: optional [R // ray_chunk] int32 flags
    — a chunk flagged 0 gets all-zero rows; excl: optional [R] float32
    triangle id each ray may not hit (0: none); any_hit: the occlusion
    query, which stops a ray at its first hit and leaves the payload rows
    0 (only ROW_ID != 0 is meaningful, ROADMAP C5).  Rows 11..15 are 0.
    The kernel reads the records and group boxes, the plain version the
    per-lane tables.
    """
    dev = ot.device
    if dev.type == "cpu":
        return trace_perlane_plain(ot, dt, alive, tables.plt_i, tables.plt_s,
                                   tables.ab, page_size, excl, any_hit,
                                   ray_chunk, chunk_live)
    native.require(dev.type == "cuda",
                   f"trace_perlane: no kernel for device {dev}")
    R = ot.shape[1]
    P = page_size
    NB = tables.ab.shape[0] // GROUP
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    native.check_tensor("alive", alive, dev, (R,), torch.float32)
    _check_records(dev, P, NB, tables)
    native.check_tensor("gab", tables.gab, dev,
                        (NB * GROUP // PAGES_A_BOX, PAB_LANES), torch.float32)
    if excl is not None:
        native.check_tensor("excl", excl, dev, (R,), torch.float32)
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev,
                            (R // ray_chunk,), torch.int32)
    out = torch.empty((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    native.TRACE_PERLANE(
        ot.data_ptr(), dt.data_ptr(), ot.stride(0), alive.data_ptr(), R,
        0 if excl is None else excl.data_ptr(), int(any_hit),
        tables.rec.data_ptr(), tables.pab.data_ptr(), tables.gab.data_ptr(),
        tables.extent.data_ptr(), P, NB, ray_chunk,
        0 if chunk_live is None else chunk_live.data_ptr(), out.data_ptr(),
        native.stream(dev))
    return out


def _check_records(dev, P: int, NB: int, tables: PerlaneTables) -> None:
    native.check_tensor("rec", tables.rec, dev, (NB * GROUP, P, REC_LANES),
                        torch.float32)
    native.check_tensor("pab", tables.pab, dev, (NB * GROUP, PAB_LANES),
                        torch.float32)
    native.check_tensor("extent", tables.extent, dev, (NB,), torch.int32)


def shadow_feeler_plain(st, rows, seed, rays, ray_chunk: int,
                        fixed_rng: bool, light, plt_i, plt_s, ab, P: int):
    """The fused shadow feeler of the rays at global positions `rays`:
    st/rows [16, n] their state and winner rows; light (ox, oy, oz, len2).
    Returns the [n] float32 shadow mask (1: a hit point that another
    triangle hides from its jittered point on the light).

    Mirrors the JAX `_kernel_fused`'s has_lights block with XLA's
    contractions (ROADMAP C7): p = fma(t, d, o), a = fma(u3, len2, l) - p,
    the sum of squares `norm2`, so = fma(nf, 0.005*(u1 + 1), p); under
    fixed_rng XLA vectorizes the rsqrt's fusion 16 wide (`rsqrt(wide=)`)."""
    hitm = (st[ROW_ALIVE] != 0.0) & (rows[ROW_ID] != 0.0)
    tm = torch.where(hitm, rows[ROW_T], 0.0)
    p = [fma(tm, st[3 + k], st[k]) for k in range(3)]
    back = rows[ROW_ENC] >= 8.0
    nf = [torch.where(back, -rows[ROW_NORM + k], rows[ROW_NORM + k])
          for k in range(3)]
    u3, u1 = shadow_uvs(seed, rays, ray_chunk, fixed_rng)
    lx, ly, lz, l2 = (float(x) for x in light)
    a = [fma(u3[k], l2, lk) - p[k] for k, lk in enumerate((lx, ly, lz))]
    inv = rsqrt(norm2(*a), wide=fixed_rng)
    off = 0.005 * (u1 + 1.0)
    so = torch.stack([torch.where(hitm, fma(nf[k], off, p[k]), 0.0)
                      for k in range(3)])
    sd = torch.stack([torch.where(hitm, a[k] * inv, 0.0) for k in range(3)])
    excl = torch.where(hitm, rows[ROW_ID], 0.0)
    srows = trace_perlane_plain(so, sd, hitm.float(), plt_i, plt_s, ab, P,
                                excl=excl, any_hit=True)
    return (hitm & (srows[ROW_ID] != 0.0)).float()


def trace_shade_perlane_plain(state, tables: PerlaneTables, seed,
                              page_size: int, ray_chunk: int,
                              fixed_rng: bool, weight_cutoff: float,
                              chunk_live, light=None):
    """Plain torch version of `trace_shade_perlane`: reads the JAX layout
    (tables.plt_i, plt_s, ab) only."""
    plt_i, plt_s, ab = tables.plt_i, tables.plt_s, tables.ab
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    for i in range(0, rays.numel(), _PLAIN_RAYS):
        idx = rays[i:i + _PLAIN_RAYS]
        st = state[:, idx]
        rows = trace_perlane_plain(st[0:3], st[3:6], st[ROW_ALIVE], plt_i,
                                   plt_s, ab, page_size)
        shd = None
        if light is not None:
            shd = shadow_feeler_plain(st, rows, seed, idx, ray_chunk,
                                      fixed_rng, light, plt_i, plt_s, ab,
                                      page_size)
        rv = scatter_rv(seed, idx, ray_chunk, fixed_rng)
        out[:, idx] = shade_state_rows(st, rows, rv, weight_cutoff, shd)
    return out


def trace_shade_perlane(state, tables: PerlaneTables, seed, page_size: int,
                        ray_chunk: int, fixed_rng: bool, weight_cutoff: float,
                        chunk_live, light=None):
    """One bounce wave: per-ray trace, shade and state update.

    state: [16, R] float32 ray state (ops/state.py); tables: the resident
    tables and their records (`perlane_tables`); seed: the wave's two
    uint32 key words; ray_chunk: the RNG chunk width (scatter_rv);
    chunk_live: [NC] int32 flags — chunks flagged 0 hold no live ray and
    pass their state through; light: optional (ox, oy, oz, len2) of the
    scene's light, which runs the shadow feeler between trace and shade.
    Returns the new state.  The kernel reads the records, the plain
    version the per-lane tables.
    """
    dev = state.device
    if dev.type == "cpu":
        return trace_shade_perlane_plain(state, tables, seed, page_size,
                                         ray_chunk, fixed_rng, weight_cutoff,
                                         chunk_live, light)
    native.require(dev.type == "cuda",
                   f"trace_shade_perlane: no kernel for device {dev}")
    R = state.shape[1]
    P = page_size
    NB = tables.ab.shape[0] // GROUP
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    _check_records(dev, P, NB, tables)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    lx, ly, lz, l2 = (0.0,) * 4 if light is None else (float(x)
                                                       for x in light)
    wide = xla_rsqrt.device_table(dev, wide=True)
    native.TRACE_SHADE_PERLANE(
        state.data_ptr(), out.data_ptr(), R, tables.rec.data_ptr(),
        tables.pab.data_ptr(), tables.extent.data_ptr(), P, NB, ray_chunk,
        chunk_live.data_ptr(), s0, s1, int(fixed_rng), float(weight_cutoff),
        int(light is not None), lx, ly, lz, l2,
        xla_rsqrt.device_table(dev).data_ptr(),
        0 if wide is None else wide.data_ptr(), native.stream(dev))
    return out
