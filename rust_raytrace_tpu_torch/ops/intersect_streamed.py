"""B9, B10 and B12: the streamed regime's traces, for scenes past the
resident tables' cap.

Counterparts in `rust_raytrace_tpu/ops/intersect_streamed.py`:
`build_streamed_tables` (copied: the JAX module imports jax),
`trace_shade_streamed_pallas` (B9, inner `_kernel_streamed_fused`),
`trace_streamed_pallas` (B10, inner `_kernel_streamed`) and
`trace_shade_bankmajor_pallas` (B12, the bank-major sweep: inner
`_kernel_bm_prep`, `_kernel_bm_sweep`, `_kernel_bm_finish` and the glue
between them).  `trace_shade_streamed` and `trace_streamed` run the CUDA
kernels of `csrc/trace_streamed.cu`, and `bankmajor_prep`,
`bankmajor_sweep` and `bankmajor_finish` those of
`csrc/trace_bankmajor.cu`, on CUDA tensors, and their `*_plain` versions
on CPU tensors.

The tables (`StreamedTables`) are the per-lane tables of every bank, one
bank per slab ([NB, 17P, 128] and [NB, 7P, 128]), beside the page AABBs
and each bank's AABB: the JAX package's layout, which the plain versions,
the CPU tests and B12's finish read.  The plain versions take any number
of banks; the CUDA kernels at most `native.MAX_STREAMED_BANKS` (4,096,
about 117 million triangle slots at P = 224), because a block of B9 or
B10 stages every bank's AABB in shared memory, 32 B each.  Beside them lie the
same triangles page-major (`intersect_perlane.page_records`, which builds
the resident regime's too): one 96-byte record of the packed lanes 0..23
per triangle and one 32-byte AABB per page, which the CUDA walks of B9,
B10 and B12's sweep read (csrc/perlane.cuh:bank_walk; B9's walk by a warp
a ray in csrc/trace_streamed.cu), and B9's group boxes of 8 pages.
Every ray walks the banks its slab test hits, the nearest remaining one
first (ties to the lower index), skips a bank once its entry lies beyond
the ray's best hit, and runs the per-lane page traversal
(`intersect_perlane.bank_pass`) inside.  The TPU kernel walks one worklist
per chunk and sorts lanes by primary bank; the winner, a lexicographic
(t, id) minimum with exact pruning, does not depend on that order.  Not
carried: the TPU kernel's `stats` profiling rows and `sort_lanes`, which
change no output.

B12 runs one wave as three phases, chained by `trace_shade_bankmajor`:
prep (each lane's winner init and, per bank and chunk, a bitmask of the
chunk's 128-lane groups whose rays enter the bank), a glue step over the
[NB, NC] demand only (each bank's demanding chunks first, and their
count), the sweep (banks in index order for each demanded group, each
bank over its demanding chunks' demanded groups, `bank_pass` per ray, the
winner kept as t, id and slot; the kernel is one persistent launch that
claims (bank, group) items bank-major) and the finish (the winner's
payload from its slot, then the shade).  It equals B9 bit for bit; the TPU kernel's lane sort by primary bank is not
carried.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils import native, xla_rsqrt
from .cull import slab, slab_inv
from .intersect_perlane import (GROUP, N_INT, N_SHD, PAB_LANES, REC_LANES,
                                bank_pass, bank_views, build_perlane_tables,
                                page_records, winner_init, winner_rows)
from .pages import PACK_LANES, PageTables
from .intersect import packed_hit_predicate, payload_features, PAYLOAD_ROWS
from .shade import scatter_rv, shade_state_rows
from .state import ROW_ALIVE, ROW_ID, STATE_ROWS, TRACE_ROWS

#: rays a plain-version block holds (a step gathers 17*P table floats per ray)
_PLAIN_RAYS = 32768
#: hit rays whose winner page a plain finish block gathers at once
_PLAIN_FINISH_RAYS = 8192

#: B12's winner stream, [WIN_ROWS, R] float32: t, id, and the winner's
#: slot (page * P + triangle, pages counted over all banks) as int32 bits
WIN_T = 0
WIN_ID = 1
WIN_SLOT = 2
WIN_ROWS = 3


def build_streamed_tables(pages: PageTables):
    """The streamed kernels' tables, as numpy float32:

      plt_i   [NB, N_INT*P, 128]  intersect features, pages on lanes
      plt_s   [NB, N_SHD*P, 128]  shade features
      ab      [NB*128, 128]       page AABBs (lanes 0..2 lo, 3..5 hi, 6 valid)
      bank_ab [NB8, 128]          bank AABBs (the union of the bank's pages,
                                  same lanes); NB8 = NB padded to a multiple
                                  of 8, padding rows zero (lane 6 invalid)
    """
    NB = -(-pages.num_pages // GROUP)
    P = pages.page_size
    plt_i, plt_s, ab = build_perlane_tables(pages, max_banks=NB)
    NB8 = -(-NB // 8) * 8
    bank_ab = np.zeros((NB8, PACK_LANES), np.float32)
    for b in range(NB):
        lo = pages.aabb_lo[b * GROUP:(b + 1) * GROUP]
        hi = pages.aabb_hi[b * GROUP:(b + 1) * GROUP]
        ok = np.isfinite(lo).all(axis=1)
        if not ok.any():
            continue
        bank_ab[b, 0:3] = lo[ok].min(axis=0)
        bank_ab[b, 3:6] = hi[ok].max(axis=0)
        bank_ab[b, 6] = 1.0
    return (plt_i.reshape(NB, N_INT * P, GROUP),
            plt_s.reshape(NB, N_SHD * P, GROUP), ab, bank_ab)


class StreamedTables(NamedTuple):
    """The streamed regime's tables on one device, in both layouts.

    plt_i, plt_s, ab, bank_ab: `build_streamed_tables` (pages on lanes, the
    JAX package's layout); rec [NB*128, P, 24] and pab [NB*128, 8]:
    `page_records` of them (page-major, the CUDA walks' layout); gab
    [NB*128 / PAGES_A_BOX, 8]: `group_boxes(pab)`, B9's first level of page
    culling."""
    plt_i: torch.Tensor
    plt_s: torch.Tensor
    ab: torch.Tensor
    bank_ab: torch.Tensor
    rec: torch.Tensor
    pab: torch.Tensor
    gab: torch.Tensor


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
    whose slab test passes passes its group box's: B9 skips the pages of a
    group that fails (tests/test_torch_streamed_walk.py holds it on -0,
    NaN and padding bounds)."""
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


def upload_streamed_tables(pages: PageTables, device) -> StreamedTables:
    """`build_streamed_tables` as float32 tensors on `device`, and their
    page-major records and group boxes built there."""
    tabs = tuple(torch.from_numpy(x).to(device)
                 for x in build_streamed_tables(pages))
    rec, pab = page_records(*tabs[:3])
    return StreamedTables(*tabs, rec, pab, group_boxes(pab))


def _trace_block(o, d, valid, views, bank_ab, excl, any_hit: bool):
    """The bank worklists of one block of rays: the winner triple."""
    win = winner_init(valid)
    best_t, best_id, _ = win
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    NB = views[0].shape[0]
    bb = bank_ab[:NB]
    btlo, bthi = slab([bb[:, k:k + 1] for k in range(3)],
                      [bb[:, k + 3:k + 4] for k in range(3)],
                      [o[k][None] for k in range(3)],
                      [inv[k][None] for k in range(3)])      # [NB, n]
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


def trace_streamed_plain(ot, dt, alive, tables: StreamedTables,
                         page_size: int, ray_chunk: int = 0, chunk_live=None,
                         excl=None, any_hit: bool = False):
    """Plain torch version of `trace_streamed`: reads the JAX layout."""
    n = ot.shape[1]
    valid = alive != 0.0
    if chunk_live is not None:
        live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
        valid = valid & live
    views = bank_views(tables.plt_i, tables.plt_s, tables.ab, page_size)
    bank_ab = tables.bank_ab
    rows = torch.empty((TRACE_ROWS, n), dtype=torch.float32, device=ot.device)
    for i in range(0, n, _PLAIN_RAYS):
        sl = slice(i, min(n, i + _PLAIN_RAYS))
        rows[:, sl] = winner_rows(*_trace_block(
            ot[:, sl], dt[:, sl], valid[sl], views, bank_ab,
            None if excl is None else excl[sl], any_hit))
    if any_hit:
        # the TPU kernel extracts no payload for the occlusion query
        rows[ROW_ID + 1:] = 0.0
    if chunk_live is not None:
        rows = torch.where(live[None], rows, 0.0)
    return rows


def trace_streamed(ot, dt, alive, tables: StreamedTables, page_size: int,
                   ray_chunk: int, chunk_live=None, excl=None,
                   any_hit: bool = False):
    """Winner rows [16, R] (ops/state.py ROW_* layout) of the streamed
    trace (B10).

    ot/dt: [3, R] float32 ray origins and directions (rows of a larger
    tensor are fine: the last dim must be dense, one row stride for both);
    alive: [R] float32, rays with alive == 0 are invalid (ROW_T -inf, the
    rest 0); tables: `upload_streamed_tables`; chunk_live:
    optional [R // ray_chunk] int32 flags — a chunk flagged 0 gets all-zero
    rows; excl: optional [R] float32 triangle id each ray may not hit (0:
    none); any_hit: the occlusion query, which stops a ray at its first hit
    and leaves the payload rows 0 (only ROW_ID != 0 is meaningful, ROADMAP
    C5).  Rows 11..15 are 0.
    """
    dev = ot.device
    if dev.type == "cpu":
        return trace_streamed_plain(ot, dt, alive, tables, page_size,
                                    ray_chunk, chunk_live, excl, any_hit)
    native.require(dev.type == "cuda",
                   f"trace_streamed: no kernel for device {dev}")
    R = ot.shape[1]
    P = page_size
    NB = tables.plt_i.shape[0]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    native.check_tensor("alive", alive, dev, (R,), torch.float32)
    _check_tables(dev, P, NB, tables)
    if excl is not None:
        native.check_tensor("excl", excl, dev, (R,), torch.float32)
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev,
                            (R // ray_chunk,), torch.int32)
    out = torch.empty((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    native.TRACE_STREAMED(
        ot.data_ptr(), dt.data_ptr(), ot.stride(0), alive.data_ptr(), R,
        0 if excl is None else excl.data_ptr(), int(any_hit),
        tables.rec.data_ptr(), tables.pab.data_ptr(),
        tables.bank_ab.data_ptr(), P, NB, ray_chunk,
        0 if chunk_live is None else chunk_live.data_ptr(), out.data_ptr(),
        native.stream(dev))
    return out


def trace_shade_streamed_plain(state, tables: StreamedTables, seed,
                               page_size: int, ray_chunk: int,
                               fixed_rng: bool, weight_cutoff: float,
                               chunk_live):
    """Plain torch version of `trace_shade_streamed`."""
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    st = state[:, rays]
    rows = trace_streamed_plain(st[0:3], st[3:6], st[ROW_ALIVE], tables,
                                page_size)
    rv = scatter_rv(seed, rays, ray_chunk, fixed_rng)
    out[:, rays] = shade_state_rows(st, rows, rv, weight_cutoff)
    return out


def trace_shade_streamed(state, tables: StreamedTables, seed,
                         page_size: int, ray_chunk: int, fixed_rng: bool,
                         weight_cutoff: float, chunk_live):
    """One wave of the streamed regime (B9): trace, shade and state update.

    state: [16, R] float32 ray state (ops/state.py); tables:
    `upload_streamed_tables`; seed: the wave's two uint32 key words;
    ray_chunk: the RNG chunk width (scatter_rv); chunk_live: [NC] int32
    flags — chunks flagged 0 hold no live ray and pass their state through.
    Returns the new state.
    """
    dev = state.device
    if dev.type == "cpu":
        return trace_shade_streamed_plain(state, tables, seed, page_size,
                                          ray_chunk, fixed_rng,
                                          weight_cutoff, chunk_live)
    native.require(dev.type == "cuda",
                   f"trace_shade_streamed: no kernel for device {dev}")
    out, args, _scratch = _b9_args(state, tables, seed, page_size,
                                   ray_chunk, fixed_rng, weight_cutoff,
                                   chunk_live)
    native.TRACE_SHADE_STREAMED(*args, native.stream(dev))
    return out


#: the rows of `trace_shade_streamed_counts`'s counts
#: (csrc/trace_streamed.cu Count)
COUNT_ROWS = ("bank_steps", "bank_tests", "bank_visits", "group_tests",
              "page_tests", "pages", "tris", "led", "lane_iters")


def _b9_args(state, tables: StreamedTables, seed, page_size: int,
             ray_chunk: int, fixed_rng: bool, weight_cutoff: float,
             chunk_live):
    """Validate B9's arguments on the card; returns (out, the C entry's
    arguments up to and including its scratch, the scratch): the live list
    [R] int32 and its three counters (the list's length, the trace grid's
    claims, the listed rays that start outside every bank box they enter),
    which must outlive the launch's enqueueing."""
    dev = state.device
    R = state.shape[1]
    P = page_size
    NB = tables.plt_i.shape[0]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    _check_tables(dev, P, NB, tables)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    out = torch.empty_like(state)
    scratch = torch.empty(R, dtype=torch.int32, device=dev)
    count = torch.zeros(3, dtype=torch.int32, device=dev)
    s0, s1 = (int(w) for w in seed)
    return out, (state.data_ptr(), out.data_ptr(), R, tables.rec.data_ptr(),
                 tables.pab.data_ptr(), tables.gab.data_ptr(),
                 tables.bank_ab.data_ptr(), P, NB,
                 ray_chunk, chunk_live.data_ptr(), s0, s1, int(fixed_rng),
                 float(weight_cutoff), xla_rsqrt.device_table(dev).data_ptr(),
                 scratch.data_ptr(), count.data_ptr()), (scratch, count)


def trace_shade_streamed_counts(state, tables: StreamedTables, seed,
                                page_size: int, ray_chunk: int,
                                fixed_rng: bool, weight_cutoff: float,
                                chunk_live):
    """B9's counting instance, on the card only: `trace_shade_streamed`'s
    result, [len(COUNT_ROWS), R] int32 counts of each traced ray's work at
    its lane, 0 elsewhere (bank selection steps, bank-box slab tests, bank
    visits, group-box and page-box slab tests, pages and triangles tested,
    and the triangle-loop iterations the ray's lanes led and ran, so that
    lane_iters / (32 * led) is the loop's active-lane share), and the lanes
    a ray the trace grid took: 16 where more than half the listed rays
    start outside every bank box they enter, else 32.  No render path
    calls it."""
    dev = state.device
    native.require(dev.type == "cuda",
                   f"trace_shade_streamed_counts: no kernel for device {dev}")
    out, args, (_, count) = _b9_args(state, tables, seed, page_size,
                                     ray_chunk, fixed_rng, weight_cutoff,
                                     chunk_live)
    cnt = torch.zeros((len(COUNT_ROWS), state.shape[1]), dtype=torch.int32,
                      device=dev)
    native.TRACE_SHADE_STREAMED_COUNTS(*args, cnt.data_ptr(),
                                       native.stream(dev))
    listed, _, outside = count.tolist()
    return out, cnt, 16 if 2 * outside > listed else 32


def _check_tables(dev, P: int, NB: int, tables: StreamedTables) -> None:
    native.check_tensor("plt_i", tables.plt_i, dev, (NB, N_INT * P, GROUP),
                        torch.float32)
    native.check_tensor("plt_s", tables.plt_s, dev, (NB, N_SHD * P, GROUP),
                        torch.float32)
    native.check_tensor("ab", tables.ab, dev, (NB * GROUP, PACK_LANES),
                        torch.float32)
    native.check_tensor("bank_ab", tables.bank_ab, dev,
                        (-(-NB // 8) * 8, PACK_LANES), torch.float32)
    native.check_tensor("rec", tables.rec, dev, (NB * GROUP, P, REC_LANES),
                        torch.float32)
    native.check_tensor("pab", tables.pab, dev, (NB * GROUP, PAB_LANES),
                        torch.float32)
    native.check_tensor("gab", tables.gab, dev,
                        (NB * GROUP // PAGES_A_BOX, PAB_LANES), torch.float32)
    native.require(NB <= native.MAX_STREAMED_BANKS,
                   f"{NB} banks: the streamed kernels stage at most "
                   f"{native.MAX_STREAMED_BANKS} bank AABBs")


def _check_bankmajor(R: int, ray_chunk: int) -> None:
    native.check_ray_chunk(R, ray_chunk)
    native.require(ray_chunk % GROUP == 0,
                   f"bank-major sweep needs ray_chunk % {GROUP} == 0, got "
                   f"{ray_chunk}")


def _chunk_lanes(chunk_live, ray_chunk: int):
    return torch.repeat_interleave(chunk_live != 0, ray_chunk)


def bankmajor_prep_plain(state, bank_ab, NB: int, ray_chunk: int,
                         chunk_live=None):
    """Plain torch version of `bankmajor_prep`."""
    R = state.shape[1]
    RB = ray_chunk
    G = RB // GROUP
    valid = state[ROW_ALIVE] != 0.0
    if chunk_live is not None:
        valid = valid & _chunk_lanes(chunk_live, RB)
    win = torch.zeros((WIN_ROWS, R), dtype=torch.float32,
                      device=state.device)
    win[WIN_T] = torch.where(valid, torch.inf, -torch.inf)
    gm = torch.empty((NB, R // RB), dtype=torch.int32, device=state.device)
    bb = bank_ab[:NB]
    bits = 1 << torch.arange(G, device=state.device)
    step = max(1, _PLAIN_RAYS // RB) * RB
    for i in range(0, R, step):
        sl = slice(i, min(R, i + step))
        o, d = state[0:3, sl], state[3:6, sl]
        btlo, bthi = slab([bb[:, k:k + 1] for k in range(3)],
                          [bb[:, k + 3:k + 4] for k in range(3)],
                          [o[k][None] for k in range(3)],
                          [slab_inv(d[k])[None] for k in range(3)])
        hit = ((btlo <= bthi) & (bthi >= 0.0) & (bb[:, 6:7] != 0.0)
               & valid[sl][None])                                # [NB, n]
        grp = hit.reshape(NB, -1, G, GROUP).any(dim=3)           # [NB, c, G]
        gm[:, i // RB:sl.stop // RB] = (grp * bits).sum(dim=2).to(
            torch.int32)
    return win, gm


def bankmajor_prep(state, bank_ab, NB: int, ray_chunk: int,
                   chunk_live=None):
    """B12a: the winner stream's init and the group demand of one wave.

    state: [16, R] ray state; bank_ab: `upload_streamed_tables`' bank
    AABBs; NB: the bank count; chunk_live: optional [R // ray_chunk] int32
    flags (a chunk flagged 0 is invalid throughout).  Returns (win, gm):
    win [WIN_ROWS, R] float32 with t = +inf on valid lanes and -inf on the
    rest, id and slot 0; gm [NB, R // ray_chunk] int32, bit g of gm[b, c]
    set when a valid ray of chunk c's 128-lane group g enters bank b's
    AABB."""
    dev = state.device
    if dev.type == "cpu":
        return bankmajor_prep_plain(state, bank_ab, NB, ray_chunk,
                                    chunk_live)
    native.require(dev.type == "cuda",
                   f"bankmajor_prep: no kernel for device {dev}")
    R = state.shape[1]
    _check_bankmajor(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("bank_ab", bank_ab, dev,
                        (-(-NB // 8) * 8, PACK_LANES), torch.float32)
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev,
                            (R // ray_chunk,), torch.int32)
    win = torch.empty((WIN_ROWS, R), dtype=torch.float32, device=dev)
    gm = torch.empty((NB, R // ray_chunk), dtype=torch.int32, device=dev)
    native.BM_PREP(state.data_ptr(), R, bank_ab.data_ptr(), NB, ray_chunk,
                   0 if chunk_live is None else chunk_live.data_ptr(),
                   win.data_ptr(), gm.data_ptr(), native.stream(dev))
    return win, gm


def bankmajor_order(gm):
    """B12's glue, on the [NB, NC] demand only: (count [NB] int32, order
    [NB, NC] int32), each bank's demanding chunks first in chunk order
    (a stable sort), then the rest (JAX: phase B of
    trace_shade_bankmajor_pallas at one bank per step)."""
    demand = gm != 0
    count = demand.sum(dim=1, dtype=torch.int32)
    order = torch.sort((~demand).to(torch.int32), dim=1, stable=True).indices
    return count, order.to(torch.int32).contiguous()


def bankmajor_sweep_plain(state, win, gm, count, order,
                          tables: StreamedTables, page_size: int,
                          ray_chunk: int):
    """Plain torch version of `bankmajor_sweep`."""
    R = state.shape[1]
    RB = ray_chunk
    out = win.clone()
    best_t, best_id = out[WIN_T], out[WIN_ID]
    slot = out[WIN_SLOT].view(torch.int32)
    payload = torch.zeros((len(PAYLOAD_ROWS), R), dtype=torch.float32,
                          device=win.device)        # not kept: the slot is
    views = bank_views(tables.plt_i, tables.plt_s, tables.ab, page_size)
    o, d = state[0:3], state[3:6]
    inv = torch.stack([slab_inv(d[k]) for k in range(3)])
    valid = state[ROW_ALIVE] != 0.0
    group = torch.arange(RB, device=win.device) // GROUP
    for b in range(views[0].shape[0]):
        chunks = order[b, :int(count[b])].long()
        lanes = (chunks[:, None] * RB
                 + torch.arange(RB, device=win.device)).reshape(-1)
        want = ((gm[b, chunks][:, None] >> group[None]) & 1).reshape(-1)
        rays = lanes[want != 0]
        rays = rays[valid[rays]]
        for i in range(0, rays.numel(), _PLAIN_RAYS):
            bank_pass(views, b, rays[i:i + _PLAIN_RAYS], o, d, inv,
                      (best_t, best_id, payload, slot))
    return out


def bankmajor_sweep(state, win, gm, count, order, tables: StreamedTables,
                    page_size: int, ray_chunk: int):
    """B12b: the bank-major sweep.  Banks in index order; bank b runs the
    per-lane page traversal (`bank_pass`) for every valid ray of the
    groups its demand list (gm, count, order of `bankmajor_order`) names,
    after each ray's bank-AABB test against its winner so far.  Returns the
    new winner stream (t, id, slot); the payload is the finish's.  On the
    card: one launch a call, whatever NB (csrc/trace_bankmajor.cu)."""
    dev = state.device
    if dev.type == "cpu":
        return bankmajor_sweep_plain(state, win, gm, count, order, tables,
                                     page_size, ray_chunk)
    native.require(dev.type == "cuda",
                   f"bankmajor_sweep: no kernel for device {dev}")
    R = state.shape[1]
    P = page_size
    NB = tables.plt_i.shape[0]
    NC = R // ray_chunk
    _check_bankmajor(R, ray_chunk)
    native.require(NB * GROUP * P < 2 ** 31, "winner slots overflow int32")
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("win", win, dev, (WIN_ROWS, R), torch.float32)
    native.check_tensor("gm", gm, dev, (NB, NC), torch.int32)
    native.check_tensor("count", count, dev, (NB,), torch.int32)
    native.check_tensor("order", order, dev, (NB, NC), torch.int32)
    _check_tables(dev, P, NB, tables)
    out = win.clone()
    # the item counter, then each (chunk, group)'s last swept bank + 1
    sync = torch.zeros(1 + NC * (ray_chunk // GROUP), dtype=torch.int32,
                       device=dev)
    native.BM_SWEEP(state.data_ptr(), R, out.data_ptr(), gm.data_ptr(),
                    count.data_ptr(), order.data_ptr(),
                    tables.rec.data_ptr(), tables.pab.data_ptr(),
                    tables.bank_ab.data_ptr(), P, NB, ray_chunk,
                    sync.data_ptr(), native.stream(dev))
    return out


def winner_stream_rows(st, win, plt_i, plt_s, page_size: int):
    """[16, n] winner rows (ROW_* layout) of rays st [16, n] from their
    winner stream win [WIN_ROWS, n]: t, id, and each hit's payload
    extracted from its winner's page as `bank_pass` extracts it (the
    page's candidates against the ray, a one-hot masked sum)."""
    P = page_size
    n = st.shape[1]
    payload = torch.zeros((len(PAYLOAD_ROWS), n), dtype=torch.float32,
                          device=st.device)
    hits = torch.nonzero(win[WIN_ID] != 0.0).squeeze(1)
    slots = win[WIN_SLOT].view(torch.int32)
    for i in range(0, hits.numel(), _PLAIN_FINISH_RAYS):
        h = hits[i:i + _PLAIN_FINISH_RAYS]
        page = slots[h].long() // P
        b, p = page // GROUP, page % GROUP
        m = h.numel()
        gi = plt_i[b, :, p].reshape(m, N_INT, P).permute(1, 2, 0)
        gs = plt_s[b, :, p].reshape(m, N_SHD, P).permute(1, 2, 0)

        def col(f, gi=gi, gs=gs):
            return gi[f] if f < N_INT else gs[f - N_INT]

        _, _, ids, md_n, dv = packed_hit_predicate(
            col, tuple(st[k, h][None] for k in range(3)),
            tuple(st[3 + k, h][None] for k in range(3)))
        w = (ids == win[WIN_ID, h][None]).float()
        for j, v in enumerate(payload_features(col, md_n, dv)):
            payload[j, h] = (w * v).sum(dim=0)
    return winner_rows(win[WIN_T], win[WIN_ID], payload)


def bankmajor_finish_plain(state, win, plt_i, plt_s, seed, page_size: int,
                           ray_chunk: int, fixed_rng: bool,
                           weight_cutoff: float, chunk_live):
    """Plain torch version of `bankmajor_finish`."""
    out = state.clone()
    rays = torch.nonzero(_chunk_lanes(chunk_live, ray_chunk)).squeeze(1)
    st = state[:, rays]
    rows = winner_stream_rows(st, win[:, rays], plt_i, plt_s, page_size)
    rv = scatter_rv(seed, rays, ray_chunk, fixed_rng)
    out[:, rays] = shade_state_rows(st, rows, rv, weight_cutoff)
    return out


def bankmajor_finish(state, win, plt_i, plt_s, seed, page_size: int,
                     ray_chunk: int, fixed_rng: bool, weight_cutoff: float,
                     chunk_live):
    """B12c: each ray's payload from its winner's slot, then the shade +
    scatter + state update of B9 (the scatter hash keyed on (chunk, lane)
    at ray_chunk).  chunk_live: [R // ray_chunk] int32 flags; chunks
    flagged 0 pass their state through.  Returns the new state."""
    dev = state.device
    if dev.type == "cpu":
        return bankmajor_finish_plain(state, win, plt_i, plt_s, seed,
                                      page_size, ray_chunk, fixed_rng,
                                      weight_cutoff, chunk_live)
    native.require(dev.type == "cuda",
                   f"bankmajor_finish: no kernel for device {dev}")
    R = state.shape[1]
    P = page_size
    NB = plt_i.shape[0]
    _check_bankmajor(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("win", win, dev, (WIN_ROWS, R), torch.float32)
    native.check_tensor("plt_i", plt_i, dev, (NB, N_INT * P, GROUP),
                        torch.float32)
    native.check_tensor("plt_s", plt_s, dev, (NB, N_SHD * P, GROUP),
                        torch.float32)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    native.BM_FINISH(state.data_ptr(), out.data_ptr(), R, win.data_ptr(),
                     plt_i.data_ptr(), plt_s.data_ptr(), P, ray_chunk,
                     chunk_live.data_ptr(), s0, s1, int(fixed_rng),
                     float(weight_cutoff),
                     xla_rsqrt.device_table(dev).data_ptr(),
                     native.stream(dev))
    return out


def trace_shade_bankmajor_plain(state, tables: StreamedTables, seed,
                                page_size: int, ray_chunk: int,
                                fixed_rng: bool, weight_cutoff: float,
                                chunk_live=None):
    """Plain torch version of `trace_shade_bankmajor`: the plain phases."""
    if chunk_live is None:
        chunk_live = torch.ones(state.shape[1] // ray_chunk,
                                dtype=torch.int32, device=state.device)
    win, gm = bankmajor_prep_plain(state, tables.bank_ab,
                                   tables.plt_i.shape[0], ray_chunk,
                                   chunk_live)
    count, order = bankmajor_order(gm)
    win = bankmajor_sweep_plain(state, win, gm, count, order, tables,
                                page_size, ray_chunk)
    return bankmajor_finish_plain(state, win, tables.plt_i, tables.plt_s,
                                  seed, page_size, ray_chunk, fixed_rng,
                                  weight_cutoff, chunk_live)


def trace_shade_bankmajor(state, tables: StreamedTables, seed,
                          page_size: int, ray_chunk: int, fixed_rng: bool,
                          weight_cutoff: float, chunk_live=None):
    """One wave of the streamed regime through the bank-major sweep (B12):
    `bankmajor_prep`, `bankmajor_order`, `bankmajor_sweep`,
    `bankmajor_finish`.  Same arguments and result as
    `trace_shade_streamed` (B9), bit for bit; chunk_live None: every chunk
    live."""
    if chunk_live is None:
        chunk_live = torch.ones(state.shape[1] // ray_chunk,
                                dtype=torch.int32, device=state.device)
    NB = tables.plt_i.shape[0]
    win, gm = bankmajor_prep(state, tables.bank_ab, NB, ray_chunk,
                             chunk_live)
    count, order = bankmajor_order(gm)
    win = bankmajor_sweep(state, win, gm, count, order, tables, page_size,
                          ray_chunk)
    return bankmajor_finish(state, win, tables.plt_i, tables.plt_s, seed,
                            page_size, ray_chunk, fixed_rng, weight_cutoff,
                            chunk_live)
