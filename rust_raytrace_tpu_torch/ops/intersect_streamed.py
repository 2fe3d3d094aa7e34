"""B9 and B10: the streamed regime's bank-worklist trace, for scenes past
the resident tables' cap.

Counterparts in `rust_raytrace_tpu/ops/intersect_streamed.py`:
`build_streamed_tables` (copied: the JAX module imports jax),
`trace_shade_streamed_pallas` (B9, inner `_kernel_streamed_fused`) and
`trace_streamed_pallas` (B10, inner `_kernel_streamed`).
`trace_shade_streamed` and `trace_streamed` run the CUDA kernels of
`csrc/trace_streamed.cu` on CUDA tensors and `trace_shade_streamed_plain`
and `trace_streamed_plain` on CPU tensors.

The tables are the per-lane tables of every bank, with no bank cap, one
bank per slab ([NB, 17P, 128] and [NB, 7P, 128]), beside the page AABBs and
each bank's AABB.  Every ray walks the banks its slab test hits, the nearest
remaining one first (ties to the lower index), skips a bank once its entry
lies beyond the ray's best hit, and runs the per-lane page traversal
(`intersect_perlane.bank_pass`) inside.  The TPU kernel walks one worklist
per chunk and sorts lanes by primary bank; the winner, a lexicographic
(t, id) minimum with exact pruning, does not depend on that order.  Not
carried: the TPU kernel's `stats` profiling rows and `sort_lanes`, which
change no output.
"""

import numpy as np
import torch

from ..utils import native, xla_rsqrt
from .cull import slab, slab_inv
from .intersect_perlane import (GROUP, N_INT, N_SHD, bank_pass, bank_views,
                                build_perlane_tables, winner_init,
                                winner_rows)
from .pages import PACK_LANES, PageTables
from .shade import scatter_rv, shade_state_rows
from .state import ROW_ALIVE, ROW_ID, STATE_ROWS, TRACE_ROWS

#: rays a plain-version block holds (a step gathers 17*P table floats per ray)
_PLAIN_RAYS = 32768


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


def upload_streamed_tables(pages: PageTables, device):
    """`build_streamed_tables` as float32 tensors on `device`."""
    return tuple(torch.from_numpy(x).to(device)
                 for x in build_streamed_tables(pages))


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


def trace_streamed_plain(ot, dt, alive, plt_i, plt_s, ab, bank_ab,
                         page_size: int, ray_chunk: int = 0, chunk_live=None,
                         excl=None, any_hit: bool = False):
    """Plain torch version of `trace_streamed`."""
    n = ot.shape[1]
    valid = alive != 0.0
    if chunk_live is not None:
        live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
        valid = valid & live
    views = bank_views(plt_i, plt_s, ab, page_size)
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


def trace_streamed(ot, dt, alive, plt_i, plt_s, ab, bank_ab, page_size: int,
                   ray_chunk: int, chunk_live=None, excl=None,
                   any_hit: bool = False):
    """Winner rows [16, R] (ops/state.py ROW_* layout) of the streamed
    trace (B10).

    ot/dt: [3, R] float32 ray origins and directions (rows of a larger
    tensor are fine: the last dim must be dense, one row stride for both);
    alive: [R] float32, rays with alive == 0 are invalid (ROW_T -inf, the
    rest 0); plt_i/plt_s/ab/bank_ab: `upload_streamed_tables`; chunk_live:
    optional [R // ray_chunk] int32 flags — a chunk flagged 0 gets all-zero
    rows; excl: optional [R] float32 triangle id each ray may not hit (0:
    none); any_hit: the occlusion query, which stops a ray at its first hit
    and leaves the payload rows 0 (only ROW_ID != 0 is meaningful, ROADMAP
    C5).  Rows 11..15 are 0.
    """
    dev = ot.device
    if dev.type == "cpu":
        return trace_streamed_plain(ot, dt, alive, plt_i, plt_s, ab, bank_ab,
                                    page_size, ray_chunk, chunk_live, excl,
                                    any_hit)
    native.require(dev.type == "cuda",
                   f"trace_streamed: no kernel for device {dev}")
    R = ot.shape[1]
    P = page_size
    NB = plt_i.shape[0]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    native.check_tensor("alive", alive, dev, (R,), torch.float32)
    _check_tables(dev, P, NB, plt_i, plt_s, ab, bank_ab)
    if excl is not None:
        native.check_tensor("excl", excl, dev, (R,), torch.float32)
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev,
                            (R // ray_chunk,), torch.int32)
    out = torch.empty((TRACE_ROWS, R), dtype=torch.float32, device=dev)
    native.TRACE_STREAMED(
        ot.data_ptr(), dt.data_ptr(), ot.stride(0), alive.data_ptr(), R,
        0 if excl is None else excl.data_ptr(), int(any_hit),
        plt_i.data_ptr(), plt_s.data_ptr(), ab.data_ptr(), bank_ab.data_ptr(),
        P, NB, ray_chunk, 0 if chunk_live is None else chunk_live.data_ptr(),
        out.data_ptr(), native.stream(dev))
    return out


def trace_shade_streamed_plain(state, plt_i, plt_s, ab, bank_ab, seed,
                               page_size: int, ray_chunk: int,
                               fixed_rng: bool, weight_cutoff: float,
                               chunk_live):
    """Plain torch version of `trace_shade_streamed`."""
    out = state.clone()
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    rays = torch.nonzero(live).squeeze(1)
    st = state[:, rays]
    rows = trace_streamed_plain(st[0:3], st[3:6], st[ROW_ALIVE], plt_i,
                                plt_s, ab, bank_ab, page_size)
    rv = scatter_rv(seed, rays, ray_chunk, fixed_rng)
    out[:, rays] = shade_state_rows(st, rows, rv, weight_cutoff)
    return out


def trace_shade_streamed(state, plt_i, plt_s, ab, bank_ab, seed,
                         page_size: int, ray_chunk: int, fixed_rng: bool,
                         weight_cutoff: float, chunk_live):
    """One wave of the streamed regime (B9): trace, shade and state update.

    state: [16, R] float32 ray state (ops/state.py); plt_i/plt_s/ab/bank_ab:
    `upload_streamed_tables`; seed: the wave's two uint32 key words;
    ray_chunk: the RNG chunk width (scatter_rv); chunk_live: [NC] int32
    flags — chunks flagged 0 hold no live ray and pass their state through.
    Returns the new state.
    """
    dev = state.device
    if dev.type == "cpu":
        return trace_shade_streamed_plain(state, plt_i, plt_s, ab, bank_ab,
                                          seed, page_size, ray_chunk,
                                          fixed_rng, weight_cutoff,
                                          chunk_live)
    native.require(dev.type == "cuda",
                   f"trace_shade_streamed: no kernel for device {dev}")
    R = state.shape[1]
    P = page_size
    NB = plt_i.shape[0]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    _check_tables(dev, P, NB, plt_i, plt_s, ab, bank_ab)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    native.TRACE_SHADE_STREAMED(
        state.data_ptr(), out.data_ptr(), R, plt_i.data_ptr(),
        plt_s.data_ptr(), ab.data_ptr(), bank_ab.data_ptr(), P, NB,
        ray_chunk, chunk_live.data_ptr(), s0, s1, int(fixed_rng),
        float(weight_cutoff), xla_rsqrt.device_table(dev).data_ptr(),
        native.stream(dev))
    return out


def _check_tables(dev, P: int, NB: int, plt_i, plt_s, ab, bank_ab) -> None:
    native.check_tensor("plt_i", plt_i, dev, (NB, N_INT * P, GROUP),
                        torch.float32)
    native.check_tensor("plt_s", plt_s, dev, (NB, N_SHD * P, GROUP),
                        torch.float32)
    native.check_tensor("ab", ab, dev, (NB * GROUP, PACK_LANES),
                        torch.float32)
    native.check_tensor("bank_ab", bank_ab, dev,
                        (-(-NB // 8) * 8, PACK_LANES), torch.float32)
