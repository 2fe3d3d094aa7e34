"""Wavefront compaction at a boundary and its inverse, in plain torch.

The benchmark reference's frozen copy of the port's `ops/compact.py`
(`compact_meta`, `compact_plain`, `expand_plain`).  A boundary moves each
512-lane chunk's surviving rays to a dense prefix in chunk and lane order,
each chunk's segment padded to 128 lanes, and harvests the payload of its
retired rays at the same kind of offsets; the scatter hash of the next
waves keys on the lanes this layout gives (ROADMAP C3).  A boundary whose
padded survivors would not fit passes the state through.
"""

import torch

from .trace import ROW_ACC, ROW_ALIVE, ROW_DEAD

DEFAULT_CB = 512
ALIGN = 128
ROW_CODE = 12
PAYLOAD_ROWS = 8
M_CNT_A, M_CASE_A, M_OFF_A, M_CNT_D, M_CASE_D, M_OFF_D, M_IDENT = range(7)


def pick_cb(R: int, cb: int = DEFAULT_CB) -> int:
    while R % cb:
        cb //= 2
    return max(cb, ALIGN)


def dead_capacity(R: int, boundaries: int, cb: int) -> int:
    need = R + boundaries * (R // cb) * (ALIGN - 1)
    return max(2 * R, -(-need // ALIGN) * ALIGN)


def compact_meta(alive, dead, cb: int, dead_base, R: int):
    """(meta [R // cb, 8] int32, total_a, skip, dead_end) of a boundary."""
    NC = R // cb
    cnt_a = (alive.reshape(NC, cb) != 0).sum(dim=1, dtype=torch.int32)
    cnt_d = (dead.reshape(NC, cb) != 0).sum(dim=1, dtype=torch.int32)
    pad_a = (cnt_a + (ALIGN - 1)) // ALIGN * ALIGN
    pad_d = (cnt_d + (ALIGN - 1)) // ALIGN * ALIGN
    cs_a = torch.cumsum(pad_a, dim=0, dtype=torch.int32)
    cs_d = torch.cumsum(pad_d, dim=0, dtype=torch.int32)
    base = dead_base.to(torch.int32)
    total_a = cs_a[-1]
    skip = total_a > R
    ident = skip.to(torch.int32).expand(NC)
    meta = torch.stack([cnt_a, pad_a // ALIGN, cs_a - pad_a, cnt_d,
                        pad_d // ALIGN, base + cs_d - pad_d, ident,
                        torch.zeros_like(cnt_a)], dim=1)
    return meta, total_a, skip, base + cs_d[-1]


def _ranks(mask, cb: int):
    m = mask.reshape(-1, cb).to(torch.int64)
    return torch.cumsum(m, dim=1) - m


def compact(state, dead_arr, meta, cb: int):
    R = state.shape[1]
    out = torch.zeros_like(state)
    ident = meta[:, M_IDENT] != 0
    busy = (meta[:, M_CNT_A] + meta[:, M_CNT_D]) > 0
    chunk = torch.arange(R, device=state.device) // cb
    copy = (ident & busy)[chunk]
    out[:, copy] = state[:, copy]
    move = ~ident[chunk]
    alive = (state[ROW_ALIVE] != 0) & move
    dead = (state[ROW_DEAD] != 0) & move
    dst_a = meta[:, M_OFF_A].long()[chunk] + _ranks(alive, cb).reshape(R)
    out[:ROW_CODE, dst_a[alive]] = state[:ROW_CODE, alive]
    dst_d = meta[:, M_OFF_D].long()[chunk] + _ranks(dead, cb).reshape(R)
    dead_arr[:, dst_d[dead]] = state[ROW_ACC:ROW_ACC + PAYLOAD_ROWS, dead]
    cnt_d = meta[:, M_CNT_D].long()
    lane = torch.arange(cb, device=state.device)[None]
    pad = ((lane >= cnt_d[:, None])
           & (lane < meta[:, M_CASE_D].long()[:, None] * ALIGN)
           & ~ident[:, None])
    dead_arr[:, (meta[:, M_OFF_D].long()[:, None] + lane)[pad]] = 0.0
    return out, dead_arr


def expand(y, dead_arr, masks, meta, cb: int):
    rows, R = y.shape
    ident = meta[:, M_IDENT] != 0
    cnt_a = meta[:, M_CNT_A]
    cnt_d = meta[:, M_CNT_D]
    lanes = torch.arange(R, device=y.device)
    chunk = lanes // cb
    lane = lanes % cb
    alive = masks[0] != 0
    dead = masks[1] != 0
    src_a = meta[:, M_OFF_A].long()[chunk] + _ranks(alive, cb).reshape(R)
    src_d = meta[:, M_OFF_D].long()[chunk] + _ranks(dead, cb).reshape(R)
    full_d = (cnt_d == cb)[chunk]
    src_d = torch.where(full_d, meta[:, M_OFF_D].long()[chunk] + lane, src_d)
    busy = ((cnt_a + cnt_d) > 0)[chunk] & ~ident[chunk]
    take_d = busy & (full_d | (~alive & dead))
    take_a = busy & ~full_d & alive
    out = torch.zeros_like(y)
    out[:, take_a] = y[:, src_a[take_a]]
    out[:, take_d] = dead_arr[:rows, src_d[take_d]]
    keep = ident[chunk]
    out[:, keep] = y[:, keep]
    return out
