"""B3 and B5: wavefront compaction and its inverse.

Counterpart: `rust_raytrace_tpu/ops/compact.py` — the constants,
`dead_capacity`, `make_dead_array`, `compact_meta` (in torch ops, on the
device, with no host sync), `compact_pallas` (B3) and `expand_pallas` (B5).
`compact` and `expand` run the CUDA kernels of `csrc/compact.cu` on CUDA
tensors and `compact_plain` / `expand_plain` on CPU tensors.  The bucketed
variants (B14: `compact_meta_buckets`, `compact_buckets` and
`expand_buckets`, kernels in `csrc/compact_buckets.cu`) are here too; no
render path calls them, as in the JAX package.  So are the JAX module's
numpy oracles, `compact_oracle`, `expand_oracle`, `compact_oracle_buckets`
and `expand_oracle_buckets`: the port keeps its own copies.

After a wave, compaction moves each chunk's surviving rays (alive row set)
to a dense prefix of a fresh state array, in chunk order and lane order
within a chunk, each chunk's segment padded to 128 lanes, and harvests the
payload rows 8..15 (accumulated color, retired flag, spares) of its retired
rays into a dead array at the same kind of offsets.  The next waves then
run on the prefix only, and the scatter hash, which keys on a ray's chunk
and lane, sees the JAX package's layout exactly (ROADMAP C3).  At the end,
`expand` walks the boundaries backward and puts every ray's payload back at
its original lane.  When the padded survivors would not fit in R lanes, the
boundary becomes an identity pass-through (column M_IDENT) and harvests
nothing; the retired flag is cumulative, so no ray is lost.  With
`gate_frac` a boundary also becomes the identity when its padded survivors
exceed that share of the state's current content (`compact_meta`): the
wave loop decides on the device, with no host sync, whether a boundary
pays.
"""

import numpy as np
import torch

from ..utils import native
from .state import ROW_ACC, ROW_ALIVE, ROW_DEAD, STATE_ROWS

#: compaction chunk (independent of the trace ray_chunk)
DEFAULT_CB = 512
ALIGN = 128
#: state rows a survivor carries (12..15 are spare and stay zero)
ROW_CODE = 12
#: rows of the dead array: state rows 8..15 of a retired ray
PAYLOAD_ROWS = 8

#: meta columns (int32)
M_CNT_A, M_CASE_A, M_OFF_A, M_CNT_D, M_CASE_D, M_OFF_D, M_IDENT = range(7)
META_COLS = 8


def dead_capacity(R: int, boundaries: int = 0, cb: int = DEFAULT_CB) -> int:
    """Dead-array lanes: 2R, as the JAX package sizes it, or more where
    `boundaries` compactions of R // cb chunks could need it.  A ray
    retires once, and each boundary pads each chunk's dead segment by at
    most 127 lanes; the JAX package's 2R assumes few boundaries of many
    rays per chunk.  The layout does not depend on the capacity."""
    need = R + boundaries * (R // cb) * (ALIGN - 1)
    return max(2 * R, -(-need // ALIGN) * ALIGN)


def make_dead_array(R: int, device="cpu", boundaries: int = 0,
                    cb: int = DEFAULT_CB) -> torch.Tensor:
    """The [8, dead_capacity] float32 dead-ray harvest buffer, zeros."""
    return torch.zeros((PAYLOAD_ROWS, dead_capacity(R, boundaries, cb)),
                       dtype=torch.float32, device=device)


def pick_cb(R: int, cb: int = DEFAULT_CB) -> int:
    """The compaction chunk for R rays: DEFAULT_CB halved until it divides
    R, and at least 128 (the JAX engine's rule; R is a multiple of 128)."""
    while R % cb:
        cb //= 2
    return max(cb, ALIGN)


def compact_meta(alive, dead, cb: int, dead_base, R: int, prefix=None,
                 gate_frac=None):
    """Per-chunk counts and offsets of one boundary.

    alive, dead: [R] (nonzero = set); dead_base: int32 scalar tensor, the
    dead array's first free lane.  Returns (meta [R // cb, META_COLS] int32,
    total_a, skip, dead_end): total_a the lanes of the padded survivor
    prefix, skip whether the boundary becomes an identity pass-through
    (column M_IDENT), dead_end = dead_base + this boundary's padded dead
    lanes.  All tensors stay on alive's device.

    The boundary skips when it overflows (total_a > R) and, with gate_frac
    set, when it would not pay: total_a > gate_frac * prefix, prefix the
    int32 scalar tensor of the lanes the state's content spans (None: R).
    Both sides of that comparison are float32, as in the JAX package:
    gate_frac rounds to float32 first and the product rounds in float32
    (a float64 product flips the decision at the edge).
    """
    NC = R // cb
    cnt_a = (alive.reshape(NC, cb) != 0).sum(dim=1, dtype=torch.int32)
    cnt_d = (dead.reshape(NC, cb) != 0).sum(dim=1, dtype=torch.int32)
    pad_a = (cnt_a + (ALIGN - 1)) // ALIGN * ALIGN
    pad_d = (cnt_d + (ALIGN - 1)) // ALIGN * ALIGN
    cs_a = torch.cumsum(pad_a, dim=0, dtype=torch.int32)
    cs_d = torch.cumsum(pad_d, dim=0, dtype=torch.int32)
    base = dead_base.to(torch.int32)
    off_a = cs_a - pad_a
    off_d = base + cs_d - pad_d
    total_a = cs_a[-1]
    dead_end = base + cs_d[-1]
    skip = total_a > R
    if gate_frac is not None:
        pref_f = (torch.full((), R, dtype=torch.float32, device=alive.device)
                  if prefix is None else prefix.to(torch.float32))
        frac = torch.full((), float(np.float32(gate_frac)),
                          dtype=torch.float32, device=alive.device)
        skip = skip | (total_a.to(torch.float32) > frac * pref_f)
    ident = skip.to(torch.int32).expand(NC)
    meta = torch.stack([cnt_a, pad_a // ALIGN, off_a, cnt_d, pad_d // ALIGN,
                        off_d, ident, torch.zeros_like(cnt_a)], dim=1)
    return meta, total_a, skip, dead_end


def _ranks(mask, cb: int):
    """Exclusive rank of each set lane among its chunk's set lanes: [NC, cb]
    int64."""
    m = mask.reshape(-1, cb).to(torch.int64)
    return torch.cumsum(m, dim=1) - m


def compact_plain(state, dead_arr, meta, cb: int, grid_live=None):
    """Plain torch version of `compact` (grid_live only bounds the work of
    the kernel: chunks past it hold no ray, so both write nothing there)."""
    del grid_live
    R = state.shape[1]
    out = torch.zeros_like(state)
    ident = meta[:, M_IDENT] != 0
    busy = (meta[:, M_CNT_A] + meta[:, M_CNT_D]) > 0
    lanes = torch.arange(R, device=state.device)
    chunk = lanes // cb
    copy = (ident & busy)[chunk]
    out[:, copy] = state[:, copy]

    move = ~ident[chunk]
    alive = (state[ROW_ALIVE] != 0) & move
    dead = (state[ROW_DEAD] != 0) & move
    dst_a = meta[:, M_OFF_A].long()[chunk] + _ranks(alive, cb).reshape(R)
    out[:ROW_CODE, dst_a[alive]] = state[:ROW_CODE, alive]
    dst_d = meta[:, M_OFF_D].long()[chunk] + _ranks(dead, cb).reshape(R)
    dead_arr[:, dst_d[dead]] = state[ROW_ACC:ROW_ACC + PAYLOAD_ROWS, dead]
    # the dead segments' padding lanes
    cnt_d = meta[:, M_CNT_D].long()
    lane = torch.arange(cb, device=state.device)[None]
    pad = ((lane >= cnt_d[:, None]) & (lane < meta[:, M_CASE_D].long()[:, None]
                                       * ALIGN) & ~ident[:, None])
    dead_arr[:, (meta[:, M_OFF_D].long()[:, None] + lane)[pad]] = 0.0
    return out, dead_arr


def compact(state, dead_arr, meta, cb: int, grid_live=None):
    """Apply one boundary's compaction.

    state: [16, R] float32 ray state (ops/state.py); dead_arr: [8, RD]
    float32, updated in place; meta: `compact_meta` of this state;
    grid_live: optional int32 scalar tensor, the lane extent of the state's
    content (the previous boundary's survivor prefix).  Returns (new state
    [16, R]: the survivor prefix, zeros elsewhere; dead_arr)."""
    dev = state.device
    if dev.type == "cpu":
        return compact_plain(state, dead_arr, meta, cb, grid_live)
    native.require(dev.type == "cuda", f"compact: no kernel for device {dev}")
    R = state.shape[1]
    RD = dead_arr.shape[1]
    _check(dev, R, cb, meta, grid_live)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("dead_arr", dead_arr, dev, (PAYLOAD_ROWS, RD),
                        torch.float32)
    out = torch.zeros_like(state)
    native.COMPACT(state.data_ptr(), out.data_ptr(), dead_arr.data_ptr(), R,
                   RD, meta.data_ptr(), cb, _ptr(grid_live),
                   native.stream(dev))
    return out, dead_arr


def expand_plain(y, dead_arr, masks, meta, cb: int, grid_live=None):
    """Plain torch version of `expand`; it writes every lane, where the
    kernel leaves the lanes past grid_live unwritten."""
    del grid_live
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


def expand(y, dead_arr, masks, meta, cb: int, grid_live=None):
    """Reverse one boundary's compaction for the payload rows.

    y: [rows, R] float32 (rows <= 8, the leading rows of the state's rows
    8..15) in post-compaction order; dead_arr: [8, RD]; masks: [2, R]
    float32, the alive and retired rows recorded before the boundary; meta:
    that boundary's.  grid_live: optional int32 scalar tensor, the lane
    extent of the rays before this boundary; the kernel leaves the lanes
    past it unwritten (garbage), so pass it only when nothing reads there.
    Returns [rows, R] in pre-compaction order."""
    dev = y.device
    if dev.type == "cpu":
        return expand_plain(y, dead_arr, masks, meta, cb, grid_live)
    native.require(dev.type == "cuda", f"expand: no kernel for device {dev}")
    rows, R = y.shape
    RD = dead_arr.shape[1]
    _check(dev, R, cb, meta, grid_live)
    native.require(1 <= rows <= PAYLOAD_ROWS, f"expand: {rows} rows")
    native.check_tensor("y", y, dev, (rows, R), torch.float32)
    native.check_tensor("dead_arr", dead_arr, dev, (PAYLOAD_ROWS, RD),
                        torch.float32)
    native.check_tensor("masks", masks, dev, (2, R), torch.float32)
    out = torch.empty_like(y)
    native.EXPAND(y.data_ptr(), dead_arr.data_ptr(), masks.data_ptr(),
                  out.data_ptr(), rows, R, RD, meta.data_ptr(), cb,
                  _ptr(grid_live), native.stream(dev))
    return out


def _check(dev, R, cb, meta, grid_live):
    native.require(cb % 32 == 0 and ALIGN <= cb <= 1024 and R % cb == 0,
                   f"cb {cb} must be a multiple of 32 in [128, 1024] "
                   f"dividing R = {R}")
    native.check_tensor("meta", meta, dev, (R // cb, META_COLS), torch.int32)
    if grid_live is not None:
        native.check_tensor("grid_live", grid_live, dev, (), torch.int32)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


# numpy oracles of one boundary (the JAX module's, copied): a chunk at a
# time, in the order the layout is defined, for differential tests.

def compact_oracle(state, dead_arr, cb: int, dead_base: int):
    """numpy reference of one forward compaction.  state: [16, R];
    dead_arr: [8, RD], the payload rows 8..15 of retired rays.  Returns
    (new_state, new_dead, meta, total_a, overflow, dead_end).

    On an overflowing (identity) boundary it copies the whole state, where
    `compact` copies only the chunks that hold a live or retired ray and
    leaves the others zero: the two agree on every live and retired lane,
    not on an identity boundary's empty chunks."""
    state = np.asarray(state)
    R = state.shape[1]
    NC = R // cb
    alive = state[ROW_ALIVE] != 0
    dead = state[ROW_DEAD] != 0
    new_state = np.zeros_like(state)
    new_dead = np.array(dead_arr, copy=True)
    meta = np.zeros((NC, META_COLS), np.int32)
    off_a = 0
    off_d = int(dead_base)
    for c in range(NC):
        sl = slice(c * cb, (c + 1) * cb)
        ia = np.nonzero(alive[sl])[0] + c * cb
        idd = np.nonzero(dead[sl])[0] + c * cb
        cnt_a, cnt_d = len(ia), len(idd)
        pad_a = -(-cnt_a // ALIGN) * ALIGN
        pad_d = -(-cnt_d // ALIGN) * ALIGN
        meta[c] = [cnt_a, pad_a // ALIGN, off_a,
                   cnt_d, pad_d // ALIGN, off_d, 0, 0]
        if off_a + cnt_a <= R:
            new_state[:, off_a:off_a + cnt_a] = state[:, ia]
            # survivors do not carry the spare rows 12..15
            new_state[ROW_CODE:, off_a:off_a + cnt_a] = 0.0
        new_dead[:, off_d:off_d + cnt_d] = state[ROW_ACC:ROW_ACC
                                                 + PAYLOAD_ROWS, idd]
        off_a += pad_a
        off_d += pad_d
    overflow = off_a > R
    if overflow:
        # identity pass-through (M_IDENT): nothing moves, nothing harvested
        meta[:, M_IDENT] = 1
        new_state = state.copy()
        new_dead = np.array(dead_arr, copy=True)
    return new_state, new_dead, meta, off_a, overflow, off_d


def expand_oracle(y, dead_arr, alive, dead, meta, cb: int):
    """numpy reference of one boundary's inverse for the 8-row payload:
    y [8, R] in post-compaction order, alive and dead [R] the masks before
    the boundary.  Returns [8, R], zero on the lanes that are neither."""
    y = np.asarray(y)
    R = y.shape[1]
    out = np.zeros((PAYLOAD_ROWS, R), y.dtype)
    for c in range(R // cb):
        sl = slice(c * cb, (c + 1) * cb)
        ia = np.nonzero(np.asarray(alive[sl]) != 0)[0] + c * cb
        idd = np.nonzero(np.asarray(dead[sl]) != 0)[0] + c * cb
        off_a = meta[c, M_OFF_A]
        off_d = meta[c, M_OFF_D]
        out[:, ia] = y[:, off_a:off_a + len(ia)]
        out[:, idd] = np.asarray(dead_arr)[:, off_d:off_d + len(idd)]
    return out


# The bucketed ("ray sorting") variant, B14: survivors grouped bucket-major
# by the code in state row ROW_CODE (0 gap, 1 retired, 2 + q alive in
# bucket q), each (chunk, bucket) segment 128-aligned.  The JAX package
# measured it slower end to end on the TPU (the alignment padding of eight
# segments a chunk inflates the prefix) and wires it into no render path;
# neither does the port.

#: alive buckets (direction octants)
NB = 8
#: meta columns: [cnt, case, off] per bucket, then the dead segment's, then
#: the busy flag
META9_COLS = 32
M9_DEAD = 3 * NB
M9_BUSY = 27


def compact_meta_buckets(code, cb: int, dead_base, R: int):
    """Per-chunk, per-bucket counts and offsets of one bucketed boundary.

    code: [R] float32 codes; dead_base: int32 scalar tensor.  Returns (meta
    [R // cb, META9_COLS] int32, total_a, overflow, dead_end): total_a the
    lanes of the padded survivor prefix, overflow whether it exceeds R
    (then the JAX engine would not compact), dead_end = dead_base + this
    boundary's padded dead lanes.  All tensors stay on code's device; no
    host sync."""
    NC = R // cb
    codes = code.reshape(NC, 1, cb)
    q = torch.arange(2, 2 + NB, device=code.device, dtype=torch.float32)
    cnt_q = (codes == q[None, :, None]).sum(dim=2, dtype=torch.int32)
    cnt_d = (codes[:, 0] == 1.0).sum(dim=1, dtype=torch.int32)
    pad_q = (cnt_q + (ALIGN - 1)) // ALIGN * ALIGN
    pad_d = (cnt_d + (ALIGN - 1)) // ALIGN * ALIGN
    tot_q = pad_q.sum(dim=0, dtype=torch.int32)                  # [NB]
    base_q = torch.cumsum(tot_q, dim=0, dtype=torch.int32) - tot_q
    within = torch.cumsum(pad_q, dim=0, dtype=torch.int32) - pad_q
    off_q = base_q[None, :] + within
    cs_d = torch.cumsum(pad_d, dim=0, dtype=torch.int32)
    base = dead_base.to(torch.int32)
    off_d = base + cs_d - pad_d
    dead_end = base + cs_d[-1]
    total_a = tot_q.sum(dtype=torch.int32)
    overflow = total_a > R
    busy = ((cnt_q.sum(dim=1) + cnt_d) > 0).to(torch.int32)
    cols = []
    for b in range(NB):
        cols += [cnt_q[:, b], pad_q[:, b] // ALIGN, off_q[:, b]]
    cols += [cnt_d, pad_d // ALIGN, off_d, busy]
    meta = torch.zeros((NC, META9_COLS), dtype=torch.int32,
                       device=code.device)
    meta[:, :len(cols)] = torch.stack(cols, dim=1)
    return meta, total_a, overflow, dead_end


def _bucket_lanes(code, meta, cb: int, R: int, RD: int):
    """The lanes of busy chunks in a bucket (mask columns 0..NB-1) or
    retired (column NB): (masks [R, NB + 1] bool, each lane's position in
    its segment [R] int64, and whether its segment ends within its array:
    R lanes for a bucket's, RD for the dead one's, [R, NB + 1] bool)."""
    chunk = torch.arange(R, device=code.device) // cb
    q = torch.tensor([2.0 + b for b in range(NB)] + [1.0],
                     device=code.device)
    busy = (meta[:, M9_BUSY] != 0)[chunk]
    masks = (code[:, None] == q[None]) & busy[:, None]           # [R, 9]
    m = masks.reshape(R // cb, cb, NB + 1).to(torch.int64)
    rank = (torch.cumsum(m, dim=1) - m).reshape(R, NB + 1)
    cols = [3 * b for b in range(NB)] + [M9_DEAD]
    cnt = meta[:, cols].long()
    end = meta[:, [c + 2 for c in cols]].long() + ALIGN * meta[
        :, [c + 1 for c in cols]].long()
    limit = torch.tensor([R] * NB + [RD], device=code.device)
    fits = ((cnt > 0) & (end <= limit))[chunk]                   # [R, 9]
    pos = (meta[:, [c + 2 for c in cols]].long()[chunk] + rank).gather(
        1, masks.long().argmax(dim=1, keepdim=True))[:, 0]
    return masks & fits, pos


def compact_buckets_plain(state, dead_arr, meta, cb: int):
    """Plain torch version of `compact_buckets`."""
    R = state.shape[1]
    RD = dead_arr.shape[1]
    out = torch.zeros_like(state)
    moves, dst = _bucket_lanes(state[ROW_CODE], meta, cb, R, RD)
    alive = moves[:, :NB].any(dim=1)
    out[:, dst[alive]] = state[:, alive]
    dead = moves[:, NB]
    dead_arr[:, dst[dead]] = state[ROW_ACC:ROW_ACC + PAYLOAD_ROWS, dead]
    # the padding lanes of the dead segments that are written
    cnt_d = meta[:, M9_DEAD].long()
    off_d = meta[:, M9_DEAD + 2].long()
    pad_d = meta[:, M9_DEAD + 1].long() * ALIGN
    lane = torch.arange(cb, device=state.device)[None]
    pad = ((lane >= cnt_d[:, None]) & (lane < pad_d[:, None])
           & ((cnt_d > 0) & (off_d + pad_d <= RD))[:, None])
    dead_arr[:, (off_d[:, None] + lane)[pad]] = 0.0
    return out, dead_arr


def compact_buckets(state, dead_arr, meta, cb: int):
    """B14a: apply one bucketed boundary's compaction.

    state: [16, R] float32 with the codes in row ROW_CODE; dead_arr: [8, RD]
    float32, updated in place; meta: `compact_meta_buckets` of the codes.
    Returns (new state [16, R]: each (chunk, bucket) segment at its offset,
    all 16 rows, zeros elsewhere; dead_arr).  A segment that would end past
    its array (an overflowing layout) is not written."""
    dev = state.device
    if dev.type == "cpu":
        return compact_buckets_plain(state, dead_arr, meta, cb)
    native.require(dev.type == "cuda",
                   f"compact_buckets: no kernel for device {dev}")
    R = state.shape[1]
    RD = dead_arr.shape[1]
    _check_buckets(dev, R, cb, meta)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("dead_arr", dead_arr, dev, (PAYLOAD_ROWS, RD),
                        torch.float32)
    out = torch.zeros_like(state)
    native.COMPACT_BUCKETS(state.data_ptr(), out.data_ptr(),
                           dead_arr.data_ptr(), R, RD, meta.data_ptr(), cb,
                           native.stream(dev))
    return out, dead_arr


def expand_buckets_plain(y, dead_arr, code, meta, cb: int):
    """Plain torch version of `expand_buckets`."""
    R = y.shape[1]
    moves, src = _bucket_lanes(code.reshape(R), meta, cb, R,
                               dead_arr.shape[1])
    out = torch.zeros_like(y)
    alive = moves[:, :NB].any(dim=1)
    out[:, alive] = y[:, src[alive]]
    dead = moves[:, NB]
    out[:, dead] = dead_arr[:, src[dead]]
    return out


def expand_buckets(y, dead_arr, code, meta, cb: int):
    """B14b: reverse one bucketed boundary for the 8-row payload.

    y: [8, R] float32 in post-compaction order (rows 8..15 of the state
    `compact_buckets` returned); dead_arr: [8, RD]; code: [1, R] float32,
    the codes recorded before the boundary; meta: that boundary's.  Returns
    [8, R] in pre-compaction order: each bucket lane's bits from its
    segment, each retired lane's from the dead array, 0 on gaps, on idle
    chunks and where a segment does not fit."""
    dev = y.device
    if dev.type == "cpu":
        return expand_buckets_plain(y, dead_arr, code, meta, cb)
    native.require(dev.type == "cuda",
                   f"expand_buckets: no kernel for device {dev}")
    R = y.shape[1]
    RD = dead_arr.shape[1]
    _check_buckets(dev, R, cb, meta)
    native.check_tensor("y", y, dev, (PAYLOAD_ROWS, R), torch.float32)
    native.check_tensor("dead_arr", dead_arr, dev, (PAYLOAD_ROWS, RD),
                        torch.float32)
    native.check_tensor("code", code, dev, (1, R), torch.float32)
    out = torch.empty_like(y)
    native.EXPAND_BUCKETS(y.data_ptr(), dead_arr.data_ptr(), code.data_ptr(),
                          out.data_ptr(), R, RD, meta.data_ptr(), cb,
                          native.stream(dev))
    return out


def _check_buckets(dev, R, cb, meta):
    native.require(cb % ALIGN == 0 and cb <= 1024 and R % cb == 0,
                   f"cb {cb} must be a multiple of {ALIGN} up to 1024 "
                   f"dividing R = {R}")
    native.check_tensor("meta", meta, dev, (R // cb, META9_COLS),
                        torch.int32)


def compact_oracle_buckets(state, dead_arr, cb: int, dead_base: int):
    """numpy reference of one bucketed forward compaction.  Returns
    (new_state, new_dead, meta, total_a, overflow, dead_end); a segment
    that would end past R is not written."""
    state = np.asarray(state)
    R = state.shape[1]
    NC = R // cb
    code = state[ROW_CODE]
    new_state = np.zeros_like(state)
    new_dead = np.array(dead_arr, copy=True)
    meta = np.zeros((NC, META9_COLS), np.int32)
    # the bucket-major bases
    pad_q = np.zeros((NC, NB), np.int64)
    for c in range(NC):
        sl = code[c * cb:(c + 1) * cb]
        for q in range(NB):
            cnt = int((sl == 2 + q).sum())
            pad_q[c, q] = -(-cnt // ALIGN) * ALIGN
    base = np.concatenate([[0], np.cumsum(pad_q.sum(axis=0))])[:NB]
    off_d = int(dead_base)
    offs = base.copy().astype(np.int64)
    for c in range(NC):
        sl = slice(c * cb, (c + 1) * cb)
        codes_c = code[sl]
        busy = 0
        for q in range(NB):
            idx = np.nonzero(codes_c == 2 + q)[0] + c * cb
            cnt = len(idx)
            pad = -(-cnt // ALIGN) * ALIGN
            meta[c, 3 * q:3 * q + 3] = [cnt, pad // ALIGN, offs[q]]
            if offs[q] + cnt <= R:
                new_state[:, offs[q]:offs[q] + cnt] = state[:, idx]
            offs[q] += pad
            busy += cnt
        idd = np.nonzero(codes_c == 1)[0] + c * cb
        cnt_d = len(idd)
        pad_d = -(-cnt_d // ALIGN) * ALIGN
        meta[c, M9_DEAD:M9_DEAD + 3] = [cnt_d, pad_d // ALIGN, off_d]
        new_dead[:, off_d:off_d + cnt_d] = state[ROW_ACC:ROW_ACC
                                                 + PAYLOAD_ROWS, idd]
        off_d += pad_d
        busy += cnt_d
        meta[c, M9_BUSY] = 1 if busy else 0
    total_a = int(base[NB - 1] + pad_q[:, NB - 1].sum())
    overflow = total_a > R
    return new_state, new_dead, meta, total_a, overflow, off_d


def expand_oracle_buckets(y, dead_arr, code, meta, cb: int):
    """numpy reference of one bucketed boundary's inverse: y [8, R] in
    post-compaction order, code the [R] (or [1, R]) codes before the
    boundary.  Returns [8, R], zero on gap lanes."""
    y = np.asarray(y)
    code = np.asarray(code).reshape(-1)
    R = y.shape[1]
    out = np.zeros((PAYLOAD_ROWS, R), y.dtype)
    for c in range(R // cb):
        codes_c = code[c * cb:(c + 1) * cb]
        for q in range(NB):
            idx = np.nonzero(codes_c == 2 + q)[0] + c * cb
            off = meta[c, 3 * q + 2]
            out[:, idx] = y[:, off:off + len(idx)]
        idd = np.nonzero(codes_c == 1)[0] + c * cb
        off_d = meta[c, M9_DEAD + 2]
        out[:, idd] = np.asarray(dead_arr)[:, off_d:off_d + len(idd)]
    return out
