"""B1: exact packet cull of ray chunks against page AABBs; B13: the same
cull with each chunk's pages sorted in the kernel; and the XLA path's
interval-arithmetic culls.

Counterpart: `rust_raytrace_tpu/ops/cull_pallas.py:cull_mask_exact_pallas`
(and its XLA form `ops/cull.py:cull_mask_exact`) and `cull_sorted_pallas`.
`cull_mask_exact` and `cull_sorted` run the CUDA kernels of `csrc/cull.cu`
on CUDA tensors and `cull_mask_exact_plain` / `cull_sorted_plain` on CPU
tensors; chip_smoke.py holds each pair equal on the card.
`chunk_bounds`, `cull_mask`, `cull_mask_tmin` and their octant forms are
the JAX package's `ops/cull.py` functions of the same names, in torch ops,
and so is `ray_aabb_hits`, the exact per-ray slab test that is the oracle
for the culls' conservativeness.
"""

import torch

from ..utils import native

BIG = 1e30

#: pairs (ray x page) a plain-version block may hold at once
_PLAIN_BLOCK = 1 << 22


def slab_inv(d: torch.Tensor) -> torch.Tensor:
    """Slab reciprocal: 1/d, or +-BIG where a direction component is 0."""
    return torch.where(d != 0.0, torch.reciprocal(d),
                       torch.where(d >= 0.0, BIG, -BIG))


def slab(lo, hi, o, inv):
    """Slab interval (tlo, thi) of boxes lo/hi [..., 3] against rays o/inv
    given per axis as broadcastable tensors (index k on the last box dim)."""
    tlo = thi = None
    for k in range(3):
        t1 = (lo[k] - o[k]) * inv[k]
        t2 = (hi[k] - o[k]) * inv[k]
        alo = torch.minimum(t1, t2)
        ahi = torch.maximum(t1, t2)
        tlo = alo if tlo is None else torch.maximum(tlo, alo)
        thi = ahi if thi is None else torch.minimum(thi, ahi)
    return tlo, thi


def _chunk_page_reduce(ot, dt, valid, blo, bhi, ray_chunk: int,
                       miss: float):
    """Per (chunk, page): whether a valid ray of the chunk hits the page's
    slab, and the min over the chunk's rays of max(tlo, 0) on a hit and
    `miss` on a miss: ([NC, NP] bool, [NC, NP] float32)."""
    RB = ray_chunk
    R = ot.shape[1]
    NC = R // RB
    NP = blo.shape[0]
    mask = torch.empty((NC, NP), dtype=torch.bool, device=ot.device)
    emin = torch.empty((NC, NP), dtype=torch.float32, device=ot.device)
    step = max(1, _PLAIN_BLOCK // (RB * NP))
    lo = [blo[:, k][None, :, None] for k in range(3)]     # [1, NP, 1]
    hi = [bhi[:, k][None, :, None] for k in range(3)]
    for c0 in range(0, NC, step):
        c1 = min(NC, c0 + step)
        rays = slice(c0 * RB, c1 * RB)
        o = [ot[k, rays].reshape(c1 - c0, 1, RB) for k in range(3)]
        inv = [slab_inv(dt[k, rays]).reshape(c1 - c0, 1, RB)
               for k in range(3)]
        v = valid[rays].reshape(c1 - c0, 1, RB)
        tlo, thi = slab(lo, hi, o, inv)                   # [c, NP, RB]
        hit = (tlo <= thi) & (thi >= 0.0) & v
        entry = torch.where(hit, torch.clamp(tlo, min=0.0), miss)
        mask[c0:c1] = hit.any(dim=2)
        emin[c0:c1] = entry.amin(dim=2)
    return mask, emin


def cull_mask_exact_plain(ot, dt, valid, blo, bhi, ray_chunk: int,
                          chunk_live=None):
    """Plain torch version of `cull_mask_exact`."""
    mask, emin = _chunk_page_reduce(ot, dt, valid, blo, bhi, ray_chunk,
                                    torch.inf)
    if chunk_live is not None:
        mask = mask & (chunk_live != 0)[:, None]
    # a -0 entry (an origin on the box's face) is +0, as XLA's max(tlo, 0)
    emin = torch.where(emin == 0.0, 0.0, emin)
    return mask, torch.where(mask, emin, torch.inf)


def cull_mask_exact(ot, dt, valid, blo, bhi, ray_chunk: int,
                    chunk_live=None):
    """Which pages each ray chunk can hit, and its nearest entry distance.

    ot, dt: [3, R] float32 (rows of the ray state are fine: the last dim
    must be contiguous); valid: [R] bool; blo/bhi: [NP, 3] page AABBs;
    chunk_live: optional [NC] int32 flags, a chunk marked 0 gets an empty
    mask with no slab test (None: every chunk live).  Returns ([NC, NP]
    bool mask, [NC, NP] float32 tmin, +inf on a miss), NC = R // ray_chunk.
    """
    dev = ot.device
    if dev.type == "cpu":
        return cull_mask_exact_plain(ot, dt, valid, blo, bhi, ray_chunk,
                                     chunk_live)
    native.require(dev.type == "cuda",
                   f"cull_mask_exact: no kernel for device {dev}")
    R = ot.shape[1]
    NP = blo.shape[0]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    native.check_tensor("valid", valid, dev, (R,), torch.bool)
    native.check_tensor("blo", blo, dev, (NP, 3), torch.float32)
    native.check_tensor("bhi", bhi, dev, (NP, 3), torch.float32)
    NC = R // ray_chunk
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev, (NC,),
                            torch.int32)
    mask = torch.empty((NC, NP), dtype=torch.bool, device=dev)
    tmin = torch.empty((NC, NP), dtype=torch.float32, device=dev)
    native.CULL(ot.data_ptr(), dt.data_ptr(), ot.stride(0), valid.data_ptr(),
                blo.data_ptr(), bhi.data_ptr(), NP, NC, ray_chunk,
                0 if chunk_live is None else chunk_live.data_ptr(),
                mask.data_ptr(), tmin.data_ptr(), native.stream(dev))
    return mask, tmin


#: B13's key of a page no ray of the chunk hits (the JAX package's finite
#: BIGT, cull_pallas.py:42)
BIGT = 3.0e38


def cull_sorted_plain(ot, dt, valid, blo, bhi, ray_chunk: int,
                      chunk_live=None):
    """Plain torch version of `cull_sorted`."""
    R = ot.shape[1]
    NC = R // ray_chunk
    NP = blo.shape[0]
    NPpad = -(-NP // 128) * 128
    hit, emin = _chunk_page_reduce(ot, dt, valid, blo, bhi, ray_chunk, BIGT)
    key = torch.full((NC, NPpad), BIGT, dtype=torch.float32, device=ot.device)
    # the TPU kernel extracts the keys with one-hot sums: -0 comes out +0
    key[:, :NP] = torch.where(hit, torch.where(emin == 0.0, 0.0, emin), BIGT)
    ptmin, plist = torch.sort(key, dim=1, stable=True)
    counts = hit.sum(dim=1, dtype=torch.int32)
    plist = plist.to(torch.int32)
    if chunk_live is not None:
        dead = (chunk_live == 0)[:, None]
        counts = torch.where(dead[:, 0], 0, counts)
        plist = torch.where(dead, 0, plist)
        ptmin = torch.where(dead, BIGT, ptmin)
    return counts, plist, ptmin


def cull_sorted(ot, dt, valid, blo, bhi, ray_chunk: int, chunk_live=None):
    """B13: the exact cull with each chunk's pages sorted front to back.

    ot, dt, valid, blo, bhi, ray_chunk: as `cull_mask_exact`; chunk_live:
    optional [NC] int32, chunks flagged 0 are dead.  A page's key is the
    least max(tlo, 0) over the chunk's valid rays that hit it, BIGT where
    none does (and for the padding pages NP..NPpad, NPpad = NP rounded up
    to 128).  Returns (counts [NC] int32, the pages hit; plist [NC, NPpad]
    int32, the pages by (key, page index); ptmin [NC, NPpad] float32, their
    keys); a dead chunk gets count 0, plist 0 and ptmin BIGT.  The engine
    takes the split form (`cull_mask_exact`, then `engine.page_lists`), as
    the JAX engine does: no render path calls this.
    """
    dev = ot.device
    if dev.type == "cpu":
        return cull_sorted_plain(ot, dt, valid, blo, bhi, ray_chunk,
                                 chunk_live)
    native.require(dev.type == "cuda",
                   f"cull_sorted: no kernel for device {dev}")
    R = ot.shape[1]
    NP = blo.shape[0]
    NPpad = -(-NP // 128) * 128
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("ot", ot, dev, (3, R), torch.float32, False)
    native.check_tensor("dt", dt, dev, (3, R), torch.float32, False)
    native.require(ot.stride(0) == dt.stride(0),
                   "ot and dt need one row stride")
    native.check_tensor("valid", valid, dev, (R,), torch.bool)
    native.check_tensor("blo", blo, dev, (NP, 3), torch.float32)
    native.check_tensor("bhi", bhi, dev, (NP, 3), torch.float32)
    NC = R // ray_chunk
    if chunk_live is not None:
        native.check_tensor("chunk_live", chunk_live, dev, (NC,),
                            torch.int32)
    counts = torch.empty((NC,), dtype=torch.int32, device=dev)
    plist = torch.empty((NC, NPpad), dtype=torch.int32, device=dev)
    ptmin = torch.empty((NC, NPpad), dtype=torch.float32, device=dev)
    native.CULL_SORTED(
        ot.data_ptr(), dt.data_ptr(), ot.stride(0), valid.data_ptr(),
        blo.data_ptr(), bhi.data_ptr(), NP, NPpad, NC, ray_chunk,
        0 if chunk_live is None else chunk_live.data_ptr(),
        counts.data_ptr(), plist.data_ptr(), ptmin.data_ptr(),
        native.stream(dev))
    return counts, plist, ptmin


# The interval-arithmetic culls of the JAX package's XLA path
# (`rust_raytrace_tpu/ops/cull.py`): torch glue on any device, not kernels.
# `Engine(exact_cull=False)` culls wave 0 with one bound per chunk and the
# bounce waves with one per direction octant; the legacy loop's shadow rays
# always take the octant form.

def chunk_bounds(ot, dt, valid, ray_chunk: int):
    """Per-chunk origin and direction AABBs of the valid rays: (olo, ohi,
    dlo, dhi), each [NC, 3]; a chunk with no valid ray gets inverted
    bounds, which fail every page test.  ot, dt: [3, R]; valid: [R] bool."""
    R = ot.shape[1]
    NC = R // ray_chunk
    o = ot.reshape(3, NC, ray_chunk)
    d = dt.reshape(3, NC, ray_chunk)
    v = valid.reshape(1, NC, ray_chunk)
    return (torch.where(v, o, torch.inf).amin(dim=-1).T,
            torch.where(v, o, -torch.inf).amax(dim=-1).T,
            torch.where(v, d, torch.inf).amin(dim=-1).T,
            torch.where(v, d, -torch.inf).amax(dim=-1).T)


def cull_mask(olo, ohi, dlo, dhi, blo, bhi):
    """[NC, NP] bool: whether some ray of a chunk's bounds can enter a page
    (the mask half of `cull_mask_tmin`)."""
    return cull_mask_tmin(olo, ohi, dlo, dhi, blo, bhi)[0]


def cull_mask_tmin(olo, ohi, dlo, dhi, blo, bhi):
    """([NC, NP] bool, [NC, NP] float32): whether some ray of a chunk's
    bounds can enter a page, and a lower bound of its entry distance (+inf
    where not).  Per axis, the interval of t at which t*d, d in [dlo, dhi],
    reaches the Minkowski-expanded box [blo - ohi, bhi - olo]; the chunk
    hits the page iff the three intervals intersect."""
    blo_e = blo[None, :, :] - ohi[:, None, :]
    bhi_e = bhi[None, :, :] - olo[:, None, :]
    dlo_e = dlo[:, None, :].expand(blo_e.shape)
    dhi_e = dhi[:, None, :].expand(blo_e.shape)
    overlap0 = (blo_e <= 0) & (bhi_e >= 0)
    pos_ok = dhi_e > 0
    pos_tlo = blo_e / dhi_e
    pos_thi = torch.where(dlo_e > 0, bhi_e / dlo_e, torch.inf)
    neg_ok = dlo_e < 0
    neg_tlo = bhi_e / dlo_e
    neg_thi = torch.where(dhi_e < 0, blo_e / dhi_e, torch.inf)
    pos_case = blo_e > 0
    feasible = overlap0 | torch.where(pos_case, pos_ok, neg_ok)
    tlo = torch.where(overlap0, 0.0, torch.where(pos_case, pos_tlo, neg_tlo))
    thi = torch.where(overlap0, torch.inf,
                      torch.where(pos_case, pos_thi, neg_thi))
    tlo = torch.where(feasible, tlo, torch.inf)
    thi = torch.where(feasible, thi, -torch.inf)
    tmin = tlo.amax(dim=-1)
    hit = (tmin <= thi.amin(dim=-1)) & feasible.all(dim=-1)
    return hit, torch.where(hit, tmin, torch.inf)


def chunk_bounds_octants(ot, dt, valid, ray_chunk: int):
    """`chunk_bounds` per direction octant (the sign pattern of d), so each
    sub-bundle's direction box is sign-definite: four [8, NC, 3] tensors."""
    R = ot.shape[1]
    NC = R // ray_chunk
    o = ot.reshape(3, NC, ray_chunk)
    d = dt.reshape(3, NC, ray_chunk)
    v = valid.reshape(1, NC, ray_chunk)
    oct_id = ((d[0:1] < 0).int() + 2 * (d[1:2] < 0).int()
              + 4 * (d[2:3] < 0).int())
    out = ([], [], [], [])
    for q in range(8):
        vq = v & (oct_id == q)
        out[0].append(torch.where(vq, o, torch.inf).amin(dim=-1).T)
        out[1].append(torch.where(vq, o, -torch.inf).amax(dim=-1).T)
        out[2].append(torch.where(vq, d, torch.inf).amin(dim=-1).T)
        out[3].append(torch.where(vq, d, -torch.inf).amax(dim=-1).T)
    return tuple(torch.stack(b) for b in out)


def cull_mask_tmin_octants(olo8, ohi8, dlo8, dhi8, blo, bhi):
    """The octant-split cull: a page survives if any octant's bounds hit
    it, with the least entry bound of those octants."""
    nc = olo8.shape[1]
    hit8, tmin8 = cull_mask_tmin(
        olo8.reshape(8 * nc, 3), ohi8.reshape(8 * nc, 3),
        dlo8.reshape(8 * nc, 3), dhi8.reshape(8 * nc, 3), blo, bhi)
    hit8 = hit8.reshape(8, nc, -1)
    tmin8 = tmin8.reshape(8, nc, -1)
    hit = hit8.any(dim=0)
    tmin = torch.where(hit8, tmin8, torch.inf).amin(dim=0)
    return hit, torch.where(hit, tmin, torch.inf)


def ray_aabb_hits(o, d, blo, bhi):
    """[R, NP] bool: the exact slab test of each ray against each box (the
    test oracle for the culls' conservativeness; the reference's slab test
    is BoundingBox::collides, raytrace.rs:861-907).  o, d: [R, 3]; blo,
    bhi: [NP, 3].

    In the JAX package's order of operations: inv = 1/d, +-inf where d is
    0 (+inf for -0); per axis t = (b - o) * inv, two roundings, no fused
    multiply-add; an axis with d == 0 admits every t when o lies in the
    slab (its faces included) and none otherwise; the max of the entries
    and the min of the exits.  A hit: tmin <= tmax and tmax >= 0.  Runs in
    blocks of rays, which changes no bit."""
    R = o.shape[0]
    NP = blo.shape[0]
    out = torch.empty((R, NP), dtype=torch.bool, device=o.device)
    step = max(1, _PLAIN_BLOCK // max(NP, 1))
    for r0 in range(0, R, step):
        ob, db = o[r0:r0 + step, None, :], d[r0:r0 + step, None, :]
        inv = torch.where(db != 0, torch.reciprocal(db),
                          torch.where(db >= 0, torch.inf, -torch.inf))
        t1 = (blo[None] - ob) * inv                       # [n, NP, 3]
        t2 = (bhi[None] - ob) * inv
        zero = db == 0
        inside = (ob >= blo[None]) & (ob <= bhi[None])
        tlo = torch.where(zero, torch.where(inside, -torch.inf, torch.inf),
                          torch.minimum(t1, t2))
        thi = torch.where(zero, torch.where(inside, torch.inf, -torch.inf),
                          torch.maximum(t1, t2))
        tmin = tlo.amax(dim=-1)
        tmax = thi.amin(dim=-1)
        out[r0:r0 + step] = (tmin <= tmax) & (tmax >= 0)
    return out
