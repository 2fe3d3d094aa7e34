"""B1: exact packet cull of ray chunks against page AABBs.

Counterpart: `rust_raytrace_tpu/ops/cull_pallas.py:cull_mask_exact_pallas`
(and its XLA form `ops/cull.py:cull_mask_exact`).  `cull_mask_exact` runs
the CUDA kernel `csrc/cull.cu` on CUDA tensors and `cull_mask_exact_plain`
on CPU tensors; chip_smoke.py holds the two equal on the card.
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


def cull_mask_exact_plain(ot, dt, valid, blo, bhi, ray_chunk: int):
    """Plain torch version of `cull_mask_exact`."""
    RB = ray_chunk
    R = ot.shape[1]
    NC = R // RB
    NP = blo.shape[0]
    mask = torch.empty((NC, NP), dtype=torch.bool, device=ot.device)
    tmin = torch.empty((NC, NP), dtype=torch.float32, device=ot.device)
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
        entry = torch.where(hit, torch.clamp(tlo, min=0.0), torch.inf)
        m = hit.any(dim=2)
        mask[c0:c1] = m
        tmin[c0:c1] = torch.where(m, entry.amin(dim=2), torch.inf)
    return mask, tmin


def cull_mask_exact(ot, dt, valid, blo, bhi, ray_chunk: int):
    """Which pages each ray chunk can hit, and its nearest entry distance.

    ot, dt: [3, R] float32 (rows of the ray state are fine: the last dim
    must be contiguous); valid: [R] bool; blo/bhi: [NP, 3] page AABBs.
    Returns ([NC, NP] bool mask, [NC, NP] float32 tmin, +inf on a miss),
    NC = R // ray_chunk.
    """
    dev = ot.device
    if dev.type == "cpu":
        return cull_mask_exact_plain(ot, dt, valid, blo, bhi, ray_chunk)
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
    mask = torch.empty((NC, NP), dtype=torch.bool, device=dev)
    tmin = torch.empty((NC, NP), dtype=torch.float32, device=dev)
    native.CULL(ot.data_ptr(), dt.data_ptr(), ot.stride(0), valid.data_ptr(),
                blo.data_ptr(), bhi.data_ptr(), NP, NC, ray_chunk,
                mask.data_ptr(), tmin.data_ptr(), native.stream(dev))
    return mask, tmin
