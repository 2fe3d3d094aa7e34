"""The portable nearest hit: a scan over triangle pages with a running
minimum, in torch ops on any device; and `device_pages`, the packed pages
on a device.

Counterpart: `rust_raytrace_tpu/ops/intersect_xla.py` (`device_pages`,
`nearest_hit_xla`).  `nearest_hit_xla` is the JAX package's portable path
(`WavefrontRenderer` backend "xla").  It is not a kernel port: the port's
"portable" backend keeps it as the JAX package keeps it, a second
implementation beside the brute-force kernel (B11,
`ops.intersect.nearest_hit`).  Its update rule is its own: a page's least t
replaces a ray's best only when it is smaller, with no cross-page tie rule,
so a tie across pages keeps the earlier page's winner.

The bits are XLA-CPU's.  Each of the scan's eight products of a [P, 3]
feature block with the [R, 3] rays (`dot_general`, precision HIGHEST)
compiles to a loop that accumulates over x, y, z in order with fused
multiply-adds from +0: fma(a2, b2, fma(a1, b1, a0*b0 + 0)) (measured
against the jitted JAX function at several shapes).  The plane distances
`sk.o + t*sk.d - ck` fuse the product into the add: fma(t, sk.d, sk.o) - ck.
"""

import torch

from .intersect import PLAIN_PAIRS
from .pages import (LANE_ID, LANE_N, LANE_NC, LANE_S0, LANE_S0C, LANE_S1,
                    LANE_S1C, LANE_S2, LANE_S2C)
from .shade import fma, sum3


def device_pages(pages, device="cuda"):
    """The packed pages `pages.PK` ([NP, P, 128] float32) as a tensor on
    `device`, once a scene: on the card by default, on the CPU only when
    the caller asks."""
    return torch.from_numpy(pages.PK).to(device)


def _dot(pk, lane: int, v):
    """XLA-CPU's dot_general of the features pk[:, lane:lane+3] ([P, 3])
    with the rays v (three [1, n] rows): [P, n], summed over x, y, z from
    +0 (`sum3`)."""
    return sum3([pk[:, lane + k:lane + k + 1] for k in range(3)], v)


def nearest_hit_xla(O, D, PK, page_size: int):
    """O, D: [R, 3] float32; PK: [NP, P, 128] packed pages.  Returns
    (best_t [R] float32, +inf on a miss; best_id [R] int32, 0 on a miss)."""
    R = O.shape[0]
    dev = O.device
    best_t = torch.full((R,), torch.inf, dtype=torch.float32, device=dev)
    best_id = torch.zeros((R,), dtype=torch.float32, device=dev)
    ot, dt = O.T.float(), D.T.float()
    block = max(128, PLAIN_PAIRS.get(dev.type, 1 << 16) // PK.shape[1])
    for r0 in range(0, R, block):
        rays = slice(r0, min(R, r0 + block))
        o = [ot[k, rays][None] for k in range(3)]              # [1, n]
        d = [dt[k, rays][None] for k in range(3)]
        bt, bi = best_t[rays], best_id[rays]
        for pk in PK:
            t = (pk[:, LANE_NC:LANE_NC + 1] - _dot(pk, LANE_N, o)) \
                / _dot(pk, LANE_N, d)
            valid = t >= 0
            for s, c in ((LANE_S0, LANE_S0C), (LANE_S1, LANE_S1C),
                         (LANE_S2, LANE_S2C)):
                dv = fma(t, _dot(pk, s, d), _dot(pk, s, o)) - pk[:, c:c + 1]
                valid = valid & (dv <= 1)
            tt = torch.where(valid, t, torch.inf)
            page_min = tt.amin(dim=0)
            ids = torch.where(tt == page_min, pk[:, LANE_ID:LANE_ID + 1],
                              torch.inf).amin(dim=0)
            upd = page_min < bt
            bt = torch.where(upd, page_min, bt)
            bi = torch.where(upd, ids, bi)
        best_t[rays], best_id[rays] = bt, bi
    return best_t, best_id.to(torch.int32)
