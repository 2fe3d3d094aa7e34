"""Triangle page tables — the kernel-side scene layout.

The torch port's copy of `rust_raytrace_tpu/ops/pages.py`: numpy only, so the
port imports nothing of the JAX package. The C++ fast paths of `morton_order`
and `kd_order` are not carried: the port always takes the numpy path.

The reference GPU path marshals, per cycle, per-ray lists of <=256 candidate
triangles into a thread-strided SoA layout (`cuda_rt.cu:32-56, 341-377`) and
re-uploads them every cycle; its host-side pagination windows each ray's
ordered leaf list into fixed-size pages (`cuda_raytrace.rs:231-253`).

On TPU the scene lives in HBM once, pre-packed into fixed-size PAGES of
triangle features shaped for the intersect kernel, and pages are streamed
through VMEM — no per-cycle repacking (that repack is the reference's measured
bottleneck; see its 4-phase timers, cuda_rt.cu:432-440).

Packed page layout PK [NP, P, 128] f32 — triangles on sublanes (P a multiple
of 8), features on lanes (padded to the 128-lane tile so page slices DMA
cleanly and each feature is a natural [P, 1] column in VMEM):

  lane  0..2   n       unit plane normal (sides[0] x sides[1], raytrace.rs:370)
  lane  3..5   s0'     sides[0] / side_lens[0]  (prescaled inward edge normal)
  lane  6..8   s1'     sides[1] / side_lens[1]
  lane  9..11  s2'     sides[2] / side_lens[2]
  lane 12      n.c     plane offset (c = centroid)
  lane 13..15  sk'.c   half-plane offsets
  lane 16      id      global triangle index as f32 (exact below 2^24)
  lane 17      edge_thickness   (edge band fraction, raytrace.rs:415-422)
  lane 18      material kind    (0 solid / 1 matte / 2 reflective, as f32)
  lane 19..21  material color
  lane 22      material alpha
  lane 23      material scattering
  lane 24..127 zero

Lanes 17..23 exist so the trace kernel can emit the winning triangle's full
shading state via in-kernel masked reductions — XLA device gathers from
per-triangle tables measure 0.5-75 s at 3.7M rays on TPU, so the wavefront
NEVER gathers by hit id.

The kernel tile orientation is triangles-on-sublanes x rays-on-lanes: the
min-reduction over candidates folds across sublanes (a handful of full-width
vector ops) — measured ~5x faster than the lane-reduction orientation.

Intersection math consumed by all kernel implementations (see
ops/intersect_ref.py for the executable model), for rays O, D [3, R]:
  t      = (n.c - n.O) / n.D                        [P, R]
  dist_k = sk'.O + t * sk'.D - sk'.c                (<= 1 for inside)
  valid  = t >= 0  AND  all dist_k <= 1
with the same accept-on-equality boundaries as `Triangle::intersects`
(raytrace.rs:400-439).  The reference CPU path's bounding-circle reject
(raytrace.rs:410) is an early-out, not a semantic filter — every true hit lies
inside the corner circle — so the kernel contract omits it, exactly as the
reference's own CUDA kernel does (cuda_rt.cu:166-256; its Rust oracle
neutralizes the circle with r2=1000, cuda_raytrace.rs:145).

Sentinel id 0 = miss; padding rows are all-zero (n = 0 -> t = NaN -> never
valid) with id 0.
"""

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..geometry import TriangleArrays

F32 = np.float32

#: lane offsets in the packed page layout
LANE_N = 0
LANE_S0 = 3
LANE_S1 = 6
LANE_S2 = 9
LANE_NC = 12
LANE_S0C = 13
LANE_S1C = 14
LANE_S2C = 15
LANE_ID = 16
LANE_ET = 17
LANE_KIND = 18
LANE_COLOR = 19
LANE_ALPHA = 22
LANE_SCAT = 23
PACK_LANES = 128


@dataclass
class PageTables:
    """Paged scene tables (numpy host-side; moved to device by the renderer)."""

    PK: np.ndarray     # [NP, P, 128] f32 packed features (layout above)
    page_size: int
    num_tris: int      # real (unpadded) triangle count referenced by the pages
    aabb_lo: np.ndarray = None  # [NP, 3] f32 page bounds (+inf for empty pages)
    aabb_hi: np.ndarray = None  # [NP, 3] f32 (-inf for empty pages)

    @property
    def num_pages(self) -> int:
        return self.PK.shape[0]


def pack_features(tris: TriangleArrays, indices: np.ndarray) -> np.ndarray:
    """Packed feature rows [n, 128] for a flat list of triangle indices."""
    sel = np.asarray(indices, dtype=np.int64)
    n = sel.shape[0]
    center = tris.incenter[sel]                               # [n,3]
    norm = tris.norm[sel]                                     # [n,3]
    s = tris.sides[sel] / tris.side_lens[sel][..., None]      # [n,3,3]

    pk = np.zeros((n, PACK_LANES), dtype=F32)
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


def build_pages(tris: TriangleArrays, page_size: int = 256,
                order: Optional[Sequence[int]] = None) -> PageTables:
    """Pack triangles into fixed-size pages.

    `order`: triangle indices to include, in page order.  Defaults to the
    brute-force list 1..N-1 (slot 0, the miss sentinel, is excluded exactly as
    `build_bounding_box` excludes it — raytrace.rs:791).  Spatially-ordered
    page lists (morton_order) keep page AABBs tight for packet culling.
    """
    if order is None:
        order = np.arange(1, len(tris), dtype=np.int64)
    order = np.asarray(order, dtype=np.int64)

    n = order.shape[0]
    num_pages = max(1, -(-n // page_size))
    padded = num_pages * page_size

    pk = np.zeros((padded, PACK_LANES), dtype=F32)
    pk[:n] = pack_features(tris, order)

    # Page AABBs over member triangle corners (for packet culling).
    lo = np.full((padded, 3), np.inf, dtype=F32)
    hi = np.full((padded, 3), -np.inf, dtype=F32)
    corners = tris.corners[order]          # [n, 3, 3]
    lo[:n] = corners.min(axis=1)
    hi[:n] = corners.max(axis=1)
    lo = lo.reshape(num_pages, page_size, 3).min(axis=1)
    hi = hi.reshape(num_pages, page_size, 3).max(axis=1)

    return PageTables(
        PK=np.ascontiguousarray(pk.reshape(num_pages, page_size, PACK_LANES)),
        page_size=page_size,
        num_tris=len(tris),
        aabb_lo=lo.astype(F32),
        aabb_hi=hi.astype(F32),
    )


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz -> 30-bit Morton codes.  q: [n,3] uint32 < 1024."""
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def morton_order(tris: TriangleArrays) -> np.ndarray:
    """Triangle indices 1..N-1 sorted by centroid Morton code.

    Spatially coherent page packing: consecutive triangles land in compact
    blobs, so page AABBs stay tight and packet culling bites.  Unlike octree
    leaf pages (the reference's spatial index duplicates triangles into every
    leaf they touch, raytrace.rs:790-845), Morton pages reference each
    triangle exactly once.
    """
    from ..utils import host_native
    if len(tris) >= 1024 and host_native.available():
        nat = host_native.morton_order_native(tris.incenter)
        if nat is not None:
            return nat

    c = tris.incenter[1:]
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-20)
    q = np.minimum((c - lo) / span * 1024.0, 1023.0).astype(np.uint32)
    codes = _morton3(q)
    return np.argsort(codes, kind="stable").astype(np.int64) + 1


def build_pages_morton(tris: TriangleArrays, page_size: int = 256) -> PageTables:
    """Morton-ordered pages (the round-1 production layout)."""
    return build_pages(tris, page_size=page_size, order=morton_order(tris))


def kd_order(tris: TriangleArrays, page_size: int) -> np.ndarray:
    """Triangle indices 1..N-1 ordered by recursive page-aligned SAH splits
    of the centroids (axis AND split position minimizing
    SA(left)*n_left + SA(right)*n_right over all page-multiple positions).

    Morton cells overlap heavily once carved into fixed-size pages (a z-curve
    run can straddle cell boundaries); adaptive splits track the actual
    triangle distribution, so page AABBs overlap far less and every consumer
    of the page bounds sharpens — the packet cull's page lists, the per-lane
    kernel's slab-selected step counts, and the shade kernel's provable-miss
    test.  SAH (surface-area heuristic, the standard BVH build cost model)
    replaced the round-2 longest-axis median rule after an offline probe on
    sampled bounce rays (scripts/probe_r4a.py) measured mean slab-hit
    pages/ray 6.06 -> 2.77 on multi and 2.24 -> 2.14 on teapot at identical
    page counts; the winner (t, id) is partition-independent, so the swap is
    bit-exact.  This is the flat-page analog of the reference's octree
    subdivision (build_bounding_box, raytrace.rs:790-845) without its
    triangle duplication.  Sentinel slot 0 stays excluded (raytrace.rs:791).

    The native C++ path (rt_kd_order, `utils/host_native`), taken from
    1,024 triangles on as in the JAX package, is an exact behavioral copy
    of this one: the same stable sorts, the same float32 cost arithmetic,
    the same first-wins tie rule.
    """
    from ..utils import host_native
    if len(tris) >= 1024 and host_native.available():
        nat = host_native.kd_order_native(tris.incenter, page_size)
        if nat is not None:
            return nat

    c = tris.incenter

    out = []

    def rec(ids):
        n = len(ids)
        if n <= page_size:
            out.append(ids)
            return
        cc = c[ids]
        k = -(-n // page_size)
        best = None          # (cost, order, nl); strict < keeps the first
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


def build_pages_kd(tris: TriangleArrays, page_size: int = 256) -> PageTables:
    """KD-split pages (the production layout: minimal page-AABB overlap)."""
    return build_pages(tris, page_size=page_size,
                       order=kd_order(tris, page_size))
