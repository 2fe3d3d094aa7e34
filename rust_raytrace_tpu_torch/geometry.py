"""Triangle primitive tables and procedural geometry.

The torch port's copy of `rust_raytrace_tpu/geometry.py`: numpy only, so the
port imports nothing of the JAX package.  `make_triangles` takes the C++
fast path of its own copy of the scene pipeline (`utils/host_native`) for
parts of 1,024 or more triangles whenever the library loads, as the JAX
package does, so both packages build a scene with the same bits.

The reference's `Triangle` (`raytrace_lib/src/raytrace.rs:326-337`) is stored in
a precomputed intersection-friendly form — NOT as three vertices:

  - `incenter`:   the intersection of two vertex->opposite-midpoint rays
                  (raytrace.rs:350-357).  Despite the name this is the triangle
                  CENTROID (the rays are medians); we compute (a+b+c)/3 directly.
  - `norm`:       unit(sides[0] x sides[1]) (raytrace.rs:370).
  - `bounding_r2`: squared radius of the corner-circumscribing circle around the
                  centroid (raytrace.rs:375).
  - `sides`:      three unit vectors from the centroid perpendicular to each
                  edge (p_i -> p_{i+1}), pointing toward the edge, and
  - `side_lens`:  centroid->edge distances (raytrace.rs:359-368).
  The hit test is then: plane hit + bounding-circle reject + three half-plane
  tests `dot(hit - centroid, side_i) <= side_len_i` (raytrace.rs:400-439).

Here each scene is one SoA table (struct-of-arrays over triangles) so a Pallas
kernel can stream contiguous pages of triangle features from HBM through VMEM.
All precompute is vectorized float32 numpy, matching the reference's f32 math.

Index 0 is the reserved "miss" sentinel: scenes push `dummy_triangle()` first
(raytrace/src/main.rs:117) and every traversal skips slot 0
(raytrace.rs:791, cuda_rt.cu:166,317).
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from . import math3d as m3
from .materials import MaterialTable, Surface, solid

F32 = np.float32
PI = F32(np.pi)


@dataclass
class TriangleArrays:
    """SoA triangle table (+ per-triangle materials).

    Mirrors the fields of the reference `Triangle` (raytrace.rs:326-337); `num`
    is implicit as the row index.
    """

    corners: np.ndarray         # [N,3,3] f32 — raw vertices (kept for octree build)
    incenter: np.ndarray        # [N,3] f32 — centroid (reference field name kept)
    norm: np.ndarray            # [N,3] f32
    bounding_r2: np.ndarray     # [N] f32
    sides: np.ndarray           # [N,3,3] f32 — unit inward edge perpendiculars
    side_lens: np.ndarray       # [N,3] f32
    edge_thickness: np.ndarray  # [N] f32
    materials: MaterialTable

    def __len__(self) -> int:
        return self.incenter.shape[0]

    @staticmethod
    def concat(parts: Sequence["TriangleArrays"]) -> "TriangleArrays":
        return TriangleArrays(
            corners=np.concatenate([p.corners for p in parts]),
            incenter=np.concatenate([p.incenter for p in parts]),
            norm=np.concatenate([p.norm for p in parts]),
            bounding_r2=np.concatenate([p.bounding_r2 for p in parts]),
            sides=np.concatenate([p.sides for p in parts]),
            side_lens=np.concatenate([p.side_lens for p in parts]),
            edge_thickness=np.concatenate([p.edge_thickness for p in parts]),
            materials=MaterialTable.concat([p.materials for p in parts]),
        )


def make_triangles(points: np.ndarray, surface: Surface,
                   edge_thickness: float) -> TriangleArrays:
    """Vectorized `make_triangle` precompute (raytrace.rs:340-383).

    points: [N,3,3] f32 — N triangles x 3 corners x xyz.

    The reference finds the center by intersecting two median rays with a
    tolerance-laden 2D projection solver (raytrace.rs:212-267, 350-357); the
    closed form of that intersection is the centroid, which we compute directly
    (difference is f32 rounding noise; the ray solver can also spuriously panic
    on axis-degenerate triangles, which the closed form avoids).
    """
    points = np.asarray(points, dtype=F32)
    n = points.shape[0]

    # C++ fast path (the same math; its float bits are the JAX package's)
    from .utils import host_native
    if n >= 1024 and host_native.available():
        nat = host_native.make_triangles_native(points)
        if nat is not None:
            incenter, norm, sides, side_lens, bounding_r2 = nat
            return TriangleArrays(
                corners=points, incenter=incenter, norm=norm,
                bounding_r2=bounding_r2, sides=sides, side_lens=side_lens,
                edge_thickness=np.full(n, edge_thickness, dtype=F32),
                materials=MaterialTable.broadcast(surface, n),
            )

    a, b, c = points[:, 0], points[:, 1], points[:, 2]
    incenter = (a + b + c) / F32(3.0)

    sides = np.empty((n, 3, 3), dtype=F32)
    side_lens = np.empty((n, 3), dtype=F32)
    for idx in range(3):
        # vedge = p[i+1] - p[i]; po = centroid - p[i];
        # oc = proj_edge(po) - po  (centroid -> edge perpendicular), raytrace.rs:361-368
        vedge = points[:, (idx + 1) % 3] - points[:, idx]
        po = incenter - points[:, idx]
        scale = m3.dot(vedge, po) / m3.len2(vedge)
        pc = vedge * scale[:, None]
        oc = pc - po
        sides[:, idx] = m3.unit(oc)
        side_lens[:, idx] = m3.length(oc)

    norm = m3.unit(m3.cross(sides[:, 0], sides[:, 1]))
    bounding_r2 = m3.len2(points - incenter[:, None, :]).max(axis=1)

    return TriangleArrays(
        corners=points,
        incenter=incenter,
        norm=norm,
        bounding_r2=bounding_r2.astype(F32),
        sides=sides,
        side_lens=side_lens,
        edge_thickness=np.full(n, edge_thickness, dtype=F32),
        materials=MaterialTable.broadcast(surface, n),
    )


def dummy_triangle() -> TriangleArrays:
    """Slot-0 miss sentinel (raytrace.rs:385-391): unit-simplex Solid red."""
    pts = np.asarray([[[1., 0., 0.], [0., 1., 0.], [0., 0., 1.]]], dtype=F32)
    return make_triangles(pts, solid(m3.make_color((255, 0, 0))), 0.0)


def make_sphere(orig, r: float, lat_lon, surface: Surface,
                edge_thickness: float) -> TriangleArrays:
    """Triangulated lat/lon sphere shell (raytrace.rs:464-529).

    Faithful to the reference's staggered strip construction, including the
    half-cell `smudge` on odd rows and the pole rows emitting only one triangle
    per cell.  (The reference's per-triangle debug `println!` spam at
    raytrace.rs:514-516 is intentionally not reproduced.)

    The JAX package builds each cell with float32 scalars in a loop over
    rows and columns; here each row is one set of float32 array operations
    over its columns: the same operations element by element, so the same
    bits (tests/test_torch_host_native.py), ~100x faster at the 708x708
    sphere of synthetic_1m_2k.
    """
    orig = np.asarray(orig, dtype=F32)
    num_lat, num_lon = lat_lon
    assert num_lat % 2 == 0

    rows = []
    frac_pi_2 = F32(np.pi / 2)
    lon = np.arange(num_lon, dtype=F32)
    for lat_idx in range(num_lat):
        if lat_idx % 2 == 0:
            phi1 = -(F32(lat_idx) / F32(num_lat) * PI - frac_pi_2)
            phi23 = -(F32(lat_idx + 1) / F32(num_lat) * PI - frac_pi_2)
        else:
            phi1 = -(F32(lat_idx + 1) / F32(num_lat) * PI - frac_pi_2)
            phi23 = -(F32(lat_idx) / F32(num_lat) * PI - frac_pi_2)

        smudge = F32(0.0) if lat_idx % 2 == 0 else F32(0.5)
        theta1 = (lon + smudge) / F32(num_lon) * 2 * PI
        theta2 = (lon + F32(0.5) + smudge) / F32(num_lon) * 2 * PI
        theta3 = (lon - F32(0.5) + smudge) / F32(num_lon) * 2 * PI
        theta4 = (lon + F32(1.0) + smudge) / F32(num_lon) * 2 * PI

        def at(phi, theta):
            sphi, cphi = np.sin(phi, dtype=F32), np.cos(phi, dtype=F32)
            return orig + np.stack(
                [np.full(theta.shape, r * sphi),
                 r * cphi * np.cos(theta, dtype=F32),
                 r * cphi * np.sin(theta, dtype=F32)], axis=-1).astype(F32)

        p1 = at(phi1, theta1)
        p4 = at(phi1, theta4)
        p2 = at(phi23, theta2)
        p3 = at(phi23, theta3)

        # a cell's triangles in the loop's order: (p1, p2, p3), then
        # (p1, p2, p4) off the pole rows
        cell = [np.stack([p1, p2, p3], axis=1)]
        if lat_idx != 0 and lat_idx != num_lat - 1:
            cell.append(np.stack([p1, p2, p4], axis=1))
        rows.append(np.stack(cell, axis=1).reshape(-1, 3, 3))

    return make_triangles(np.concatenate(rows), surface, edge_thickness)


def make_disk(orig, norm, r: float, d: float, num_tris: int,
              surface: Surface, side_surface: Surface,
              edge_thickness: float) -> TriangleArrays:
    """Thick disk: 2 faces + rim, 4*num_tris triangles (raytrace.rs:531-592)."""
    orig = np.asarray(orig, dtype=F32)
    norm = np.asarray(norm, dtype=F32)

    norm_orth0 = m3.unit(m3.orthogonal(norm)) * F32(r)
    norm_orth1 = m3.unit(m3.cross(norm, norm_orth0)) * F32(r)
    norm_pd = norm * F32(d)
    norm_md = norm * F32(-d)

    face_pts, side_pts = [], []
    for idx in range(num_tris):
        theta1 = F32(idx) / F32(num_tris) * 2 * PI
        theta2 = (F32(idx) + F32(1.0)) / F32(num_tris) * 2 * PI
        theta3 = (F32(idx) + F32(0.5)) / F32(num_tris) * 2 * PI
        theta4 = (F32(idx) + F32(1.5)) / F32(num_tris) * 2 * PI

        def rim(base, theta):
            return (orig + base
                    + norm_orth0 * np.sin(theta, dtype=F32)
                    + norm_orth1 * np.cos(theta, dtype=F32))

        p1p = orig + norm_pd
        p2p = rim(norm_pd, theta1)
        p3p = rim(norm_pd, theta2)
        face_pts.append([p1p, p2p, p3p])

        p1m = orig + norm_md
        p2m = rim(norm_md, theta3)
        p3m = rim(norm_md, theta4)
        face_pts.append([p1m, p2m, p3m])

        side_pts.append([p2p, p3p, p2m])
        side_pts.append([p2m, p3m, p3p])

    # Interleave to preserve the reference's emit order
    # (top, bottom, side, side per wedge — raytrace.rs:565-586).
    faces = make_triangles(np.asarray(face_pts, dtype=F32), surface, edge_thickness)
    rims = make_triangles(np.asarray(side_pts, dtype=F32), side_surface, edge_thickness)
    src = np.empty(4 * num_tris, dtype=np.int64)
    for i in range(num_tris):
        src[4 * i:4 * i + 4] = [2 * i, 2 * i + 1, 2 * num_tris + 2 * i,
                                2 * num_tris + 2 * i + 1]
    both = TriangleArrays.concat([faces, rims])
    return TriangleArrays(
        corners=both.corners[src],
        incenter=both.incenter[src],
        norm=both.norm[src],
        bounding_r2=both.bounding_r2[src],
        sides=both.sides[src],
        side_lens=both.side_lens[src],
        edge_thickness=both.edge_thickness[src],
        materials=MaterialTable(
            kind=both.materials.kind[src],
            color=both.materials.color[src],
            alpha=both.materials.alpha[src],
            scattering=both.materials.scattering[src],
        ),
    )
