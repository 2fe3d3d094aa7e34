"""Triangle tables, procedural parts and the camera, from a configuration's
own parameters.

The benchmark reference's frozen copy of the port's numpy scene build
(`geometry.py`'s `make_triangles`, `make_disk` and the slot-0
sentinel, `scene.assemble`, `camera.create_viewport`), and of the C++ path
on which the port builds a part of 1,024 or more triangles
(`native/scene_pipeline.cc:rt_make_triangles`).
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
    """SoA triangle table (row 0 the miss sentinel once assembled)."""

    corners: np.ndarray         # [N,3,3] vertices (the page boxes)
    incenter: np.ndarray        # [N,3] centroid
    norm: np.ndarray            # [N,3]
    sides: np.ndarray           # [N,3,3] unit inward edge perpendiculars
    side_lens: np.ndarray       # [N,3]
    edge_thickness: np.ndarray  # [N]
    materials: MaterialTable

    def __len__(self) -> int:
        return self.incenter.shape[0]

    def take(self, idx) -> "TriangleArrays":
        m = self.materials
        return TriangleArrays(
            self.corners[idx], self.incenter[idx], self.norm[idx],
            self.sides[idx], self.side_lens[idx], self.edge_thickness[idx],
            MaterialTable(m.kind[idx], m.color[idx], m.alpha[idx],
                          m.scattering[idx]))

    @staticmethod
    def concat(parts: Sequence["TriangleArrays"]) -> "TriangleArrays":
        return TriangleArrays(
            corners=np.concatenate([p.corners for p in parts]),
            incenter=np.concatenate([p.incenter for p in parts]),
            norm=np.concatenate([p.norm for p in parts]),
            sides=np.concatenate([p.sides for p in parts]),
            side_lens=np.concatenate([p.side_lens for p in parts]),
            edge_thickness=np.concatenate([p.edge_thickness for p in parts]),
            materials=MaterialTable.concat([p.materials for p in parts]))


def make_triangles(points, surface: Surface,
                   edge_thickness: float) -> TriangleArrays:
    """The triangle precompute (raytrace.rs:340-383) in float32 numpy:
    centroid, inward edge perpendiculars and their lengths, plane normal.

    A part of 1,024 or more triangles takes the port's C++ path
    (`rt_make_triangles`, scene_pipeline.cc:51-75, built with
    -ffp-contract=off): its centroid is (a + b + c) * float32(1/3) where
    the numpy path divides by 3; the rest of its arithmetic is this
    function's, in the same order (dot and len2 left to right, pc - po,
    each side and the normal scaled by 1/sqrt(len2))."""
    points = np.asarray(points, dtype=F32)
    n = points.shape[0]
    a, b, c = points[:, 0], points[:, 1], points[:, 2]
    if n >= 1024:
        incenter = (a + b + c) * (F32(1.0) / F32(3.0))
    else:
        incenter = (a + b + c) / F32(3.0)
    sides = np.empty((n, 3, 3), dtype=F32)
    side_lens = np.empty((n, 3), dtype=F32)
    for idx in range(3):
        vedge = points[:, (idx + 1) % 3] - points[:, idx]
        po = incenter - points[:, idx]
        scale = m3.dot(vedge, po) / m3.len2(vedge)
        oc = vedge * scale[:, None] - po
        sides[:, idx] = m3.unit(oc)
        side_lens[:, idx] = m3.length(oc)
    norm = m3.unit(m3.cross(sides[:, 0], sides[:, 1]))
    return TriangleArrays(
        corners=points, incenter=incenter, norm=norm, sides=sides,
        side_lens=side_lens,
        edge_thickness=np.full(n, edge_thickness, dtype=F32),
        materials=MaterialTable.broadcast(surface, n))


def dummy_triangle() -> TriangleArrays:
    """Slot-0 miss sentinel (raytrace.rs:385-391)."""
    pts = np.asarray([[[1., 0., 0.], [0., 1., 0.], [0., 0., 1.]]], dtype=F32)
    return make_triangles(pts, solid(m3.make_color((255, 0, 0))), 0.0)


def assemble(parts) -> TriangleArrays:
    """The scene's table: the sentinel, then the parts in order."""
    return TriangleArrays.concat([dummy_triangle()] + list(parts))


def make_disk(orig, norm, r: float, d: float, num_tris: int,
              surface: Surface, side_surface: Surface,
              edge_thickness: float) -> TriangleArrays:
    """Thick disk: 2 faces + rim, 4*num_tris triangles (raytrace.rs:531-592),
    in the reference's emit order (top, bottom, side, side per wedge)."""
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

        p2p, p3p = rim(norm_pd, theta1), rim(norm_pd, theta2)
        p2m, p3m = rim(norm_md, theta3), rim(norm_md, theta4)
        face_pts.append([orig + norm_pd, p2p, p3p])
        face_pts.append([orig + norm_md, p2m, p3m])
        side_pts.append([p2p, p3p, p2m])
        side_pts.append([p2m, p3m, p3p])
    faces = make_triangles(np.asarray(face_pts, dtype=F32), surface,
                           edge_thickness)
    rims = make_triangles(np.asarray(side_pts, dtype=F32), side_surface,
                          edge_thickness)
    src = np.empty(4 * num_tris, dtype=np.int64)
    for i in range(num_tris):
        src[4 * i:4 * i + 4] = [2 * i, 2 * i + 1, 2 * num_tris + 2 * i,
                                2 * num_tris + 2 * i + 1]
    return TriangleArrays.concat([faces, rims]).take(src)


@dataclass(frozen=True)
class Viewport:
    """The image-plane frame (raytrace.rs:1305-1318)."""

    width: int
    height: int
    orig: np.ndarray
    cam: np.ndarray
    vu: np.ndarray
    vv: np.ndarray
    maxdepth: int
    samples_per_pixel: int


def create_viewport(px, size, pos, dir, fov_deg: float, c_roll: float,
                    maxdepth: int, samples: int) -> Viewport:
    """raytrace.rs:1320-1370: the yaw/pitch/roll frame of the view
    direction, the image-plane anchor (its offset not rotated, as the
    upstream has it), the pinhole and the plane's extents."""
    pos = np.asarray(pos, dtype=F32)
    size_w, size_h = F32(size[0]), F32(size[1])
    dist = size_w / (2.0 * np.tan(np.radians(F32(fov_deg)) / 2.0, dtype=F32))
    dvec = m3.unit(np.asarray(dir, dtype=F32))
    roll = -np.arctan2(-dvec[1], dvec[2])
    pitch = -np.arcsin(dvec[0])
    yaw = F32(-F32(c_roll))
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    rot = (np.stack([cy * cp, sy * cp, -sp]).astype(F32),
           np.stack([cy * sp * sr - sy * cr, sy * sp * sr + cy * cr,
                     cp * sr]).astype(F32),
           np.stack([cy * sp * cr + sy * sr, sy * sp * cr - cy * sr,
                     cp * cr]).astype(F32))
    orig = pos + np.asarray([size_h / 2.0, -size_w / 2.0, 0.0], dtype=F32)
    cam = pos - m3.change_basis(np.asarray([0.0, 0.0, dist], dtype=F32), rot)
    vu = m3.change_basis(np.asarray([0.0, size_w, 0.0], dtype=F32), rot)
    vv = m3.change_basis(np.asarray([-size_h, 0.0, 0.0], dtype=F32), rot)
    return Viewport(int(px[0]), int(px[1]), orig, cam, vu, vv, int(maxdepth),
                    int(samples))
