"""Multi-object instanced scene (BASELINE config 5).

The torch port's copy of `rust_raytrace_tpu/models/multi.py`: numpy only, so
the port imports nothing of the JAX package.

"Instanced teapots + spheres, reflective materials, multi-bounce secondary-ray
wavefronts."  Instancing is host-side: one template mesh is loaded once and
stamped into the scene under per-instance rigid transforms (the reference has
no instancing machinery; its OBJ loader bakes a single transform per load,
obj_parser.rs:63-66 — we reuse exactly that vertex-transform semantics per
instance).
"""

from typing import Sequence

import numpy as np

from .. import math3d as m3
from ..camera import create_transform, create_viewport
from ..geometry import TriangleArrays, make_disk, make_sphere, make_triangles
from ..materials import Surface, matte, reflective
from ..obj_parser import parse_obj
from ..scene import assemble, reference_asset

F32 = np.float32

RESOLUTIONS = {"dev": (64, 64), "2k": (2560, 1440)}


def instance(template: TriangleArrays, offset, scale: float, transform,
             surface: Surface, edge_thickness: float) -> TriangleArrays:
    """Stamp a template mesh under `v*scale -> change_basis -> +offset`.

    Same per-vertex math as the OBJ loader (obj_parser.rs:64-66), applied to an
    already-loaded table's corners, then re-precomputed.
    """
    offset = np.asarray(offset, dtype=F32)
    pts = template.corners.reshape(-1, 3)
    pts = m3.change_basis(pts * F32(scale), transform) + offset
    return make_triangles(pts.reshape(-1, 3, 3), surface, edge_thickness)


def build(resolution="dev", maxdepth: int = 5, samples: int = 1,
          obj_path: str | None = None):
    if isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution
    aspect = F32(height) / F32(width)

    parts = []

    # Teapot instances (when the reference asset is available; otherwise the
    # scene is spheres+disks only).
    path = obj_path or reference_asset("raytrace", "teapot_tri.obj")
    if path is not None:
        base = parse_obj(
            path, offset=(0.0, 0.0, 0.0), scale=1.0,
            transform=create_transform(m3.unit(m3.vec(0.0, 0.3, 1.0)),
                                       np.radians(F32(270.0))),
            surface=matte(m3.make_color((252, 119, 0)), alpha=0.2),
            edge_thickness=0.05)
        placements = [
            ((0.0, 0.5, 5.0), 1.0, matte(m3.make_color((252, 119, 0)), 0.2)),
            ((-3.0, -1.0, 8.0), 0.8, matte(m3.make_color((90, 180, 90)), 0.2)),
            ((3.5, 1.0, 9.0), 1.2,
             reflective(m3.make_color((220, 220, 240)), 0.6, 0.001)),
        ]
        ident = (m3.vec(1, 0, 0), m3.vec(0, 1, 0), m3.vec(0, 0, 1))
        for offset, scale, surf in placements:
            parts.append(instance(base, offset, scale, ident, surf, 0.05))

    parts.append(make_sphere((-1.5, 2.5, 7.0), 1.0, (12, 18),
                             reflective(m3.make_color((230, 230, 230)), 0.7,
                                        0.0005), -1.0))
    parts.append(make_sphere((1.0, -2.0, 6.0), 0.7, (12, 18),
                             matte(m3.make_color((200, 80, 80)), 0.3), -1.0))
    parts.append(make_disk((0.0, -3.5, 7.0), m3.unit(m3.vec(0.0, 1.0, 0.0)),
                           6.0, 0.05, 40,
                           reflective(m3.make_color((200, 200, 200)), 0.7,
                                      0.0002),
                           matte(m3.make_color((40, 40, 40)), 0.2), -1.0))

    scene = assemble(parts)
    viewport = create_viewport(
        px=(width, height), size=(1.0, float(aspect)),
        pos=(2.0, 0.0, 0.0), dir=m3.unit(m3.vec(0.0, 0.0, 1.0)),
        fov_deg=90.0, c_roll=0.0, maxdepth=maxdepth, samples=samples)
    return scene, viewport
