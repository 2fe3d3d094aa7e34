"""Generic user-OBJ scene: render ANY .obj file with an auto-framed camera.

The torch port's copy of `rust_raytrace_tpu/models/objfile.py`: numpy only,
so the port imports nothing of the JAX package.

The reference can only render assets wired into `main.rs` at compile time
(teapot_tri.obj, main.rs:118-126); a framework user expects to point the CLI
at their own mesh.  This model loads an arbitrary OBJ (honoring `mtllib`/
`usemtl` via the MTL extension, falling back to a neutral matte), then frames
the camera automatically: it looks down +z at the mesh's bounding-sphere
center from a distance that fits the sphere inside the reference's fov-90
viewport with a 15% margin.  All camera math is deterministic closed form —
same mesh, same framing.

Usage: `build(obj_path=...)`; the port has no CLI yet (ROADMAP A12), the
JAX package's CLI takes `render --scene obj --obj path/to/mesh.obj`.
"""

import numpy as np

from .. import math3d as m3
from ..camera import create_viewport
from ..materials import matte
from ..obj_parser import parse_obj_with_mtl
from ..scene import assemble
from .teapot import RESOLUTIONS

F32 = np.float32

#: Neutral default when the OBJ carries no (or partial) MTL materials.
DEFAULT_SURFACE_COLOR = (180, 180, 180)
DEFAULT_ALPHA = 0.3
FRAME_MARGIN = 1.15


def build(resolution="dev", maxdepth: int = 5, samples: int = 1,
          obj_path: str | None = None, scale: float = 1.0,
          edge_thickness: float = -1.0):
    if obj_path is None:
        raise ValueError("the 'obj' scene needs --obj PATH (an .obj file)")
    if isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution
    aspect = F32(height) / F32(width)

    identity = np.eye(3, dtype=F32)
    tris = parse_obj_with_mtl(
        obj_path, offset=(0.0, 0.0, 0.0), scale=scale, transform=identity,
        default_surface=matte(m3.make_color(DEFAULT_SURFACE_COLOR),
                              alpha=DEFAULT_ALPHA),
        edge_thickness=edge_thickness)
    if tris.corners.shape[0] == 0:
        raise ValueError(f"{obj_path!r} contains no faces")
    scene = assemble([tris])

    # Auto-framing: bounding sphere of all corners; camera on the -z side
    # looking +z (the reference's canonical view direction, main.rs:168),
    # far enough that the sphere fits the fov-90 half-angle with margin.
    pts = scene.tris.corners[1:].reshape(-1, 3)  # skip the miss sentinel
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - center))
    radius = max(radius, 1e-3)
    half_fov = np.radians(45.0)  # fov 90
    # the viewport's narrow axis sees fov * min(1, aspect) — frame to it
    narrow = half_fov if aspect >= 1.0 else np.arctan(
        np.tan(half_fov) * float(aspect))
    dist = FRAME_MARGIN * radius / np.tan(narrow)
    pos = center - np.asarray([0.0, 0.0, dist + radius], dtype=np.float64)

    viewport = create_viewport(
        px=(width, height), size=(1.0, float(aspect)),
        pos=tuple(float(v) for v in pos),
        dir=m3.unit(m3.vec(0.0, 0.0, 1.0)),
        fov_deg=90.0, c_roll=0.0, maxdepth=maxdepth, samples=samples)
    return scene, viewport
