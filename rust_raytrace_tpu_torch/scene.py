"""Scene container and assembly helpers.

The torch port's copy of `rust_raytrace_tpu/scene.py`: numpy only, so the
port imports nothing of the JAX package. `scene_from_arrays` is the port's
own.

Analog of the reference `Scene { tris, boxes, debug_ctx, debug_en }`
(raytrace_lib/src/raytrace.rs:1297-1303) and of the scene-construction code in
`raytrace/src/main.rs:116-164`.  A scene is a single SoA triangle table (slot 0
is the dummy miss sentinel, main.rs:117) plus an optional octree acceleration
structure; `populate_triangle_numbers` (raytrace.rs:393-397) is implicit — a
triangle's number IS its row index.
"""

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .geometry import TriangleArrays, dummy_triangle
from .materials import MaterialTable

#: Read-only checkout of the reference repo; scene assets (teapot_tri.obj) and
#: golden PNGs are loaded from here at runtime rather than copied into this repo.
REFERENCE_DIR = os.environ.get("RUST_RAYTRACE_REF", "/root/reference")


def reference_asset(*parts: str) -> Optional[str]:
    path = os.path.join(REFERENCE_DIR, *parts)
    return path if os.path.exists(path) else None


@dataclass
class Scene:
    tris: TriangleArrays
    octree: Optional[object] = None    # octree.Octree, built lazily
    debug_ctx: Optional[object] = None  # utils.raydebug.DebugCtx when enabled
    lights: Optional[object] = None    # LightSource for the shadow-ray extension

    @property
    def num_triangles(self) -> int:
        return len(self.tris)


def assemble(parts, with_sentinel: bool = True) -> Scene:
    """Concatenate triangle tables into a scene, prepending the slot-0 sentinel."""
    all_parts = ([dummy_triangle()] if with_sentinel else []) + list(parts)
    return Scene(tris=TriangleArrays.concat(all_parts))


#: the `TriangleArrays` fields `scene_from_arrays` takes
TRIANGLE_FIELDS = ("corners", "incenter", "norm", "bounding_r2", "sides",
                   "side_lens", "edge_thickness")
#: the `MaterialTable` fields it takes
MATERIAL_FIELDS = ("kind", "color", "alpha", "scattering")


def scene_from_arrays(fields: dict, lights=None) -> Scene:
    """A scene from plain arrays, e.g. those of a scene another package
    built: `fields` maps every name of TRIANGLE_FIELDS and MATERIAL_FIELDS
    to an array (slot 0 the miss sentinel, as `assemble` lays it out);
    `lights`, if given, maps "orig" and "len2".  The arrays are copied."""
    missing = [k for k in TRIANGLE_FIELDS + MATERIAL_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"scene_from_arrays: missing fields {missing}")

    def arr(k, dtype=np.float32):
        return np.array(fields[k], dtype=dtype, copy=True)

    mats = MaterialTable(kind=arr("kind", np.int32), color=arr("color"),
                         alpha=arr("alpha"), scattering=arr("scattering"))
    tris = TriangleArrays(**{k: arr(k) for k in TRIANGLE_FIELDS},
                          materials=mats)
    light = None
    if lights is not None:
        light = LightSource(orig=np.array(lights["orig"], np.float32),
                            len2=float(lights["len2"]))
    return Scene(tris=tris, lights=light)


@dataclass(frozen=True)
class LightSource:
    """Point-ish light for the shadow-ray extension.

    The reference contains only a disabled scaffold for this (`LightSource`,
    raytrace.rs:595-610; shadow logic commented out at raytrace.rs:1203-1224).
    Implemented here to the commented-out design, off by default.
    """

    orig: np.ndarray   # [3]
    len2: float        # jitter cube edge for soft shadows
