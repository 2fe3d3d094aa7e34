"""The reference's active scene: Utah teapot + two reflective disks.

The torch port's copy of `rust_raytrace_tpu/models/teapot.py`: numpy only, so
the port imports nothing of the JAX package.

Byte-for-byte parameter match of `raytrace/src/main.rs:96-173`:
  - dummy sentinel triangle first (main.rs:117);
  - `teapot_tri.obj` (3,644 verts / 6,320 tri faces), scale 1.0, rotated by
    `create_transform(unit([0,0.3,1]), 270 deg)`, offset [0,0.5,5], Matte
    (252,119,0) alpha 0.2, edge_thickness 0.05 (main.rs:118-126);
  - 50-wedge disk at [4,4,7], normal unit([-0.3,-0.55,-0.5]), r=2, d=0.1,
    Reflective {scattering 2e-4, (230,230,230), alpha 0.7}, Matte rim,
    edge_thickness -1 (main.rs:128-138);
  - 50-wedge disk at [4,-3,5], normal unit([-0.5,2,-0.5]), r=1, d=0.04,
    Reflective {scattering 2e-3, ...} (main.rs:140-150);
  - camera at [2,0,0] looking +z, fov 90, roll 0, maxdepth 5, 1 spp
    (main.rs:166-173); octree params orig [0,0,20.1], half-side 20,
    maxdepth 10, minobjs 19 (main.rs:160-164).

The teapot OBJ is read from the read-only reference checkout (scene data, not
code); scenes that need it skip gracefully when the asset is unavailable.
"""

import numpy as np

from .. import math3d as m3
from ..camera import create_transform, create_viewport
from ..geometry import make_disk
from ..materials import matte, reflective
from ..obj_parser import parse_obj
from ..scene import Scene, assemble, reference_asset

F32 = np.float32

#: Resolution presets from main.rs:96-110 (name -> (width, height)).
RESOLUTIONS = {
    "dev": (64, 64),
    "512": (512, 512),      # BASELINE config 2: naive 512x512
    "sd": (640, 480),
    "2k": (2560, 1440),
    "square2k": (2048, 2048),
    "4k": (3840, 2160),
}

OCTREE_PARAMS = dict(orig=(0.0, 0.0, 20.1), len2=20.0, maxdepth=10, minobjs=19)


def teapot_obj_path() -> str:
    path = reference_asset("raytrace", "teapot_tri.obj")
    if path is None:
        raise FileNotFoundError(
            "teapot_tri.obj not found under the reference checkout; "
            "set RUST_RAYTRACE_REF to a rust_raytrace checkout")
    return path


def build(resolution="dev", maxdepth: int = 5, samples: int = 1,
          obj_path: str | None = None, with_light: bool = False):
    if isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution
    aspect = F32(height) / F32(width)

    teapot = parse_obj(
        obj_path or teapot_obj_path(),
        offset=(0.0, 0.5, 5.0),
        scale=1.0,
        transform=create_transform(m3.unit(m3.vec(0.0, 0.3, 1.0)),
                                   np.radians(F32(270.0))),
        surface=matte(m3.make_color((252, 119, 0)), alpha=0.2),
        edge_thickness=0.05,
    )

    disk1 = make_disk(
        orig=(4.0, 4.0, 7.0),
        norm=m3.unit(m3.vec(-0.3, -0.55, -0.5)),
        r=2.0, d=0.1, num_tris=50,
        surface=reflective(m3.make_color((230, 230, 230)), alpha=0.7,
                           scattering=0.0002),
        side_surface=matte(m3.make_color((40, 40, 40)), alpha=0.2),
        edge_thickness=-1.0,
    )

    disk2 = make_disk(
        orig=(4.0, -3.0, 5.0),
        norm=m3.unit(m3.vec(-0.5, 2.0, -0.5)),
        r=1.0, d=0.04, num_tris=50,
        surface=reflective(m3.make_color((230, 230, 230)), alpha=0.7,
                           scattering=0.002),
        side_surface=matte(m3.make_color((40, 40, 40)), alpha=0.2),
        edge_thickness=-1.0,
    )

    scene = assemble([teapot, disk1, disk2])
    if with_light:
        # Shadow-ray extension (BASELINE config 3); light placement is this
        # repo's own — the reference's LightSource scaffold carries no scene
        # values (raytrace.rs:595-598, unused).
        from ..scene import LightSource
        scene.lights = LightSource(
            orig=np.asarray([-4.0, 8.0, 0.0], dtype=F32), len2=0.2)
    viewport = create_viewport(
        px=(width, height), size=(1.0, float(aspect)),
        pos=(2.0, 0.0, 0.0), dir=m3.unit(m3.vec(0.0, 0.0, 1.0)),
        fov_deg=90.0, c_roll=0.0, maxdepth=maxdepth, samples=samples)
    return scene, viewport
