"""Sphere-shell scene for the `circles_2k` config.

The torch port's copy of `rust_raytrace_tpu/models/circles.py`: numpy only,
so the port imports nothing of the JAX package.

The reference repo ships `circles_2k.png` but its generating scene is no longer
in `main.rs`; the geometry generator that produced it, `make_sphere`
(raytrace.rs:464-529), survives.  This module defines this repo's own circles
scene: a floor disk plus a cluster of matte/reflective/solid sphere shells —
exercising `make_sphere`, all three material kinds and multi-bounce shading at
2k resolution (BASELINE config 1: "sphere-only scene, brute-force
intersection + basic shading").
"""

import numpy as np

from .. import math3d as m3
from ..camera import create_viewport
from ..geometry import make_disk, make_sphere
from ..materials import matte, reflective, solid
from ..scene import assemble

F32 = np.float32

RESOLUTIONS = {
    "dev": (64, 64),
    "2k": (2560, 1440),
    "square2k": (2048, 2048),
}

#: (center, radius, lat/lon, surface) for each sphere shell.
SPHERES = [
    ((0.0, 0.0, 6.0), 1.5, (16, 24),
     lambda: matte(m3.make_color((200, 60, 60)), alpha=0.3)),
    ((-2.5, 1.5, 8.0), 1.0, (12, 18),
     lambda: reflective(m3.make_color((230, 230, 230)), alpha=0.7,
                        scattering=0.001)),
    ((2.5, -1.0, 7.0), 0.8, (12, 18),
     lambda: solid(m3.make_color((60, 120, 220)))),
    ((1.5, 2.0, 9.0), 1.2, (12, 18),
     lambda: matte(m3.make_color((80, 200, 120)), alpha=0.2)),
]


def build(resolution="dev", maxdepth: int = 5, samples: int = 1):
    if isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution
    aspect = F32(height) / F32(width)

    parts = [make_sphere(center, r, latlon, surf(), edge_thickness=-1.0)
             for center, r, latlon, surf in SPHERES]
    parts.append(make_disk(
        orig=(0.0, -3.0, 7.0), norm=m3.unit(m3.vec(0.0, 1.0, 0.0)),
        r=8.0, d=0.05, num_tris=40,
        surface=matte(m3.make_color((120, 120, 120)), alpha=0.3),
        side_surface=matte(m3.make_color((40, 40, 40)), alpha=0.2),
        edge_thickness=-1.0))

    scene = assemble(parts)
    viewport = create_viewport(
        px=(width, height), size=(1.0, float(aspect)),
        pos=(0.0, 0.0, 0.0), dir=m3.unit(m3.vec(0.0, 0.0, 1.0)),
        fov_deg=90.0, c_roll=0.0, maxdepth=maxdepth, samples=samples)
    return scene, viewport
