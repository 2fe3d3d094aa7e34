"""The disks scene from its configuration: each disk on `make_disk`
behind the sentinel, seen from the upstream camera
(raytrace/src/main.rs:166-173): pinhole at `pos`, looking along `dir`,
the image plane 1.0 wide and height/width high, `fov_deg`."""

import numpy as np

from .. import math3d as m3
from ..geometry import assemble, create_viewport, make_disk
from ..materials import matte, reflective, solid

F32 = np.float32


def _surface(m: dict):
    color = m3.make_color(tuple(m["color"]))
    if m["kind"] == "matte":
        return matte(color, alpha=m["alpha"])
    if m["kind"] == "reflective":
        return reflective(color, alpha=m["alpha"], scattering=m["scattering"])
    if m["kind"] == "solid":
        return solid(color)
    raise ValueError(f"material kind {m['kind']!r}")


def build(cfg: dict, spp: int):
    parts = [make_disk(
        orig=d["center"], norm=m3.unit(m3.vec(*d["normal"])),
        r=d["radius"], d=d["half_thickness"], num_tris=d["wedges"],
        surface=_surface(d["surface"]),
        side_surface=_surface(d["side_surface"]),
        edge_thickness=d["edge_thickness"]) for d in cfg["disks"]]
    width, height = cfg["resolution"]
    cam = cfg["camera"]
    view = create_viewport(
        px=(width, height), size=(1.0, float(F32(height) / F32(width))),
        pos=cam["pos"], dir=m3.unit(m3.vec(*cam["dir"])),
        fov_deg=cfg["fov_deg"], c_roll=cam["roll"], maxdepth=cfg["maxdepth"],
        samples=spp)
    light = cfg.get("light")
    return (assemble(parts),
            None if light is None else (*light["orig"], light["len2"]),
            view)
