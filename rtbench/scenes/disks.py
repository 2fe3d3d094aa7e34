"""The disks scene through the port's API, from the configuration's own
parameters: each disk by `geometry.make_disk`, the sentinel and the parts
by `scene.assemble`, the camera by `camera.create_viewport` (the image
plane 1.0 wide and height/width high), and the configuration's light
where the traffic asks for one."""

import numpy as np

F32 = np.float32


def _surface(m: dict):
    from rust_raytrace_tpu_torch import math3d as m3
    from rust_raytrace_tpu_torch.materials import matte, reflective, solid

    color = m3.make_color(tuple(m["color"]))
    if m["kind"] == "matte":
        return matte(color, alpha=m["alpha"])
    if m["kind"] == "reflective":
        return reflective(color, alpha=m["alpha"], scattering=m["scattering"])
    if m["kind"] == "solid":
        return solid(color)
    raise ValueError(f"material kind {m['kind']!r}")


def build(cfg: dict, spp: int, lit: bool):
    from rust_raytrace_tpu_torch import math3d as m3
    from rust_raytrace_tpu_torch.camera import create_viewport
    from rust_raytrace_tpu_torch.geometry import make_disk
    from rust_raytrace_tpu_torch.scene import LightSource, assemble

    parts = [make_disk(
        orig=d["center"], norm=m3.unit(m3.vec(*d["normal"])),
        r=d["radius"], d=d["half_thickness"], num_tris=d["wedges"],
        surface=_surface(d["surface"]),
        side_surface=_surface(d["side_surface"]),
        edge_thickness=d["edge_thickness"]) for d in cfg["disks"]]
    scene = assemble(parts)
    if lit:
        light = cfg["light"]
        scene.lights = LightSource(orig=np.asarray(light["orig"], F32),
                                   len2=light["len2"])
    width, height = cfg["resolution"]
    cam = cfg["camera"]
    view = create_viewport(
        px=(width, height), size=(1.0, float(F32(height) / F32(width))),
        pos=cam["pos"], dir=m3.unit(m3.vec(*cam["dir"])),
        fov_deg=cfg["fov_deg"], c_roll=cam["roll"],
        maxdepth=cfg["maxdepth"], samples=spp)
    return scene, view
