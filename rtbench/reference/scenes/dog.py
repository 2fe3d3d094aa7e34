"""dm_control's dog from the configuration's baked file (the arrays
`scripts/bake_dog.py` writes from the MuJoCo model at qpos0: the mesh
geoms MuJoCo draws by default and its posed skin), read with numpy: each
part Matte in its colour at the configuration's alpha, in the file's order
behind the sentinel, then the floor's two triangles, Reflective at its
material's reflectance in the mean of its checker's two colours; the light
at its position with the configuration's jitter cube; camera `y-axis` as a
viewport whose pinhole is the camera, looking along its -z with its y up,
its vertical extent the camera's fovy."""

import dataclasses
import math
from pathlib import Path

import numpy as np

from .. import math3d as m3
from ..geometry import assemble, create_viewport, make_triangles
from ..materials import matte, reflective

F32 = np.float32
ROOT = Path(__file__).resolve().parents[3]


def _roll(xmat) -> float:
    """The roll that puts the camera's y up in the viewport's frame: at
    roll 0 the frame of view direction d has first columns
    A = (cp, sp sr, sp cr) and C = (0, cr, -sr) (pitch -asin(d0), roll
    atan2(d1, d2)); at roll c its first column is cos(-c) A - sin(-c) C."""
    r = np.asarray(xmat, dtype=np.float64).reshape(3, 3)
    d = -r[:, 2] / math.sqrt(float(r[:, 2] @ r[:, 2]))
    pitch, roll = -math.asin(d[0]), math.atan2(d[1], d[2])
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    up = r[:, 1]
    along_a = up[0] * cp + up[1] * sp * sr + up[2] * sp * cr
    along_c = up[1] * cr - up[2] * sr
    return -math.atan2(-along_c, along_a)


def _viewport(data, width: int, height: int, maxdepth: int, spp: int):
    """The viewport's frame, extents and distance for the camera's view,
    roll and horizontal fov (the angle its fovy gives at the image's
    aspect), re-anchored: the pinhole at the camera and the image plane
    centred on the view axis."""
    r = np.asarray(data["cam_xmat"], dtype=np.float64).reshape(3, 3)
    half = math.tan(math.radians(float(data["cam_fovy"])) / 2.0) \
        * width / height
    view = create_viewport(
        px=(width, height), size=(1.0, float(F32(height) / F32(width))),
        pos=(0.0, 0.0, 0.0), dir=m3.unit(np.asarray(-r[:, 2], F32)),
        fov_deg=math.degrees(2.0 * math.atan(half)),
        c_roll=_roll(data["cam_xmat"]), maxdepth=maxdepth, samples=spp)
    cam = np.asarray(data["cam_xpos"], dtype=F32)
    orig = cam + (-view.cam) - view.vu * F32(0.5) - view.vv * F32(0.5)
    return dataclasses.replace(view, cam=cam, orig=orig.astype(F32))


def build(cfg: dict, spp: int):
    with np.load(ROOT / cfg["data"], allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    vo, fo = data["vertex_offsets"], data["face_offsets"]
    parts = []
    for i, rgba in enumerate(data["part_rgba"]):
        verts = data["vertices"][vo[i]:vo[i + 1]]
        faces = data["faces"][fo[i]:fo[i + 1]]
        parts.append(make_triangles(verts[faces],
                                    matte(rgba[:3], alpha=cfg["matte_alpha"]),
                                    -1.0))
    parts.append(make_triangles(
        data["floor_corners"],
        reflective((data["floor_rgb1"] + data["floor_rgb2"]) / 2.0,
                   alpha=float(data["floor_reflectance"]), scattering=0.0),
        -1.0))
    width, height = cfg["resolution"]
    view = _viewport(data, width, height, cfg["maxdepth"], spp)
    light = (*np.asarray(data["light_xpos"], F32).tolist(), cfg["light_len2"])
    return assemble(parts), light, view
