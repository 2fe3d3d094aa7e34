"""dm_control's dog, posed at qpos0, lit by its light and seen by its camera.

The scene data is baked from the DeepMind Control Suite's `dog` model
(github.com/google-deepmind/dm_control, `suite/dog.xml` and
`suite/dog_assets/`, Apache-2.0) by `scripts/bake_dog.py`, which builds
it as `dm_control.suite.dog.stand()` does, runs `mj_forward` at qpos0 and
writes `assets/dog_qpos0.npz`; rerun that script (it needs `mujoco` and
`dm_control`) to bake it again.  The scene is what MuJoCo draws by default
(geom and skin groups 0-2).  Rendering it needs only numpy.

  - the 18 drawn mesh geoms (geom group 1: the claws' phalanges and the
    eyes, 15,648 triangles) and the skin MuJoCo posed over the bones
    (33,900 triangles), each its own part through `make_triangles` (a part
    of 1,024 or more triangles takes the C++ precompute), Matte with the
    upstream's matte alpha 0.2 (raytrace/src/main.rs:118-126), in the
    geom's rgba or the skin's flat colour, in the file's order behind the
    sentinel;
  - the floor plane at the task's half-size 15 as two triangles, its
    material `grid`'s reflectance 0.2 as the Reflective share of the mean
    of its checker's two colours (the shader's alpha is the share the
    reflected ray carries);
  - the light (dog.xml:338) as a `LightSource` at its position whose jitter
    cube's edge is the bulb's diameter (MuJoCo's default bulbradius 0.02);
  - camera `y-axis` (dog.xml:339): the pinhole at the camera, the view
    along its -z, the image's up its y, the vertical extent its fovy, at
    the model's own offscreen size (dog.xml:160) by default.

Left out: the textures (the skin in its material's colour times its
texture's mean, the floor's checker in its two colours' mean), the 4
primitive geoms MuJoCo draws (the irises and pupils: the port builds
triangles only) and the light's spot cone and intensity (the port's light
only casts shadows).
"""

import dataclasses
import math
import os

import numpy as np

from .. import math3d as m3
from ..camera import create_viewport
from ..geometry import make_triangles
from ..materials import matte, reflective
from ..scene import LightSource, assemble
from .teapot import RESOLUTIONS

F32 = np.float32

DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "assets", "dog_qpos0.npz")

#: the upstream's matte alpha (the teapot's, raytrace/src/main.rs:118-126)
MATTE_ALPHA = 0.2


def load() -> dict:
    """The baked arrays (`scripts/bake_dog.py`)."""
    with np.load(DATA_PATH, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def horizontal_fov_deg(fovy_deg: float, width: int, height: int) -> float:
    """The horizontal angle that a vertical angle gives at the image's
    aspect (`create_viewport` takes the horizontal one)."""
    half = math.tan(math.radians(fovy_deg) / 2.0) * width / height
    return math.degrees(2.0 * math.atan(half))


def camera_roll(xmat) -> float:
    """The roll (radians) for which `create_transform` of the camera's view
    direction d (its -z) puts the image's up on the camera's y.  At roll 0
    that frame's first two columns are A = (cp, sp sr, sp cr) and
    C = (0, cr, -sr), with pitch -asin(d0) and roll atan2(d1, d2)
    (raytrace.rs:1320-1341); at roll c its first column is
    cos(-c) A - sin(-c) C."""
    r = np.asarray(xmat, dtype=np.float64).reshape(3, 3)
    d = -r[:, 2] / math.sqrt(float(r[:, 2] @ r[:, 2]))
    pitch, roll = -math.asin(d[0]), math.atan2(d[1], d[2])
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    up = r[:, 1]
    along_a = up[0] * cp + up[1] * sp * sr + up[2] * sp * cr
    along_c = up[1] * cr - up[2] * sr
    return -math.atan2(-along_c, along_a)


def mujoco_viewport(cam_xpos, cam_xmat, fovy_deg: float, width: int,
                    height: int, maxdepth: int, samples: int):
    """A MuJoCo camera as the port's Viewport: `create_viewport`'s frame,
    extents and distance for the view along the camera's -z, the roll that
    puts its y up and the horizontal fov of its fovy, with the pinhole at
    the camera and the image plane centred on the view axis
    (`create_viewport` offsets the plane's corner without rotating it,
    raytrace.rs:1349, which only a camera looking along +z tolerates)."""
    r = np.asarray(cam_xmat, dtype=np.float64).reshape(3, 3)
    view = create_viewport(
        px=(width, height), size=(1.0, float(F32(height) / F32(width))),
        pos=(0.0, 0.0, 0.0), dir=m3.unit(np.asarray(-r[:, 2], F32)),
        fov_deg=horizontal_fov_deg(fovy_deg, width, height),
        c_roll=camera_roll(cam_xmat), maxdepth=maxdepth, samples=samples)
    cam = np.asarray(cam_xpos, dtype=F32)
    forward = -view.cam                 # the pinhole sits at pos - forward
    orig = cam + forward - view.vu * F32(0.5) - view.vv * F32(0.5)
    return dataclasses.replace(view, cam=cam, orig=orig.astype(F32))


def build(resolution=None, maxdepth: int = 5, samples: int = 1,
          with_light: bool = False):
    """(Scene, Viewport) of the dog; resolution None is the model's own
    offscreen size, else a preset name or (width, height)."""
    data = load()
    if resolution is None:
        width, height = (int(x) for x in data["offsize"])
    elif isinstance(resolution, str):
        width, height = RESOLUTIONS[resolution]
    else:
        width, height = resolution

    parts = []
    vo, fo = data["vertex_offsets"], data["face_offsets"]
    for i, rgba in enumerate(data["part_rgba"]):
        verts = data["vertices"][vo[i]:vo[i + 1]]
        faces = data["faces"][fo[i]:fo[i + 1]]
        parts.append(make_triangles(
            verts[faces], matte(rgba[:3], alpha=MATTE_ALPHA),
            edge_thickness=-1.0))
    floor_color = (data["floor_rgb1"] + data["floor_rgb2"]) / 2.0
    parts.append(make_triangles(
        data["floor_corners"],
        reflective(floor_color, alpha=float(data["floor_reflectance"]),
                   scattering=0.0),
        edge_thickness=-1.0))
    scene = assemble(parts)
    if with_light:
        scene.lights = LightSource(
            orig=np.asarray(data["light_xpos"], dtype=F32),
            len2=2.0 * float(data["light_bulbradius"]))
    view = mujoco_viewport(data["cam_xpos"], data["cam_xmat"],
                           float(data["cam_fovy"]), width, height, maxdepth,
                           samples)
    return scene, view
