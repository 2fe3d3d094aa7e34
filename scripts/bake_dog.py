"""Bake dm_control's dog, posed at qpos0, into the port's scene data file.

    MUJOCO_GL=disable python scripts/bake_dog.py [--out PATH]

Needs `mujoco` and `dm_control` (DeepMind Control Suite,
github.com/google-deepmind/dm_control, Apache-2.0); the port and the
benchmark read only the file this writes, so neither needs them.  The model
is the one `dm_control.suite.dog.stand()` builds:
`get_model_and_assets(floor_size=_WALK_SPEED * _DEFAULT_TIME_LIMIT)`
(suite/dog.py:88-101), which drops the ball, the target and the walls.  It
is compiled, `mj_forward` run at qpos0, and `mjv_updateScene` run with
MuJoCo's default visual options (geom and skin groups 0-2) from camera
`y-axis`: what it puts in the scene is what MuJoCo draws.  Of that, the
mesh geoms and the skin are written; the 4 primitive geoms it also draws
(the irises and pupils) are not, since the port builds triangles only, and
the bones of geom group 5 and the collision primitives of group 3 are not
drawn.  Written, every float as MuJoCo holds it (float64 unless said):

  - per part, the drawn mesh geoms in geom order and then the skin:
    `part_names`, the posed float32 vertices concatenated in `vertices`
    with `vertex_offsets` [P + 1], the int32 faces (indices into the
    part's own vertices) in `faces` with `face_offsets` [P + 1], and
    `part_rgba` [P, 4] float32.  A mesh geom's vertices are
    `geom_xpos + geom_xmat @ mesh_vert`, computed in float64 and rounded
    once, and its colour its geom rgba; the skin's are the scene's
    `skinvert` (MuJoCo poses them from the bones' weights, in float32),
    and its colour its material's rgba times the mean of its texture;
  - the floor plane as two float32 triangles at the task's size
    (`floor_corners` [2, 3, 3]), its material's `floor_reflectance` and its
    checker texture's `floor_rgb1` and `floor_rgb2`;
  - camera `y-axis`: `cam_xpos`, `cam_xmat` (row-major 3x3), `cam_fovy`
    (degrees, vertical);
  - the light: `light_xpos`, `light_xdir`, `light_cutoff` (degrees),
    `light_diffuse`, `light_bulbradius`;
  - `offsize`: the model's offscreen width and height.

The zip is written with fixed timestamps and sorted members, so a bake on
the same MuJoCo and zlib reproduces the file byte for byte.
"""

import argparse
import io
import os
import zipfile

import numpy as np

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "rust_raytrace_tpu_torch", "models", "assets", "dog_qpos0.npz")

CAMERA = "y-axis"
FLOOR = "floor"


def _posed(xpos, xmat, vert):
    """xpos + xmat @ v for each vertex, in float64, one term at a time (no
    BLAS, so the bits do not depend on the build), rounded to float32."""
    v = np.asarray(vert, dtype=np.float64)
    r = np.asarray(xmat, dtype=np.float64).reshape(3, 3)
    out = (np.asarray(xpos, dtype=np.float64)[None]
           + v[:, 0:1] * r[:, 0][None]
           + v[:, 1:2] * r[:, 1][None]
           + v[:, 2:3] * r[:, 2][None])
    return out.astype(np.float32)


def _skin_rgba(m, s: int) -> np.ndarray:
    """Skin s's flat colour: its material's rgba, the rgb times the mean of
    the material's texture."""
    import mujoco

    mat = m.skin_matid[s]
    tex = m.mat_texid[mat][mujoco.mjtTextureRole.mjTEXROLE_RGB]
    n = m.tex_width[tex] * m.tex_height[tex] * m.tex_nchannel[tex]
    texels = m.tex_data[m.tex_adr[tex]:m.tex_adr[tex] + n].reshape(
        -1, m.tex_nchannel[tex])[:, :3]
    out = np.asarray(m.mat_rgba[mat], dtype=np.float64)
    out[:3] *= texels.astype(np.float64).mean(axis=0) / 255.0
    return out.astype(np.float32)


def bake() -> dict:
    """The arrays of the data file, from the compiled model at qpos0."""
    import mujoco
    from dm_control.suite import dog

    xml, assets = dog.get_model_and_assets(
        floor_size=dog._WALK_SPEED * dog._DEFAULT_TIME_LIMIT)
    m = mujoco.MjModel.from_xml_string(xml, assets)
    d = mujoco.MjData(m)
    mujoco.mj_forward(m, d)
    cam = m.camera(CAMERA)
    view = mujoco.MjvCamera()
    view.type = mujoco.mjtCamera.mjCAMERA_FIXED
    view.fixedcamid = cam.id
    opt = mujoco.MjvOption()
    scn = mujoco.MjvScene(m, maxgeom=m.ngeom + 1000)
    mujoco.mjv_updateScene(m, d, opt, mujoco.MjvPerturb(),
                           view, mujoco.mjtCatBit.mjCAT_ALL, scn)
    drawn = sorted(int(g.objid) for g in scn.geoms[:scn.ngeom]
                   if g.objtype == mujoco.mjtObj.mjOBJ_GEOM)

    names, verts, faces, rgba = [], [], [], []
    for g in drawn:
        if m.geom_type[g] != mujoco.mjtGeom.mjGEOM_MESH:
            continue
        mesh = m.geom_dataid[g]
        va, vn = m.mesh_vertadr[mesh], m.mesh_vertnum[mesh]
        fa, fn = m.mesh_faceadr[mesh], m.mesh_facenum[mesh]
        names.append(m.geom(g).name)
        verts.append(_posed(d.geom_xpos[g], d.geom_xmat[g],
                            m.mesh_vert[va:va + vn]))
        faces.append(np.asarray(m.mesh_face[fa:fa + fn], dtype=np.int32))
        rgba.append(np.asarray(m.geom_rgba[g], dtype=np.float32))
    for s in range(scn.nskin):
        if not opt.skingroup[m.skin_group[s]]:
            continue
        va, vn = scn.skinvertadr[s], scn.skinvertnum[s]
        fa, fn = m.skin_faceadr[s], m.skin_facenum[s]
        names.append(m.skin(s).name)
        verts.append(np.array(scn.skinvert[3 * va:3 * (va + vn)],
                              dtype=np.float32).reshape(vn, 3))
        faces.append(np.asarray(m.skin_face[fa:fa + fn], dtype=np.int32))
        rgba.append(_skin_rgba(m, s))

    floor = m.geom(FLOOR)
    hx, hy = (float(s) for s in floor.size[:2])
    local = np.asarray([[-hx, -hy, 0.0], [hx, -hy, 0.0], [hx, hy, 0.0],
                        [-hx, hy, 0.0]])
    quad = _posed(d.geom_xpos[floor.id], d.geom_xmat[floor.id], local)
    mat = m.mat(floor.matid[0])
    spec = mujoco.MjSpec.from_string(xml.decode() if isinstance(xml, bytes)
                                     else xml, assets)
    tex_name = m.tex(int(mat.texid[mujoco.mjtTextureRole.mjTEXROLE_RGB])).name
    tex = next(t for t in spec.textures if t.name == tex_name)

    return {
        "part_names": np.asarray(names),
        "vertices": np.concatenate(verts),
        "vertex_offsets": np.cumsum([0] + [len(v) for v in verts]),
        "faces": np.concatenate(faces),
        "face_offsets": np.cumsum([0] + [len(f) for f in faces]),
        "part_rgba": np.stack(rgba),
        "floor_corners": quad[[[0, 1, 2], [0, 2, 3]]],
        "floor_reflectance": np.float64(mat.reflectance[0]),
        "floor_rgb1": np.asarray(tex.rgb1, dtype=np.float64),
        "floor_rgb2": np.asarray(tex.rgb2, dtype=np.float64),
        "cam_xpos": np.asarray(d.cam_xpos[cam.id], dtype=np.float64),
        "cam_xmat": np.asarray(d.cam_xmat[cam.id], dtype=np.float64),
        "cam_fovy": np.float64(m.cam_fovy[cam.id]),
        "light_xpos": np.asarray(d.light_xpos[0], dtype=np.float64),
        "light_xdir": np.asarray(d.light_xdir[0], dtype=np.float64),
        "light_cutoff": np.float64(m.light_cutoff[0]),
        "light_diffuse": np.asarray(m.light_diffuse[0], dtype=np.float64),
        "light_bulbradius": np.float64(m.light_bulbradius[0]),
        "offsize": np.asarray([m.vis.global_.offwidth,
                               m.vis.global_.offheight], dtype=np.int64),
    }


def write_npz(path: str, arrays: dict) -> None:
    """An .npz that `np.load` reads, with sorted members and fixed zip
    timestamps, so the same arrays give the same bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(arrays[name]),
                                      allow_pickle=False)
            info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python scripts/bake_dog.py")
    p.add_argument("--out", default=DEFAULT_OUT)
    a = p.parse_args(argv)
    arrays = bake()
    write_npz(a.out, arrays)
    print(f"{a.out}: {len(arrays['part_names'])} parts, "
          f"{len(arrays['faces'])} triangles, "
          f"{len(arrays['vertices'])} vertices, "
          f"{os.path.getsize(a.out)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
