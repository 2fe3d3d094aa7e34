"""Wavefront OBJ loader with the reference's exact semantics.

The torch port's copy of `rust_raytrace_tpu/obj_parser.py`: numpy only, so
the port imports nothing of the JAX package.

Mirrors `raytrace_lib/src/obj_parser.rs:20-73`:
  - only `v` and `f` lines are parsed (vn/vt/usemtl/mtllib ignored);
  - face vertex tokens may be `a`, `a/b`, `a/b/c` — only the first (position)
    index is used (obj_parser.rs:32), 1-based;
  - faces are assumed triangular: corners [0],[1],[2] are taken as-is
    (no fan triangulation in the reference — obj_parser.rs:63-66);
  - each vertex is transformed `v * scale -> change_basis(transform) -> + offset`
    (obj_parser.rs:64-66).

As a flagged extension beyond the reference (whose teapot.mtl is empty and
ignored), `parse_mtl`/`parse_obj_with_mtl` implement MTL material support
(Kd/Ks/Ns/d/illum -> Matte or Reflective, mapping documented on parse_mtl)
for the BASELINE "MTL materials" config.
"""

import os
from typing import Dict, Optional

import numpy as np

from . import math3d as m3
from .geometry import TriangleArrays, make_triangles
from .materials import MaterialTable, Surface, matte, reflective

F32 = np.float32


def _read_obj(path: str):
    vertices = []
    faces = []          # list of (corner index triples, material name)
    current_mtl = None
    mtllib = None
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line[2:].split()
                assert len(parts) == 3
                vertices.append([float(p) for p in parts])
            elif line.startswith("f "):
                corners = [int(tok.split("/")[0]) for tok in line[2:].split()]
                faces.append((corners, current_mtl))
            elif line.startswith("usemtl "):
                current_mtl = line[7:].strip()
            elif line.startswith("mtllib "):
                mtllib = line[7:].strip()
    return np.asarray(vertices, dtype=F32), faces, mtllib


def parse_obj(path: str, offset, scale: float, transform, surface: Surface,
              edge_thickness: float) -> TriangleArrays:
    """Load an OBJ as one uniform-surface triangle table (obj_parser.rs:47-73)."""
    offset = np.asarray(offset, dtype=F32)
    vertices, faces, _ = _read_obj(path)
    verts_t = m3.change_basis(vertices * F32(scale), transform) + offset

    idx = np.asarray([[c[0] - 1, c[1] - 1, c[2] - 1] for c, _ in faces],
                     dtype=np.int64).reshape(-1, 3)  # (0,3) when faceless
    points = verts_t[idx]  # [N,3,3]
    return make_triangles(points, surface, edge_thickness)


def parse_mtl(path: str) -> Dict[str, Surface]:
    """MTL parser (extension; the reference ignores its empty teapot.mtl).

    Statement directives and their mapping onto the reference's surface
    model (SurfaceKind, raytrace.rs:303-308 — there is no transmission or
    microfacet model to map to, so the mapping is documented and tested
    rather than physically exact):

      newmtl        starts a material
      Kd r g b      surface color
      Ks r g b      max(Ks) > 1e-3 selects Reflective (mirror-like);
                    the bounce mix weight alpha = clamp(mean(Ks), 0, 1)
      Ns s          shininess -> Reflective fuzz: scattering = 1/(1+sqrt(Ns))
                    (Ns 0 -> fully fuzzy 1.0; Ns 900 -> near-mirror 0.032)
      d a           dissolve scales the bounce weight (no transmission
                    support: a translucent surface bounces more, like the
                    reference's alpha): Matte alpha = 0.2 * d,
                    Reflective alpha *= d
      illum n       n >= 3 also selects Reflective (ray-traced highlights)

    Unknown directives are ignored, matching the reference parser's
    only-`v`/`f` tolerance (obj_parser.rs:20-73).
    """
    materials: Dict[str, Surface] = {}
    name: Optional[str] = None

    def fresh():
        return {
            "kd": np.asarray([1.0, 1.0, 1.0], dtype=F32),
            "ks": np.zeros(3, dtype=F32),
            "ns": 0.0,
            "d": 1.0,
            "illum": 2,
        }

    cur = fresh()

    def flush():
        if name is None:
            return
        reflective_sel = float(cur["ks"].max()) > 1e-3 or cur["illum"] >= 3
        if reflective_sel:
            scattering = 1.0 / (1.0 + float(np.sqrt(cur["ns"])))
            alpha = float(np.clip(cur["ks"].mean(), 0.0, 1.0)) * cur["d"]
            materials[name] = reflective(cur["kd"], max(alpha, 1e-3),
                                         scattering)
        else:
            materials[name] = matte(cur["kd"], 0.2 * cur["d"])

    with open(path, "r") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "newmtl":
                flush()
                name = tok[1]
                cur = fresh()
            elif tok[0] == "Kd":
                cur["kd"] = np.asarray([float(t) for t in tok[1:4]],
                                       dtype=F32)
            elif tok[0] == "Ks":
                cur["ks"] = np.asarray([float(t) for t in tok[1:4]],
                                       dtype=F32)
            elif tok[0] == "Ns":
                cur["ns"] = float(tok[1])
            elif tok[0] == "d":
                cur["d"] = float(tok[1])
            elif tok[0] == "illum":
                cur["illum"] = int(float(tok[1]))
    flush()
    return materials


def parse_obj_with_mtl(path: str, offset, scale: float, transform,
                       default_surface: Surface,
                       edge_thickness: float) -> TriangleArrays:
    """OBJ loader honoring usemtl/mtllib via `parse_mtl` (flagged extension)."""
    offset = np.asarray(offset, dtype=F32)
    vertices, faces, mtllib = _read_obj(path)
    verts_t = m3.change_basis(vertices * F32(scale), transform) + offset

    materials: Dict[str, Surface] = {}
    if mtllib is not None:
        mtl_path = os.path.join(os.path.dirname(path), mtllib)
        if os.path.exists(mtl_path):
            materials = parse_mtl(mtl_path)

    idx = np.asarray([[c[0] - 1, c[1] - 1, c[2] - 1] for c, _ in faces],
                     dtype=np.int64).reshape(-1, 3)  # (0,3) when faceless
    tris = make_triangles(verts_t[idx], default_surface, edge_thickness)

    if materials:
        mt = tris.materials
        for i, (_, mtl_name) in enumerate(faces):
            surf = materials.get(mtl_name)
            if surf is not None:
                mt.kind[i] = surf.kind
                mt.color[i] = surf.color
                mt.alpha[i] = surf.alpha
                mt.scattering[i] = surf.scattering
    return tris
