"""Octree acceleration structure — API-faithful port of the reference's
"BoundingBox" spatial index (raytrace_lib/src/raytrace.rs:612-1101).

The torch port's copy of `rust_raytrace_tpu/octree.py`: numpy only, so the
port imports nothing of the JAX package.  `build_bounding_box` takes the
C++ build of the port's own copy of the scene pipeline (`utils/host_native`)
when the library loads, as the JAX package does; the vectorized numpy build
is the fallback and test oracle.

The production TPU render path does NOT traverse this tree (divergent per-ray
tree walks don't map to a 8x128 SIMD machine); it uses KD pages + packet
culling (ops/pages.py, ops/cull.py).  The octree exists because it is part of
the reference's capability surface:

  - `build_bounding_box(tris, orig, len2, maxdepth, minobjs)` — cube octree
    with triangle-in-box tests including the face/line clip predicate
    (raytrace.rs:790-845, 645-779); slot 0 (sentinel) excluded (:791);
  - `collides(ray)` — slab test returning (tmin, tmax) (raytrace.rs:861-907);
  - `get_object_intersection_for_ray` — front-to-back nearest-hit walk with
    the insertion-sorted children and early skip (raytrace.rs:909-1009);
  - `get_all_objects_for_ray` — ordered {box tmin -> leaf triangle list} map,
    the query that powered the reference's GPU wavefront
    (raytrace.rs:1052-1077) — including the BTreeMap quirk that equal tmin
    keys overwrite;
  - `build_trivial_bounding_box` / `build_empty_box` / `print_tree`
    (raytrace.rs:847-856, 781-788, 1079-1093).

It also provides `octree_page_order()` — leaf-grouped triangle ordering as an
alternative page layout for the packet-culled kernel.

All geometry predicates are vectorized numpy over candidate triangles, f32
like the reference.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from . import math3d as m3
from .geometry import TriangleArrays

F32 = np.float32
FACE_NORMALS = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                           [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=F32)


@dataclass
class Octree:
    """A node: cube at `orig` with half-side `len2` (reference `BoundingBox`)."""

    orig: np.ndarray                 # [3]
    len2: float
    depth: int
    children: Optional[List["Octree"]] = None   # BBSubobj::Boxes
    tri_indices: Optional[np.ndarray] = None    # BBSubobj::Tris

    @property
    def is_leaf(self) -> bool:
        return self.tri_indices is not None


def _box_contains_points(orig, len2, pts):
    """Strict point-in-cube (box_contains_point, raytrace.rs:636-643)."""
    return (np.abs(pts - orig) < len2).all(axis=-1)


def _face_contains_triangles(p, norm, len2, tris: TriangleArrays,
                             idx: np.ndarray) -> np.ndarray:
    """Vectorized `face_contains_triangle` (raytrace.rs:645-729).

    Intersects each triangle's plane with the face's plane, clips the
    intersection line against the box slabs of the two in-face axes, and
    tests whether the line passes between the projected corners.
    """
    n1 = norm                                     # [3] axis-aligned unit
    tn = tris.norm[idx]                           # [m,3]
    tc = tris.incenter[idx]
    corners = tris.corners[idx]                   # [m,3,3]
    m = idx.shape[0]

    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        h1 = F32(np.dot(n1, p + n1 * F32(len2)))
        h2 = np.einsum("mc,mc->m", tn, tc).astype(F32)
        ndot = tn @ n1                            # [m]
        denom = F32(1.0) - ndot * ndot
        c1 = (h1 - h2 * ndot) / denom
        c2 = (h2 - h1 * ndot) / denom

        line_orig = n1[None, :] * c1[:, None] + tn * c2[:, None]
        cross = m3.cross(np.broadcast_to(n1, (m, 3)), tn)
        dir_unit = m3.unit(cross)                 # make_ray normalizes (:201)
        inv_dir = F32(1.0) / dir_unit

        # First clip: pull the line origin behind the box if needed
        # (raytrace.rs:659-685).
        free_axis = n1 == 0.0                     # [3]
        tmin1 = np.full(m, np.finfo(np.float32).max, dtype=F32)
        for k in range(3):
            if not free_axis[k]:
                continue
            t1 = (p[k] - F32(len2) - line_orig[:, k]) * inv_dir[:, k]
            t2 = (p[k] + F32(len2) - line_orig[:, k]) * inv_dir[:, k]
            tmin1 = np.minimum(tmin1, np.minimum(t1, t2))
        shift = tmin1 <= 0.0
        line_orig = np.where(shift[:, None],
                             line_orig + dir_unit * (tmin1 * 2)[:, None],
                             line_orig)

        # Second clip: slab intersection on the free axes (raytrace.rs:687-716)
        tmin = np.full(m, np.finfo(np.float32).min, dtype=F32)
        tmax = np.full(m, np.finfo(np.float32).max, dtype=F32)
        for k in range(3):
            if not free_axis[k]:
                continue
            t1 = (p[k] - F32(len2) - line_orig[:, k]) * inv_dir[:, k]
            t2 = (p[k] + F32(len2) - line_orig[:, k]) * inv_dir[:, k]
            tmin = np.maximum(tmin, np.minimum(t1, t2))
            tmax = np.minimum(tmax, np.maximum(t1, t2))
        ok = tmax >= tmin

        # Third: does the clipped line pass between the corners?
        # (raytrace.rs:718-728)
        tproj = np.einsum("mkc,mc->mk", corners - line_orig[:, None, :],
                          dir_unit).astype(F32)
        proj = line_orig[:, None, :] + tproj[..., None] * dir_unit[:, None, :]
        dvec = proj - corners                     # [m,3,3]
        d01 = np.einsum("mc,mc->m", dvec[:, 0], dvec[:, 1])
        d02 = np.einsum("mc,mc->m", dvec[:, 0], dvec[:, 2])
        d12 = np.einsum("mc,mc->m", dvec[:, 1], dvec[:, 2])
        between = (d01 < 0) | (d02 < 0) | (d12 < 0)

    result = ok & between
    return np.where(np.isnan(result.astype(np.float32)), False, result)


def box_contains_polygon(orig, len2, tris: TriangleArrays,
                         idx: np.ndarray) -> np.ndarray:
    """Vectorized `box_contains_polygon` (raytrace.rs:753-779) over `idx`."""
    orig = np.asarray(orig, dtype=F32)
    inside = _box_contains_points(orig, F32(len2), tris.incenter[idx])
    for k in range(3):
        inside |= _box_contains_points(orig, F32(len2), tris.corners[idx, k])
    pending = ~inside
    for face in FACE_NORMALS:
        if not pending.any():
            break
        sub = idx[pending]
        hit = _face_contains_triangles(orig, face, len2, tris, sub)
        inside[pending] |= hit
        pending = ~inside
    return inside


def build_bounding_box(tris: TriangleArrays, orig, len2: float,
                       maxdepth: int, minobjs: int,
                       use_native: bool = True) -> Octree:
    """Reference `build_bounding_box` (raytrace.rs:790-845): triangles 1..N-1
    filtered recursively into octants; leaf when < minobjs or depth maxed.

    Uses the C++ build (`utils/host_native`) when use_native and the
    library loads; the vectorized-numpy build below is the fallback.
    """
    if use_native:
        from .utils import host_native
        if host_native.available():
            flat = host_native.build_octree_native(tris, orig, len2, maxdepth,
                                                   minobjs)
            if flat is not None:
                if flat["root"] < 0:
                    raise ValueError("no triangles inside the root box")
                return _from_flat(flat, flat["root"])

    refvec = np.arange(1, len(tris), dtype=np.int64)
    node = _build_helper(tris, refvec, np.asarray(orig, dtype=F32),
                         F32(len2), 0, maxdepth, minobjs)
    if node is None:
        raise ValueError("no triangles inside the root box")
    return node


def _from_flat(flat: dict, i: int) -> Octree:
    """The Octree of node i of the native build's flat arrays."""
    if flat["num_children"][i] == 0:
        s = int(flat["leaf_start"][i])
        c = int(flat["leaf_count"][i])
        return Octree(orig=flat["node_orig"][i].copy(),
                      len2=float(flat["node_len2"][i]),
                      depth=int(flat["node_depth"][i]),
                      tri_indices=flat["leaf_tris"][s:s + c].copy())
    cs = int(flat["children_start"][i])
    nc = int(flat["num_children"][i])
    kids = [_from_flat(flat, int(flat["child_indices"][cs + j]))
            for j in range(nc)]
    return Octree(orig=flat["node_orig"][i].copy(),
                  len2=float(flat["node_len2"][i]),
                  depth=int(flat["node_depth"][i]), children=kids)


def _build_helper(tris, objs, orig, len2, depth, maxdepth, minobjs):
    contained = objs[box_contains_polygon(orig, len2, tris, objs)]
    if contained.shape[0] == 0:
        return None
    if contained.shape[0] < minobjs or depth >= maxdepth:
        return Octree(orig=orig, len2=float(len2), depth=depth,
                      tri_indices=contained)

    children = []
    new_len2 = F32(len2) / F32(2.0)
    for i in range(8):
        off = np.asarray([
            -new_len2 if (i & 1) == 0 else new_len2,
            -new_len2 if (i & 2) == 0 else new_len2,
            -new_len2 if (i & 4) == 0 else new_len2,
        ], dtype=F32)
        child = _build_helper(tris, contained, orig + off, new_len2,
                              depth + 1, maxdepth, minobjs)
        if child is not None:
            children.append(child)

    if children:
        return Octree(orig=orig, len2=float(len2), depth=depth,
                      children=children)
    return None


def build_trivial_bounding_box(tris: TriangleArrays, orig,
                               len2: float) -> Octree:
    """Single leaf holding all triangles (raytrace.rs:847-856)."""
    return Octree(orig=np.asarray(orig, dtype=F32), len2=float(len2), depth=0,
                  tri_indices=np.arange(1, len(tris), dtype=np.int64))


def build_empty_box() -> Octree:
    """Unit leaf with no triangles (raytrace.rs:781-788)."""
    return Octree(orig=np.zeros(3, dtype=F32), len2=1.0, depth=0,
                  tri_indices=np.empty(0, dtype=np.int64))


def collides(node: Octree, orig, d, inv_d=None) -> Optional[Tuple[float, float]]:
    """Slab test (BoundingBox::collides, raytrace.rs:861-907).

    Matches the reference exactly, including: axes with d == 0 are IGNORED
    (no containment check) and the hit condition is tmin < tmax strictly.
    """
    orig = np.asarray(orig, dtype=F32)
    d = np.asarray(d, dtype=F32)
    if inv_d is None:
        with np.errstate(divide="ignore"):
            inv_d = F32(1.0) / d
    tmin = np.finfo(np.float32).min
    tmax = np.finfo(np.float32).max
    first = True
    for k in range(3):
        if d[k] == 0.0:
            # skipped axes never touch inv_d[k] == inf, so no 0*inf NaN
            # (the reference's per-axis slab loop, raytrace.rs:869-897,
            # has the same structure)
            continue
        tmp1 = (node.orig[k] - orig[k]) * inv_d[k]
        tmp2 = inv_d[k] * F32(node.len2)
        t1s, t2s = tmp1 - tmp2, tmp1 + tmp2
        lo, hi = (t1s, t2s) if inv_d[k] > 0 else (t2s, t1s)
        if first and k == 0:
            tmin, tmax = lo, hi
        else:
            tmin = max(tmin, lo)
            tmax = min(tmax, hi)
    if tmin < tmax:
        return float(tmin), float(tmax)
    return None


def get_all_objects_for_ray(node: Octree, orig, d) -> Dict[float, np.ndarray]:
    """Ordered {box tmin -> leaf triangle indices} (raytrace.rs:1052-1077).

    Returned dict iterates in ascending-tmin order (BTreeMap semantics);
    equal keys overwrite, like BTreeMap::insert.
    """
    out: Dict[float, np.ndarray] = {}

    def helper(n: Octree):
        hit = collides(n, orig, d)
        if hit is None:
            return
        if n.is_leaf:
            out[hit[0]] = n.tri_indices
        else:
            for c in n.children:
                helper(c)

    helper(node)
    return dict(sorted(out.items()))


def get_object_intersection_for_ray(node: Octree, tris: TriangleArrays,
                                    orig, d):
    """Front-to-back nearest-hit walk (raytrace.rs:909-1009): children sorted
    by entry tmin; subtrees skipped when their entry exceeds the current best.
    Returns (t, tri_index) or None.  Leaf scans use the exact reference
    intersection predicate via oracle.intersect_all semantics."""
    from .oracle import intersect_all

    def leaf_min(n: Octree):
        if n.tri_indices.shape[0] == 0:
            return None
        t, valid, _, _ = intersect_all(tris, np.asarray(orig, dtype=F32),
                                       np.asarray(d, dtype=F32))
        sub_t = np.where(valid[n.tri_indices], t[n.tri_indices], np.inf)
        k = int(np.argmin(sub_t))
        if np.isinf(sub_t[k]):
            return None
        return float(sub_t[k]), int(n.tri_indices[k])

    from .utils import tracelog

    def walk(n: Octree, best):
        # depth-indented traversal tracing (raytrace.rs:912-918, 954-958)
        tracelog.box_visit(n.depth, f"d={n.depth} orig={n.orig.tolist()} "
                                    f"len2={n.len2}")
        if n.is_leaf:
            tracelog.box_kind(n.depth, "Subobjects")
            cand = leaf_min(n)
            if tracelog.enabled():
                tracelog.leaf_result(
                    n.depth, None if cand is None
                    else (cand[0], None, None, cand[1]))
            if cand is None:
                return best
            if best is None or cand[0] < best[0]:
                return cand
            return best
        tracelog.box_kind(n.depth, "Subboxes")
        entries = []
        for c in n.children:
            hit = collides(c, orig, d)
            if hit is not None:
                entries.append((hit[0], hit[1], c))
        entries.sort(key=lambda e: e[0])
        for tmin, _tmax, c in entries:
            if best is not None and tmin >= best[0]:
                continue    # early skip (raytrace.rs:965)
            best = walk(c, best)
        return best

    return walk(node, None)


def print_tree(node: Octree, out=print):
    """Debug dump (raytrace.rs:1079-1093)."""
    out(f"Bx: {node.depth} {node.orig.tolist()} {node.len2}")
    if node.is_leaf:
        for t in node.tri_indices:
            out(f"Obj {int(t)}")
    else:
        for c in node.children:
            print_tree(c, out)


def leaves(node: Octree) -> List[Octree]:
    if node.is_leaf:
        return [node]
    out = []
    for c in node.children:
        out.extend(leaves(c))
    return out


def octree_page_order(tris: TriangleArrays, orig, len2: float,
                      maxdepth: int = 10, minobjs: int = 19) -> np.ndarray:
    """Leaf-grouped triangle order (deduplicated) for page packing — the
    octree-flavored alternative to Morton ordering.  Triangles referenced by
    multiple leaves are emitted at their first leaf (each exactly once);
    triangles outside the root box are appended at the end (they must remain
    hittable — the brute-force contract covers all triangles)."""
    tree = build_bounding_box(tris, orig, len2, maxdepth, minobjs)
    seen = np.zeros(len(tris), dtype=bool)
    seen[0] = True
    order = []
    for leaf in leaves(tree):
        for t in leaf.tri_indices:
            if not seen[t]:
                seen[t] = True
                order.append(t)
    rest = np.nonzero(~seen)[0]
    return np.concatenate([np.asarray(order, dtype=np.int64),
                           rest.astype(np.int64)])
