"""Pure-numpy reference renderer — the framework's differential-test oracle.

The torch port's copy of `rust_raytrace_tpu/oracle.py`: numpy only, on the
port's own camera, math3d, geometry and materials, so the port imports
nothing of the JAX package.  It is a backend the caller names (`cli
render --backend oracle`), never a device path.

The reference's main correctness methodology is differential testing between
redundant implementations: its CUDA wavefront backend runs a pure-Rust model of
the kernel every cycle and diffs results (`cuda_raytrace_lib/src/
cuda_raytrace.rs:118-229, 387-420`), and the CPU/CUDA renders are compared
per-ray (`raytrace_lib/src/debug.rs:150-222`).  This module plays the same
role for the TPU build: a slow, obviously-correct numpy implementation of

  - the recursive Whitted integrator `project_ray`/`color_ray`
    (raytrace.rs:1199-1295) — recursion kept recursive here, unlike the
    wavefront production path, precisely so the two differ structurally;
  - brute-force nearest-hit with the reference's intersection semantics
    (`Triangle::intersects`, raytrace.rs:400-439) vectorized over triangles;
  - scatter-ray construction `reflect_ray`/`lambertian_ray`
    (raytrace.rs:278-297).

Randomness is injected through an `Rng` object so oracle and production runs
can be made bit-deterministic for comparison (the reference's thread-local
`rand::random` streams are unreproducible even between its own runs).
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from . import math3d as m3
from .camera import Viewport, pixel_rays
from .geometry import TriangleArrays
from .materials import KIND_MATTE, KIND_REFLECTIVE, KIND_SOLID

F32 = np.float32

SKY_COLOR = m3.make_color((128, 180, 255))   # CPU sky (raytrace.rs:1264)
BLACK = m3.make_color((0, 0, 0))


class FixedRng:
    """Deterministic random source: constant unit vector / constant uniforms.

    Makes Matte/Reflective bounce chains and shadow-ray jitter reproducible
    across backends (the production JAX path accepts the same constants in
    oracle-comparison mode).
    """

    def __init__(self, v=(0.36, 0.48, 0.8), u=0.5):
        self._v = m3.unit(np.asarray(v, dtype=F32))
        self._u = F32(u)

    def unit_vec(self, shape=()):
        return np.broadcast_to(self._v, shape + (3,)).copy()

    def uniform(self, shape=()):
        return np.broadcast_to(self._u, shape).copy()


class NumpyRng:
    """`random_vec` semantics of raytrace.rs:188-192: unit(uniform[-.5,.5]^3)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def unit_vec(self, shape=()):
        v = self._rng.random(shape + (3,), dtype=np.float32) - F32(0.5)
        return m3.unit(v)

    def uniform(self, shape=()):
        return self._rng.random(shape, dtype=np.float32)


def intersect_all(tris: TriangleArrays, orig: np.ndarray, d: np.ndarray):
    """Reference `Triangle::intersects` (raytrace.rs:400-439) over all triangles.

    Returns (t [N], valid [N], edge [N], back [N]) for one ray.  Slot 0 (the
    miss sentinel) is always invalid (raytrace.rs:791 excludes it from the
    octree; the CUDA kernel skips it at cuda_rt.cu:166).

    NaN policy: the reference's `if t < 0 { return None }` admits NaN t (all
    NaN comparisons are false in both Rust and IEEE numpy); we instead require
    t >= 0 so NaNs are misses.  This only differs on the measure-zero case of a
    ray exactly in a triangle's plane.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = m3.dot(tris.norm, d[None, :])
        t = m3.dot(tris.norm, tris.incenter - orig[None, :]) / denom
        p = orig[None, :] + t[:, None] * d[None, :]
        ip = p - tris.incenter
        dist = np.einsum("nkc,nc->nk", tris.sides, ip).astype(F32)

    valid = (t >= 0)
    valid &= m3.len2(ip) <= tris.bounding_r2
    valid &= (dist <= tris.side_lens).all(axis=1)
    valid[0] = False
    edge = (dist > tris.side_lens * (F32(1.0) - tris.edge_thickness[:, None])).any(axis=1)
    back = denom > 0
    return t, valid, edge, back


def nearest_hit(tris: TriangleArrays, orig: np.ndarray, d: np.ndarray
                ) -> Optional[Tuple[float, int, bool, bool]]:
    """Brute-force nearest hit: (t, tri_index, edge, back) or None.

    Equals the octree walk's result (raytrace.rs:910-1009): the walk visits
    every leaf whose box the ray enters and each triangle hit lies in such a
    leaf, so the min over all triangles is the same hit (modulo fp ties).
    Ties break to the lowest index, like the fold at raytrace.rs:1029-1038.
    """
    t, valid, edge, back = intersect_all(tris, orig, d)
    if not valid.any():
        return None
    tv = np.where(valid, t, np.inf)
    i = int(np.argmin(tv))
    return float(t[i]), i, bool(edge[i]), bool(back[i])


def reflect_dir(norm_f, d, fuzz, rng) -> Tuple[np.ndarray, np.ndarray]:
    """Fuzzy mirror scatter (raytrace.rs:278-290): returns (new_orig_offset_dir, dir).

    norm_f is the face-corrected normal (flipped for Back hits,
    raytrace.rs:441-449).  reflect = d + 2*n*|d.n|; dir = unit(reflect +
    fuzz*rand_vec); the new origin is offset 0.001 along dir
    (raytrace.rs:289).
    """
    ddot = np.abs(m3.dot(d, norm_f))
    reflect = d + norm_f * (2 * ddot)
    rv = rng.unit_vec() * F32(fuzz)
    out = m3.unit(reflect + rv)
    return out, out


def lambertian_dir(norm_f, rng) -> Tuple[np.ndarray, np.ndarray]:
    """Lambertian scatter (raytrace.rs:292-297): origin offset 0.001*rand_vec,
    dir = unit(norm + rand_vec)."""
    rv = rng.unit_vec()
    return rv, m3.unit(norm_f + rv)


@dataclass
class OracleStats:
    """Run statistics mirroring the named-stat registry (progress.rs:8-55)."""

    rays: int = 0
    counts: Dict[str, int] = field(default_factory=dict)


def shadow_ray(light, point, norm_f, rng):
    """Jittered shadow ray to the light (the commented `get_shadow_ray`
    design, raytrace.rs:600-610): light position jittered by uniform*len2 per
    component, origin offset along the normal by 0.005*(uniform+1)."""
    jitter = rng.uniform((3,)).astype(F32) * F32(light.len2)
    adj = np.asarray(light.orig, dtype=F32) + jitter
    d = m3.unit(adj - point)
    smudge = norm_f * F32(0.005) * (rng.uniform(()) + F32(1.0))
    return point + smudge, d


def is_shadowed(tris: TriangleArrays, light, point, norm_f, self_idx: int,
                rng) -> bool:
    """Occlusion query per the commented design (raytrace.rs:1204-1224):
    shadowed if any OTHER object intersects the shadow ray (no distance
    limit, self excluded by id)."""
    o, d = shadow_ray(light, point, norm_f, rng)
    t, valid, _, _ = intersect_all(tris, o, d)
    valid = valid.copy()
    valid[self_idx] = False
    return bool(valid.any())


def project_ray(tris: TriangleArrays, orig, d, depth: int, rng,
                stats: Optional[OracleStats] = None,
                debug_ctx=None, lights=None, octree=None) -> np.ndarray:
    """Recursive integrator (`project_ray`, raytrace.rs:1256-1295).

    depth==0 -> black (checked before anything else, raytrace.rs:1261-1263);
    miss -> sky blue; hit -> `color_ray` dispatch (raytrace.rs:1199-1254).
    `lights` enables the shadow-ray extension (the commented-out design at
    raytrace.rs:1203-1224): a shadowed hit contributes black instead of its
    surface color.  `octree` (with debug_ctx) records each visited leaf's
    candidate-triangle list into the trace, exactly where the reference's
    traversal does (raytrace.rs:1018-1021) — the set the differ uses to
    classify mismatches as traversal-vs-intersection bugs.
    """
    if depth == 0:
        return BLACK.copy()
    from .utils import tracelog
    tracelog.ray(orig, d)     # RUST_RAYTRACE_LOG=debug (raytrace.rs:1259)
    if debug_ctx is not None:
        debug_ctx.add_ray(orig, d)
        if octree is not None:
            from .octree import get_all_objects_for_ray
            for tri_list in get_all_objects_for_ray(octree, orig, d).values():
                debug_ctx.update_ray_triangles(orig, tri_list)
    if stats is not None:
        stats.rays += 1

    hit = nearest_hit(tris, orig, d)
    if hit is None:
        return SKY_COLOR.copy()
    t, idx, edge, back = hit
    if debug_ctx is not None:
        debug_ctx.update_ray_hit(orig, idx, t)

    point = orig + d * F32(t)
    # Edge band -> solid black wireframe (Triangle::getsurface, raytrace.rs:450-460)
    if edge:
        return BLACK.copy()

    kind = int(tris.materials.kind[idx])
    color = tris.materials.color[idx]
    norm_f0 = tris.norm[idx] * (F32(-1.0) if back else F32(1.0))
    if lights is not None and is_shadowed(tris, lights, point, norm_f0, idx,
                                          rng):
        color = BLACK

    if kind == KIND_SOLID:
        return color.copy()

    norm_f = norm_f0
    alpha = F32(tris.materials.alpha[idx])
    if kind == KIND_MATTE:
        off, nd = lambertian_dir(norm_f, rng)
        norig = point + off * F32(0.001)
    elif kind == KIND_REFLECTIVE:
        fuzz = F32(tris.materials.scattering[idx])
        off, nd = reflect_dir(norm_f, d, fuzz, rng)
        norig = point + off * F32(0.001)
    else:
        raise ValueError(f"bad material kind {kind}")

    bounce = project_ray(tris, norig, nd, depth - 1, rng, stats, debug_ctx,
                         lights, octree)
    return m3.mix_color(color, bounce, alpha)


def render(tris: TriangleArrays, v: Viewport, rng=None,
           stats: Optional[OracleStats] = None,
           debug_ctx=None, lights=None, octree=None) -> np.ndarray:
    """Render [H, W, 3] with the recursive oracle (walk_ray_set semantics,
    raytrace.rs:1396-1440; box-filter average over samples at :1426).

    With `debug_ctx` and `octree`, each ray's candidate-triangle sets are
    recorded from the octree walk (raytrace.rs:1018-1021) for the differ.
    """
    rng = rng or FixedRng()
    img = np.zeros((v.height, v.width, 3), dtype=F32)
    for row in range(v.height):
        for col in range(v.width):
            acc = np.zeros(3, dtype=F32)
            for _ in range(v.samples_per_pixel):
                if v.samples_per_pixel == 1:
                    jitter = None
                else:
                    # drawn from the injected rng so multi-sample renders are
                    # reproducible (bit-determinism contract of this module)
                    jitter = (float(rng.uniform(())), float(rng.uniform(())))
                o, d = pixel_rays(v, np.asarray(row), np.asarray(col), jitter)
                if debug_ctx is not None:
                    debug_ctx.register_ray(o, (row, col))
                acc += project_ray(tris, o, d, v.maxdepth, rng, stats,
                                   debug_ctx, lights, octree)
            img[row, col] = acc * (F32(1.0) / F32(v.samples_per_pixel))
    return img
