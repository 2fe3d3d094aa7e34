"""3-vector math for host-side scene precompute.

The benchmark reference's frozen copy of the port's `math3d.py` (numpy
only): the reference imports nothing of the program.

TPU-native rethink of the reference's SIMD Vec3 core
(`raytrace_lib/src/raytrace.rs:22-173`).  The reference wraps a 4-lane f32 SIMD
register per vector and threads scalar Vec3 values through every call; on TPU
there is no scalar-SIMD type — vectors are rows of `[..., 3]` float32 arrays and
the 8x128 VPU vectorizes across the batch dimension instead of across xyz.  All
functions here are shape-polymorphic over leading dimensions and are used both
by numpy (host precompute, test oracle) and by jax.numpy inside jit (they only
use ufuncs common to both).

Semantics matched to the reference (all f32):
  - dot/cross/len/len2/unit:       raytrace.rs:65-96
  - orthogonal:                    raytrace.rs:98-108
  - basis:                         raytrace.rs:110-115
  - change_basis (row-matrix mul): raytrace.rs:117-121
"""

import numpy as np

__all__ = [
    "vec", "dot", "cross", "len2", "length", "unit",
    "orthogonal", "basis", "change_basis", "make_color", "mix_color",
]

F32 = np.float32


def vec(x, y, z, xp=np):
    """Build a single f32 3-vector (reference `make_vec`, raytrace.rs:29-33)."""
    return xp.asarray([x, y, z], dtype=F32)


def dot(a, b, xp=np):
    """Row-wise dot product over the last axis (raytrace.rs:75-77)."""
    return xp.sum(a * b, axis=-1)


def cross(a, b, xp=np):
    """Row-wise cross product (raytrace.rs:80-90, SIMD swizzle form)."""
    a1 = xp.stack([a[..., 1], a[..., 2], a[..., 0]], axis=-1)
    a2 = xp.stack([a[..., 2], a[..., 0], a[..., 1]], axis=-1)
    b1 = xp.stack([b[..., 1], b[..., 2], b[..., 0]], axis=-1)
    b2 = xp.stack([b[..., 2], b[..., 0], b[..., 1]], axis=-1)
    return a1 * b2 - a2 * b1


def len2(a, xp=np):
    return xp.sum(a * a, axis=-1)


def length(a, xp=np):
    return xp.sqrt(xp.sum(a * a, axis=-1))


def unit(a, xp=np):
    """`v * (1/|v|)` exactly as raytrace.rs:92-96 (mult by reciprocal length).

    A zero vector yields inf/nan, matching the reference's behavior.
    """
    inv = F32(1.0) / length(a, xp)
    return a * inv[..., None]


def orthogonal(a, xp=np):
    """Deterministic orthogonal vector (raytrace.rs:98-108).

    Single-vector only (the reference recurses on near-zero input; that branch
    can only loop forever for the zero vector, so we don't reproduce it).
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    if a.ndim == 1:
        if abs(float(ax)) > 0.1:
            return unit(xp.stack([-(ay + az) / ax, F32(1.0), F32(1.0)], axis=-1), xp)
        if abs(float(ay)) > 0.1:
            return unit(xp.stack([F32(1.0), -(ax + az) / ay, F32(1.0)], axis=-1), xp)
        if abs(float(az)) > 0.1:
            return unit(xp.stack([F32(1.0), F32(1.0), -(ax + ay) / az], axis=-1), xp)
        return orthogonal(unit(a, xp), xp)
    # Branchless batched form (used by batched shading paths).  Unselected
    # candidates get a safe denominator so zero components can't produce
    # inf/NaN temporaries (only the branch with |component| > 0.1 is kept).
    one = xp.ones_like(ax)
    use_x = xp.abs(ax) > 0.1
    use_y = xp.abs(ay) > 0.1
    use_z = xp.abs(az) > 0.1
    sx = xp.where(use_x, ax, one)
    sy = xp.where(use_y, ay, one)
    sz = xp.where(use_z, az, one)
    cand_x = xp.stack([-(ay + az) / sx, one, one], axis=-1)
    cand_y = xp.stack([one, -(ax + az) / sy, one], axis=-1)
    cand_z = xp.stack([one, one, -(ax + ay) / sz], axis=-1)
    out = xp.where(use_x[..., None], cand_x,
                   xp.where(use_y[..., None], cand_y, cand_z))
    return unit(out, xp)


def basis(a, xp=np):
    """Orthonormal frame (bx, by, n) with n = unit(a) (raytrace.rs:110-115)."""
    n = unit(a, xp)
    bx = orthogonal(n, xp)
    by = cross(n, bx, xp)
    return bx, by, n


def change_basis(v, b, xp=np):
    """Project `v` onto frame rows (b0, b1, b2) (raytrace.rs:117-121).

    Returns [b0.v, b1.v, b2.v]; i.e. multiplication by the row matrix [b0;b1;b2].
    `v` may be batched [..., 3]; each b_i is a single 3-vector.
    """
    b0, b1, b2 = b
    return xp.stack([dot(v, b0, xp), dot(v, b1, xp), dot(v, b2, xp)], axis=-1)


def _ray_intersect_2d(ao, av, bo, bv, i, j):
    """2D-projection solve onto axes (i, j) (raytrace.rs:212-224).

    Returns (t1, t2) or None when the projected directions are parallel
    (|det| < 1e-4, the reference's threshold).  f32 operation order matches
    the reference: det = u_i*v_j - u_j*v_i with u = bv, v = av.
    """
    det = F32(bv[i] * av[j] - bv[j] * av[i])
    if abs(det) < F32(0.0001):
        return None
    dx = F32(bo[i] - ao[i])
    dy = F32(bo[j] - ao[j])
    return (F32(dy * bv[i] - dx * bv[j]) / det,
            F32(dy * av[i] - dx * av[j]) / det)


def ray_intersect(ao, ad, bo, bd):
    """Closest-point ray-ray intersection (raytrace.rs:231-267).

    Tries the xy, xz, then yz projection planes; the first non-parallel
    projection yields parameters (t1, t2), and the candidate points
    p1 = ao + t1*ad, p2 = bo + t2*bd intersect iff |p2 - p1|^2 < 0.01.
    Returns p1 (f32 [3]) or None — including for "intersections" behind
    either origin (negative t), exactly as the reference accepts them.

    Host-side utility (completeness parity: the reference's only call site,
    light sampling at raytrace.rs:1030-1076, is replaced on-device by the
    closed-form centroid — docs/PARITY.md)."""
    ao = np.asarray(ao, dtype=F32)
    ad = np.asarray(ad, dtype=F32)
    bo = np.asarray(bo, dtype=F32)
    bd = np.asarray(bd, dtype=F32)
    sol = _ray_intersect_2d(ao, ad, bo, bd, 0, 1)
    if sol is None:
        sol = _ray_intersect_2d(ao, ad, bo, bd, 0, 2)
    if sol is None:
        sol = _ray_intersect_2d(ao, ad, bo, bd, 1, 2)
    if sol is None:
        return None
    t1, t2 = sol
    p1 = ao + F32(t1) * ad
    p2 = bo + F32(t2) * bd
    if len2(p2 - p1) < F32(0.01):
        return p1
    return None


def make_color(rgb):
    """8-bit color tuple -> f32 color in [0,1] (raytrace.rs:176-180)."""
    r, g, b = rgb
    return np.asarray([r / 255.0, g / 255.0, b / 255.0], dtype=F32)


def mix_color(c1, c2, a, xp=np):
    """Lerp c1*(1-a) + c2*a (raytrace.rs:299-301). `a` scalar or [...]-shaped."""
    a = xp.asarray(a, dtype=F32)
    return c1 * (F32(1.0) - a)[..., None] + c2 * a[..., None]
