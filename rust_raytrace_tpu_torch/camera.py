"""Camera / viewport: batched ray generation.

The torch port's copy of `rust_raytrace_tpu/camera.py`: numpy only, so the
port imports nothing of the JAX package.

Reference semantics (`raytrace_lib/src/raytrace.rs:1305-1394`):
  - `create_transform(dir, d_roll)` builds a yaw/pitch/roll rotation frame from
    the view direction (raytrace.rs:1320-1341);
  - `create_viewport` places the image plane:
      dist  = size.w / (2*tan(fov/2))                 (raytrace.rs:1345)
      orig  = pos + [size.h/2, -size.w/2, 0]          (raytrace.rs:1349 — note:
              this offset is NOT rotated; a reference quirk we preserve)
      cam   = pos - change_basis([0,0,dist])          (raytrace.rs:1351-1352)
      vu    = change_basis([0, size.w, 0])            (raytrace.rs:1354-1355)
      vv    = change_basis([-size.h, 0, 0])           (raytrace.rs:1357-1358)
  - `pixel_ray((row, col))` (raytrace.rs:1374-1394):
      px_u = orig + vu/width*(col + u_off) + vv/height*(row + v_off)
      ray  = (orig=px_u, dir=unit(px_u - cam))
      u_off = v_off = 0.5 when samples_per_pixel == 1, else uniform random
      jitter (raytrace.rs:1382-1386).

The per-pixel scalar call becomes one broadcast over the pixel grid: the whole
[H*W(,S),3] ray batch is produced in a single fused XLA computation.  Works
with numpy (host/oracle) or jax.numpy (inside jit) via the `xp` argument.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import math3d as m3

F32 = np.float32


def create_transform(dir_in, d_roll: float, xp=np):
    """Rotation frame rows from view direction + roll (raytrace.rs:1320-1341)."""
    d = m3.unit(xp.asarray(dir_in, dtype=F32), xp)
    roll = -xp.arctan2(-d[1], d[2])
    pitch = -xp.arcsin(d[0])
    yaw = F32(-d_roll)

    cy, sy = xp.cos(yaw), xp.sin(yaw)
    cp, sp = xp.cos(pitch), xp.sin(pitch)
    cr, sr = xp.cos(roll), xp.sin(roll)

    b0 = xp.stack([cy * cp, sy * cp, -sp]).astype(F32)
    b1 = xp.stack([cy * sp * sr - sy * cr, sy * sp * sr + cy * cr, cp * sr]).astype(F32)
    b2 = xp.stack([cy * sp * cr + sy * sr, sy * sp * cr - cy * sr, cp * cr]).astype(F32)
    return b0, b1, b2


@dataclass(frozen=True)
class Viewport:
    """Precomputed image-plane frame (reference `Viewport`, raytrace.rs:1305-1318)."""

    width: int
    height: int
    orig: np.ndarray   # [3] image-plane anchor
    cam: np.ndarray    # [3] pinhole position
    vu: np.ndarray     # [3] horizontal image-plane extent (rotated)
    vv: np.ndarray     # [3] vertical image-plane extent (rotated)
    maxdepth: int
    samples_per_pixel: int


def create_viewport(px: Tuple[int, int], size: Tuple[float, float], pos, dir,
                    fov_deg: float, c_roll: float, maxdepth: int,
                    samples: int) -> Viewport:
    """Build a Viewport (raytrace.rs:1343-1370)."""
    pos = np.asarray(pos, dtype=F32)
    size_w, size_h = F32(size[0]), F32(size[1])

    dist = size_w / (2.0 * np.tan(np.radians(F32(fov_deg)) / 2.0, dtype=F32))
    # c_roll arrives in radians (callers convert, as raytrace/src/main.rs:171 does)
    rot = create_transform(dir, F32(c_roll))

    orig = pos + np.asarray([size_h / 2.0, -size_w / 2.0, 0.0], dtype=F32)
    cam = pos - m3.change_basis(np.asarray([0.0, 0.0, dist], dtype=F32), rot)
    vu = m3.change_basis(np.asarray([0.0, size_w, 0.0], dtype=F32), rot)
    vv = m3.change_basis(np.asarray([-size_h, 0.0, 0.0], dtype=F32), rot)

    return Viewport(width=int(px[0]), height=int(px[1]), orig=orig, cam=cam,
                    vu=vu, vv=vv, maxdepth=int(maxdepth),
                    samples_per_pixel=int(samples))


def pixel_rays(v: Viewport, rows, cols, jitter: Optional[tuple] = None, xp=np):
    """Rays for pixel coordinates (vectorized `pixel_ray`, raytrace.rs:1374-1394).

    rows, cols: broadcastable integer arrays (row = x index in [0,height),
    col = y index in [0,width) — reference's (px.0, px.1) order).
    jitter: None for the deterministic spp==1 center offset (0.5, 0.5), else a
    tuple (u_off, v_off) of arrays broadcastable to rows/cols in [0,1).

    Returns (orig, dir) with shape [..., 3]; dir is unit length.  `inv_dir` is
    not materialized — slab tests compute it where needed (the reference
    precomputes it in `make_ray`, raytrace.rs:201-210).
    """
    rows = xp.asarray(rows, dtype=F32)
    cols = xp.asarray(cols, dtype=F32)
    if jitter is None:
        u_off = v_off = F32(0.5)
    else:
        u_off, v_off = jitter

    vu_delta = xp.asarray(v.vu) * (F32(1.0) / F32(v.width))
    vv_delta = xp.asarray(v.vv) * (F32(1.0) / F32(v.height))

    px_u = (xp.asarray(v.orig)
            + vu_delta * (cols + u_off)[..., None]
            + vv_delta * (rows + v_off)[..., None])
    d = m3.unit(px_u - xp.asarray(v.cam), xp)
    return px_u, d


def camera_rays(v: Viewport, xp=np, jitter: Optional[tuple] = None):
    """All primary rays, row-major [H*W, 3] origins and unit directions."""
    rows = xp.arange(v.height)[:, None] * xp.ones((1, v.width), dtype=np.int32)
    cols = xp.ones((v.height, 1), dtype=np.int32) * xp.arange(v.width)[None, :]
    o, d = pixel_rays(v, rows.reshape(-1), cols.reshape(-1), jitter, xp)
    return o, d
