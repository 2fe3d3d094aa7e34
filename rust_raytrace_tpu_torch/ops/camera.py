"""The camera: a render's primary rays in tile-major order.

Counterpart: `rust_raytrace_tpu/engine.py:_camera_rays_tiled` with the spp
jitter `_pos_uniform`, which the JAX package computes in XLA, outside any
kernel.  `camera_rays_tiled` runs the CUDA kernel of `csrc/camera.cu` for a
CUDA device, one launch, and `camera_rays_tiled_plain` for a CPU one.  No
TPU kernel is replaced; the kernel exists because the plain version's ~640
elementwise launches a frame (the threefry in int64, each fma in float64)
held the H100 57 ms of a ~75 ms 2560x1440 spp 4 frame.
"""

import numpy as np
import torch

from ..utils import native, xla_rsqrt
from ..utils.rng import fold_in, threefry2x32
from .shade import fma, unit_rows

F32 = np.float32

#: the salts of the spp jitter's two draws: across, then down
SALT_U, SALT_V = 1_000_001, 1_000_002


def pos_uniform(key, q: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) float32 keyed by the absolute stream position q (the
    JAX `_pos_uniform`): the first word of Threefry-2x32 under the key
    fold_in(key, salt) of the counter (q, 0), its top 24 bits times 2^-24.
    A pure function of (key, salt, q), so any window of the stream draws
    the full render's values."""
    k0, k1 = (int(w) for w in fold_in(key, salt))
    bits, _ = threefry2x32(k0, k1, q.to(torch.int64) & 0xFFFFFFFF, 0)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _live_count(v, q_base: int, n_live):
    if n_live is None:
        return v.height * v.width * v.samples_per_pixel - q_base
    return n_live


def camera_rays_tiled_plain(v, tile: int, n_pad: int, device, key=None,
                            q_base: int = 0, pinhole: bool = False,
                            n_live=None):
    """Plain torch version of `camera_rays_tiled`, on `device`."""
    spp = v.samples_per_pixel
    R0 = v.height * v.width * spp
    q = torch.arange(n_pad, device=device) + q_base
    pix = q // spp if spp > 1 else q
    T = tile
    tpr = v.width // T
    tile_id = pix // (T * T)
    within = pix % (T * T)
    row = ((tile_id // tpr) * T + within // T).to(torch.float32)
    col = ((tile_id % tpr) * T + within % T).to(torch.float32)
    if spp == 1:
        u_off = v_off = 0.5
    else:
        u_off = pos_uniform(key, q, SALT_U)
        v_off = pos_uniform(key, q, SALT_V)

    def column(a):
        return torch.from_numpy(np.asarray(a, F32).copy()).to(device)[:, None]

    vu_delta = column(np.asarray(v.vu, F32) * (F32(1.0) / F32(v.width)))
    vv_delta = column(np.asarray(v.vv, F32) * (F32(1.0) / F32(v.height)))
    px_u = fma(vv_delta, (row + v_off)[None],
               fma(vu_delta, (col + u_off)[None], column(v.orig)))
    d = unit_rows(px_u - column(v.cam))
    live = (q < R0)[None]
    if pinhole:
        o = column(v.cam).expand(3, n_pad).contiguous()
    else:
        o = torch.where(live, px_u, 0.0)
    alive = torch.arange(n_pad, device=device) < _live_count(v, q_base,
                                                             n_live)
    return o, torch.where(live, d, 0.0), alive


def camera_rays_tiled(v, tile: int, n_pad: int, device, key=None,
                      q_base: int = 0, pinhole: bool = False, n_live=None):
    """Primary rays in tile-major order (`pixel_ray`): (o, d, alive), o and
    d [3, n_pad] float32 and alive [n_pad] bool on `device`, for the stream
    positions q_base .. q_base + n_pad of the whole image (a band of
    `Engine.render_banded` or a rank's shard gets the very rays the full
    render emits there).  A pixel's spp samples sit on adjacent lanes (q //
    spp is the pixel); spp 1 shoots through the pixel centre, spp > 1
    jitters sample q by `pos_uniform(key, q, SALT_U)` across and `SALT_V`
    down.  Positions past the image have o = d = 0 (invalid lanes).
    pinhole: o is the camera's position on every lane, padding included
    (the Engine's pinhole fold).  alive: lane i < n_live (default: the
    lanes inside the image).

    The image-plane point is orig + vu*(col + 0.5) + vv*(row + 0.5) with
    both multiply-adds fused, as XLA on the CPU compiles the JAX version
    (ROADMAP C2): unfused, a ray 1 ulp off flips a pixel of the 48x27
    circles render.  The normalization is `unit_rows`, with XLA-CPU's rsqrt
    (C1).

    On a CUDA device one launch of `csrc/camera.cu` computes it, the host
    passing every constant as a scalar (nothing is copied to the card); on
    the CPU `camera_rays_tiled_plain`.  Raises on what the kernel does not
    take: a tile that is not a power of two dividing the width, stream
    positions past 2^31 - 1, no key at spp > 1."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return camera_rays_tiled_plain(v, tile, n_pad, dev, key, q_base,
                                       pinhole, n_live)
    native.require(dev.type == "cuda",
                   f"camera_rays_tiled: no kernel for device {dev}")
    spp = v.samples_per_pixel
    native.require(tile >= 1 and tile & (tile - 1) == 0
                   and v.width % tile == 0,
                   f"camera_rays_tiled: tile {tile} for width {v.width}")
    native.require(n_pad >= 0 and 0 <= q_base
                   and q_base + n_pad <= 2 ** 31 - 1
                   and v.height * v.width * spp <= 2 ** 31 - 1,
                   f"camera_rays_tiled: positions {q_base} + {n_pad}")
    native.require(spp == 1 or key is not None,
                   f"camera_rays_tiled: spp {spp} jitters by a key")
    ku, kv = ((fold_in(key, SALT_U), fold_in(key, SALT_V)) if spp > 1
              else ((0, 0), (0, 0)))
    # held in a local until the launch has read it
    view = np.concatenate([
        np.asarray(v.orig, F32).reshape(3), np.asarray(v.cam, F32).reshape(3),
        np.asarray(v.vu, F32).reshape(3) * (F32(1.0) / F32(v.width)),
        np.asarray(v.vv, F32).reshape(3) * (F32(1.0) / F32(v.height))])
    o = torch.empty((3, n_pad), dtype=torch.float32, device=dev)
    d = torch.empty((3, n_pad), dtype=torch.float32, device=dev)
    alive = torch.empty(n_pad, dtype=torch.bool, device=dev)
    native.CAMERA(o.data_ptr(), d.data_ptr(), alive.data_ptr(), n_pad,
                  q_base, v.height * v.width * spp,
                  _live_count(v, q_base, n_live), spp, v.width, tile,
                  view.ctypes.data, int(ku[0]), int(ku[1]),
                  int(kv[0]), int(kv[1]),
                  xla_rsqrt.device_table(dev).data_ptr(), int(pinhole),
                  native.stream(dev))
    return o, d, alive
