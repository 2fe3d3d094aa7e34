"""A frame from its key, in plain torch: the camera, the wave loop, the
box filter, the u8 quantization and the un-permute.

The benchmark reference's frozen copy of the port's `engine.py` render
under live RNG (`camera_rays_tiled`, `pos_uniform`, the pinhole fold, the
wave loop of `_render_waves` with its compaction boundaries, the unfused
lit wave 0 with `shadow_rays` and `shadow_mask`, the streamed regime's
`_streamed_wave` with `shadow_mask_streamed`, `box_filter`, `quantize_u8`,
`tile_permutation`, `_assemble_host_image`, `plan_boundaries`) and of
`parallel/distributed.py`'s shards, each under fold_in(key, rank).  It
takes the scene's triangles from `geometry`, builds its own pages and
tables, takes the regime the program's default Engine takes (a scene past
the resident tables is streamed), and derives every key, lane and schedule
from the frame's key as the program does.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from .arith import fma, fold_in, rsqrt, sum3, threefry2x32, uniform
from .compact import compact, compact_meta, dead_capacity, expand, pick_cb
from .pages import (GROUP, MAX_BANKS, STREAMED_PAGE_SIZE, TABLE_SLOT_CAP,
                    auto_page_size, build_pages_kd, build_perlane_tables,
                    build_streamed_tables)
from .trace import (ROW_ACC, ROW_ALIVE, ROW_DEAD, ROW_ENC, ROW_ID, ROW_NORM,
                    ROW_T, cull, fold_pages_origin, page_lists, shade,
                    trace_chunks, trace_shade_perlane, trace_shade_streamed,
                    trace_streamed)

F32 = np.float32
RAY_CHUNK = 1024
WEIGHT_CUTOFF = 1 / 512


@dataclass
class SceneTables:
    """The reference's own tables of a scene on a device: the union pages
    and the resident tables, or in the streamed regime the streamed tables
    (PK, aabb_lo, aabb_hi and perlane None)."""

    PK: torch.Tensor
    aabb_lo: torch.Tensor
    aabb_hi: torch.Tensor
    perlane: tuple
    page_size: int
    light: tuple          # (ox, oy, oz, len2) float32 values, or None
    folded: dict          # camera -> PK with the pinhole folded in
    streamed: tuple = None    # (plt_i, plt_s, ab, bank_ab)

    @property
    def device(self):
        return (self.PK if self.streamed is None else self.streamed[0]).device


def scene_tables(tris, light, device) -> SceneTables:
    """Pages of the program's page size and the resident tables; past the
    resident tables, as the program's default Engine decides it, pages of
    at least STREAMED_PAGE_SIZE and the streamed tables."""
    n_tris = max(len(tris) - 1, 1)
    page_size = (auto_page_size(n_tris) if n_tris <= TABLE_SLOT_CAP
                 else STREAMED_PAGE_SIZE)
    PK, lo, hi = build_pages_kd(tris, page_size)
    dev = torch.device(device)
    lit = None if light is None else tuple(
        float(np.float32(x)) for x in (*np.asarray(light[:3]).reshape(3),
                                       light[3]))
    if PK.shape[0] > MAX_BANKS * GROUP or PK.size // 128 > TABLE_SLOT_CAP:
        tabs = tuple(torch.from_numpy(x).to(dev)
                     for x in build_streamed_tables(PK, lo, hi))
        return SceneTables(None, None, None, None, page_size, lit, {}, tabs)
    tabs = tuple(torch.from_numpy(x).to(dev)
                 for x in build_perlane_tables(PK, lo, hi))
    return SceneTables(torch.from_numpy(PK).to(dev),
                       torch.from_numpy(lo).to(dev),
                       torch.from_numpy(hi).to(dev), tabs, page_size, lit, {})


def pick_tile(width: int, height: int) -> int:
    for t in (32, 16, 8):
        if width % t == 0 and height % t == 0:
            return t
    return 1


def tile_permutation(height: int, width: int, spp: int, tile: int):
    """perm[q] = row-major ray index of tile-major stream position q."""
    rows, cols = np.arange(height), np.arange(width)
    order = []
    for tr in range(0, height, tile):
        for tc in range(0, width, tile):
            rr, cc = np.meshgrid(rows[tr:tr + tile], cols[tc:tc + tile],
                                 indexing="ij")
            order.append((rr * width + cc).reshape(-1))
    order = np.concatenate(order)
    if spp > 1:
        order = (order[:, None] * spp + np.arange(spp)[None, :]).reshape(-1)
    return order.astype(np.int64)


def pos_uniform(key, q, salt: int):
    k0, k1 = (int(w) for w in fold_in(key, salt))
    bits, _ = threefry2x32(k0, k1, q.to(torch.int64) & 0xFFFFFFFF, 0)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def unit_rows(v):
    return v * rsqrt(sum3(v, v))[None]


def camera_rays_tiled(v, tile: int, n_pad: int, device, key, q_base: int = 0):
    """(o, d) [3, n_pad] of the stream positions q_base.. in tile order, a
    pixel's spp samples adjacent and jittered by pos_uniform, zero past the
    image; both image-plane multiply-adds fused."""
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
        u_off = pos_uniform(key, q, 1_000_001)
        v_off = pos_uniform(key, q, 1_000_002)

    def column(a):
        return torch.from_numpy(np.asarray(a, F32).copy()).to(device)[:, None]

    vu_delta = column(np.asarray(v.vu, F32) * (F32(1.0) / F32(v.width)))
    vv_delta = column(np.asarray(v.vv, F32) * (F32(1.0) / F32(v.height)))
    px_u = fma(vv_delta, (row + v_off)[None],
               fma(vu_delta, (col + u_off)[None], column(v.orig)))
    d = unit_rows(px_u - column(v.cam))
    live = (q < R0)[None]
    return torch.where(live, px_u, 0.0), torch.where(live, d, 0.0)


def shadow_rays(tabs: SceneTables, state, rows, key, wave: int):
    """From each hit a jittered ray to the light (jax.random draws under
    fold_in(key, 7_000_000 + wave)): (so, sd, hit, excl), zero off the hit
    mask, excl the id of each ray's own triangle."""
    o, d = state[0:3], state[3:6]
    R = o.shape[1]
    dev = o.device
    hid = rows[ROW_ID]
    hit = (state[ROW_ALIVE] != 0.0) & (hid != 0.0)
    point = fma(torch.where(hit, rows[ROW_T], 0.0)[None], d, o)
    nrm = rows[ROW_NORM:ROW_NORM + 3]
    norm_f = torch.where((rows[ROW_ENC] >= 8.0)[None], -nrm, nrm)
    skey = fold_in(key, 7_000_000 + wave)
    u3 = uniform(fold_in(skey, 0), (3, R), dev)
    u1 = uniform(fold_in(skey, 1), (1, R), dev)
    lo = torch.tensor(tabs.light[:3], dtype=torch.float32, device=dev)[:, None]
    sd = unit_rows(fma(u3, tabs.light[3], lo) - point)
    so = fma(norm_f, 0.005 * (u1 + 1.0), point)
    so = torch.where(hit[None], so, 0.0)
    sd = torch.where(hit[None], sd, 0.0)
    return so, sd, hit, torch.where(hit, hid, 0.0)


def shadow_mask(tabs: SceneTables, state, rows, key, wave: int):
    """The unfused shadow pass: the shadow rays, the cull, a sort and the
    union trace with the ray's own triangle excluded."""
    so, sd, hit, excl = shadow_rays(tabs, state, rows, key, wave)
    smask, stmin = cull(so, sd, hit, tabs.aabb_lo, tabs.aabb_hi, RAY_CHUNK)
    srows = trace_chunks(so, sd, tabs.PK, *page_lists(smask, stmin),
                         RAY_CHUNK, excl=excl)
    return (hit & (srows[ROW_ID] != 0.0)).float()


def streamed_wave(tabs: SceneTables, state, key, wave: int, seed,
                  chunk_live):
    """One wave of the streamed regime: unlit, the trace and shade of the
    live chunks; lit, the trace to winner rows, the shadow rays' any-hit
    trace with each ray's own triangle excluded, the shade."""
    P = tabs.page_size
    if tabs.light is None:
        return trace_shade_streamed(state, tabs.streamed, seed, P, RAY_CHUNK,
                                    WEIGHT_CUTOFF, chunk_live)
    rows = trace_streamed(state[0:3], state[3:6], state[ROW_ALIVE],
                          tabs.streamed, P, RAY_CHUNK, chunk_live)
    so, sd, hit, excl = shadow_rays(tabs, state, rows, key, wave)
    srows = trace_streamed(so, sd, hit.float(), tabs.streamed, P, excl=excl,
                           any_hit=True)
    shd = (hit & (srows[ROW_ID] != 0.0)).float()
    return shade(state, rows, seed, RAY_CHUNK, WEIGHT_CUTOFF, chunk_live,
                 shd)


def waves(tabs: SceneTables, o, d, alive0, key, maxdepth: int, pk0,
          schedule):
    """The compacted wave loop: ([3, R] float color in lane order, the
    live rays at the start of each wave).  schedule: a bool per boundary
    (after wave b)."""
    R = o.shape[1]
    RB = RAY_CHUNK
    dev = o.device
    a0 = alive0.to(torch.float32)[None]
    state = torch.cat([o, d, a0, a0, torch.zeros((16 - ROW_ACC, R),
                                                 device=dev)], dim=0)
    cb = pick_cb(R)
    n_bound = sum(bool(s) for s in schedule[:maxdepth - 1])
    dead_arr = torch.zeros((8, dead_capacity(R, n_bound, cb)),
                           dtype=torch.float32, device=dev)
    dead_base = torch.zeros((), dtype=torch.int32, device=dev)
    boundaries, counts = [], []
    P = tabs.page_size
    for wave in range(maxdepth):
        alive = state[ROW_ALIVE] != 0.0
        counts.append(int(alive.sum()))
        seed = fold_in(key, wave)
        if tabs.streamed is not None:
            chunk_live = (alive.reshape(R // RB, RB).any(dim=1) if wave
                          else torch.ones(R // RB, dtype=torch.bool,
                                          device=dev))
            state = streamed_wave(tabs, state, key, wave, seed, chunk_live)
        elif wave == 0:
            mask, tmin = cull(state[0:3], state[3:6], alive, tabs.aabb_lo,
                              tabs.aabb_hi, RB)
            rows = trace_chunks(state[0:3], state[3:6], pk0,
                                *page_lists(mask, tmin), RB,
                                zero_origin=True)
            shd = (None if tabs.light is None
                   else shadow_mask(tabs, state, rows, key, 0))
            state = shade(state, rows, seed, RB, WEIGHT_CUTOFF,
                          torch.ones(R // RB, dtype=torch.int32, device=dev),
                          shd)
        else:
            chunk_live = alive.reshape(R // RB, RB).any(dim=1)
            state = trace_shade_perlane(state, tabs.perlane, seed, P, RB,
                                        WEIGHT_CUTOFF, chunk_live, tabs.light)
        if not (wave < len(schedule) and schedule[wave]
                and wave < maxdepth - 1):
            continue
        meta, _, _, dead_end = compact_meta(state[ROW_ALIVE],
                                            state[ROW_DEAD], cb, dead_base, R)
        masks = torch.stack([state[ROW_ALIVE], state[ROW_DEAD]])
        state, dead_arr = compact(state, dead_arr, meta, cb)
        boundaries.append((meta, masks))
        skip = bool(meta[0, 6])
        dead_base = dead_base if skip else dead_end
    y = state[ROW_ACC:ROW_ACC + 4]
    for meta, masks in reversed(boundaries):
        y = expand(y, dead_arr, masks, meta, cb)
    return y[0:3], counts


def quantized(img, spp: int):
    """The box filter (a left-to-right add chain over a pixel's samples,
    then /spp) and the PNG writer's u8 truncation."""
    if spp > 1:
        s = img.reshape(3, img.shape[1] // spp, spp)
        acc = s[..., 0]
        for i in range(1, spp):
            acc = acc + s[..., i]
        img = acc / float(spp)
    x = torch.nan_to_num(img * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def unpermute(img_u8, v) -> np.ndarray:
    """The tile-order u8 framebuffer [3, >= H*W] as the [H, W, 3] image."""
    spp = v.samples_per_pixel
    P0 = v.height * v.width
    perm = tile_permutation(v.height, v.width, spp,
                            pick_tile(v.width, v.height))
    pixperm = perm[::spp] // spp if spp > 1 else perm
    img = np.empty((P0, 3), dtype=np.uint8)
    img[pixperm] = img_u8.cpu().numpy().T[:P0]
    return img.reshape(v.height, v.width, 3)


def _folded(tabs: SceneTables, v):
    cam = tuple(np.asarray(v.cam, dtype=np.float32).tolist())
    if cam not in tabs.folded:
        tabs.folded[cam] = fold_pages_origin(tabs.PK, cam)
    return tabs.folded[cam]


def render(tabs: SceneTables, v, key, schedule=(True, True), shards: int = 1):
    """(image [H, W, 3] u8, live rays of each wave summed over the shards)
    of one frame under `key`: with shards n, rank r's share of the
    tile-order rays under fold_in(key, r), as the render across processes
    splits it."""
    spp = v.samples_per_pixel
    R0 = v.height * v.width * spp
    quantum = RAY_CHUNK * spp // math.gcd(RAY_CHUNK, spp)
    R = -(-R0 // (shards * quantum)) * shards * quantum
    Rs = R // shards
    dev = tabs.device
    tile = pick_tile(v.width, v.height)
    pk0 = None if tabs.streamed is not None else _folded(tabs, v)
    cam = torch.from_numpy(np.asarray(v.cam, F32).copy()).to(dev)
    parts, counts = [], np.zeros(v.maxdepth, dtype=np.int64)
    for r in range(shards):
        k = key if shards == 1 else fold_in(key, r)
        _, d = camera_rays_tiled(v, tile, Rs, dev, key, q_base=r * Rs)
        o = cam[:, None].expand(d.shape).contiguous()
        alive0 = torch.arange(Rs, device=dev) + r * Rs < R0
        img, c = waves(tabs, o, d, alive0, k, v.maxdepth, pk0, schedule)
        parts.append(quantized(img, spp))
        counts += np.asarray(c, dtype=np.int64)
    return unpermute(torch.cat(parts, dim=1), v), counts


def plan_boundaries(wave_rays, tau_mid: float = 0.65):
    """The program's one-shot schedule from a frame's wave decay: boundary
    b compacts iff its survivors are at most tau_mid of the content prefix
    while two or more waves remain, never before the last wave."""
    n = len(wave_rays)
    sched = []
    prefix = max(float(wave_rays[0]), 1.0)
    for b in range(1, n):
        surv = float(wave_rays[b])
        if n - b > 1 and surv <= tau_mid * prefix:
            sched.append(True)
            prefix = max(surv, 1.0)
        else:
            sched.append(False)
    return tuple(sched)
