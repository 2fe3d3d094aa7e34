"""The production render path on torch: `Engine` and its host helpers.

Counterpart: `rust_raytrace_tpu/engine.py` — `Engine.__init__` (resident
regime), `Engine.render` with `_pinhole_fold` and the autotune of the
compaction schedule, the wave loop of `_render_device_compact` and its
shadow pass `_shadow_mask`; plus `_camera_rays_tiled` (spp 1) with
`_unit_rows`, `_quantize_u8`, `pick_tile`, `tile_permutation`,
`plan_boundaries`, `auto_page_size` and `_assemble_host_image`, copied
because the JAX module imports jax.

One render: tile-order camera rays -> pinhole fold of the page scalars ->
wave 0 = cull (B1) -> stable sort of the page lists -> union trace + shade
(B2) -> at each compaction boundary: `compact_meta` and compaction (B3) ->
waves 1.. = per-lane trace + shade (B4) -> expansion (B5) backward over the
boundaries -> u8 quantization on the device -> un-permute on the host.  A
scene with a light (`scene.lights`) runs wave 0 unfused: cull (B1) -> sort
-> union trace to winner rows (B6) -> `shadow_mask` (the shadow rays
through B1, a sort and B6 with self-exclusion) -> shade with the mask (B8);
its bounce waves run B4 with the shadow feeler fused.  The kernels run on
CUDA tensors and their plain torch versions on CPU tensors (`device=`).

What this engine does not run yet raises NotImplementedError naming the
ROADMAP item that brings it: spp > 1, debug buffers, bounce_chunk and the
streamed regime.
"""

import time

import numpy as np
import torch

from .camera import Viewport
from .ops.compact import (compact, compact_meta, expand, make_dead_array,
                          pick_cb)
from .ops.cull import cull_mask_exact
from .ops.intersect import (fold_pages_origin, trace_chunks,
                            trace_shade_chunks)
from .ops.intersect_perlane import (GROUP, MAX_BANKS, trace_shade_perlane,
                                    upload_perlane_tables)
from .ops.pages import build_pages_kd
from .ops.shade import fma, rsqrt, shade
from .ops.state import (ROW_ACC, ROW_ALIVE, ROW_DEAD, ROW_ENC, ROW_ID,
                        ROW_NORM, ROW_T, STATE_ROWS)
from .render import RenderResult
from .scene import Scene
from .utils.rng import fold_in, prng_key, uniform

F32 = np.float32

#: rays whose throughput falls below this retire (0.0 under fixed_rng)
WEIGHT_CUTOFF = 1 / 512
#: page-table slots (pages x page size) the resident regime holds; a scene
#: past it needs the streamed regime
TABLE_SLOT_CAP = 262144


def pick_tile(width: int, height: int) -> int:
    for t in (32, 16, 8):
        if width % t == 0 and height % t == 0:
            return t
    return 1


def tile_permutation(height: int, width: int, spp: int, tile: int) -> np.ndarray:
    """perm[q] = row-major ray index of tile-major position q (host side)."""
    rows = np.arange(height)
    cols = np.arange(width)
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


def auto_page_size(n_tris: int, page_size: int = 56) -> int:
    """Scene-adaptive page size: grow the page past the 1-bank default only
    when the scene would need more than 8 banks of 128 pages (target 7), and
    as far as needed to stay within MAX_BANKS banks."""
    def cdiv(a, b):
        return -(-a // b)

    if cdiv(cdiv(n_tris, page_size), GROUP) > 8:
        target = min(7, MAX_BANKS)
        page_size = cdiv(cdiv(n_tris, target * GROUP), 8) * 8
    while cdiv(n_tris, page_size) > MAX_BANKS * GROUP:
        page_size += 8
    return page_size


def plan_boundaries(wave_rays, tau_mid: float = 0.65,
                    tau_last: float = 0.0):
    """Static compaction-boundary schedule from a render's wave decay.

    wave_rays: live rays at the start of each wave.  Boundary b (after wave
    b) compacts iff its survivors are at most tau_mid of the current
    content prefix while two or more waves remain, tau_last (never, by
    default) before the last wave.  The thresholds are the JAX package's,
    fitted to its TPU sweeps.  Returns a per-boundary bool tuple for
    Engine's ncompact."""
    n = len(wave_rays)
    sched = []
    prefix = max(float(wave_rays[0]), 1.0)
    for b in range(1, n):
        surv = float(wave_rays[b])
        tau = tau_last if n - b == 1 else tau_mid
        if tau > 0.0 and surv <= tau * prefix:
            sched.append(True)
            prefix = max(surv, 1.0)
        else:
            sched.append(False)
    return tuple(sched)


def _assemble_host_image(img_dev, v: Viewport, perm: np.ndarray, spp: int,
                         dev_quant: bool) -> np.ndarray:
    """Un-permute a tile-order framebuffer ([3, R] or [3, R//spp] numpy)
    into the [height, width, 3] image.  dev_quant: the input is u8,
    already quantized (and box-filtered) on the device."""
    if dev_quant:
        P0 = v.height * v.width
        data = np.asarray(img_dev).T[:P0]            # [P0, 3] u8
        pixperm = perm[::spp] // spp if spp > 1 else perm
        img = np.empty((P0, 3), dtype=np.uint8)
        img[pixperm] = data
        return img.reshape(v.height, v.width, 3)
    R0 = v.height * v.width * spp
    data = np.asarray(img_dev, dtype=np.float32).T[:R0]
    img = np.empty((R0, 3), dtype=np.float32)
    img[perm] = data
    if spp > 1:
        img = img.reshape(v.height, v.width, spp, 3).mean(axis=2)
    else:
        img = img.reshape(v.height, v.width, 3)
    return img


def unit_rows(v: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """Normalize [3, R] column vectors.  XLA reduces `jnp.sum(v * v,
    axis=0)` in row order with each product fused into the running sum:
    fma(v2, v2, fma(v1, v1, v0*v0)) (measured against the jitted camera).
    wide: the rsqrt of a fusion XLA vectorizes 16 floats wide (C7)."""
    return v * rsqrt(fma(v[2], v[2], fma(v[1], v[1], v[0] * v[0])),
                     wide)[None]


def camera_rays_tiled(v: Viewport, tile: int, n_pad: int, device):
    """Primary rays in tile-major order (`pixel_ray` at the pixel centre):
    (o, d) as [3, n_pad] float32 on `device`; positions past the image have
    o = d = 0 (invalid lanes).

    The image-plane point is orig + vu*(col + 0.5) + vv*(row + 0.5) with
    both multiply-adds fused, as XLA on the CPU compiles the JAX version
    (ROADMAP C2): unfused, a ray 1 ulp off flips a pixel of the 48x27
    circles render.  The normalization is `unit_rows`, with XLA-CPU's rsqrt
    (C1)."""
    if v.samples_per_pixel != 1:
        raise NotImplementedError("spp > 1 camera jitter (ROADMAP A6)")
    R0 = v.height * v.width
    q = torch.arange(n_pad, device=device)
    T = tile
    tpr = v.width // T
    tile_id = q // (T * T)
    within = q % (T * T)
    row = ((tile_id // tpr) * T + within // T).to(torch.float32)
    col = ((tile_id % tpr) * T + within % T).to(torch.float32)

    def column(a):
        return torch.from_numpy(np.asarray(a, F32).copy()).to(device)[:, None]

    vu_delta = column(np.asarray(v.vu, F32) * (F32(1.0) / F32(v.width)))
    vv_delta = column(np.asarray(v.vv, F32) * (F32(1.0) / F32(v.height)))
    px_u = fma(vv_delta, (row + 0.5)[None],
               fma(vu_delta, (col + 0.5)[None], column(v.orig)))
    d = unit_rows(px_u - column(v.cam))
    live = (q < R0)[None]
    return torch.where(live, px_u, 0.0), torch.where(live, d, 0.0)


def page_lists(mask: torch.Tensor, tmin: torch.Tensor):
    """Cull output -> (counts [NC], plist [NC, NP], ptmin [NC, NP]): each
    chunk's hit pages first, nearest entry first; +inf ties keep page
    order (a stable sort, as jnp.argsort(stable=True))."""
    counts = mask.sum(dim=1, dtype=torch.int32)
    ptmin, plist = torch.sort(tmin, dim=1, stable=True)
    return counts, plist.to(torch.int32).contiguous(), ptmin.contiguous()


def shadow_rays(state, rows, key, wave: int, fixed_rng: bool, light):
    """The shadow rays of a wave (JAX: the first half of `_shadow_mask`):
    from each hit, a jittered ray to a point of the light.

    state: [16, R] ray state (rows 0..2 the true origins); rows: the wave's
    [16, R] winner rows; key: the render's key (the jitter draws from
    fold_in(key, 7_000_000 + wave), as `jax.random.uniform`); light:
    (ox, oy, oz, len2).  Returns (so, sd, hit, excl): [3, R] origins and
    directions, zero off the [R] bool hit mask, and the [R] float32 id of
    each ray's own triangle (0 off the mask).

    The multiply-adds are XLA's (ROADMAP C7): point = fma(t, d, o), the
    light point fma(u3, len2, l), the camera's sum of squares, and
    so = fma(nf, 0.005*(u1 + 1), point); under fixed_rng XLA vectorizes the
    normalization 16 floats wide."""
    R = state.shape[1]
    dev = state.device
    o, d = state[0:3], state[3:6]
    hid = rows[ROW_ID]
    hit = (state[ROW_ALIVE] != 0.0) & (hid != 0.0)
    point = fma(torch.where(hit, rows[ROW_T], 0.0)[None], d, o)
    nrm = rows[ROW_NORM:ROW_NORM + 3]
    norm_f = torch.where((rows[ROW_ENC] >= 8.0)[None], -nrm, nrm)
    if fixed_rng:
        u3 = torch.full((3, R), 0.5, dtype=torch.float32, device=dev)
        u1 = torch.full((1, R), 0.5, dtype=torch.float32, device=dev)
    else:
        skey = fold_in(key, 7_000_000 + wave)
        u3 = uniform(fold_in(skey, 0), (3, R), dev)
        u1 = uniform(fold_in(skey, 1), (1, R), dev)
    lo = torch.tensor([float(x) for x in light[:3]], dtype=torch.float32,
                      device=dev)[:, None]
    adj = fma(u3, float(light[3]), lo)
    sd = unit_rows(adj - point, wide=fixed_rng)
    so = fma(norm_f, 0.005 * (u1 + 1.0), point)
    return (torch.where(hit[None], so, 0.0), torch.where(hit[None], sd, 0.0),
            hit, torch.where(hit, hid, 0.0))


def shadow_mask(state, rows, key, wave: int, fixed_rng: bool, light,
                aabb_lo, aabb_hi, PK, page_size: int, ray_chunk: int):
    """The unfused shadow pass of a wave (JAX: `_shadow_mask`, the resident
    regime's packet-culled branch): `shadow_rays`, then B1, a stable sort
    and B6 with each ray's own triangle excluded; shadowed if another
    triangle intersects the ray.  PK: the unfolded pages.  Returns the [R]
    float32 mask."""
    so, sd, hit, excl = shadow_rays(state, rows, key, wave, fixed_rng, light)
    smask, stmin = cull_mask_exact(so, sd, hit, aabb_lo, aabb_hi, ray_chunk)
    counts, plist, ptmin = page_lists(smask, stmin)
    srows = trace_chunks(so, sd, PK, counts, plist, ptmin, page_size,
                         ray_chunk, excl=excl)
    return (hit & (srows[ROW_ID] != 0.0)).float()


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """PNG writer's exact `(c*255) as u8` semantics (raytrace.rs:1470-1472)."""
    x = torch.nan_to_num(img * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


class Engine:
    """Culled, compacted wavefront renderer, resident regime.

    scene: a `scene.Scene`, lit when `scene.lights` is set (a shadow ray
    from every hit; see `shadow_mask`); device: where the scene and the
    rays live ("cuda" runs the kernels; "cpu" their plain versions).  The
    other arguments mean what they mean for the JAX Engine, whose defaults
    the port fixes: the page size adapts to the scene (auto_pages) and
    primary rays start at the pinhole (pinhole_origin).

    ncompact: None (the default) compacts after waves 0 and 1 and, on a
    CUDA device, replans the schedule once from the first render's wave
    decay (`plan_boundaries`), as the JAX Engine does on the TPU; an int n
    compacts after the first n waves (negative: after every wave but the
    last); a sequence of bools says per boundary.  Every schedule renders
    the same image bits.
    """

    def __init__(self, scene: Scene, page_size: int = 56,
                 ray_chunk: int = 1024, bounce_chunk: int = 0,
                 ncompact=None, device="cuda"):
        if bounce_chunk != 0:
            raise NotImplementedError(
                "bounce_chunk != 0: ROADMAP 'Engine knobs'")
        self._auto_schedule = ncompact is None
        if ncompact is None:
            ncompact = 2
        elif isinstance(ncompact, (list, tuple)):
            ncompact = tuple(bool(b) for b in ncompact)
        self.ncompact = ncompact
        n_tris = max(len(scene.tris) - 1, 1)
        if n_tris <= TABLE_SLOT_CAP:
            page_size = auto_page_size(n_tris, page_size)
        self.pages = build_pages_kd(scene.tris, page_size=page_size)
        slots = self.pages.num_pages * self.pages.page_size
        fits_resident = (self.pages.num_pages <= MAX_BANKS * GROUP
                         and slots <= TABLE_SLOT_CAP)
        if not fits_resident:
            raise NotImplementedError(
                f"streamed regime ({self.pages.num_pages} pages x "
                f"{page_size}): ROADMAP A8 (B9/B10)")
        self.device = torch.device(device)
        dev = self.device
        self.PK = torch.from_numpy(self.pages.PK).to(dev)
        self.aabb_lo = torch.from_numpy(self.pages.aabb_lo).to(dev)
        self.aabb_hi = torch.from_numpy(self.pages.aabb_hi).to(dev)
        self.plt_i, self.plt_s, self.ab = upload_perlane_tables(self.pages,
                                                                dev)
        self.scene = scene
        lights = scene.lights
        #: (ox, oy, oz, len2) as float32 values, or None: an unlit scene
        self.light = None if lights is None else tuple(
            float(np.float32(x)) for x in (*np.asarray(lights.orig).reshape(3),
                                           lights.len2))
        self.page_size = page_size
        self.ray_chunk = ray_chunk
        self._perm_cache = {}
        self._pk0_cache = {}

    def _compacts_after(self, wave: int, maxdepth: int) -> bool:
        """Whether boundary `wave` (after that wave) compacts."""
        if isinstance(self.ncompact, tuple):
            return wave < len(self.ncompact) and self.ncompact[wave]
        limit = maxdepth - 1 if self.ncompact < 0 else self.ncompact
        return wave < min(limit, maxdepth - 1)

    def _perm(self, v: Viewport, tile: int) -> np.ndarray:
        key = (v.height, v.width, v.samples_per_pixel, tile)
        if key not in self._perm_cache:
            self._perm_cache[key] = tile_permutation(
                v.height, v.width, v.samples_per_pixel, tile)
        return self._perm_cache[key]

    def _pinhole_fold(self, v: Viewport, o: torch.Tensor):
        """Re-anchor primary rays at the pinhole and fold it into the page
        scalars (cached per camera).  Returns (o, pk0)."""
        cam = torch.from_numpy(np.asarray(v.cam, F32).copy()).to(self.device)
        o = cam[:, None].expand(o.shape).contiguous()
        cam_key = tuple(np.asarray(v.cam, dtype=np.float32).tolist())
        if cam_key not in self._pk0_cache:
            self._pk0_cache[cam_key] = fold_pages_origin(self.PK, cam_key)
        return o, self._pk0_cache[cam_key]

    def _render_waves(self, state, key, maxdepth: int, fixed_rng: bool, pk0):
        """The wave loop of _render_device_compact.  Returns (accumulated
        color [3, R] in the original lane order, per-wave live counts as
        tensors).  No host sync: counts, offsets and prefixes stay on the
        device (the plain versions on the CPU do sync)."""
        R = state.shape[1]
        RB = self.ray_chunk
        P = self.page_size
        cb = pick_cb(R)
        wc = 0.0 if fixed_rng else WEIGHT_CUTOFF
        dev = state.device
        dead_arr = dead_base = None
        prefix = None          # lane extent of the state's content (None: R)
        boundaries = []        # (meta, masks, prefix before the boundary)
        wave_counts = []
        for wave in range(maxdepth):
            alive = state[ROW_ALIVE] != 0.0
            wave_counts.append(alive.sum(dtype=torch.int32))
            seed = fold_in(key, wave)
            if wave == 0:
                mask, tmin = cull_mask_exact(state[0:3], state[3:6], alive,
                                             self.aabb_lo, self.aabb_hi, RB)
                counts, plist, ptmin = page_lists(mask, tmin)
                if self.light is None:
                    state = trace_shade_chunks(state, pk0, counts, plist,
                                               ptmin, seed, P, RB, fixed_rng,
                                               wc, zero_origin=True)
                else:
                    # the shadow pass runs between trace and shade
                    rows = trace_chunks(state[0:3], state[3:6], pk0, counts,
                                        plist, ptmin, P, RB, zero_origin=True)
                    shd = shadow_mask(state, rows, key, wave, fixed_rng,
                                      self.light, self.aabb_lo, self.aabb_hi,
                                      self.PK, P, RB)
                    live0 = torch.ones(R // RB, dtype=torch.int32, device=dev)
                    state = shade(state, rows, seed, RB, fixed_rng, wc, live0,
                                  shd)
            else:
                # chunks whose rays have all retired pass through
                chunk_live = alive.reshape(R // RB, RB).any(dim=1)
                state = trace_shade_perlane(
                    state, self.plt_i, self.plt_s, self.ab, seed, P, RB,
                    fixed_rng, wc, chunk_live.to(torch.int32), self.light)
            if not self._compacts_after(wave, maxdepth):
                continue
            if dead_arr is None:
                n_bound = sum(self._compacts_after(w, maxdepth)
                              for w in range(maxdepth))
                dead_arr = make_dead_array(R, dev, n_bound, cb)
                dead_base = torch.zeros((), dtype=torch.int32, device=dev)
            meta, total_a, skip, dead_end = compact_meta(
                state[ROW_ALIVE], state[ROW_DEAD], cb, dead_base, R)
            masks = torch.stack([state[ROW_ALIVE], state[ROW_DEAD]])
            state, dead_arr = compact(state, dead_arr, meta, cb,
                                      grid_live=prefix)
            boundaries.append((meta, masks, prefix))
            old = (torch.full((), R, dtype=torch.int32, device=dev)
                   if prefix is None else prefix)
            prefix = torch.where(skip, old, total_a)
            dead_base = torch.where(skip, dead_base, dead_end)
        # rows 8..11 (accum + retired flag) back to the original lanes; each
        # step writes only the prefix the next one reads, the last all lanes
        y = state[ROW_ACC:ROW_ACC + 4]
        for meta, masks, before in reversed(boundaries):
            y = expand(y, dead_arr, masks, meta, cb, grid_live=before)
        return y[0:3], wave_counts

    def render(self, v: Viewport, key=None, fixed_rng: bool = False,
               progress=None, debug: bool = False,
               quantize: bool = True) -> RenderResult:
        """Render `v`.  key: a `utils.rng.prng_key` (default key 0);
        quantize=True returns u8 quantized on the device, False float."""
        if debug:
            raise NotImplementedError("debug buffers: ROADMAP A7")
        if v.samples_per_pixel != 1:
            raise NotImplementedError("spp > 1: ROADMAP A6")
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        RB = self.ray_chunk
        dev = self.device
        t0 = time.perf_counter()

        tile = pick_tile(v.width, v.height)
        R0 = v.height * v.width
        quantum = max(RB, 128)
        R = -(-R0 // quantum) * quantum
        o, d = camera_rays_tiled(v, tile, R, dev)
        o, pk0 = self._pinhole_fold(v, o)
        alive0 = (torch.arange(R, device=dev) < R0).to(torch.float32)[None]
        state = torch.cat(
            [o, d, alive0, alive0,
             torch.zeros((STATE_ROWS - ROW_ACC, R), dtype=torch.float32,
                         device=dev)], dim=0)

        img, wave_counts = self._render_waves(state, key, v.maxdepth,
                                              fixed_rng, pk0)
        if quantize:
            img = quantize_u8(img)
        img_h = img.cpu().numpy()
        wave_counts = torch.stack(wave_counts).cpu().numpy()
        img = _assemble_host_image(img_h, v, self._perm(v, tile), 1, quantize)
        if self._auto_schedule and dev.type == "cuda":
            # one shot, as the JAX Engine on the TPU: the schedule changes
            # speed only, never bits
            self._auto_schedule = False
            self.ncompact = plan_boundaries(wave_counts.tolist())

        seconds = time.perf_counter() - t0
        result = RenderResult(image=img, rays_traced=int(wave_counts.sum()),
                              wave_rays=wave_counts, primary_t=None,
                              primary_id=None, seconds=seconds)
        if progress is not None:
            progress.update_wavefront(result)
        return result
