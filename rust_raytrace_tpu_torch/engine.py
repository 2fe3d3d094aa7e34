"""The production render path on torch: `Engine` and its host helpers.

Counterpart: `rust_raytrace_tpu/engine.py` — `Engine.__init__` (its choice
of regime and page size), `Engine.render` with `_pinhole_fold`, the
autotune of the compaction schedule and the debug buffers, the wave loop
of `_render_device_compact` and its shadow pass `_shadow_mask` (the
resident wave-0, per-lane and streamed branches), the legacy loop
`_render_device` with its inline shadow pass and `_shade_rows`,
`walk_one_ray`, `render_banded` and `_dispatch_device`; plus
`_camera_rays_tiled` with the spp jitter (`_pos_uniform`, `_threefry2x32`),
`_unit_rows`, `_box_filter`, `_device_quantizable`, `_quantize_u8`,
`pick_tile`, `tile_permutation`, `plan_boundaries`, `auto_page_size` and
`_assemble_host_image`, copied because the JAX module imports jax.

One render: tile-order camera rays (a pixel's spp samples on adjacent
lanes) -> pinhole fold of the page scalars -> wave 0 = cull (B1) -> stable
sort of the page lists -> union trace + shade (B2) -> at each compaction
boundary: `compact_meta` and compaction (B3) -> waves 1.. = per-lane trace +
shade (B4) -> expansion (B5) backward over the boundaries -> box filter (spp
2, 4) and u8 quantization on the device -> un-permute on the host.  A
scene with a light (`scene.lights`), or a debug render, runs wave 0
unfused: cull (B1) -> sort -> union trace to winner rows (B6) -> (lit:
`shadow_mask`, the shadow rays through B1, a sort and B6 with
self-exclusion) -> shade (B8); a lit scene's bounce waves run B4 with the
shadow feeler fused.

A scene past the resident tables' cap (`table_slot_cap` triangle slots)
takes the streamed regime by default: no cull and no pinhole fold; every wave, wave 0
included, runs the bank-worklist trace + shade (B9), or, with a light or
for debug rows at wave 0, the bank-worklist trace to winner rows (B10) ->
(lit: the shadow rays through B10's any-hit mode with self-exclusion,
`shadow_mask_streamed`) -> shade (B8); compaction (B3) and expansion (B5)
as in the resident regime.  With `Engine(bank_major=True)` the unlit
waves from 2 on run the bank-major sweep instead of B9: prep, sweep and
finish (B12), the same bits.

`Engine(compact=False)` or `exact_cull=False` takes the legacy loop in
either regime: no compaction; every wave B1 (or the interval culls of
`ops.cull`), a sort, B6 to winner rows and the shade in torch glue, with
the scatter vectors of jax.random.uniform; lit, its own shadow pass
(`legacy_shadow_mask`).  The kernels run on CUDA tensors and their plain
torch versions on CPU tensors (`device=`).

With `streamed=False` such a scene keeps the union tables and no per-lane
ones, and every bounce wave runs as wave 0 does: cull (B1, with the
chunks whose rays have all retired flagged dead) -> sort -> union trace +
shade (B2, which passes the dead chunks and those past the compacted
survivor prefix through), or, lit or for debug rows, B6 rows -> the
shadow pass -> B8.  `bounce_chunk` runs the waves from 1 on at that ray
chunk in either loop.

`render_banded` renders the image in horizontal bands of whole tiles,
each band the same tile-major stream positions the full render emits,
through the same wave loop; `render_sharded` splits the tile-order rays
into equal shards over a list of devices (`parallel.sharding`), each
running this wave loop under its own key.  `shadow_mask_perlane` is the
per-lane branch of the shadow pass (B7 any-hit with self-exclusion), which
the JAX wave loop takes only under its probe arguments; no Engine path
calls it.
"""

import copy
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from .camera import Viewport, pixel_rays
from .ops.compact import (compact, compact_meta, expand, make_dead_array,
                          pick_cb)
from .ops.cull import (chunk_bounds, chunk_bounds_octants, cull_mask_exact,
                       cull_mask_tmin, cull_mask_tmin_octants)
from .ops.intersect import (fold_pages_origin, trace_chunks,
                            trace_shade_chunks)
from .ops.intersect_perlane import (GROUP, MAX_BANKS, perlane_tables,
                                    trace_perlane, trace_shade_perlane,
                                    upload_perlane_tables)
from .ops.intersect_streamed import (trace_shade_bankmajor,
                                     trace_shade_streamed, trace_streamed,
                                     upload_streamed_tables)
from .ops.pages import LANE_ID, build_pages_kd
from .ops.shade import FIXED_RV, SKY, fma, rsqrt, shade, sum3
from .ops.state import (ROW_ACC, ROW_ALIVE, ROW_ALPHA, ROW_COLOR, ROW_DEAD,
                        ROW_ENC, ROW_ID, ROW_NORM, ROW_SCAT, ROW_T, ROW_W,
                        STATE_ROWS)
from .materials import KIND_MATTE, KIND_REFLECTIVE
from .render import RayCaster, RenderResult
from .scene import Scene
from .utils.png import quantize_u8 as host_quantize_u8
from .utils.rng import fold_in, prng_key, threefry2x32, uniform

F32 = np.float32

#: page-table slots (pages x page size) the resident regime holds; a scene
#: past it takes the streamed regime
TABLE_SLOT_CAP = 262144
#: the streamed regime's least page size (the JAX package's measured optimum)
STREAMED_PAGE_SIZE = 224


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
                         dev_quant: bool, want_u8: bool = False) -> np.ndarray:
    """Un-permute a tile-order framebuffer ([3, R] or [3, R//spp] numpy)
    into the [height, width, 3] image.  dev_quant: the input is u8,
    already quantized (and box-filtered) on the device.  want_u8: the
    device rendered float where u8 was asked for (an spp that
    `device_quantizable` rejects): average and quantize here."""
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
    if want_u8:
        img = host_quantize_u8(img)
    return img


def device_quantizable(spp: int) -> bool:
    """Whether quantizing on the device is byte-equal to quantizing the
    float image on the host (the JAX package's `_device_quantizable`): the
    box filter's division by spp is exact, and its left-to-right add chain
    matches np.mean's order, only for spp in {1, 2, 4}."""
    return spp in (1, 2, 4)


def box_filter(img: torch.Tensor, spp: int) -> torch.Tensor:
    """The samples of each pixel averaged (raytrace.rs:1426): [3, R] in
    tile order, a pixel's spp samples on adjacent lanes -> [3, R // spp],
    with an explicit left-to-right add chain, as the JAX `_box_filter`."""
    s = img.reshape(3, img.shape[1] // spp, spp)
    acc = s[..., 0]
    for i in range(1, spp):
        acc = acc + s[..., i]
    return acc / float(spp)


def pos_uniform(key, q: torch.Tensor, salt: int) -> torch.Tensor:
    """Uniform [0, 1) float32 keyed by the absolute stream position q (the
    JAX `_pos_uniform`): the first word of Threefry-2x32 under the key
    fold_in(key, salt) of the counter (q, 0), its top 24 bits times 2^-24.
    A pure function of (key, salt, q), so any window of the stream draws
    the full render's values."""
    k0, k1 = (int(w) for w in fold_in(key, salt))
    bits, _ = threefry2x32(k0, k1, q.to(torch.int64) & 0xFFFFFFFF, 0)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def unit_rows(v: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """Normalize [3, R] column vectors (`jnp.sum(v * v, axis=0)` is XLA's
    `sum3`, measured against the jitted camera).  wide: the rsqrt of a
    fusion XLA vectorizes 16 floats wide (C7)."""
    return v * rsqrt(sum3(v, v), wide)[None]


def camera_rays_tiled(v: Viewport, tile: int, n_pad: int, device,
                      key=None, q_base: int = 0):
    """Primary rays in tile-major order (`pixel_ray`): (o, d) as [3, n_pad]
    float32 on `device` for the stream positions q_base .. q_base + n_pad
    of the whole image (a band of `Engine.render_banded` gets the very rays
    the full render emits there); positions past the image have o = d = 0
    (invalid lanes).  A pixel's spp samples sit on adjacent lanes (q // spp
    is the pixel); spp 1 shoots through the pixel centre, spp > 1 jitters
    sample q by `pos_uniform(key, q, 1_000_001)` across and 1_000_002 down.

    The image-plane point is orig + vu*(col + 0.5) + vv*(row + 0.5) with
    both multiply-adds fused, as XLA on the CPU compiles the JAX version
    (ROADMAP C2): unfused, a ray 1 ulp off flips a pixel of the 48x27
    circles render.  The normalization is `unit_rows`, with XLA-CPU's rsqrt
    (C1)."""
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
    return shadow_rays_od(state[0:3], state[3:6], state[ROW_ALIVE] != 0.0,
                          rows, key, wave, fixed_rng, light)


def shadow_rays_od(o, d, alive, rows, key, wave: int, fixed_rng: bool,
                   light):
    """`shadow_rays` of rays o, d [3, R] with the [R] bool mask alive (the
    legacy loop carries no state tensor)."""
    R = o.shape[1]
    dev = o.device
    hid = rows[ROW_ID]
    hit = alive & (hid != 0.0)
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


def shadow_mask_streamed(state, rows, key, wave: int, fixed_rng: bool, light,
                         tables, page_size: int, ray_chunk: int):
    """The shadow pass of a wave in the streamed regime (JAX: the streamed
    branch of `_shadow_mask`): `shadow_rays`, then B10's any-hit mode with
    each ray's own triangle excluded (a ray stops demanding banks at its
    first occluder).  tables: `upload_streamed_tables`.  Returns the [R]
    float32 mask."""
    so, sd, hit, excl = shadow_rays(state, rows, key, wave, fixed_rng, light)
    srows = trace_streamed(so, sd, hit.float(), tables, page_size,
                           ray_chunk, excl=excl, any_hit=True)
    return (hit & (srows[ROW_ID] != 0.0)).float()


def shadow_mask_perlane(state, rows, key, wave: int, fixed_rng: bool, light,
                        tables, page_size: int, ray_chunk: int):
    """The shadow pass of a wave over the resident tables (JAX: the
    per-lane branch of `_shadow_mask`): `shadow_rays`, then B7's any-hit
    mode with each ray's own triangle excluded (shadow rays are scattered,
    so no packet cull).  tables: `perlane_tables` (the Engine's
    `ptables`).  Returns the [R] float32 mask.  Like the JAX wave loop,
    which reaches this branch only under its probe arguments, no Engine
    path calls it."""
    so, sd, hit, excl = shadow_rays(state, rows, key, wave, fixed_rng, light)
    srows = trace_perlane(so, sd, hit.float(), tables, page_size, ray_chunk,
                          excl=excl, any_hit=True)
    return (hit & (srows[ROW_ID] != 0.0)).float()


def legacy_shadow_mask(o, d, alive, rows, key, wave: int, fixed_rng: bool,
                       light, aabb_lo, aabb_hi, PK, page_size: int,
                       ray_chunk: int):
    """The shadow pass of the legacy loop (JAX: inlined in
    `_render_device`): `shadow_rays_od` of the wave's masked rays, the
    octant interval cull, a stable sort and B6 with each ray's own triangle
    excluded.  Returns the [R] bool mask."""
    so, sd, hit, excl = shadow_rays_od(o, d, alive, rows, key, wave,
                                       fixed_rng, light)
    smask, stmin = cull_mask_tmin_octants(
        *chunk_bounds_octants(so, sd, hit, ray_chunk), aabb_lo, aabb_hi)
    counts, plist, ptmin = page_lists(smask, stmin)
    srows = trace_chunks(so, sd, PK, counts, plist, ptmin, page_size,
                         ray_chunk, excl=excl)
    return hit & (srows[ROW_ID] != 0.0)


def legacy_rv(key, wave: int, R: int, fixed_rng: bool, device):
    """The legacy loop's scatter vectors (JAX `_random_unit_rows`): (v,
    inv) with v = jax.random.uniform of shape (3, R) from fold_in(key,
    wave), less 0.5, and inv [R] its rsqrt norm, so rv = v * inv; under
    fixed_rng (FIXED_RV as [3, R], None)."""
    if fixed_rng:
        return (torch.tensor(FIXED_RV, dtype=torch.float32,
                             device=device)[:, None].expand(3, R), None)
    v = uniform(fold_in(key, wave), (3, R), device) - 0.5
    return v, rsqrt(sum3(v, v))


def shade_rows(rows, o, d, weight, valid, rv, shadowed=None,
               fused_ddot: bool = True):
    """One wave of the legacy loop's shade from the winner rows (JAX:
    `engine._shade_rows`, XLA glue): the color algebra of
    `ops.shade.shade_state_rows` on [3, R] columns with separate accum,
    weight and alive, and the scatter vectors of `legacy_rv`.  Returns
    (contrib [3, R], weight', alive', o', d').  The sums over the three
    rows are XLA's reductions (`sum3`); |d.nf| is one too where
    fused_ddot, else its products round before the adds, as XLA compiles
    the legacy loop's wave 0 (ROADMAP C8)."""
    v, inv_v = rv
    t = rows[ROW_T]
    miss = rows[ROW_ID] == 0.0
    n = rows[ROW_NORM:ROW_NORM + 3]
    enc = rows[ROW_ENC]
    kind = torch.remainder(enc, 4.0)
    edge = torch.remainder(torch.floor(enc / 4.0), 2.0) == 1.0
    back = enc >= 8.0
    color = rows[ROW_COLOR:ROW_COLOR + 3]
    if shadowed is not None:
        color = torch.where(shadowed[None], 0.0, color)
    alpha = rows[ROW_ALPHA]
    scat = rows[ROW_SCAT]
    nf = torch.where(back[None], -n, n)
    is_scatter = (~miss) & (~edge) & ((kind == KIND_MATTE)
                                      | (kind == KIND_REFLECTIVE))
    is_terminal = valid & ~is_scatter
    scatter_live = valid & is_scatter
    sky = torch.tensor(SKY, dtype=torch.float32, device=o.device)[:, None]
    term = torch.where(miss[None], sky, torch.where(edge[None], 0.0, color))
    contrib = (torch.where(is_terminal[None], weight * term, 0.0)
               + torch.where(scatter_live[None],
                             weight * color * (1.0 - alpha), 0.0))
    new_w = torch.where(scatter_live, weight * alpha, weight)

    p = fma(t[None], d, o)
    if inv_v is None:
        rvs = v
        m = nf + rvs
    else:
        rvs = v * inv_v
        m = fma(v, inv_v, nf)
    m = m * rsqrt(sum3(m, m))
    if fused_ddot:
        ddot = torch.abs(sum3(d, nf))
    else:
        ddot = torch.abs((d[0] * nf[0] + d[1] * nf[1]) + d[2] * nf[2])
    r = fma(rvs, scat, fma(2.0 * nf, ddot, d))
    r = r * rsqrt(sum3(r, r))
    is_matte = (kind == KIND_MATTE)[None]
    if inv_v is None:
        no = p + torch.where(is_matte, rvs * 0.001, r * 0.001)
    else:
        no = fma(torch.where(is_matte, rvs, r), 0.001, p)
    nd = torch.where(is_matte, m, r)
    upd = scatter_live[None]
    return (contrib, new_w, scatter_live, torch.where(upd, no, o),
            torch.where(upd, nd, d))


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """PNG writer's exact `(c*255) as u8` semantics (raytrace.rs:1470-1472)."""
    x = torch.nan_to_num(img * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def _check_chunks(R: int, *chunks) -> None:
    """Every ray chunk of a render must divide its padded ray count."""
    for rb in chunks:
        if rb <= 0 or R % rb:
            raise ValueError(f"ray chunk {rb} does not divide the {R} rays "
                             f"of the render")


class Engine(RayCaster):
    """Culled, compacted wavefront renderer.

    scene: a `scene.Scene`, lit when `scene.lights` is set (a shadow ray
    from every hit; see `shadow_mask`); device: where the scene and the
    rays live ("cuda" runs the kernels; "cpu" their plain versions).  The
    other arguments mean what they mean for the JAX Engine, with its
    defaults.  The JAX Engine's `nbuf`, `interpret`, `gate_frac`,
    `wave0_fused_lights`, `wave0_skippable` and `profile_skip` are TPU
    means or were measured out on the TPU; this Engine takes none of them
    (README, "The PyTorch/CUDA port").

    weight_cutoff: a ray whose throughput falls to it retires (0.0 under
    fixed_rng).  auto_pages: the page size adapts to the scene
    (auto_page_size; a scene of more than table_slot_cap triangles gets
    pages of at least STREAMED_PAGE_SIZE); False keeps page_size.
    pinhole_origin: primary rays start at the pinhole, whose position is
    folded into the wave-0 page scalars (`fold_pages_origin`); False keeps
    their image-plane origins and wave 0 reads the unfolded pages.
    bounce_chunk: the ray chunk of the waves from 1 on (0: ray_chunk); it
    must divide the padded ray count.  The scatter hash keys on the chunk
    and lane, so under live RNG it changes the bits, as in the JAX Engine.

    streamed: None (the default) takes the streamed regime exactly when the
    scene's pages do not fit the resident tables (more than MAX_BANKS banks
    or table_slot_cap slots); True forces it on any scene; False keeps the
    resident regime's union tables on any scene, and past the cap the
    bounce waves run the union kernels (see the module docstring).

    ncompact: None (the default) compacts after waves 0 and 1 and, on a
    CUDA device, replans the schedule once from the first render's wave
    decay (`plan_boundaries`), as the JAX Engine does on the TPU; an int n
    compacts after the first n waves (negative: after every wave but the
    last); a sequence of bools says per boundary.  Every schedule renders
    the same image bits.

    bank_major: in the streamed regime, the unlit waves from 2 on run the
    bank-major sweep (B12) instead of the bank-worklist kernel (B9); the
    same bits either way.  Accepted and inert in the resident regime, as
    in the JAX Engine.

    compact=False or exact_cull=False takes the legacy loop (`_render_legacy`,
    the JAX `_render_device`) in either regime: every wave culls (B1, or
    with exact_cull=False the interval culls of `ops.cull`), sorts and runs
    the union trace to winner rows (B6) over the union page tables, then
    shades in torch glue (`shade_rows`).
    """

    def __init__(self, scene: Scene, page_size: int = 56,
                 ray_chunk: int = 1024, bounce_chunk: int = 0,
                 ncompact=None, streamed=None,
                 table_slot_cap: int = TABLE_SLOT_CAP,
                 bank_major: bool = False, compact: bool = True,
                 exact_cull: bool = True, weight_cutoff: float = 1 / 512,
                 auto_pages: bool = True, pinhole_origin: bool = True,
                 device="cuda"):
        self.bank_major = bool(bank_major)
        self.bounce_chunk = bounce_chunk
        self.weight_cutoff = weight_cutoff
        self.pinhole_origin = pinhole_origin
        self.compact = compact
        self.exact_cull = exact_cull
        self._auto_schedule = ncompact is None
        if ncompact is None:
            ncompact = 2
        elif isinstance(ncompact, (list, tuple)):
            ncompact = tuple(bool(b) for b in ncompact)
        self.ncompact = ncompact
        n_tris = max(len(scene.tris) - 1, 1)
        if auto_pages and n_tris <= table_slot_cap:
            page_size = auto_page_size(n_tris, page_size)
        elif auto_pages:
            # no page size fits such a scene in the resident tables
            page_size = max(page_size, STREAMED_PAGE_SIZE)
        self.pages = build_pages_kd(scene.tris, page_size=page_size)
        slots = self.pages.num_pages * self.pages.page_size
        fits_resident = (self.pages.num_pages <= MAX_BANKS * GROUP
                         and slots <= table_slot_cap)
        self.streamed = (not fits_resident) if streamed is None \
            else bool(streamed)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.PK = self.aabb_lo = self.aabb_hi = None
        #: the streamed regime's `StreamedTables` and the resident regime's
        #: `PerlaneTables` (the JAX layout and the page-major records), or
        #: None in the other regime and past the cap with streamed=False
        self.stables = self.ptables = None
        if self.streamed:
            self.stables = upload_streamed_tables(self.pages, dev)
        elif fits_resident:
            self.ptables = perlane_tables(*upload_perlane_tables(self.pages,
                                                                 dev))
        if not self.streamed or not self._use_compact():
            # the union tables: the resident regime's wave 0 and the
            # legacy loop (which reads them in either regime)
            self.PK = torch.from_numpy(self.pages.PK).to(dev)
            self.aabb_lo = torch.from_numpy(self.pages.aabb_lo).to(dev)
            self.aabb_hi = torch.from_numpy(self.pages.aabb_hi).to(dev)
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
        self._replicas = {}

    def _replica(self, dev) -> "Engine":
        """This Engine with its tables on `dev` (itself on its own device),
        made once a device: a shard of `render_sharded` runs there."""
        dev = torch.device(dev)
        if dev == self.device:
            return self
        if dev not in self._replicas:
            def move(t):
                return None if t is None else t.to(dev)

            rep = copy.copy(self)
            rep.device = dev
            rep.PK, rep.aabb_lo, rep.aabb_hi = (
                move(t) for t in (self.PK, self.aabb_lo, self.aabb_hi))
            for name in ("ptables", "stables"):
                tabs = getattr(self, name)
                setattr(rep, name, None if tabs is None
                        else type(tabs)(*(move(t) for t in tabs)))
            rep._pk0_cache = {}
            rep._replicas = {}
            self._replicas[dev] = rep
        return self._replicas[dev]

    def _use_compact(self) -> bool:
        """The compacted wave loop, or the legacy one (the JAX
        `_use_compact`; its spp condition always holds here, since the ray
        count is padded to a multiple of spp)."""
        return self.compact and self.exact_cull

    def _compacts_after(self, wave: int, maxdepth: int, ncompact=None) -> bool:
        """Whether boundary `wave` (after that wave) compacts."""
        ncompact = self.ncompact if ncompact is None else ncompact
        if isinstance(ncompact, tuple):
            return wave < len(ncompact) and ncompact[wave]
        limit = maxdepth - 1 if ncompact < 0 else ncompact
        return wave < min(limit, maxdepth - 1)

    def _perm(self, v: Viewport, tile: int) -> np.ndarray:
        key = (v.height, v.width, v.samples_per_pixel, tile)
        if key not in self._perm_cache:
            self._perm_cache[key] = tile_permutation(
                v.height, v.width, v.samples_per_pixel, tile)
        return self._perm_cache[key]

    def _pinhole_fold(self, v: Viewport, o: torch.Tensor):
        """Re-anchor primary rays at the pinhole and fold it into the page
        scalars (cached per camera).  Returns (o, pk0); pk0 is None when
        the render reads no union pages at wave 0 (the streamed regime's
        compacted loop: its kernels take the true origins), and (o, None)
        as given with pinhole_origin=False."""
        if not self.pinhole_origin:
            return o, None
        cam = torch.from_numpy(np.asarray(v.cam, F32).copy()).to(self.device)
        o = cam[:, None].expand(o.shape).contiguous()
        if self.PK is None:
            return o, None
        cam_key = tuple(np.asarray(v.cam, dtype=np.float32).tolist())
        if cam_key not in self._pk0_cache:
            self._pk0_cache[cam_key] = fold_pages_origin(self.PK, cam_key)
        return o, self._pk0_cache[cam_key]

    def _render_waves(self, state, key, maxdepth: int, fixed_rng: bool, pk0,
                      ray_chunk=None, bounce_chunk=None, ncompact=None,
                      want_primary: bool = False):
        """The wave loop of _render_device_compact.  Returns (accumulated
        color [3, R] in the original lane order, per-wave live counts as
        tensors, primary [2, R] rows (t, id) of wave 0 or None, cull0 =
        wave 0's (counts, plist) or None).  want_primary runs wave 0
        unfused (trace to winner rows, then B8) and keeps its rows and, in
        the resident regime, its page lists.  ray_chunk and bounce_chunk
        default to the Engine's.  No host sync: counts, offsets and
        prefixes stay on the device (the plain versions on the CPU do
        sync)."""
        R = state.shape[1]
        RB = self.ray_chunk if ray_chunk is None else ray_chunk
        rb_bounce = (self.bounce_chunk if bounce_chunk is None
                     else bounce_chunk) or RB
        _check_chunks(R, RB, rb_bounce)
        cb = pick_cb(R)
        wc = 0.0 if fixed_rng else self.weight_cutoff
        dev = state.device
        dead_arr = dead_base = None
        prefix = None          # lane extent of the state's content (None: R)
        grid_live = None       # its chunks at the bounce chunk (None: all)
        boundaries = []        # (meta, masks, prefix before the boundary)
        wave_counts = []
        primary = cull0 = None
        for wave in range(maxdepth):
            rb_w = rb_bounce if wave else RB
            alive = state[ROW_ALIVE] != 0.0
            wave_counts.append(alive.sum(dtype=torch.int32))
            seed = fold_in(key, wave)
            # chunks whose rays have all retired pass through
            chunk_live = (alive.reshape(R // rb_w, rb_w).any(dim=1)
                          .to(torch.int32) if wave else
                          torch.ones(R // rb_w, dtype=torch.int32, device=dev))
            if self.streamed:
                state, rows = self._streamed_wave(
                    state, key, wave, seed, fixed_rng, wc, chunk_live, rb_w,
                    want_primary and wave == 0)
            elif wave == 0 or self.ptables is None:
                state, rows, cull = self._union_wave(
                    state, key, wave, seed, fixed_rng, wc, pk0,
                    chunk_live if wave else None,
                    grid_live if wave else None, rb_w,
                    want_primary and wave == 0)
                if want_primary and wave == 0:
                    cull0 = cull
            else:
                rows = None
                state = trace_shade_perlane(
                    state, self.ptables, seed, self.page_size, rb_w,
                    fixed_rng, wc, chunk_live, self.light)
            if want_primary and wave == 0:
                primary = rows[ROW_T:ROW_ID + 1]
            if not self._compacts_after(wave, maxdepth, ncompact):
                continue
            if dead_arr is None:
                n_bound = sum(self._compacts_after(w, maxdepth, ncompact)
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
            # the next waves' chunks of the survivor prefix (the JAX loop's
            # grid_live, planned at the bounce chunk)
            nc_next = R // rb_bounce
            old_nc = (torch.full((), nc_next, dtype=torch.int32, device=dev)
                      if grid_live is None else grid_live)
            grid_live = torch.where(
                skip, old_nc, torch.clamp((total_a + rb_bounce - 1)
                                          // rb_bounce, max=nc_next)
            ).to(torch.int32)
        # rows 8..11 (accum + retired flag) back to the original lanes; each
        # step writes only the prefix the next one reads, the last all lanes
        y = state[ROW_ACC:ROW_ACC + 4]
        for meta, masks, before in reversed(boundaries):
            y = expand(y, dead_arr, masks, meta, cb, grid_live=before)
        return y[0:3], wave_counts, primary, cull0

    def _union_wave(self, state, key, wave: int, seed, fixed_rng: bool,
                    wc: float, pk0, chunk_live, grid_live, RB: int,
                    want_rows: bool):
        """One wave over the union tables: the resident regime's wave 0, and
        every wave of a scene past the cap with streamed=False.  Cull (B1),
        a stable sort, then B2, or with a light, or when the rows are wanted
        (debug), B6 to winner rows, the shadow pass (lit) and B8.  Wave 0
        runs on the folded pages when pk0 is given, and takes no skip flags
        (chunk_live and grid_live None: B1 and B2 without them); a bounce
        wave's retired chunks and those past the survivor prefix pass
        through.  Returns (state, rows or None, (counts, plist))."""
        P = self.page_size
        alive = state[ROW_ALIVE] != 0.0
        mask, tmin = cull_mask_exact(state[0:3], state[3:6], alive,
                                     self.aabb_lo, self.aabb_hi, RB,
                                     chunk_live=chunk_live)
        counts, plist, ptmin = page_lists(mask, tmin)
        zo = wave == 0 and pk0 is not None
        pk = pk0 if zo else self.PK
        if self.light is None and not want_rows:
            state = trace_shade_chunks(state, pk, counts, plist, ptmin, seed,
                                       P, RB, fixed_rng, wc, zero_origin=zo,
                                       chunk_live=chunk_live,
                                       grid_live=grid_live)
            return state, None, (counts, plist)
        # unfused: the shadow pass (lit) runs between trace and shade, and
        # debug keeps the rows
        rows = trace_chunks(state[0:3], state[3:6], pk, counts, plist, ptmin,
                            P, RB, zero_origin=zo)
        shd = None
        if self.light is not None:
            shd = shadow_mask(state, rows, key, wave, fixed_rng, self.light,
                              self.aabb_lo, self.aabb_hi, self.PK, P, RB)
        if chunk_live is None:
            chunk_live = torch.ones(state.shape[1] // RB, dtype=torch.int32,
                                    device=state.device)
        state = shade(state, rows, seed, RB, fixed_rng, wc, chunk_live, shd)
        return state, rows, (counts, plist)

    def _streamed_wave(self, state, key, wave: int, seed, fixed_rng: bool,
                       wc: float, chunk_live, RB: int, want_rows: bool):
        """One wave of the streamed regime: B9, or from wave 2 on with
        bank_major the bank-major sweep (B12); or with a light, or when the
        rows are wanted (debug), B10 to winner rows, the streamed shadow
        pass (lit) and B8.  Returns (state, rows or None)."""
        P = self.page_size
        if self.light is None and not want_rows:
            fused = (trace_shade_bankmajor if wave > 1 and self.bank_major
                     else trace_shade_streamed)
            return fused(state, self.stables, seed, P, RB, fixed_rng, wc,
                         chunk_live), None
        rows = trace_streamed(state[0:3], state[3:6], state[ROW_ALIVE],
                              self.stables, P, RB, chunk_live=chunk_live)
        shd = None
        if self.light is not None:
            shd = shadow_mask_streamed(state, rows, key, wave, fixed_rng,
                                       self.light, self.stables, P, RB)
        return shade(state, rows, seed, RB, fixed_rng, wc, chunk_live,
                     shd), rows

    def _render_legacy(self, o, d, alive0, key, maxdepth: int,
                       fixed_rng: bool, pk0, want_primary: bool):
        """The legacy wave loop (JAX `_render_device`): no compaction; o, d
        [3, R] and the accum, weight and alive of every ray carried whole.
        Each wave: the masked rays, a cull (B1; with exact_cull=False the
        chunk-bound cull at wave 0 and the octant cull after), a stable
        sort, B6 to winner rows (zero_origin on the folded pages at wave
        0), the shadow pass when lit, `shade_rows`, and the weight cutoff;
        the waves from 1 on at the bounce chunk.  Returns (accum [3, R],
        wave counts, primary [2, R] or None)."""
        R = o.shape[1]
        P = self.page_size
        dev = o.device
        wc = 0.0 if fixed_rng else self.weight_cutoff
        _check_chunks(R, self.ray_chunk, self.bounce_chunk or self.ray_chunk)
        accum = torch.zeros((3, R), dtype=torch.float32, device=dev)
        weight = torch.ones((R,), dtype=torch.float32, device=dev)
        alive = alive0
        wave_counts = []
        primary = None
        for wave in range(maxdepth):
            RB = self.ray_chunk if wave == 0 or not self.bounce_chunk \
                else self.bounce_chunk
            wave_counts.append(alive.sum(dtype=torch.int32))
            o_m = torch.where(alive[None], o, 0.0)
            d_m = torch.where(alive[None], d, 0.0)
            if self.exact_cull:
                mask, tmin = cull_mask_exact(o_m, d_m, alive, self.aabb_lo,
                                             self.aabb_hi, RB)
            elif wave == 0:
                mask, tmin = cull_mask_tmin(
                    *chunk_bounds(o_m, d_m, alive, RB), self.aabb_lo,
                    self.aabb_hi)
            else:
                mask, tmin = cull_mask_tmin_octants(
                    *chunk_bounds_octants(o_m, d_m, alive, RB),
                    self.aabb_lo, self.aabb_hi)
            counts, plist, ptmin = page_lists(mask, tmin)
            zo = wave == 0 and pk0 is not None
            rows = trace_chunks(o_m, d_m, pk0 if zo else self.PK, counts,
                                plist, ptmin, P, RB, zero_origin=zo)
            if wave == 0 and want_primary:
                primary = rows[ROW_T:ROW_ID + 1]
            rv = legacy_rv(key, wave, R, fixed_rng, dev)
            shadowed = None
            if self.light is not None:
                shadowed = legacy_shadow_mask(
                    o_m, d_m, alive, rows, key, wave, fixed_rng, self.light,
                    self.aabb_lo, self.aabb_hi, self.PK, P, RB)
            contrib, weight, alive, o, d = shade_rows(
                rows, o_m, d_m, weight, alive, rv, shadowed,
                fused_ddot=wave > 0)
            accum = accum + contrib
            if wc > 0.0:
                alive = alive & (weight > wc)
        return accum, wave_counts, primary

    def render(self, v: Viewport, key=None, fixed_rng: bool = False,
               progress=None, debug: bool = False,
               quantize: bool = True) -> RenderResult:
        """Render `v`.  key: a `utils.rng.prng_key` (default key 0);
        quantize=True returns u8 (quantized on the device where that is
        byte-equal to the host's quantization, `device_quantizable`), False
        float.  debug: also the primary hit buffers (primary_t,
        primary_id; and in the compacted resident regime at spp 1 the
        candidate sets, primary_chunk and chunk_tris)."""
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        spp = v.samples_per_pixel
        dev = self.device
        t0 = time.perf_counter()

        quant = quantize and device_quantizable(spp)
        tile, o, d, alive0, pk0 = self._primary_rays(v, key)
        img, wave_counts, primary, cull0 = self._dispatch(
            v.maxdepth, spp, o, d, alive0, key, fixed_rng, debug, quant, pk0)
        img_h = img.cpu().numpy()
        wave_counts = torch.stack(wave_counts).cpu().numpy()
        perm = self._perm(v, tile)
        img = _assemble_host_image(img_h, v, perm, spp, quant,
                                   want_u8=quantize and not quant)
        pt = pid = primary_chunk = chunk_tris = None
        if debug:
            pt, pid, primary_chunk, chunk_tris = self._debug_buffers(
                v, perm, primary, cull0, self.ray_chunk)
        if self._auto_schedule and self._use_compact() and dev.type == "cuda":
            # one shot, as the JAX Engine on the TPU: the schedule changes
            # speed only, never bits
            self._auto_schedule = False
            self.ncompact = plan_boundaries(wave_counts.tolist())

        seconds = time.perf_counter() - t0
        result = RenderResult(image=img, rays_traced=int(wave_counts.sum()),
                              wave_rays=wave_counts, primary_t=pt,
                              primary_id=pid, seconds=seconds,
                              primary_chunk=primary_chunk,
                              chunk_tris=chunk_tris)
        if progress is not None:
            progress.update_wavefront(result)
        return result

    def _primary_rays(self, v: Viewport, key):
        """A render's primary rays on the Engine's device: (tile, o, d,
        alive0, pk0), the rays [3, R] padded to whole quanta in tile order
        under `key` (spp > 1 jitters by it), through the pinhole fold,
        and the live-lane mask [R]."""
        tile = pick_tile(v.width, v.height)
        R0 = v.height * v.width * v.samples_per_pixel
        quantum = self._quantum(v.samples_per_pixel)
        R = -(-R0 // quantum) * quantum
        o, d = camera_rays_tiled(v, tile, R, self.device, key)
        o, pk0 = self._pinhole_fold(v, o)
        alive0 = torch.arange(R, device=self.device) < R0
        return tile, o, d, alive0, pk0

    def _quantum(self, spp: int) -> int:
        """The ray-count padding quantum: whole chunks, the 128-lane
        compaction alignment and whole sample groups — their lcm, as the
        JAX Engine pads."""
        quantum = max(self.ray_chunk, 128)
        return quantum * spp // math.gcd(quantum, spp)

    def _dispatch(self, maxdepth: int, spp: int, o, d, alive0, key,
                  fixed_rng: bool, debug: bool, quant: bool, pk0):
        """The device render of prepared rays (JAX: `_dispatch_device`),
        shared by render(), render_banded() and each shard of
        render_sharded(): the compacted or the legacy wave loop, then on
        the device the box filter and u8 quantization where quant.  Returns
        (image [3, R] float32 or [3, R // spp] u8, per-wave live counts as
        tensors, primary rows or None, cull0)."""
        cull0 = None
        if self._use_compact():
            R = o.shape[1]
            a0 = alive0.to(torch.float32)[None]
            state = torch.cat(
                [o, d, a0, a0,
                 torch.zeros((STATE_ROWS - ROW_ACC, R), dtype=torch.float32,
                             device=o.device)], dim=0)
            img, wave_counts, primary, cull0 = self._render_waves(
                state, key, maxdepth, fixed_rng, pk0, want_primary=debug)
        else:
            img, wave_counts, primary = self._render_legacy(
                o, d, alive0, key, maxdepth, fixed_rng, pk0, debug)
        if quant:
            if spp > 1:
                img = box_filter(img, spp)
            img = quantize_u8(img)
        return img, wave_counts, primary, cull0

    def _debug_buffers(self, v: Viewport, perm, primary, cull0, RB: int):
        """The debug buffers of a render, un-permuted on the host: primary
        t and id per sample ([H, W] or [H, W, spp]) and, where the render
        kept wave 0's page lists (cull0) at spp 1, each pixel's primary
        chunk and each chunk's candidate triangle ids (the surviving pages'
        ids, as debug.rs records its check_tris)."""
        spp = v.samples_per_pixel
        R0 = v.height * v.width * spp
        primary_h = primary.cpu().numpy()[:, :R0]
        pt = np.empty(R0, dtype=np.float32)
        pid = np.empty(R0, dtype=np.int32)
        pt[perm] = primary_h[0]
        pid[perm] = primary_h[1].astype(np.int32)
        shape = (v.height, v.width, spp) if spp > 1 else (v.height, v.width)
        primary_chunk = chunk_tris = None
        if cull0 is not None and spp == 1:
            counts_h = cull0[0].cpu().numpy()
            plist_h = cull0[1].cpu().numpy()
            page_ids = self.pages.PK[:, :, LANE_ID].astype(np.int64)
            chunk_tris = []
            for c in range(counts_h.shape[0]):
                ids = page_ids[plist_h[c, :counts_h[c]]].ravel()
                chunk_tris.append(np.unique(ids[ids > 0]))
            qpos = np.empty(R0, dtype=np.int64)
            qpos[perm] = np.arange(R0)
            primary_chunk = (qpos // RB).reshape(v.height, v.width)
        return pt.reshape(shape), pid.reshape(shape), primary_chunk, \
            chunk_tris

    def walk_one_ray(self, v: Viewport, px, key=None,
                     fixed_rng: bool = True) -> RenderResult:
        """Single-pixel probe (Viewport::walk_one_ray, raytrace.rs:1442-1455)
        through the compacted wave loop: the pixel's ray (its image-plane
        origin, no pinhole fold) rides lane 0 of one 128-lane chunk, with
        ray_chunk 128 on every wave (bounce_chunk too, as in JAX) and a
        compaction after every wave but the last, the
        wave 0 unfused, and the scene's shadow pass when lit.  Under
        fixed_rng (the default) the probed pixel equals render()'s bitwise;
        with live RNG it is an independent sample (the scatter hash keys on
        the lane)."""
        row, col = px
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        dev = self.device
        o_np, d_np = pixel_rays(v, np.asarray(row), np.asarray(col))
        R = 128
        state = torch.zeros((STATE_ROWS, R), dtype=torch.float32, device=dev)
        state[0:3, 0] = torch.from_numpy(np.asarray(o_np, F32).reshape(3))
        state[3:6, 0] = torch.from_numpy(np.asarray(d_np, F32).reshape(3))
        state[ROW_W:ROW_ALIVE + 1, 0] = 1.0          # weight, alive
        img, wave_counts, primary, _ = self._render_waves(
            state, key, v.maxdepth, fixed_rng, None, ray_chunk=R,
            bounce_chunk=0, ncompact=-1, want_primary=True)
        wave_rays = torch.stack(wave_counts).cpu().numpy()
        primary_h = primary.cpu().numpy()
        return RenderResult(
            image=img.cpu().numpy()[:, 0].reshape(1, 1, 3),
            rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=primary_h[0, 0].reshape(1, 1),
            primary_id=primary_h[1, 0].astype(np.int32).reshape(1, 1))

    def render_banded(self, v: Viewport, key=None, fixed_rng: bool = False,
                      band_rows=None, max_band_rays: int = 4_194_304,
                      progress=None, quantize: bool = True) -> RenderResult:
        """Render `v` in horizontal bands, so that the device holds one
        band's rays, not the image's: the analog of the reference's row
        work queue (raytrace.rs:1181-1191).

        Each band's rays are the tile-major stream positions the full
        render emits there (`camera_rays_tiled(q_base=)`; the spp jitter is
        keyed by position), so under fixed_rng the banded image equals
        render()'s bit for bit at any band split and spp.  With live RNG
        band bi scatters under fold_in(key, bi) while its camera draws from
        key, as the JAX Engine does.  band_rows: rows per band, a positive
        multiple of the pixel tile (ValueError otherwise); default, as many
        as keep a band within max_band_rays rays.  Returns the whole image,
        the wave counts summed over the bands and no debug buffers;
        progress gets one `update` per band and the per-wave totals."""
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        spp = v.samples_per_pixel
        dev = self.device
        t0 = time.perf_counter()

        tile = pick_tile(v.width, v.height)
        rays_per_row = v.width * spp
        if band_rows is None:
            band_rows = max(max_band_rays // rays_per_row, tile)
            band_rows -= band_rows % tile
        if band_rows <= 0 or band_rows % tile:
            raise ValueError(f"band_rows {band_rows} must be a positive "
                             f"multiple of the {tile}-px tile")
        band_rows = min(band_rows, v.height)
        quantum = self._quantum(spp)
        quant = quantize and device_quantizable(spp)
        perm_full = self._perm(v, tile)
        out = np.empty((v.height, v.width, 3),
                       dtype=np.uint8 if quantize else np.float32)
        wave_counts = None
        for bi, r0 in enumerate(range(0, v.height, band_rows)):
            bh = min(band_rows, v.height - r0)
            q0 = r0 * rays_per_row
            Rb0 = bh * rays_per_row
            Rpad = -(-Rb0 // quantum) * quantum
            o, d = camera_rays_tiled(v, tile, Rpad, dev, key, q_base=q0)
            o, pk0 = self._pinhole_fold(v, o)
            alive0 = torch.arange(Rpad, device=dev) < Rb0
            img, wc, _, _ = self._dispatch(v.maxdepth, spp, o, d, alive0,
                                           fold_in(key, bi), fixed_rng, False,
                                           quant, pk0)
            band = SimpleNamespace(height=bh, width=v.width)
            out[r0:r0 + bh] = _assemble_host_image(
                img.cpu().numpy(), band, perm_full[q0:q0 + Rb0] - q0, spp,
                quant, want_u8=quantize and not quant)
            wc = torch.stack(wc).cpu().numpy()
            wave_counts = wc if wave_counts is None else wave_counts + wc
            if progress is not None:
                # per band, as the reference's row workers flush
                # (raytrace.rs:1411-1429)
                progress.update(bh * v.width, {"Rays": int(wc.sum())})
        result = RenderResult(image=out, rays_traced=int(wave_counts.sum()),
                              wave_rays=wave_counts, primary_t=None,
                              primary_id=None,
                              seconds=time.perf_counter() - t0)
        if progress is not None:
            for i, n in enumerate(wave_counts):
                progress._stat(f"Wave{i}Rays", "count").add(int(n))
        return result

    def render_sharded(self, v: Viewport, mesh=None, n_devices=None,
                       key=None, fixed_rng: bool = False, progress=None,
                       debug: bool = False,
                       quantize: bool = True) -> RenderResult:
        """Render `v` data-parallel over image tiles
        (`parallel.sharding.engine_render_sharded`): the tile-order rays in
        equal shards over `mesh`, a list of devices (default:
        `make_mesh(n_devices)` of this Engine's device type), each shard
        through this Engine's own wave loop under the key fold_in(key,
        shard index).  Under fixed_rng the image is byte-equal to render()'s
        at any shard count; under live RNG each shard's scatter keys on its
        own compacted layout, as on the JAX package's mesh.  debug returns
        the primary t and id buffers (each shard records its wave-0 slice),
        as render() assembles them; the wave counts are summed over the
        shards.  No autotune: the schedule is the Engine's."""
        from .parallel.sharding import engine_render_sharded, make_mesh

        if mesh is None:
            mesh = make_mesh(n_devices, None if self.device.type == "cuda"
                             else [self.device])
        n = len(mesh)
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()

        tile = pick_tile(v.width, v.height)
        R0 = v.height * v.width * spp
        # each shard: whole chunks, 128-lane groups and sample groups
        quantum = n * self._quantum(spp)
        R = -(-R0 // quantum) * quantum
        quant = quantize and device_quantizable(spp)
        o, d = camera_rays_tiled(v, tile, R, self.device, key)
        o, pk0 = self._pinhole_fold(v, o)
        alive0 = torch.arange(R, device=self.device) < R0
        img, wave_counts, primary = engine_render_sharded(
            self, o, d, alive0, key, mesh, v.maxdepth, fixed_rng=fixed_rng,
            spp=spp, pk0=pk0, quantize=quant, want_primary=debug)
        perm = self._perm(v, tile)
        img = _assemble_host_image(img.cpu().numpy(), v, perm, spp, quant,
                                   want_u8=quantize and not quant)
        pt = pid = None
        if debug:
            pt, pid, _, _ = self._debug_buffers(v, perm, primary, None,
                                                self.ray_chunk)
        wave_counts = wave_counts.cpu().numpy()
        result = RenderResult(image=img, rays_traced=int(wave_counts.sum()),
                              wave_rays=wave_counts, primary_t=pt,
                              primary_id=pid,
                              seconds=time.perf_counter() - t0)
        if progress is not None:
            progress.update_wavefront(result)
        return result
