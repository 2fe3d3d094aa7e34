"""The portable renderer: `WavefrontRenderer`, its full-batch wave loop
`trace_rays`, and `RenderResult`.

Counterpart: `rust_raytrace_tpu/render.py` — `SceneTensors`/`upload_scene`,
`_unit`, `_random_unit_vec`, `shade_active`, `_shade_wave`, `_nearest`,
`trace_rays`, `RenderResult`, `RayCaster` and `WavefrontRenderer` with its
camera (`_camera_rays_jit`, spp > 1 jitter included).

Each wave traces the rays of the slab with the nearest hit of one backend,
then shades the active rays with per-triangle tables gathered by hit id, in
[R, 3] rows; the result of a dead ray is masked.  Backends:

  "kernel"    B11, the dense brute force (`ops.intersect.nearest_hit`): the
              CUDA kernel on CUDA tensors, its plain version on CPU tensors
              (the JAX package's "pallas", and "pallas_interpret" on the
              CPU); it skips the dead rays (the JAX backends trace them);
  "portable"  the page scan in torch ops (`ops.intersect_xla`, the JAX
              package's "xla");
  "auto"      "kernel".

The arithmetic is XLA-CPU's where the JAX package leaves it to XLA
(ROADMAP C2, C8): the sums of squares and the dot products over the last
axis accumulate x, y, z in order with fused multiply-adds, the hit point is
fma(t, d, o), and rsqrt is the host CPU's (C1).
"""

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import math3d as m3
from .camera import Viewport, pixel_rays
from .materials import KIND_MATTE, KIND_REFLECTIVE
from .ops.intersect import nearest_hit
from .ops.intersect_xla import nearest_hit_xla
from .ops.pages import PageTables, build_pages
from .ops.shade import fma, rsqrt, sum3
from .scene import Scene
from .utils.rng import fold_in, prng_key, uniform

F32 = np.float32

#: the CPU sky, raytrace.rs:1264, as the JAX package's float32 constant
SKY = tuple(float(c) for c in m3.make_color((128, 180, 255)))

BACKENDS = ("kernel", "portable")


@dataclass
class SceneTensors:
    """A scene on the device: the intersection pages and the per-triangle
    shade tables, gathered by hit id."""

    PK: torch.Tensor            # [NP, P, 128] packed pages (ops/pages.py)
    page_size: int
    center: torch.Tensor        # [N, 3]
    norm: torch.Tensor          # [N, 3]
    sides: torch.Tensor         # [N, 3, 3]
    side_lens: torch.Tensor     # [N, 3]
    edge_thickness: torch.Tensor  # [N]
    mat_kind: torch.Tensor      # [N] int32
    mat_color: torch.Tensor     # [N, 3]
    mat_alpha: torch.Tensor     # [N]
    mat_scattering: torch.Tensor  # [N]


def upload_scene(scene: Scene, page_size: int = 128,
                 pages: Optional[PageTables] = None,
                 device="cuda") -> SceneTensors:
    """The scene's pages (`build_pages`, in triangle id order, unless
    `pages` is given) and shade tables as tensors on `device`."""
    pages = pages or build_pages(scene.tris, page_size=page_size)
    t = scene.tris

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SceneTensors(
        PK=dev(pages.PK), page_size=pages.page_size,
        center=dev(t.incenter), norm=dev(t.norm), sides=dev(t.sides),
        side_lens=dev(t.side_lens), edge_thickness=dev(t.edge_thickness),
        mat_kind=dev(np.asarray(t.materials.kind, np.int32)),
        mat_color=dev(t.materials.color), mat_alpha=dev(t.materials.alpha),
        mat_scattering=dev(t.materials.scattering))


def _sum3(a, b):
    """jnp.sum(a * b, axis=-1) of [..., 3] rows, as XLA-CPU reduces it
    (`ops.shade.sum3`)."""
    return sum3(a.unbind(-1), b.unbind(-1))


def _unit(v):
    """Normalize [..., 3] rows (XLA-CPU's rsqrt, C1)."""
    return v * rsqrt(_sum3(v, v))[..., None]


def _random_unit_vec(key, n: int, device):
    """`random_vec` (raytrace.rs:188-192): unit(uniform[-0.5, 0.5]^3) of
    jax.random.uniform's draw of shape (n, 3), as its two factors (v [n,
    3], inv [n]): rv = v * inv[:, None].  The shade takes both, since XLA
    re-forms the product inside the fusions that consume it."""
    v = uniform(key, (n, 3), device) - 0.5
    return v, rsqrt(_sum3(v, v))


#: the fixed_rng scatter vector, unit(0.36, 0.48, 0.8): XLA folds the
#: constant, and (0.36, 0.48, 0.8) is already unit length in float32
FIXED_RV = (0.36, 0.48, 0.8)


def shade_active(st: SceneTensors, o, d, t, hid, weight, valid, rv):
    """One wave of the color algebra over an active ray set.

    o, d: [R, 3]; t: [R] float32; hid: [R] int32 (0: miss); weight: [R];
    valid: [R] bool, the rays that entered this wave alive (padding and
    dead rays contribute nothing); rv: the scatter vectors as (v [R, 3],
    inv [R]) of `_random_unit_vec`, or (the fixed_rng vector [R, 3], None).
    Returns (contrib [R, 3], weight', alive', o', d'): contrib is this
    wave's addition to the pixel accumulator; alive' marks the rays that
    scattered and continue.

    Where XLA fuses (C8): with live RNG, the matte direction's y and z
    components fuse v*inv into nf + rv (its x component's product is
    computed once for both sides of the back-face select, so it rounds
    first), and both new origins fuse their 0.001 products into the hit
    point; under fixed_rng rv*0.001 is a folded constant.  The reflection's
    |d.nf| sums its products unfused (its operand is a select)."""
    miss = hid == 0
    h = hid.long()
    center = st.center[h]
    norm = st.norm[h]
    sides = st.sides[h]
    lens = st.side_lens[h]
    et = st.edge_thickness[h]
    kind = st.mat_kind[h]
    color = st.mat_color[h]
    alpha = st.mat_alpha[h]
    scat = st.mat_scattering[h]

    point = fma(t[:, None], d, o)
    ip = point - center
    dist = _sum3(sides, ip[:, None, :])                     # [R, 3]
    edge = (dist > lens * (1.0 - et[:, None])).any(dim=-1)
    back = _sum3(d, norm) > 0
    norm_f = torch.where(back[:, None], -norm, norm)

    is_scatter = (~miss) & (~edge) & ((kind == KIND_MATTE)
                                      | (kind == KIND_REFLECTIVE))
    is_terminal = valid & ~is_scatter
    sky = torch.tensor(SKY, dtype=torch.float32, device=o.device)
    surf_color = torch.where(edge[:, None], 0.0, color)
    term_color = torch.where(miss[:, None], sky, surf_color)
    contrib = torch.where(is_terminal[:, None], weight[:, None] * term_color,
                          0.0)
    scatter_live = valid & is_scatter
    contrib = contrib + torch.where(
        scatter_live[:, None],
        weight[:, None] * color * (1.0 - alpha[:, None]), 0.0)
    weight = torch.where(scatter_live, weight * alpha, weight)

    v, inv = rv
    if inv is None:
        rv = v
        matte_dir = _unit(norm_f + rv)
        matte_orig = point + rv * 0.001
    else:
        rv = v * inv[:, None]
        m = fma(v, inv[:, None], norm_f)
        m[:, 0] = norm_f[:, 0] + rv[:, 0]
        matte_dir = _unit(m)
        matte_orig = fma(rv, 0.001, point)
    # XLA does not fuse this reduction's products (its operand is a select)
    ddot = torch.abs((d[:, 0] * norm_f[:, 0] + d[:, 1] * norm_f[:, 1])
                     + d[:, 2] * norm_f[:, 2])[:, None]
    refl_dir = _unit(fma(rv, scat[:, None], fma(2.0 * norm_f, ddot, d)))
    refl_orig = fma(refl_dir, 0.001, point)

    is_matte = (kind == KIND_MATTE)[:, None]
    new_o = torch.where(is_matte, matte_orig, refl_orig)
    new_d = torch.where(is_matte, matte_dir, refl_dir)
    upd = scatter_live[:, None]
    return (contrib, weight, scatter_live, torch.where(upd, new_o, o),
            torch.where(upd, new_d, d))


def _shade_wave(st: SceneTensors, o, d, t, hid, accum, weight, alive, rv):
    """Full-batch wave: accumulate in place, no compaction."""
    contrib, weight, alive, o, d = shade_active(st, o, d, t, hid, weight,
                                                alive, rv)
    return accum + contrib, weight, alive, o, d


def _nearest(st: SceneTensors, o, d, backend: str, ray_chunk: int, alive):
    """The wave's nearest hits; the "kernel" backend skips the dead rays
    (+inf, 0), whose results `shade_active` masks."""
    if backend == "kernel":
        return nearest_hit(o, d, st.PK, st.page_size, ray_chunk, alive=alive)
    if backend == "portable":
        return nearest_hit_xla(o, d, st.PK, st.page_size)
    raise ValueError(f"unknown backend {backend!r}")


def trace_rays(st: SceneTensors, o, d, key, maxdepth: int,
               backend: str = "portable", ray_chunk: int = 1024,
               fixed_rng: bool = False):
    """Trace a ray batch ([R, 3] o, d) to colors.  Returns (colors [R, 3],
    aux dict): aux carries each ray's primary hit t and id (the debug
    buffers of debug.rs) and the per-wave live counts as tensors (the
    "Rays" stat of progress.rs / raytrace.rs:1278).  key: the slab's two
    uint32 key words; wave w draws its scatter vectors from fold_in(key, w).
    """
    R = o.shape[0]
    dev = o.device
    accum = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    weight = torch.ones((R,), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    primary_t = primary_id = None
    wave_rays = []
    for wave in range(maxdepth):
        wave_rays.append(alive.sum(dtype=torch.int32))
        t, hid = _nearest(st, o, d, backend, ray_chunk, alive)
        if wave == 0:
            primary_t, primary_id = t, hid
        if fixed_rng:
            rv = (torch.tensor(FIXED_RV, dtype=torch.float32,
                               device=dev).expand(R, 3), None)
        else:
            rv = _random_unit_vec(fold_in(key, wave), R, dev)
        accum, weight, alive, o, d = _shade_wave(st, o, d, t, hid, accum,
                                                 weight, alive, rv)
    # rays still alive after maxdepth waves would recurse at depth 0: black
    return accum, {"primary_t": primary_t, "primary_id": primary_id,
                   "wave_rays": torch.stack(wave_rays)}


@dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] u8, or f32 (quantize=False; and
                               # always from WavefrontRenderer)
    rays_traced: int           # total project_ray-equivalent calls
    wave_rays: np.ndarray      # [maxdepth] per-wave live-ray counts
    primary_t: np.ndarray      # [H, W(,S)] primary hit times (debug buffer)
    primary_id: np.ndarray     # [H, W(,S)] primary hit ids (0 = miss)
    seconds: float = 0.0
    # candidate-set debug buffers (Engine debug renders): each pixel's
    # primary chunk and each chunk's surviving triangle ids (debug.rs's
    # check_tris, recorded from the packet cull)
    primary_chunk: np.ndarray = None   # [H, W] int or None
    chunk_tris: list = None            # [NC] arrays of tri ids or None

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.seconds, 1e-12) / 1e6


class RayCaster:
    """Backend protocol (the `RayCaster` trait, raytrace.rs:1128-1165): a
    backend renders a viewport to a `RenderResult`; `walk_rays` wraps that
    with a progress context, as the reference's trait does."""

    def render(self, v: Viewport, **kw) -> RenderResult:   # pragma: no cover
        raise NotImplementedError

    def walk_rays(self, v: Viewport, show_progress: bool = False, **kw):
        """Render and return (result, ProgressCtx) with the stats
        accumulated (walk_rays, raytrace.rs:1133-1163)."""
        from .utils.progress import create_ctx

        ctx = create_ctx(v.width, v.height, enable_io=show_progress)
        result = self.render(v, progress=ctx, **kw)
        ctx.finish()
        return result, ctx


def camera_rays(v: Viewport, key, device):
    """All primary rays in row-major pixel order, [H*W*spp, 3] origins and
    unit directions (pixel_ray, raytrace.rs:1374-1394).  spp > 1 jitters
    each sample within its pixel by uniforms from fold_in(key, 1_000_001)
    (columns) and fold_in(key, 1_000_002) (rows), drawn as
    jax.random.uniform of shape (H*W*spp,).  The image-plane point is
    fma(vv, row + v, fma(vu, col + u, orig)), as XLA fuses it (C2)."""
    H, W, spp = v.height, v.width, v.samples_per_pixel
    n = H * W * spp
    pix = torch.arange(n, device=device) // spp
    rows = (pix // W).to(torch.float32)
    cols = (pix % W).to(torch.float32)
    if spp == 1:
        u_off = v_off = 0.5
    else:
        u_off = uniform(fold_in(key, 1_000_001), (n,), device)
        v_off = uniform(fold_in(key, 1_000_002), (n,), device)

    def row(a):
        return torch.from_numpy(np.asarray(a, F32).copy()).to(device)[None]

    vu_delta = row(np.asarray(v.vu, F32) * (F32(1.0) / F32(W)))
    vv_delta = row(np.asarray(v.vv, F32) * (F32(1.0) / F32(H)))
    px_u = fma(vv_delta, (rows + v_off)[:, None],
               fma(vu_delta, (cols + u_off)[:, None], row(v.orig)))
    return px_u, _unit(px_u - row(v.cam))


class WavefrontRenderer(RayCaster):
    """The simple full-batch RayCaster: every wave traces every ray.

    backend: "kernel" (B11; the JAX package's "pallas", or
    "pallas_interpret" on the CPU), "portable" (the page scan in torch ops;
    JAX's "xla") or "auto" ("kernel").  device: where the scene and the rays
    live ("cuda" runs the B11 kernel; "cpu" its plain version)."""

    def __init__(self, scene: Scene, page_size: int = 256,
                 ray_chunk: int = 1024, backend: str = "auto",
                 slab_size: int = 1 << 20, device="cuda"):
        if backend == "auto":
            backend = "kernel"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port has "
                             f"{BACKENDS} (JAX's 'pallas', "
                             f"'pallas_interpret' -> 'kernel'; 'xla' -> "
                             f"'portable')")
        self.backend = backend
        self.ray_chunk = ray_chunk
        self.slab_size = slab_size
        self.device = torch.device(device)
        self.tensors = upload_scene(scene, page_size=page_size,
                                    device=self.device)
        self.scene = scene

    def render(self, v: Viewport, key=None, fixed_rng: bool = False,
               progress=None) -> RenderResult:
        """Render the full image (float32), slab by slab: rays are traced in
        slabs of `slab_size` (the reference's row work queue,
        raytrace.rs:1181-1191), and slab s draws its scatter vectors from
        fold_in(key, s).  key: a `utils.rng.prng_key` (default key 0)."""
        key = prng_key(0) if key is None else np.asarray(key, np.uint32)
        spp = v.samples_per_pixel
        t0 = time.perf_counter()
        o, d = camera_rays(v, key, self.device)
        R = o.shape[0]
        S = self.slab_size
        n_slabs = max(1, -(-R // S))
        if n_slabs == 1:
            S = R
        colors, pts, pids, wrs = [], [], [], []
        for s in range(n_slabs):
            lo, hi = s * S, min(R, (s + 1) * S)
            c, aux = trace_rays(self.tensors, o[lo:hi], d[lo:hi],
                                fold_in(key, s), maxdepth=v.maxdepth,
                                backend=self.backend,
                                ray_chunk=self.ray_chunk,
                                fixed_rng=fixed_rng)
            colors.append(c)
            pts.append(aux["primary_t"])
            pids.append(aux["primary_id"])
            wrs.append(aux["wave_rays"])
            if progress is not None and n_slabs > 1:
                # per-slab live progress (the reference's per-row channel
                # reports, raytrace.rs:1429)
                wr = aux["wave_rays"].cpu().numpy()
                progress.update((hi - lo) // spp, {"Rays": int(wr.sum())})
                for i, n in enumerate(wr):
                    progress._stat(f"Wave{i}Rays", "count").add(int(n))
        img = torch.cat(colors).cpu().numpy()
        pt = torch.cat(pts).cpu().numpy()
        pid = torch.cat(pids).cpu().numpy()
        wave_rays = torch.stack(wrs).sum(dim=0).cpu().numpy()
        seconds = time.perf_counter() - t0
        if spp > 1:
            img = img.reshape(v.height, v.width, spp, 3).mean(axis=2)
            shape = (v.height, v.width, spp)
        else:
            img = img.reshape(v.height, v.width, 3)
            shape = (v.height, v.width)
        result = RenderResult(
            image=img, rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=pt.reshape(shape), primary_id=pid.reshape(shape),
            seconds=seconds)
        if progress is not None and n_slabs == 1:
            progress.update_wavefront(result)
        return result

    def walk_one_ray(self, v: Viewport, px) -> RenderResult:
        """Single-pixel probe (Viewport::walk_one_ray, raytrace.rs:1442-1455)
        under key 0, live RNG."""
        row, col = px
        o, d = pixel_rays(v, np.asarray(row), np.asarray(col))

        def ray(a):
            return torch.from_numpy(np.asarray(a, F32).reshape(1, 3)).to(
                self.device)

        colors, aux = trace_rays(self.tensors, ray(o), ray(d), prng_key(0),
                                 maxdepth=v.maxdepth, backend=self.backend,
                                 ray_chunk=self.ray_chunk)
        wave_rays = aux["wave_rays"].cpu().numpy()
        return RenderResult(
            image=colors.cpu().numpy().reshape(1, 1, 3),
            rays_traced=int(wave_rays.sum()), wave_rays=wave_rays,
            primary_t=aux["primary_t"].cpu().numpy().reshape(1, 1),
            primary_id=aux["primary_id"].cpu().numpy().reshape(1, 1))
