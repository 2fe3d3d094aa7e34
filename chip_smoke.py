#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (rust_raytrace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (hash-cached);
  3. kernels against their plain torch versions on the card, at the main
     path's shapes (ray_chunk 1024, page size 56, 37 pages) on 64 chunks of
     a real circles_2k wave: B1 bitwise, B2/B4 alive and retired rows exact
     and float rows within 1e-5; times of kernel and plain version;
  4. golden: the kernel path's 96x54 circles render under fixed_rng is
     byte-equal to tests/goldens/circles_96x54.png;
  5. kernel path vs plain path on the card at 640x360 under fixed_rng:
     at most 0.01% of u8 pixels may differ;
  6. circles_2k (2560x1440, maxdepth 5, live RNG): one warm-up and three
     timed renders through Engine.render; every kernel of the path must
     have launched;
  7. profile: one more circles_2k render under torch.profiler (the card's
     time per kernel and copy, its busy share) and the host un-permute
     timed alone.
Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no such line, when
CUDA is missing or any phase fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RB = 1024
N_CHECK_CHUNKS = 64
RTOL = 1e-5


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5) -> float:
    """Mean CUDA-event time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _abs_diff(got, want):
    """|got - want|, 0 where the two are equal (infinities included) and NaN
    where either is NaN and they differ."""
    return torch.where(got == want, 0.0, (got - want).abs())


def _compare_states(name, got, want):
    """Kernel vs plain output states: alive (7) and retired (11) rows
    exact, the float rows within RTOL relative; a NaN on either side fails.
    Returns max |diff|."""
    from rust_raytrace_tpu_torch.ops.state import ROW_ALIVE, ROW_DEAD
    for row in (ROW_ALIVE, ROW_DEAD):
        if not torch.equal(got[row], want[row]):
            n = int((got[row] != want[row]).sum())
            raise AssertionError(f"{name}: state row {row} differs on {n} rays")
    diff = _abs_diff(got, want)
    bad = ~(diff <= RTOL * want.abs())
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} values beyond rtol "
                             f"{RTOL} or NaN, max |diff| {float(diff.max())}")
    return float(diff.max())


def _profile_render(eng, vp):
    """One render under torch.profiler.  Returns (wall ms, {device activity
    name: ms}, busy ms): busy is the union of the card's kernel and copy
    intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.render(vp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("profiler: no device activity in the render")
    per_name, busy_us, edge = {}, 0.0, float("-inf")
    for start, end, name in spans:
        per_name[name] = per_name.get(name, 0.0) + (end - start) / 1e3
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    return wall_ms, per_name, busy_us / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from rust_raytrace_tpu.models import circles
    from rust_raytrace_tpu.utils import png
    from rust_raytrace_tpu_torch import engine as eng_mod
    from rust_raytrace_tpu_torch.engine import Engine, page_lists
    from rust_raytrace_tpu_torch.ops import cull, intersect, intersect_perlane
    from rust_raytrace_tpu_torch.utils import native
    from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key

    dev = torch.device("cuda")
    # 1. device
    card = _card()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # 2. build
    built = native.build()
    print(f"build: {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    native.library()

    # 3. kernels against their plain versions at main-path shapes
    scene, vp = circles.build(resolution="2k", maxdepth=5)
    eng = Engine(scene, device=dev)
    P = eng.page_size
    NP = eng.pages.num_pages
    print(f"circles_2k: {len(scene.tris) - 1} triangles, {NP} pages of {P}, "
          f"{eng.ab.shape[0] // 128} bank(s)")
    tile = eng_mod.pick_tile(vp.width, vp.height)
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d = eng_mod.camera_rays_tiled(vp, tile, R, dev)
    o, pk0 = eng._pinhole_fold(vp, o)
    alive0 = (torch.arange(R, device=dev) < R0).to(torch.float32)[None]
    full0 = torch.cat([o, d, alive0, alive0,
                       torch.zeros((8, R), device=dev)], dim=0)
    # chunks spread over the whole image
    chunks = torch.linspace(0, R // RB - 1, N_CHECK_CHUNKS,
                            device=dev).round().long()
    rays = (chunks[:, None] * RB + torch.arange(RB, device=dev)).reshape(-1)
    st0 = full0[:, rays].contiguous()
    key = prng_key(7)
    results = {}

    alive = st0[7] != 0.0
    args1 = (st0[0:3], st0[3:6], alive, eng.aabb_lo, eng.aabb_hi, RB)
    mask_k, tmin_k = cull.cull_mask_exact(*args1)
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args1)
    torch.cuda.synchronize()
    if not (torch.equal(mask_k, mask_p) and torch.equal(tmin_k, tmin_p)):
        raise AssertionError("B1: kernel and plain cull differ")
    results[native.CULL.name] = dict(
        max_abs_err=float(_abs_diff(tmin_k, tmin_p).max()),
        ms=_time_ms(lambda: cull.cull_mask_exact(*args1)),
        plain_ms=_time_ms(lambda: cull.cull_mask_exact_plain(*args1)))

    counts, plist, ptmin = page_lists(mask_k, tmin_k)
    print(f"B1 on {N_CHECK_CHUNKS} chunks: mask and tmin bitwise equal; "
          f"pages per chunk mean {float(counts.float().mean()):.2f}")
    args2 = (st0, pk0, counts, plist, ptmin, fold_in(key, 0), P, RB, False,
             1 / 512)
    st1_k = intersect.trace_shade_chunks(*args2, zero_origin=True)
    st1_p = intersect.trace_shade_chunks_plain(*args2, zero_origin=True)
    torch.cuda.synchronize()
    err = _compare_states("B2", st1_k, st1_p)
    results[native.TRACE_SHADE_UNION.name] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: intersect.trace_shade_chunks(
            *args2, zero_origin=True)),
        plain_ms=_time_ms(lambda: intersect.trace_shade_chunks_plain(
            *args2, zero_origin=True), reps=2))
    print(f"B2 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st1_k[7] != 0).sum())} rays live after wave 0")

    live = (st1_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args4 = (st1_k, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB,
             False, 1 / 512, live)
    st2_k = intersect_perlane.trace_shade_perlane(*args4)
    st2_p = intersect_perlane.trace_shade_perlane_plain(*args4)
    torch.cuda.synchronize()
    err = _compare_states("B4", st2_k, st2_p)
    results[native.TRACE_SHADE_PERLANE.name] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: intersect_perlane.trace_shade_perlane(*args4)),
        plain_ms=_time_ms(
            lambda: intersect_perlane.trace_shade_perlane_plain(*args4),
            reps=2))
    print(f"B4 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st2_k[7] != 0).sum())} rays live after wave 1")
    for k in native.KERNELS:
        r = results[k.name]
        print(f"time {k.name} ({N_CHECK_CHUNKS} chunks): kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms [{card}]")

    # the kernels alone at full 2k size (3,600 chunks)
    alive_f = full0[7] != 0.0
    fm, ft = cull.cull_mask_exact(full0[0:3], full0[3:6], alive_f,
                                  eng.aabb_lo, eng.aabb_hi, RB)
    fc, fpl, fpt = page_lists(fm, ft)
    full1 = intersect.trace_shade_chunks(full0, pk0, fc, fpl, fpt,
                                         fold_in(key, 0), P, RB, False,
                                         1 / 512, zero_origin=True)
    flive = (full1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    t_full = {
        native.CULL.name: _time_ms(lambda: cull.cull_mask_exact(
            full0[0:3], full0[3:6], alive_f, eng.aabb_lo, eng.aabb_hi, RB)),
        native.TRACE_SHADE_UNION.name: _time_ms(
            lambda: intersect.trace_shade_chunks(
                full0, pk0, fc, fpl, fpt, fold_in(key, 0), P, RB, False,
                1 / 512, zero_origin=True)),
        native.TRACE_SHADE_PERLANE.name: _time_ms(
            lambda: intersect_perlane.trace_shade_perlane(
                full1, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB,
                False, 1 / 512, flive)),
    }
    for name, ms in t_full.items():
        print(f"time {name} (full 2k wave, {R // RB} chunks): kernel "
              f"{ms:.4f} ms [{card}]")
    del full0, full1, fm, ft, fc, fpl, fpt

    # 4. golden on the card
    g_scene, g_vp = circles.build(resolution=(96, 54), maxdepth=5)
    golden = png.read_png(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests", "goldens", "circles_96x54.png"))
    img = Engine(g_scene, device=dev).render(g_vp, fixed_rng=True).image
    n_bad = int((img != golden).any(axis=-1).sum())
    if n_bad:
        raise AssertionError(f"golden: {n_bad} pixels differ")
    print("golden: circles 96x54 fixed_rng byte-equal on the card")

    # 5. kernel path vs plain path on the card
    m_scene, m_vp = circles.build(resolution=(640, 360), maxdepth=5)
    m_eng = Engine(m_scene, device=dev)
    img_k = m_eng.render(m_vp, fixed_rng=True).image
    swaps = {"cull_mask_exact": cull.cull_mask_exact_plain,
             "trace_shade_chunks": intersect.trace_shade_chunks_plain,
             "trace_shade_perlane": intersect_perlane.trace_shade_perlane_plain}
    saved = {n: getattr(eng_mod, n) for n in swaps}
    for n, fn in swaps.items():
        setattr(eng_mod, n, fn)
    try:
        img_p = m_eng.render(m_vp, fixed_rng=True).image
    finally:
        for n, fn in saved.items():
            setattr(eng_mod, n, fn)
    n_px = img_k.shape[0] * img_k.shape[1]
    n_diff = int((img_k != img_p).any(axis=-1).sum())
    print(f"kernel vs plain path 640x360 fixed_rng: {n_diff} of {n_px} "
          f"pixels differ")
    if n_diff > 1e-4 * n_px:
        raise AssertionError("kernel and plain paths differ beyond 0.01%")

    # 6. circles_2k end to end
    eng.render(vp)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        runs.append(eng.render(vp))
        torch.cuda.synchronize()
    launches = {k.name: k.launches for k in native.KERNELS}
    best = min(runs, key=lambda r: r.seconds)
    img = best.image
    if img.shape != (vp.height, vp.width, 3) or img.dtype != np.uint8:
        raise AssertionError(f"circles_2k image {img.shape} {img.dtype}")
    if int(best.wave_rays[0]) != R0 or not (img.max() > 0):
        raise AssertionError(f"circles_2k wave_rays {best.wave_rays}")
    print(f"circles_2k: best {best.seconds:.6f} s of "
          f"{[round(r.seconds, 6) for r in runs]}, rays_traced "
          f"{best.rays_traced}, {best.mrays_per_sec:.3f} Mrays/s, wave_rays "
          f"{best.wave_rays.tolist()} [{card}]")
    print(f"launches in the 3 timed renders: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # 7. where the time of one circles_2k render goes
    wall_ms, per_name, busy_ms = _profile_render(eng, vp)
    print(f"profile: render {wall_ms:.3f} ms under the profiler, device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; "
          f"{100 * busy_ms / (1e3 * best.seconds):.1f}% of the best timed "
          f"render) [{card}]")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1]):
        print(f"  device {ms:9.3f} ms  {name[:90]}")
    img_u8 = np.zeros((3, R), np.uint8)
    perm = eng._perm(vp, tile)
    t_host = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng_mod._assemble_host_image(img_u8, vp, perm, 1, True)
        t_host.append((time.perf_counter() - t0) * 1e3)
    print(f"profile: host un-permute alone {min(t_host):.3f} ms (best of "
          f"{[round(t, 3) for t in t_host]})")

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         **results[k.name]} for k in native.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
