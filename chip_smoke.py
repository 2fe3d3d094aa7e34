#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (rust_raytrace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (hash-cached, one
     nvcc per source, all started together);
  3. kernels against their plain torch versions on the card, at the main
     path's shapes (ray_chunk 1024, page size 56, 37 pages), bitwise: B1,
     B2 and B4 on 64 chunks of a real circles_2k wave, B3 and B5 on the
     whole circles_2k state after wave 0 (3,686,400 rays, cb 512, 7,200
     chunks) and again at the second boundary (after wave 1 on the survivor
     prefix: grid_live and dead_base > 0, B5 compared within the prefix);
     times of kernel and plain version, and of each kernel on the
     full wave, beside the least time the card could take (bound);
  4. golden: the default (compacted) Engine's 96x54 circles render under
     fixed_rng is byte-equal to tests/goldens/circles_96x54.png;
  5. kernel path vs plain path of the default Engine at 640x360 under
     fixed_rng: at most 0.01% of u8 pixels may differ;
  6. circles_2k (2560x1440, maxdepth 5, live RNG): the default Engine after
     its autotune (the planned schedule printed) and Engine(ncompact=0),
     three timed renders each, in turns; every kernel of the default path
     must have launched in its renders;
  7. profile: one default and one ncompact=0 circles_2k render under
     torch.profiler (the card's time per kernel and copy, its busy share)
     and the host un-permute timed alone.
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

from rust_raytrace_tpu_torch import engine as eng_mod
from rust_raytrace_tpu_torch.engine import Engine, page_lists
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.ops import (compact, cull, intersect,
                                        intersect_perlane)
from rust_raytrace_tpu_torch.utils import native, png
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key

DEVICE = "cuda"
RB = 1024
N_CHECK_CHUNKS = 64
#: NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
#: tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: float32 operations of one ray/page slab test (cull and per-lane
#: traversal: per axis 2 sub, 2 mul, min, max; the folds, the hit test and
#: the entry clamp) and of one ray/triangle hit test (four 3-term dot
#: products, the division, three plane distances, the compares and the
#: lexicographic update)
SLAB_FLOPS = 26
HIT_FLOPS = 34


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


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def _abs_diff(got, want):
    """|got - want|, 0 where the two are equal (infinities included) and NaN
    where either is NaN and they differ."""
    return torch.where(got == want, 0.0, (got - want).abs())


def _require_bitwise(name, got, want):
    """Kernel vs plain output bits (a NaN must match a NaN's bits); returns
    max |diff|, 0.0."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{name}: kernel and plain differ in {n} words")
    return 0.0


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


def _counts():
    return {k.name: k.launches for k in native.KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
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
    table_bytes = sum(t.numel() * 4 for t in (eng.plt_i, eng.plt_s, eng.ab))

    def b1_bound(n, valid):
        nc = n // RB
        return _bound(n * 25 + NP * 24 + nc * NP * 5,
                      int(valid.sum()) * NP * SLAB_FLOPS)

    def b2_bound(n, counts, state):
        # the first page of every chunk that has one: the early exit decides
        # how many more (a lower bound on the pairs this data needs)
        live = (counts > 0).repeat_interleave(RB) & (state[7] != 0)
        return _bound(n * 128 + int((counts > 0).sum()) * P * 96,
                      int(live.sum()) * P * HIT_FLOPS)

    def b4_bound(n, state):
        # every live ray slab-tests every page (a lower bound: the triangle
        # tests behind the slab hits depend on the traversal)
        return _bound(n * 128 + table_bytes,
                      int((state[7] != 0).sum()) * NP * SLAB_FLOPS)

    alive = st0[7] != 0.0
    args1 = (st0[0:3], st0[3:6], alive, eng.aabb_lo, eng.aabb_hi, RB)
    mask_k, tmin_k = cull.cull_mask_exact(*args1)
    mask_p, tmin_p = cull.cull_mask_exact_plain(*args1)
    torch.cuda.synchronize()
    if not (torch.equal(mask_k, mask_p) and torch.equal(tmin_k, tmin_p)):
        raise AssertionError("B1: kernel and plain cull differ")
    results[native.CULL.name] = dict(
        rays=int(st0.shape[1]),
        max_abs_err=float(_abs_diff(tmin_k, tmin_p).max()),
        ms=_time_ms(lambda: cull.cull_mask_exact(*args1)),
        plain_ms=_time_ms(lambda: cull.cull_mask_exact_plain(*args1)),
        **b1_bound(st0.shape[1], alive))

    counts, plist, ptmin = page_lists(mask_k, tmin_k)
    print(f"B1 on {N_CHECK_CHUNKS} chunks: mask and tmin bitwise equal; "
          f"pages per chunk mean {float(counts.float().mean()):.2f}")
    args2 = (st0, pk0, counts, plist, ptmin, fold_in(key, 0), P, RB, False,
             1 / 512)
    st1_k = intersect.trace_shade_chunks(*args2, zero_origin=True)
    st1_p = intersect.trace_shade_chunks_plain(*args2, zero_origin=True)
    torch.cuda.synchronize()
    err = _require_bitwise("B2", st1_k, st1_p)
    results[native.TRACE_SHADE_UNION.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err,
        ms=_time_ms(lambda: intersect.trace_shade_chunks(
            *args2, zero_origin=True)),
        plain_ms=_time_ms(lambda: intersect.trace_shade_chunks_plain(
            *args2, zero_origin=True), reps=2),
        **b2_bound(st0.shape[1], counts, st0))
    print(f"B2 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st1_k[7] != 0).sum())} rays live after wave 0")

    live = (st1_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args4 = (st1_k, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB,
             False, 1 / 512, live)
    st2_k = intersect_perlane.trace_shade_perlane(*args4)
    st2_p = intersect_perlane.trace_shade_perlane_plain(*args4)
    torch.cuda.synchronize()
    err = _require_bitwise("B4", st2_k, st2_p)
    results[native.TRACE_SHADE_PERLANE.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err,
        ms=_time_ms(lambda: intersect_perlane.trace_shade_perlane(*args4)),
        plain_ms=_time_ms(
            lambda: intersect_perlane.trace_shade_perlane_plain(*args4),
            reps=2),
        **b4_bound(st0.shape[1], st1_k))
    print(f"B4 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st2_k[7] != 0).sum())} rays live after wave 1")

    # the kernels alone at full 2k size (3,600 chunks)
    alive_f = full0[7] != 0.0
    fm, ft = cull.cull_mask_exact(full0[0:3], full0[3:6], alive_f,
                                  eng.aabb_lo, eng.aabb_hi, RB)
    fc, fpl, fpt = page_lists(fm, ft)
    full1 = intersect.trace_shade_chunks(full0, pk0, fc, fpl, fpt,
                                         fold_in(key, 0), P, RB, False,
                                         1 / 512, zero_origin=True)
    flive = (full1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    full_ms = {
        native.CULL.name: (_time_ms(lambda: cull.cull_mask_exact(
            full0[0:3], full0[3:6], alive_f, eng.aabb_lo, eng.aabb_hi, RB)),
            b1_bound(R, alive_f)),
        native.TRACE_SHADE_UNION.name: (_time_ms(
            lambda: intersect.trace_shade_chunks(
                full0, pk0, fc, fpl, fpt, fold_in(key, 0), P, RB, False,
                1 / 512, zero_origin=True)), b2_bound(R, fc, full0)),
        native.TRACE_SHADE_PERLANE.name: (_time_ms(
            lambda: intersect_perlane.trace_shade_perlane(
                full1, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB,
                False, 1 / 512, flive)), b4_bound(R, full1)),
    }
    for name, (ms, bound) in full_ms.items():
        results[name].update(ms_full=ms, bound_ms_full=bound["bound_ms"])
        print(f"time {name} (full 2k wave, {R // RB} chunks): kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]")

    # B3 and B5 on the whole state after wave 0: the first boundary
    cb = compact.pick_cb(R)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    meta, total_a, _, dead_end = compact.compact_meta(full1[7], full1[11], cb,
                                                      base, R)
    dead = compact.make_dead_array(R, dev)
    out_k, dead_k = compact.compact(full1, dead.clone(), meta, cb)
    out_p, dead_p = compact.compact_plain(full1, dead.clone(), meta, cb)
    torch.cuda.synchronize()
    err3 = max(_require_bitwise("B3 state", out_k, out_p),
               _require_bitwise("B3 dead", dead_k, dead_p))
    n_a = int(meta[:, compact.M_CNT_A].sum())
    n_d = int(meta[:, compact.M_CNT_D].sum())
    pad_d = int(meta[:, compact.M_CASE_D].sum()) * compact.ALIGN
    print(f"B3 at {R} rays, cb {cb}, {R // cb} chunks: bitwise equal; "
          f"{n_a} survivors in a prefix of {int(total_a)} lanes, {n_d} "
          f"retired rays in {pad_d} dead lanes (dead_end {int(dead_end)})")
    scratch = dead.clone()
    results[native.COMPACT.name] = dict(
        rays=R, max_abs_err=err3,
        ms=_time_ms(lambda: compact.compact(full1, scratch, meta, cb)),
        plain_ms=_time_ms(lambda: compact.compact_plain(full1, scratch, meta,
                                                        cb), reps=2),
        **_bound((2 * R + 12 * n_a + 8 * n_d) * 4 + (16 * R + 8 * pad_d) * 4,
                 0))
    masks = torch.stack([full1[7], full1[11]])
    y = out_k[8:12].contiguous()
    back_k = compact.expand(y, dead_k, masks, meta, cb)
    back_p = compact.expand_plain(y, dead_k, masks, meta, cb)
    torch.cuda.synchronize()
    err5 = _require_bitwise("B5", back_k, back_p)
    print(f"B5 at {R} rays: bitwise equal")
    results[native.EXPAND.name] = dict(
        rays=R, max_abs_err=err5,
        ms=_time_ms(lambda: compact.expand(y, dead_k, masks, meta, cb)),
        plain_ms=_time_ms(lambda: compact.expand_plain(y, dead_k, masks,
                                                       meta, cb), reps=2),
        **_bound((2 * R + 4 * n_a + 4 * n_d) * 4 + 4 * R * 4, 0))

    # the second boundary, as the default schedule runs it: wave 1 (B4) on
    # the survivor prefix, then B3 with grid_live = the prefix and the dead
    # array filled from dead_end on; B5 with grid_live writes only the
    # prefix, so it is compared there
    clive = (out_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    full2 = intersect_perlane.trace_shade_perlane(
        out_k, eng.plt_i, eng.plt_s, eng.ab, fold_in(key, 1), P, RB, False,
        1 / 512, clive)
    meta2, total_a2, skip2, _ = compact.compact_meta(full2[7], full2[11], cb,
                                                     dead_end, R)
    if bool(skip2):
        raise AssertionError("second boundary overflowed (M_IDENT)")
    out2_k, dead2_k = compact.compact(full2, dead_k.clone(), meta2, cb,
                                      grid_live=total_a)
    out2_p, dead2_p = compact.compact_plain(full2, dead_k.clone(), meta2, cb,
                                            grid_live=total_a)
    torch.cuda.synchronize()
    _require_bitwise("B3 state, boundary 1", out2_k, out2_p)
    _require_bitwise("B3 dead, boundary 1", dead2_k, dead2_p)
    masks2 = torch.stack([full2[7], full2[11]])
    y2 = out2_k[8:12].contiguous()
    n_pre = int(total_a)
    back2_k = compact.expand(y2, dead2_k, masks2, meta2, cb,
                             grid_live=total_a)
    back2_p = compact.expand_plain(y2, dead2_k, masks2, meta2, cb,
                                   grid_live=total_a)
    torch.cuda.synchronize()
    _require_bitwise("B5, boundary 1", back2_k[:, :n_pre].contiguous(),
                     back2_p[:, :n_pre].contiguous())
    n_a2 = int(meta2[:, compact.M_CNT_A].sum())
    print(f"B3 and B5 at the second boundary (grid_live {n_pre}, dead_base "
          f"{int(dead_end)}): bitwise equal; {n_a2} survivors in a prefix "
          f"of {int(total_a2)} lanes")
    del full2, out2_k, out2_p, dead2_k, dead2_p, y2, back2_k, back2_p, masks2
    t_zero = _time_ms(lambda: torch.zeros_like(full1))
    for k in native.KERNELS:
        r = results[k.name]
        print(f"time {k.name} ({r['rays']} rays): kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]")
    print(f"time torch.zeros [16, {R}] (inside B3's wrapper): {t_zero:.4f} ms "
          f"[{card}]")
    del full0, full1, fm, ft, fc, fpl, fpt, out_k, out_p, dead, dead_k
    del dead_p, scratch, back_k, back_p, y, masks

    # 4. golden on the card, default (compacted) Engine
    g_scene, g_vp = circles.build(resolution=(96, 54), maxdepth=5)
    golden = png.read_png(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests", "goldens", "circles_96x54.png"))
    img = Engine(g_scene, device=dev).render(g_vp, fixed_rng=True).image
    n_bad = int((img != golden).any(axis=-1).sum())
    if n_bad:
        raise AssertionError(f"golden: {n_bad} pixels differ")
    print("golden: circles 96x54 fixed_rng byte-equal on the card "
          "(default Engine, compacted after waves 0 and 1)")

    # 5. kernel path vs plain path on the card, default Engine
    m_scene, m_vp = circles.build(resolution=(640, 360), maxdepth=5)
    img_k = Engine(m_scene, device=dev).render(m_vp, fixed_rng=True).image
    swaps = {"cull_mask_exact": cull.cull_mask_exact_plain,
             "trace_shade_chunks": intersect.trace_shade_chunks_plain,
             "trace_shade_perlane":
                 intersect_perlane.trace_shade_perlane_plain,
             "compact": compact.compact_plain,
             "expand": compact.expand_plain}
    saved = {n: getattr(eng_mod, n) for n in swaps}
    before = _counts()
    for n, fn in swaps.items():
        setattr(eng_mod, n, fn)
    try:
        img_p = Engine(m_scene, device=dev).render(m_vp, fixed_rng=True).image
    finally:
        for n, fn in saved.items():
            setattr(eng_mod, n, fn)
    if _counts() != before:
        raise AssertionError("plain path launched a kernel")
    n_px = img_k.shape[0] * img_k.shape[1]
    n_diff = int((img_k != img_p).any(axis=-1).sum())
    print(f"kernel vs plain path 640x360 fixed_rng: {n_diff} of {n_px} "
          f"pixels differ")
    if n_diff > 1e-4 * n_px:
        raise AssertionError("kernel and plain paths differ beyond 0.01%")

    # 6. circles_2k end to end: the autotuned default Engine and ncompact=0
    eng.render(vp)                       # the autotune plans on this render
    planned = eng.ncompact
    eng0 = Engine(scene, ncompact=0, device=dev)
    eng0.render(vp)
    torch.cuda.synchronize()
    print(f"autotune: planned schedule {planned}")
    runs = {"default": [], "ncompact=0": []}
    launches = {k.name: 0 for k in native.KERNELS}
    for _ in range(3):
        for name, e in (("default", eng), ("ncompact=0", eng0)):
            torch.cuda.synchronize()
            if name == "default":
                native.reset_launch_counts()
            runs[name].append(e.render(vp))
            torch.cuda.synchronize()
            if name == "default":
                for k, c in _counts().items():
                    launches[k] += c
    for name, rs in runs.items():
        best = min(rs, key=lambda r: r.seconds)
        img = best.image
        if img.shape != (vp.height, vp.width, 3) or img.dtype != np.uint8:
            raise AssertionError(f"circles_2k image {img.shape} {img.dtype}")
        if int(best.wave_rays[0]) != R0 or not (img.max() > 0):
            raise AssertionError(f"circles_2k wave_rays {best.wave_rays}")
        print(f"circles_2k {name}: best {best.seconds:.6f} s of "
              f"{[round(r.seconds, 6) for r in rs]}, rays_traced "
              f"{best.rays_traced}, {best.mrays_per_sec:.3f} Mrays/s, "
              f"wave_rays {best.wave_rays.tolist()} [{card}]")
    same = all(np.array_equal(a.image, b.image)
               for a, b in zip(runs["default"], runs["ncompact=0"]))
    print(f"default and ncompact=0 images equal: {same} (live RNG: the "
          f"scatter hash keys on the compacted layout, so they may differ)")
    print(f"launches in the 3 default renders: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    # 7. where the time of one circles_2k render goes
    for name, e in (("default", eng), ("ncompact=0", eng0)):
        wall_ms, per_name, busy_ms = _profile_render(e, vp)
        print(f"profile {name}: render {wall_ms:.3f} ms under the profiler, "
              f"device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%) [{card}]")
        for n, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:16]:
            print(f"  device {ms:9.3f} ms  {n[:90]}")
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
         "library_ms": None, **results[k.name]} for k in native.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
