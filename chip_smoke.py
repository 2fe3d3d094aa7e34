#!/usr/bin/env python3
"""Smoke run of the torch/CUDA port (rust_raytrace_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns CSRC [--out FILE]
    python3 chip_smoke.py --scene-build
    python3 chip_smoke.py --counts [--out FILE]
    python3 chip_smoke.py --distributed

The second form runs no smoke phase: it times kernels and the renders
that run them in turns against a build of CSRC, the
`rust_raytrace_tpu_torch/csrc/` of an earlier commit (`git archive COMMIT
rust_raytrace_tpu_torch/csrc`).  TURNS_AGAINST names the commit, binds its
C entry points and says what is timed: now commit a0d7908's B7 (one
thread a lane over the per-lane tables) and B13 (the all-pairs rank): B7
on the lit circles_2k wave-1 rows (nearest), their shadow rays (any-hit)
and the 4-bank sphere's camera and wave-1 rays, the per-lane shadow pass
beside the B1/B6 one, B13 on the circles_2k and sphere camera waves
beside the split form and B1 alone, and the default circles_2k render.

The third form times synthetic_1m_2k's host build alone (the scene and
its Engine's pages and tables) and says whether the native scene pipeline
took it; run it with RUST_RAYTRACE_NO_NATIVE=1 for the numpy build.

The fourth runs only B9's whole-wave checks and its counting phase (see
phase 3) on synthetic_1m_2k, its numbers also as JSON to `--out`
(default `build/counts.json`).

The fifth runs only phase 6n, the render across processes, after the
builds of phase 2: on a machine of several cards, its nccl ranks one a
card.

The main paths: the unlit circles_2k render (B1, B2, B3, B4, B5); the lit
one, circles_2k with the teapot preset's light (B1 twice at wave 0, B6
twice, B8, B3, B4 with its fused shadow feeler, B5); the streamed
regime's, synthetic_1m_2k (a 708x708 lat/lon sphere, 1,001,112 triangles,
past the resident tables' cap) unlit (B9 every wave, B3, B5) and lit (B10
twice and B8 every wave, B3, B5); the portable renderer on circles_2k
(WavefrontRenderer: B11 every wave of every slab); the legacy loop on
circles_2k (Engine(compact=False): B1 and B6 every wave); spp 4 on circles
512x512 (the unlit path's kernels); a debug render (wave 0 through B1,
B6 and B8); synthetic_1m_2k through Engine(bank_major=True) (B9 on waves
0-1, the bank-major sweep's prep, sweep and finish, B12a-c, on the later
waves, B3, B5); circles_2k through render_banded (the unlit path's
kernels, band by band); the fused lit wave 0 (lit circles_2k through
`_dispatch(wave0_fused_lights=True)`: B4 on every wave, B3, B5),
circles_2k through Engine(ncompact=-1, gate_frac=0.7) (the unlit path's
kernels, B3 and B5 at every boundary) and through `_dispatch` with
wave0_skippable and with cb=256 (the unlit path's); the per-lane shadow
pass
(engine.shadow_mask_perlane, B7 any-hit) on lit circles_2k's wave-1 rows;
circles_2k through Engine(ray_chunk=4096) (the unlit path's kernels, the
chunk-block ones B1 and B2 at 4 rays a thread); circles_2k past a lowered
table_slot_cap with streamed=False (the union bounce waves: B1 with
chunk_live and B2 with chunk_live and grid_live on every bounce wave, B3,
B5; no per-lane tables), through Engine(bounce_chunk=512) (the unlit
path's kernels, the bounce waves at 512-ray chunks) and through
render_sharded over 2 shards of the card (the unlit path's kernels, once
a shard); circles_2k across processes (`parallel.distributed`: 2 gloo
ranks sharing the card, each launching the unlit path's kernels, B1 and B2
once, in its render, and B11 alone in `trace_rays_distributed`); and the
command line
(`python -m rust_raytrace_tpu_torch.cli`, run in process, its slow runs
each in a process of its own): render circles_2k (the unlit path), with
--band-rows, with --backend simple (B11) and with --debug-csv (the debug
path), diff engine vs oracle, tune.  B13
(the cull with the page sort in the kernel) and B14a/B14b (the bucketed
compaction and its inverse) launch on no render path, as in the JAX
package: phase 3 drives them directly.

Phases, each fatal on failure:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles csrc/*.cu into build/kernels/ (hash-cached, one
     nvcc per source, all started together), and g++ the port's native
     scene pipeline into build/host/ (utils/host_native), which must load;
  3. kernels against their plain torch versions on the card, at the main
     paths' shapes (ray_chunk 1024, page size 56, 37 pages), bitwise: B1,
     B2 and B4 (over the page-major records) on 64 chunks of a real
     circles_2k wave, B1 with chunk_live and B2 with chunk_live and
     grid_live on those chunks' wave-1 state (chunks with no live ray and
     every eighth chunk flagged dead, grid_live 48: the chunks B2 passes
     through keep their state words), then the lights path's B6 on those camera rays
     (folded pages), B6 on their shadow rays with self-exclusion, B8 with
     the shadow mask and B4 with the feeler on the lit wave-1 state; B1,
     B2 and B6 (camera rays, and shadow rays with self-exclusion) and the
     lit wave 0's state on the whole wave 0, with the pages each chunk
     visited and the pairs B2/B6 tested and needed (their bound counts
     what the exact function needs on the visited pages), and the ptxas
     reports of B1 and B2/B6; B2 with chunk_live and grid_live on the
     whole wave-1 state compacted as the union bounce waves compact it,
     timed beside the bound of what its exact function needs there; B4 unlit and lit on the whole wave 1; B3
     and B5 on the whole circles_2k state after wave 0 (3,686,400 rays,
     cb 512, 7,200 chunks) and again at the second boundary (after wave 1
     on the survivor prefix:
     grid_live and dead_base > 0, B5 compared within the prefix); times of
     kernel and plain version, and of each kernel on the full wave, beside
     the least time the card could take (bound), and the time of the shadow
     pass's bulk random draw (threefry glue); then the streamed kernels on
     the synthetic_1m_2k tables (its scene built on the host by the native
     scene pipeline's make_triangles and kd_order, which must be taken,
     their seconds printed; page size 224, 35 banks in device memory; the
     page-major records built on the card checked word for word against
     the per-lane tables and the pages' packed lanes) on
     64 chunks of its camera rays, spread over the chunks that hit the
     sphere: B10 nearest (all 16 rows), B10 any-hit
     with self-exclusion on their shadow rays (the occlusion bit), B9 on
     the wave-0 state with dead chunks and on the wave-1 state, under live
     and fixed RNG, all bitwise, and each timed on the full wave; B9 on
     the whole waves 0, 1 and 2 (wave 2 as `_wave2_state` makes it) under
     fixed and live RNG, bitwise against its plain version; the counting
     phase (B9's counting instance on each whole wave: per traced ray the
     mean and p99 of its bank steps, bank-, group- and page-box slab
     tests, bank visits, pages and triangles, the triangle loop's
     active-lane share and the lanes a ray the list picked, its state
     bitwise equal); B9 on the whole wave 2 timed beside its bound; then
     B11
     (t and id) on 64 chunks of circles_2k's camera rays and wave-1 rays at
     the WavefrontRenderer's page size 256, with no mask and with the
     wave's alive mask, and on the whole camera wave (no mask) and the
     whole wave 1 (masked), bitwise, timed on full waves beside its bound
     (what the exact function needs, counted from the winners: every live
     pair's t, a plane distance of each pair whose t could beat the
     winner, the winner's three), with its ptxas report; B7 (nearest, all
     16 rows) on the lit circles_2k chunks' wave-1 rays and any-hit with
     self-exclusion on their shadow rays (the occlusion bit), again on a
     resident sphere of 4 banks (camera rays, with every fifth chunk dead
     too, wave-1 rays, shadow rays), on the whole lit wave 1 and its
     shadow rays (nearest bitwise, the occlusion bits), timed there
     beside its bound, and the per-lane
     shadow pass against the B1/B6 one there (lanes that differ, times in
     turns, its launches); B12 on synthetic_1m_2k's wave-2 state (after B9
     waves 0-1 and their compactions), under fixed and live RNG, on
     N_CHECK_CHUNKS chunks with dead chunks past the prefix: prep's winner
     init and demand, the sweep's winner stream, finish's state bitwise
     against the plain phases and the chained B12 against B9; on the whole
     wave-2 state B12 == B9 bitwise, each phase timed beside its bound, one
     B12b grid a sweep call (profiler) there and on an empty wave, and
     the chain and B9 timed in turns; B7's, B9/B10's and B12's ptxas
     reports; B13
     on circles_2k's camera rays (37 pages, NPpad 128) and on the 4-bank
     sphere's (510 pages, NPpad 512): bitwise against its plain version on
     the check chunks with dead chunks, equal to B1 + stable sort on the
     whole wave, timed there beside that split form in turns (and B1
     alone), and on a branch case (a chunk on the fast path, one whose
     hit keys reach BIGT and beyond, which takes the all-pairs rank, a
     dead chunk, one with no valid ray) bitwise; B14a/B14b on
     circles_2k's state after wave 0 with octant codes (total_a / R and
     the overflow flag printed; bitwise against the plain versions even
     when it overflows), then with two buckets: bitwise, the round trip
     exact, timed in turns beside B3 and B5 on the same state; B1, B2, B6
     and B12a at ray_chunk 2048 and 4096 on 16 chunks against their plain
     versions, B1, B2 and B6 (camera and shadow rays) on the whole wave
     there too, and B1, B2 and B12a timed on whole waves at 1024, 2048 and
     4096; the ptxas reports of B13 and B14; the un-tiling (csrc/untile.cu,
     replacing no TPU kernel) on a random 2560x1440 spp 4 image, byte for
     byte against its plain version and the one PyTorch call
     permute(...).contiguous(), timed beside both, the byte bound and the
     plain version on a host tensor; the camera (csrc/camera.cu, replacing
     no TPU kernel) on the 2560x1440 spp 4 ray set, bit for bit against
     its plain version, timed beside its bound (bytes written, or the
     threefry's int32 operations) and its ptxas report;
  4. golden: the 96x54 circles render under fixed_rng of the default
     (compacted) Engine, of WavefrontRenderer(backend="kernel") and of
     Engine(compact=False) is byte-equal to tests/goldens/circles_96x54.png;
  5. kernel path vs plain path of the default Engine at 640x360 under
     fixed_rng, unlit and lit, on circles and on the synthetic_1m sphere
     (streamed regime; at STREAMED_CHECK_RES), and of the
     WavefrontRenderer; the WavefrontRenderer's "kernel" vs "portable"
     backends; the Engine vs the WavefrontRenderer; the compacted vs the
     legacy Engine, unlit, lit and at spp 4: at most 0.01% of u8 pixels
     may differ in each; the bank-major Engine on the sphere, kernel vs
     plain path (at most 0.01%) and against the worklist Engine (0 pixels,
     an equal float image); shadow_mask_perlane vs shadow_mask on lit
     circles' wave-1 rows (at most 0.01% of lanes); render_banded in three
     bands vs render() (0 pixels, equal wave_rays); Engine(ray_chunk=4096)
     on circles, kernel vs plain path (at most 0.01%); the same on circles
     at 640x360 past a lowered table_slot_cap with streamed=False (the
     union bounce waves), through Engine(bounce_chunk=512) and through
     render_sharded(n_devices=2);
  6. circles_2k (2560x1440, maxdepth 5, live RNG): the default Engine after
     its autotune (the planned schedule printed) and Engine(ncompact=0),
     three timed renders each, in turns; then the lit default Engine, three
     timed renders after a warm-up; then synthetic_1m_2k (2560x1440,
     maxdepth 5, live RNG) through the default Engine, which must take the
     streamed regime at page size 224: three timed renders after the
     autotune's, then one lit render after a warm-up; then, three timed
     renders after a warm-up each, circles_2k through WavefrontRenderer at
     its defaults (B11 only) and through Engine(compact=False) (B1 and B6,
     none of B2-B5), and the default Engine at spp 4 on circles 512x512;
     then one debug render of circles_2k (buffer shapes, valid hit ids,
     candidate sets); synthetic_1m_2k through Engine(bank_major=True),
     three timed renders after a warm-up (B9 twice and B12a-c three times
     a render, none of B1, B2, B4, B10, B11) and one fixed_rng render
     byte-equal to the default Engine's; circles_2k through render_banded
     in three bands of 480 rows, three timed renders and one fixed_rng
     render byte-equal to render()'s; circles_2k through
     Engine(ray_chunk=4096), three timed renders after a warm-up, its
     Mrays/s beside the default's; circles_2k through the union bounce
     waves (a lowered cap, streamed=False: B1 and B2 five launches a
     render, B3, B5, none of B4, B6, B8-B12), Engine(bounce_chunk=512) and
     render_sharded(n_devices=2) (B1 and B2 once a shard), one timed render
     after a warm-up each, each fixed_rng image byte-equal to the default
     Engine's; the command line in process (the
     `--debug-csv` render and the two diffs were started in processes of
     their own before phase 5, and have ended before phase 6 starts):
     `render
     --scene circles --resolution 2k --stats` byte-equal to a fresh
     Engine's first render under key 0 (B1-B5 launched), `--band-rows 480`
     byte-equal to render_banded, `--backend simple` at 2k (B11),
     `--debug-csv` at 640x360 (one line a pixel; B1, B6, B8), `diff --a
     engine --b oracle` at 16x16 (rc 0, "Found 0 errors") and at 48x27
     (its edge-tie report printed, not gated), `tune` at
     640x360 (finishes; the runtimes and ray chunks it walked printed),
     each render's ms and Mrays/s printed; every kernel of each path must
     have launched in its renders and no kernel of another path (counts
     set to 0 just before each render);
     6m. the measurement and parity utilities: the card's fp32 FMA rate
     (utils/roofline's probe rt_fma_peak, swept over the chains a thread
     and the blocks an SM, then the kept shape) and stream bandwidth, each
     within [0.5, 1.05] of the published peak, with nvidia-smi's clocks
     and power sampled beside the window and a {"roofline": ...} line;
     utils/devbench's device-only Mrays/s (ND renders back to back, no
     image copy, no un-permute) of the default and lit circles_2k Engines
     and of synthetic_1m_2k's, beside their phase-6 render Mrays/s, and
     one ND loop of the default Engine under sync-debug mode (its
     synchronizing calls printed; B1-B5 must launch); one default
     circles_2k render inside utils/profiling's `trace` and `annotate`
     (the Chrome trace must hold the render's four engine.* spans once
     each, in order (prep, dispatch, unpermute, readback), on its thread,
     B4's kernel launched inside `engine.dispatch`, the un-tiling's
     inside `engine.unpermute` and the camera's inside `engine.prep`, which
     makes no synchronizing call, and the spans' sum within
     SPAN_GAP_MS of the render's CUDA-event time); B11 on
     circles' camera rays at 320x180, page size 64, against
     ops/intersect_ref's numpy model (tie "lex": hit/miss sets equal, ids
     on at least 99.9% of rays, t within rtol 1e-5, atol 1e-6); and
     utils/parity on the card's 96x54 circles image against the golden
     (rmse, mae and sky diff 0, IoU 1);
     6n. the render across processes (`parallel.distributed.spawn`: 2
     ranks under gloo sharing the card, each with its own Engine of
     circles_2k, the kernel library built in phase 2 and only loaded by
     the ranks): under live key 0 a warm-up and one timed
     `engine_render_distributed`, rank 0's image byte-equal to
     `render_sharded(n_devices=2)`'s (timed beside it) and under fixed_rng
     to render()'s; `trace_rays_distributed(backend="kernel")` on the
     first 2^20 camera rays, its colors and wave counts bitwise equal to
     `trace_rays_sharded` over 2 shards of the card; each rank's launches
     the unlit path's (B1 and B2 once) in its render and B11 alone in its
     trace; where torch sees 2 or more cards, the same with nccl ranks,
     one a card, 2 of them and then one on every card, else 2 nccl ranks
     on the one card must each raise before any collective (NCCL refuses
     a duplicate GPU);
     6o. the JAX package's last paths, at 2560x1440: B4 with its shadow
     feeler on the circles_2k camera wave (the fused lit wave 0), bitwise
     against its plain version on the check chunks (live and fixed RNG),
     timed on the whole wave beside its bound, with its launch shape and
     the occupancy its registers allow; lit circles_2k through
     `_dispatch(wave0_fused_lights=True)` (B4 on every wave, B3 and B5 at
     each planned boundary, no B1, B2, B6 or B8), its fixed_rng image
     byte-equal to the unfused render's, and `devbench.device_metric`
     with and without the flag in turns; circles_2k through
     `Engine(ncompact=-1, gate_frac=0.7)` (B3 and B5 at every boundary;
     the boundaries that went identity read once after the render), its
     fixed_rng image byte-equal to the default Engine's, its render and
     device metric beside the default's; `wave0_skippable` and `cb=256`
     (fixed_rng images byte-equal, device metrics); B3/B5 at the first
     boundary of circles_2k equal to `compact_oracle`/`expand_oracle`;
     every page `ray_aabb_hits` finds for a ray in its chunk's B1 mask, on
     the check chunks of the circles_2k camera wave and on 8 chunks of
     synthetic_1m_2k's that hit the sphere;
  7. profile: one default, one ncompact=0, one lit, one WavefrontRenderer,
     one legacy and one union-bounce circles_2k render and one unlit, one bank-major and one
     lit synthetic_1m_2k render under torch.profiler (the card's time per
     kernel and copy, by kind with B11, B9 and B12a-c apart, its busy
     share; the bank-major render must hold one B12b grid a wave >= 2).
Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {...}}.  Exits non-zero, with no such line, when
CUDA is missing or any phase fails.
"""

import argparse
import contextlib
import ctypes
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from rust_raytrace_tpu_torch import engine as eng_mod
from rust_raytrace_tpu_torch import math3d as m3
from rust_raytrace_tpu_torch import render as render_mod
from rust_raytrace_tpu_torch.camera import create_viewport
from rust_raytrace_tpu_torch.engine import Engine, page_lists
from rust_raytrace_tpu_torch.geometry import make_sphere
from rust_raytrace_tpu_torch.materials import matte
from rust_raytrace_tpu_torch.models import circles
from rust_raytrace_tpu_torch.ops import (camera, compact, cull, intersect,
                                        intersect_perlane, intersect_streamed,
                                        shade, untile)
from rust_raytrace_tpu_torch.ops.intersect_ref import nearest_hit_model
from rust_raytrace_tpu_torch.ops.pages import (LANE_ID, LANE_N, LANE_NC,
                                              build_pages)
from rust_raytrace_tpu_torch.parallel import distributed
from rust_raytrace_tpu_torch.parallel.sharding import (make_mesh,
                                                       trace_rays_sharded)
from rust_raytrace_tpu_torch.render import WavefrontRenderer
from rust_raytrace_tpu_torch.scene import LightSource, assemble
from rust_raytrace_tpu_torch.utils import (devbench, host_native, native,
                                          parity, png, roofline)
from rust_raytrace_tpu_torch.utils.profiling import annotate, trace
from rust_raytrace_tpu_torch.utils.rng import fold_in, prng_key, uniform

DEVICE = "cuda"
RB = 1024
N_CHECK_CHUNKS = 64
#: float32 operations of one ray/page slab test (cull and per-lane
#: traversal: per axis 2 sub, 2 mul, min, max; the folds, the hit test and
#: the entry clamp) and of one ray/triangle hit test (four 3-term dot
#: products, the division, three plane distances, the compares and the
#: lexicographic update)
SLAB_FLOPS = 26
HIT_FLOPS = 34
#: B11's hit test (with the ray origin) in the parts its exact function
#: needs: of every (ray, triangle) pair the plane's t (the two 3-term dot
#: products n.d and n.o, the subtraction, the division, the tests t >= 0
#: and against the best); of a pair whose t could win, a plane distance
#: (two dot products, the fma, the subtraction, the test against 1); of the
#: winner, the lexicographic update
PLANE_T_FLOPS = 14
PLANE_DIST_FLOPS = 14
UPDATE_FLOPS = 2
#: the same on pages with a shared origin folded in (zero_origin: B2 and
#: B6's camera rays): t is n.d, the division and the two tests; a plane
#: distance s.d, the fma and the test
PLANE_T_FOLDED_FLOPS = 8
PLANE_DIST_FOLDED_FLOPS = 8
#: bytes of a page slot that B2's and B6's predicate reads (lanes 0..16:
#: the normal, the three side planes, the four offsets and the id), and of
#: the payload lanes (17..23) that only a winner's slot is read for
PRED_BYTES = 4 * (LANE_ID + 1)
PAYLOAD_BYTES = 4 * (intersect.USED_LANES - LANE_ID - 1)
#: float32 operations of one ray's shade (B0b: contributions, two
#: normalizations with their Newton steps, reflection, selects)
SHADE_FLOPS = 120
#: the teapot preset's light (models/teapot.py, with_light=True):
#: (ox, oy, oz, len2)
LIGHT = (-4.0, 8.0, 0.0, 0.2)
#: the kernels each main path runs
UNLIT_PATH = ("cull_mask_exact", "trace_shade_chunks", "compact",
              "trace_shade_perlane", "expand")
LIT_PATH = ("cull_mask_exact", "trace_chunks", "shade", "compact",
            "trace_shade_perlane", "expand")
STREAMED_PATH = ("trace_shade_streamed", "compact", "expand")
STREAMED_LIT_PATH = ("trace_streamed", "shade", "compact", "expand")
#: kernels of the resident regime, which the streamed renders never launch
RESIDENT_ONLY = ("cull_mask_exact", "trace_shade_chunks",
                 "trace_shade_perlane")
#: the legacy loop (Engine(compact=False)) runs B1 and B6 every wave and
#: none of the compacted loop's fused or compaction kernels
LEGACY_PATH = ("cull_mask_exact", "trace_chunks")
NOT_LEGACY = ("trace_shade_chunks", "compact", "trace_shade_perlane",
              "expand")
#: a debug render's wave 0 runs unfused: B1, B6 to rows, B8
DEBUG_PATH = ("cull_mask_exact", "trace_chunks", "shade")
#: Engine(bank_major=True) in the streamed regime, unlit: B9 on waves 0-1,
#: the bank-major sweep's three kernels (B12) on the later waves
BANK_MAJOR_PATH = ("trace_shade_streamed", "bankmajor_prep",
                   "bankmajor_sweep", "bankmajor_finish", "compact",
                   "expand")
BANK_MAJOR_KERNELS = ("bankmajor_prep", "bankmajor_sweep", "bankmajor_finish")
#: the per-lane shadow pass (engine.shadow_mask_perlane): B7 alone
PERLANE_SHADOW_PATH = ("trace_perlane",)
#: a scene past the resident tables' cap with streamed=False: every wave
#: culls (B1, with chunk_live on the bounce waves) and runs B2 (with
#: chunk_live and grid_live there), compacted between waves
UNION_BOUNCE_PATH = ("cull_mask_exact", "trace_shade_chunks", "compact",
                     "expand")
NOT_UNION_BOUNCE = ("trace_shade_perlane", "trace_chunks", "shade",
                    "trace_shade_streamed", "trace_streamed", "nearest_hit",
                    "trace_perlane", "bankmajor_prep", "bankmajor_sweep",
                    "bankmajor_finish")
#: the Engine's union bounce waves, bounce_chunk and render_sharded shard
#: counts in phases 5 and 6
BOUNCE_CHUNK = 512
SHARDS = 2
#: the phase-5 resolution of the synthetic_1m sphere (the plain path walks
#: the 35 banks with many small torch ops)
STREAMED_CHECK_RES = (640, 360)


def synthetic_1m_scene():
    """synthetic_1m_2k's scene (bench.py): a 708x708 lat/lon sphere of
    radius 4 at z = 10, 1,001,112 triangles."""
    return assemble([make_sphere((0.0, 0.0, 10.0), 4.0, (708, 708),
                                 matte(m3.make_color((252, 119, 0)), 0.2),
                                 0.0)])


def synthetic_view(resolution):
    """synthetic_1m_2k's camera at `resolution`: maxdepth 5, spp 1."""
    return create_viewport(resolution, (1.6, 0.9), (0.0, 0.0, 0.0),
                           m3.unit(m3.vec(0.0, 0.0, 1.0)), 90.0, 0.0, 5, 1)


def lit(scene):
    """`scene` with the teapot preset's light."""
    scene.lights = LightSource(orig=np.asarray(LIGHT[:3], np.float32),
                               len2=LIGHT[3])
    return scene


_START = time.perf_counter()


def _phase(label: str) -> None:
    """Print the seconds since the script started, at a phase's start."""
    print(f"phase {label}: {time.perf_counter() - _START:.1f} s")


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


def _device_ms(fn, reps: int = 20) -> float:
    """The card's time of fn() (the sum of its kernels' device intervals,
    torch.profiler) over reps calls, after one warm-up: a small kernel's
    time without its wrapper's host time, which CUDA events around
    back-to-back calls also count when the host is the slower."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(spans) / 1e3 / reps


def _time_plain_ms(fn) -> float:
    """CUDA-event time of one fn() with no warm-up: a plain version is torch
    ops (nothing to compile), it has just run for its check, and some take
    seconds a call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate (the H100 SXM data
    sheet's, at 700 W: `utils/roofline.py`'s published peaks)."""
    t_b = n_bytes / roofline.PUBLISHED_HBM_BYTES_PER_S * 1e3
    t_o = flops / roofline.PUBLISHED_FP32_FLOP_PER_S * 1e3
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
    name: ms}, busy ms, {device activity name: count}): busy is the union
    of the card's kernel and copy intervals."""
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
    per_name, n_name, busy_us, edge = {}, {}, 0.0, float("-inf")
    for start, end, name in spans:
        per_name[name] = per_name.get(name, 0.0) + (end - start) / 1e3
        n_name[name] = n_name.get(name, 0) + 1
        if end > edge:
            busy_us += end - max(start, edge)
            edge = end
    return wall_ms, per_name, busy_us / 1e3, n_name


def _counts():
    return {k.name: k.launches for k in native.KERNELS}


def _plain_rows(ot, dt, PK, c, pl, pt, page_size, ray_chunk,
                zero_origin=False, excl=None):
    return intersect.trace_chunks_plain(ot, dt, PK, c, pl, pt, ray_chunk,
                                        zero_origin, excl)


#: the engine module's kernel wrappers and their plain versions
PLAIN = {"cull_mask_exact": cull.cull_mask_exact_plain,
         "trace_shade_chunks": intersect.trace_shade_chunks_plain,
         "trace_shade_perlane": intersect_perlane.trace_shade_perlane_plain,
         "compact": compact.compact_plain,
         "expand": compact.expand_plain,
         "trace_chunks": _plain_rows,
         "shade": shade.shade_plain,
         "trace_shade_streamed":
             intersect_streamed.trace_shade_streamed_plain,
         "trace_streamed": intersect_streamed.trace_streamed_plain}


def _plain_perlane_rows(ot, dt, alive, tables, page_size, ray_chunk,
                        chunk_live=None, excl=None, any_hit=False):
    return intersect_perlane.trace_perlane_plain(
        ot, dt, alive, *tables[:3], page_size, excl, any_hit, ray_chunk,
        chunk_live)


def _plain_perlane_whole(ot, dt, alive, tables, page_size, excl=None,
                         any_hit=False, block=1 << 18):
    """`trace_perlane_plain` on a whole wave, in blocks of `block` rays (its
    gathers hold 17 * P floats a ray of a step)."""
    R = ot.shape[1]
    out = torch.empty((16, R), dtype=torch.float32, device=ot.device)
    for i in range(0, R, block):
        s = slice(i, min(R, i + block))
        out[:, s] = intersect_perlane.trace_perlane_plain(
            ot[:, s], dt[:, s], alive[s], *tables[:3], page_size,
            None if excl is None else excl[s], any_hit)
    return out


PLAIN["trace_shade_bankmajor"] = intersect_streamed.trace_shade_bankmajor_plain
PLAIN["trace_perlane"] = _plain_perlane_rows
PLAIN["untile_u8"] = untile.untile_u8_plain
PLAIN["camera_rays_tiled"] = camera.camera_rays_tiled_plain


def _plain_nearest(O, D, PK, page_size, ray_chunk, alive=None):
    return intersect.nearest_hit_plain(O, D, PK, ray_chunk, alive)


#: the render module's kernel wrapper (WavefrontRenderer) and its plain
#: version
PLAIN_RENDER = {"nearest_hit": _plain_nearest}


@contextlib.contextmanager
def plain_path():
    """Engines and WavefrontRenderers render through the plain versions of
    every kernel inside; fails if a kernel launched."""
    patches = [(eng_mod, PLAIN), (render_mod, PLAIN_RENDER)]
    saved = [(m, {n: getattr(m, n) for n in table}) for m, table in patches]
    before = _counts()
    for m, table in patches:
        for n, fn in table.items():
            setattr(m, n, fn)
    try:
        yield
    finally:
        for m, table in saved:
            for n, fn in table.items():
                setattr(m, n, fn)
    if _counts() != before:
        raise AssertionError("plain path launched a kernel")


def _streamed_bound(eng, page_of, o, d, valid, ids, io_bytes: int,
                    shade_flops: int = 0, any_hit: bool = False,
                    feats=None) -> dict:
    """The least time the card could take for one streamed trace (B9, B10
    or B12's sweep) of rays o/d [3, n] with `valid` [n] that found the
    triangles `ids` [n] (0: none), counting what this run's data needs:
    bytes, io_bytes per ray plus the bank AABBs, the page AABBs of every
    bank that holds a found triangle and the features of every page that
    does (intersect and shade, or `feats` of them; intersect only for
    any-hit); operations, every valid ray's slab test of every bank, of the
    128 pages of one bank for a ray that enters a bank, the hit tests of its
    found triangle's page (one triangle for any-hit), and shade_flops per
    valid ray."""
    bank_ab = eng.stables.bank_ab
    NB, P = eng.stables.plt_i.shape[0], eng.page_size
    bb = bank_ab[:NB]
    enters = torch.zeros_like(valid)
    step = 1 << 20
    for i in range(0, o.shape[1], step):
        sl = slice(i, i + step)
        tlo, thi = cull.slab([bb[:, k:k + 1] for k in range(3)],
                             [bb[:, k + 3:k + 4] for k in range(3)],
                             [o[k, sl][None] for k in range(3)],
                             [cull.slab_inv(d[k, sl])[None]
                              for k in range(3)])
        enters[sl] = (((tlo <= thi) & (thi >= 0.0) & (bb[:, 6:7] != 0.0))
                      .any(dim=0) & valid[sl])
    hits = valid & (ids != 0)
    pages = torch.unique(page_of[ids[hits].long()])
    banks = torch.unique(pages // 128)
    if feats is None:
        feats = 17 if any_hit else 24
    n_bytes = (o.shape[1] * io_bytes + NB * 7 * 4 + banks.numel() * 128 * 7 * 4
               + pages.numel() * P * feats * 4)
    flops = (int(valid.sum()) * (NB * SLAB_FLOPS + shade_flops)
             + int(enters.sum()) * 128 * SLAB_FLOPS
             + int(hits.sum()) * (1 if any_hit else P) * HIT_FLOPS)
    return _bound(n_bytes, flops)


def _check_records(eng) -> None:
    """The streamed Engine's page-major records on the card equal its
    JAX-layout tables word for word: rec[b*128 + p, j, f] = plt_i[b, f*P +
    j, p] (f < 17) or plt_s[b, (f-17)*P + j, p], pab = ab's lanes 0..7;
    and, on the host, rec's first pages equal the pages' packed lanes
    0..23."""
    tabs, P = eng.stables, eng.page_size
    NB = tabs.plt_i.shape[0]
    rec = tabs.rec.view(torch.int32).reshape(NB, 128, P, 24)
    for f in range(24):
        src = (tabs.plt_i[:, f * P:(f + 1) * P] if f < 17
               else tabs.plt_s[:, (f - 17) * P:(f - 16) * P])
        if not torch.equal(rec[..., f],
                           src.view(torch.int32).transpose(1, 2)):
            raise AssertionError(f"records: feature {f} differs from the "
                                 f"per-lane tables")
    if not torch.equal(tabs.pab.view(torch.int32),
                       tabs.ab.view(torch.int32)[:, :8]):
        raise AssertionError("records: page boxes differ from ab")
    NP = eng.pages.num_pages
    host = tabs.rec[:NP].cpu().view(torch.int32).numpy()
    if not (np.array_equal(host, eng.pages.PK[:, :, :24].view(np.int32))
            and not bool(tabs.rec.view(torch.int32)[NP:].any())):
        raise AssertionError("records: not the pages' lanes 0..23 with zero "
                             "padding pages")
    print(f"streamed records: {tuple(tabs.rec.shape)} and "
          f"{tuple(tabs.pab.shape)} equal the per-lane tables word for word "
          f"on the card, and the pages' lanes 0..23 ({NP} pages, "
          f"{NB * 128 - NP} zero padding pages)")


def _sweep_grids(fn) -> int:
    """The bm_sweep_kernel grids the card ran during fn() (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "bm_sweep_kernel" in e.name)


def _page_of(eng, n_tris: int, dev):
    """[n_tris + 1] int64: the page of each triangle id."""
    P = eng.page_size
    ids = eng.pages.PK[:, :, LANE_ID].astype(np.int64)
    page_of = np.zeros(n_tris + 1, np.int64)
    page_of[ids.ravel()] = np.repeat(np.arange(ids.shape[0]), P)
    return torch.from_numpy(page_of).to(dev)


def _perlane_bound(eng, page_of, o, valid, ids, io_bytes: int,
                   any_hit: bool = False) -> dict:
    """The least time the card could take for one per-lane trace over the
    resident tables (B7) of rays o [3, n] with `valid` [n] that found the
    triangles `ids` [n]: bytes, io_bytes per ray plus the page AABBs and
    the features of every page that holds a found triangle (intersect and
    payload; intersect only for any-hit); operations, every valid ray's
    slab test of every page and the hit tests of its found triangle's page
    (one triangle for any-hit)."""
    NP, P = eng.pages.num_pages, eng.page_size
    hits = valid & (ids != 0)
    pages = torch.unique(page_of[ids[hits].long()])
    feats = 17 if any_hit else 24
    return _bound(o.shape[1] * io_bytes + NP * 7 * 4
                  + pages.numel() * P * feats * 4,
                  int(valid.sum()) * NP * SLAB_FLOPS
                  + int(hits.sum()) * (1 if any_hit else P) * HIT_FLOPS)


def _print_ptxas(build_log: str, label: str, names) -> list:
    """Print and return the -Xptxas -v report (registers, spills) of the
    kernels whose mangled names hold one of `names`."""
    lines, out = build_log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(n in line
                                                      for n in names):
            for rep_line in lines[i:i + 4]:
                out.append(rep_line.strip())
                print(f"  ptxas {label}: {rep_line.strip()}")
    return out


def _wave2_state(eng, full0, key, fixed: bool):
    """The wave-2 state of the streamed Engine's default schedule: B9 wave
    0, compaction (B3), B9 wave 1, compaction; dead chunks past the
    survivor prefix."""
    dev = full0.device
    R = full0.shape[1]
    P = eng.page_size
    cb = compact.pick_cb(R)
    wc = 0.0 if fixed else 1 / 512
    dead = compact.make_dead_array(R, dev, 2, cb)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    prefix = None
    st = full0
    for wave in (0, 1):
        live = ((st[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
                if wave else torch.ones(R // RB, dtype=torch.int32,
                                        device=dev))
        st = intersect_streamed.trace_shade_streamed(
            st, eng.stables, fold_in(key, wave), P, RB, fixed, wc, live)
        meta, total_a, skip, dead_end = compact.compact_meta(
            st[7], st[11], cb, base, R)
        st, dead = compact.compact(st, dead, meta, cb, grid_live=prefix)
        old = (torch.full((), R, dtype=torch.int32, device=dev)
               if prefix is None else prefix)
        prefix = torch.where(skip, old, total_a)
        base = torch.where(skip, base, dead_end)
    return st


def _synthetic_wave0(eng, vp, dev):
    """An Engine's wave-0 state [16, R] of `vp` (synthetic_1m_2k's, or
    circles_2k's: tile-order camera rays, the pinhole origin folded)."""
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d, alive0, _ = eng._camera_rays(
        vp, eng_mod.pick_tile(vp.width, vp.height), R, None)
    alive0 = alive0.to(torch.float32)[None]
    return torch.cat([o, d, alive0, alive0,
                      torch.zeros((8, R), device=dev)], dim=0)


def _streamed_waves(eng, full0, key, fixed: bool = False) -> dict:
    """synthetic_1m_2k's whole waves 0, 1 and 2 as B9 takes them: label ->
    B9's arguments (wave 1 is B9's output of wave 0 with the chunks that
    hold a live ray, wave 2 `_wave2_state`)."""
    dev = full0.device
    R = full0.shape[1]
    tabs, P = eng.stables, eng.page_size
    wc = 0.0 if fixed else 1 / 512
    ones = torch.ones(R // RB, dtype=torch.int32, device=dev)
    a0 = (full0, tabs, fold_in(key, 0), P, RB, fixed, wc, ones)
    full1 = intersect_streamed.trace_shade_streamed(*a0)
    full2 = _wave2_state(eng, full0, key, fixed)
    waves = {"wave 0": a0}
    for w, st in ((1, full1), (2, full2)):
        live = (st[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        waves[f"wave {w}"] = (st, tabs, fold_in(key, w), P, RB, fixed, wc,
                              live)
    return waves


def streamed_counts(waves: dict, card) -> dict:
    """The counting phase: B9's counting instance on each wave of `waves`,
    its state bitwise equal to B9's; per traced ray (a live ray that enters
    a bank box) the mean and the 99th percentile of each count (bank
    selection steps, bank-box, group-box and page-box slab tests, bank
    visits, pages and triangles tested), with the triangle loop's
    active-lane share (lanes testing a triangle over 32 lanes a warp
    iteration) and the lanes a ray the trace grid took."""
    ist = intersect_streamed
    report = {}
    for label, args in waves.items():
        b9 = ist.trace_shade_streamed(*args)
        new, cnt, lanes = ist.trace_shade_streamed_counts(*args)
        _require_bitwise(f"B9's counting instance, {label}", new, b9)
        st, cl = args[0], args[-1]
        live = (st[7] != 0) & torch.repeat_interleave(cl != 0, RB)
        traced = cnt[1] != 0
        c = cnt[:, traced].double()
        row = {"live_rays": int(live.sum()), "traced_rays": int(traced.sum()),
               "lanes": lanes}
        for i, name in enumerate(ist.COUNT_ROWS[:7]):
            row[name] = {"mean": float(c[i].mean()),
                         "p99": float(torch.quantile(c[i], 0.99))}
        led = float(c[7].sum())
        row["active_share"] = float(c[8].sum()) / (32 * led) if led else None
        report[label] = row
        print(f"counts of B9, synthetic_1m_2k {label} ({row['live_rays']} "
              f"live rays, {row['traced_rays']} traced, {lanes} lanes a "
              f"ray; mean / p99 a traced ray): " + ", ".join(
                  f"{n} {row[n]['mean']:.3f} / {row[n]['p99']:.0f}"
                  for n in ist.COUNT_ROWS[:7])
              + f"; triangle loop active-lane share "
              f"{row['active_share']:.4f} [{card}]")
    return report


def b9_whole_waves(eng, full0, key, card):
    """B9 bitwise against its plain version on synthetic_1m_2k's whole
    waves 0, 1 and 2 under fixed and live RNG (the plain version in blocks
    of 2^17 rays, which the card's memory holds: 8x fewer torch launches
    than its default).  Returns the plain version's ms by wave under live
    RNG and the waves of live RNG (`_streamed_waves`)."""
    ist = intersect_streamed
    plain_ms = {}
    saved = ist._PLAIN_RAYS
    ist._PLAIN_RAYS = 1 << 17
    try:
        for fixed in (True, False):
            waves = _streamed_waves(eng, full0, key, fixed)
            for label, args in waves.items():
                got = ist.trace_shade_streamed(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = ist.trace_shade_streamed_plain(*args)
                torch.cuda.synchronize()
                plain_ms[label] = (time.perf_counter() - t0) * 1e3
                _require_bitwise(f"B9 whole {label}, fixed_rng {fixed}", got,
                                 want)
                print(f"B9 on the whole synthetic_1m_2k {label} (fixed_rng "
                      f"{fixed}; {int((args[0][7] != 0).sum())} live rays in "
                      f"{int(args[-1].sum())} live chunks) bitwise equal to "
                      f"its plain version ({plain_ms[label]:.1f} ms) "
                      f"[{card}]")
    finally:
        ist._PLAIN_RAYS = saved
    return plain_ms, waves


def counts_only(out: Path) -> int:
    """`--counts`: the counting phase alone, on synthetic_1m_2k, after
    B9's whole-wave checks against its plain version; the numbers also
    to `out` as JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device(DEVICE)
    card = _card()
    print(card)
    built = native.build()
    _print_ptxas(built["log"], "B9", ("stream_list_kernel",
                                      "stream_trace_kernel"))
    eng = Engine(synthetic_1m_scene(), device=dev)
    full0 = _synthetic_wave0(eng, synthetic_view((2560, 1440)), dev)
    plain_ms, waves = b9_whole_waves(eng, full0, prng_key(7), card)
    report = {"card": card, "plain_ms": plain_ms,
              "counts": streamed_counts(waves, card)}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


def _b12a_bound(st, chunk_live, NB: int) -> dict:
    """The least time the card could take for B12a on the state st with
    `chunk_live` (None: every chunk live), counting what the function
    needs: the winner init (12 B a lane), the alive word of a live
    chunk's lanes (4 B) and the o and d rows of its valid rays (24 B), the
    gm words (4 B a bank and chunk) and the bank AABBs (28 B each);
    operations, the slab test of every bank for each valid ray of a live
    chunk."""
    R = st.shape[1]
    live = (torch.ones(R, dtype=torch.bool, device=st.device)
            if chunk_live is None
            else torch.repeat_interleave(chunk_live != 0, RB))
    valid = int((live & (st[7] != 0)).sum())
    return _bound(R * 12 + int(live.sum()) * 4 + valid * 24
                  + NB * (R // RB) * 4 + NB * 28, valid * NB * SLAB_FLOPS)


def bankmajor_kernels(eng, page_of, full0, card, key, results, build_log):
    """Phase 3 for the bank-major sweep (B12) on synthetic_1m_2k: the
    wave-2 state of the default schedule (after waves 0-1 and their
    compactions), under fixed and live RNG, on N_CHECK_CHUNKS chunks
    spread over its live chunks plus dead chunks past the prefix: prep's
    winner init and group demand, the sweep's winner stream, finish's
    state, each bitwise against its plain phase, and the chained B12
    against B9; then the whole wave: B12 == B9 bitwise, and each phase, the
    chain and B9 timed beside their bounds."""
    dev = full0.device
    tabs = eng.stables
    P = eng.page_size
    NB = tabs[0].shape[0]
    st_ = intersect_streamed
    errs = {k: 0.0 for k in BANK_MAJOR_KERNELS}
    for fixed in (True, False):
        wc = 0.0 if fixed else 1 / 512
        full2 = _wave2_state(eng, full0, key, fixed)
        live2 = (full2[7] != 0).reshape(-1, RB).any(dim=1)
        lc = torch.nonzero(live2)[:, 0]
        n_dead = 8
        pick = torch.linspace(0, lc.numel() - 1, N_CHECK_CHUNKS - n_dead,
                              device=dev).round().long()
        tail = torch.arange(int(lc[-1]) + 1, int(lc[-1]) + 1 + n_dead,
                            device=dev)
        if int(tail[-1]) >= live2.numel():
            raise AssertionError("wave-2 state: no dead chunks past the "
                                 "prefix")
        chunks = torch.cat([lc[pick], tail])
        rays = (chunks[:, None] * RB
                + torch.arange(RB, device=dev)).reshape(-1)
        st2 = full2[:, rays].contiguous()
        cl = (st2[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        seed = fold_in(key, 2)
        win_k, gm_k = st_.bankmajor_prep(st2, tabs[3], NB, RB, cl)
        win_p, gm_p = st_.bankmajor_prep_plain(st2, tabs[3], NB, RB, cl)
        errs["bankmajor_prep"] = _require_bitwise(
            f"B12a winner init, fixed_rng {fixed}", win_k, win_p)
        if not torch.equal(gm_k, gm_p):
            raise AssertionError(f"B12a demand: {int((gm_k != gm_p).sum())} "
                                 f"(bank, chunk) words differ")
        count, order = st_.bankmajor_order(gm_k)
        sw_k = st_.bankmajor_sweep(st2, win_k, gm_k, count, order, tabs, P,
                                   RB)
        sw_p = st_.bankmajor_sweep_plain(st2, win_k, gm_k, count, order,
                                         tabs, P, RB)
        errs["bankmajor_sweep"] = _require_bitwise(
            f"B12b winner stream, fixed_rng {fixed}", sw_k, sw_p)
        fin = (st2, sw_k, tabs[0], tabs[1], seed, P, RB, fixed, wc, cl)
        out_k = st_.bankmajor_finish(*fin)
        errs["bankmajor_finish"] = _require_bitwise(
            f"B12c state, fixed_rng {fixed}", out_k,
            st_.bankmajor_finish_plain(*fin))
        b9 = st_.trace_shade_streamed(st2, tabs, seed, P, RB, fixed, wc, cl)
        _require_bitwise(f"B12 chained vs B9, fixed_rng {fixed}",
                         st_.trace_shade_bankmajor(st2, tabs, seed, P, RB,
                                                   fixed, wc, cl), b9)
        _require_bitwise(f"B12 chained vs B9, fixed_rng {fixed}", out_k, b9)
        print(f"B12 on {N_CHECK_CHUNKS} chunks of synthetic_1m_2k's wave-2 "
              f"state (fixed_rng {fixed}; {int((cl == 0).sum())} chunks "
              f"dead, {int((st2[7] != 0).sum())} rays live, "
              f"{int((gm_k != 0).sum())} of {gm_k.numel()} (bank, chunk) "
              f"pairs demanded, {int((sw_k[1] != 0).sum())} hits): prep, "
              f"sweep and finish bitwise equal to their plain phases, the "
              f"chain bitwise equal to B9")
    # timings: the live-RNG check inputs, then the whole wave-2 state
    wc = 1 / 512
    n = st2.shape[1]
    valid = st2[7] != 0
    hits = valid & (sw_k[1] != 0)
    pre = (st2, tabs[3], NB, RB, cl)
    swa = (st2, win_k, gm_k, count, order, tabs, P, RB)
    results["bankmajor_prep"] = dict(
        rays=n, max_abs_err=errs["bankmajor_prep"],
        ms=_time_ms(lambda: st_.bankmajor_prep(*pre)),
        plain_ms=_time_plain_ms(lambda: st_.bankmajor_prep_plain(*pre)),
        **_b12a_bound(st2, cl, NB))
    results["bankmajor_sweep"] = dict(
        rays=n, max_abs_err=errs["bankmajor_sweep"],
        ms=_time_ms(lambda: st_.bankmajor_sweep(*swa)),
        plain_ms=_time_plain_ms(lambda: st_.bankmajor_sweep_plain(*swa)),
        **_streamed_bound(eng, page_of, st2[0:3], st2[3:6], valid, sw_k[1],
                          52, feats=17))
    results["bankmajor_finish"] = dict(
        rays=n, max_abs_err=errs["bankmajor_finish"],
        ms=_time_ms(lambda: st_.bankmajor_finish(*fin)),
        plain_ms=_time_plain_ms(lambda: st_.bankmajor_finish_plain(*fin)),
        **_bound(n * 140 + int(hits.sum()) * 24 * 4,
                 int(valid.sum()) * SHADE_FLOPS
                 + int(hits.sum()) * HIT_FLOPS))
    R = full2.shape[1]
    flive = live2.to(torch.int32)
    seed = fold_in(key, 2)
    fvalid = full2[7] != 0
    fwin, fgm = st_.bankmajor_prep(full2, tabs[3], NB, RB, flive)
    fcount, forder = st_.bankmajor_order(fgm)
    fsw = st_.bankmajor_sweep(full2, fwin, fgm, fcount, forder, tabs, P, RB)
    fhits = fvalid & (fsw[1] != 0)
    chain = (full2, tabs, seed, P, RB, False, wc, flive)
    b9_full = st_.trace_shade_streamed(*chain)
    _require_bitwise("B12 chained vs B9 on the whole wave-2 state",
                     st_.trace_shade_bankmajor(*chain), b9_full)
    full = {
        "bankmajor_prep": (
            lambda: st_.bankmajor_prep(full2, tabs[3], NB, RB, flive),
            _b12a_bound(full2, flive, NB)),
        "bankmajor_sweep": (
            lambda: st_.bankmajor_sweep(full2, fwin, fgm, fcount, forder,
                                        tabs, P, RB),
            _streamed_bound(eng, page_of, full2[0:3], full2[3:6], fvalid,
                            fsw[1], 52, feats=17)),
        "bankmajor_finish": (
            lambda: st_.bankmajor_finish(full2, fsw, tabs[0], tabs[1], seed,
                                         P, RB, False, wc, flive),
            _bound(R * 140 + int(fhits.sum()) * 24 * 4,
                   int(fvalid.sum()) * SHADE_FLOPS
                   + int(fhits.sum()) * HIT_FLOPS)),
    }
    for name, (fn, bound) in full.items():
        ms = _time_ms(fn)
        dms = _device_ms(fn)
        results[name].update(ms_full=ms, device_ms_full=dms,
                             bound_ms_full=bound["bound_ms"],
                             bound_by_full=bound["bound_by"])
        print(f"time {name} (whole wave-2 state of synthetic_1m_2k, "
              f"{R // RB} chunks, {int(flive.sum())} live): kernel "
              f"{ms:.4f} ms (device time {dms:.4f} ms), bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{card}]")
    # one grid a sweep call: on the whole wave-2 state, and on an empty
    # wave (every chunk dead, as wave 4 of synthetic_1m_2k)
    dead = torch.zeros_like(flive)
    ewin, egm = st_.bankmajor_prep(full2, tabs.bank_ab, NB, RB, dead)
    ecount, eorder = st_.bankmajor_order(egm)
    n_sweeps = {}
    for label, args in (("wave 2", (full2, fwin, fgm, fcount, forder)),
                        ("empty", (full2, ewin, egm, ecount, eorder))):
        native.reset_launch_counts()
        out = []
        grids = _sweep_grids(lambda: out.append(
            st_.bankmajor_sweep(*args, tabs, P, RB)))
        n_sweeps[label] = (grids, native.BM_SWEEP.launches)
        if grids != 1 or native.BM_SWEEP.launches != 1:
            raise AssertionError(f"B12b on the {label} state: {grids} grids, "
                                 f"{native.BM_SWEEP.launches} counted "
                                 f"launches in one sweep call")
    _require_bitwise("B12b on an empty wave", out[0], ewin)
    t_empty = _time_ms(lambda: st_.bankmajor_sweep(full2, ewin, egm, ecount,
                                                   eorder, tabs, P, RB))
    # B12a on the empty wave: the winner init and zero gm words alone
    t_prep_empty = _device_ms(lambda: st_.bankmajor_prep(
        full2, tabs.bank_ab, NB, RB, dead))
    b_prep_empty = _b12a_bound(full2, dead, NB)
    print(f"B12b: one grid a sweep call (profiler: wave 2 "
          f"{n_sweeps['wave 2'][0]}, empty wave {n_sweeps['empty'][0]}); "
          f"the empty wave's sweep {t_empty:.4f} ms; B12a on the empty wave "
          f"(device time) {t_prep_empty:.4f} ms, bound "
          f"{b_prep_empty['bound_ms']:.4f} ms [{card}]")
    results["bankmajor_sweep"]["empty_wave_ms"] = t_empty
    results["bankmajor_prep"]["empty_wave"] = dict(
        device_ms=t_prep_empty, **b_prep_empty)
    chain_bound = _streamed_bound(eng, page_of, full2[0:3], full2[3:6],
                                  fvalid, fsw[1], 128, SHADE_FLOPS)
    t_glue = _time_ms(lambda: st_.bankmajor_order(fgm))
    t_chain = _time_ms(lambda: st_.trace_shade_bankmajor(*chain), reps=3)
    t_b9 = _time_ms(lambda: st_.trace_shade_streamed(*chain), reps=3)
    t_chain2 = _time_ms(lambda: st_.trace_shade_bankmajor(*chain), reps=3)
    t_b9_2 = _time_ms(lambda: st_.trace_shade_streamed(*chain), reps=3)
    # the banks a live wave-2 ray enters (the most an index-order sweep
    # can visit for it) and those it enters before its hit (the least a
    # front-to-back walk visits)
    bb = tabs[3][:NB]
    lo, dl = full2[0:3, fvalid], full2[3:6, fvalid]
    btlo, bthi = cull.slab([bb[:, k:k + 1] for k in range(3)],
                           [bb[:, k + 3:k + 4] for k in range(3)],
                           [lo[k][None] for k in range(3)],
                           [cull.slab_inv(dl[k])[None] for k in range(3)])
    entered = (btlo <= bthi) & (bthi >= 0.0) & (bb[:, 6:7] != 0.0)
    before = entered & (btlo <= fsw[0][fvalid][None])
    n_entered = float(entered.sum(dim=0).float().mean())
    n_before = float(before.sum(dim=0).float().mean())
    del btlo, bthi, entered, before, lo, dl
    print(f"wave-2 rays of synthetic_1m_2k enter {n_entered:.3f} of {NB} "
          f"bank AABBs on average, {n_before:.3f} of them before their hit")
    results["bankmajor_sweep"]["wave2"] = dict(
        chain_ms=[t_chain, t_chain2], b9_ms=[t_b9, t_b9_2], glue_ms=t_glue,
        bound_ms=chain_bound["bound_ms"], bound_by=chain_bound["bound_by"],
        banks_entered_mean=n_entered, banks_before_hit_mean=n_before)
    print(f"time B12 chained (prep, glue, sweep, finish) vs B9 on the whole "
          f"wave-2 state ({int(fvalid.sum())} live rays, {int(fhits.sum())} "
          f"hits), in turns: B12 {t_chain:.4f}, B9 {t_b9:.4f}, B12 "
          f"{t_chain2:.4f}, B9 {t_b9_2:.4f} ms; glue {t_glue:.4f} ms; bound "
          f"{chain_bound['bound_ms']:.4f} ms ({chain_bound['bound_by']}) "
          f"[{card}]")
    _print_ptxas(build_log, "B12", ("bm_prep", "bm_sweep", "bm_finish"))


def perlane_banks(dev, key):
    """B7 on a resident scene of several banks: a 120x120 lat/lon sphere
    (28,560 triangles) before synthetic_1m_2k's camera; on N_CHECK_CHUNKS
    chunks of camera rays that hit it, nearest rows (and with every fifth
    chunk dead), then the wave-1 bounce rays' nearest rows and their
    shadow rays' any-hit occlusion bits with self-exclusion, against the
    plain version.  Returns the
    sphere's Engine, its whole camera wave (o, d, valid) and the check
    lanes, which B13 takes too."""
    scene = assemble([make_sphere((0.0, 0.0, 10.0), 4.0, (120, 120),
                                  matte(m3.make_color((252, 119, 0)), 0.2),
                                  0.0)])
    eng = Engine(scene, device=dev)
    P = eng.page_size
    NB = eng.ptables.ab.shape[0] // 128
    if eng.streamed or NB < 2:
        raise AssertionError(f"B7 scene: streamed {eng.streamed}, {NB} banks")
    tabs = eng.ptables
    vp = synthetic_view((2560, 1440))
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d, alive0 = eng_mod.camera_rays_tiled(
        vp, eng_mod.pick_tile(vp.width, vp.height), R, dev)
    alive0 = alive0.to(torch.float32)
    frows = intersect_perlane.trace_perlane(o, d, alive0, tabs, P, RB)
    hit_chunks = torch.nonzero((frows[1] != 0).reshape(-1, RB).any(dim=1))
    pick = torch.linspace(0, hit_chunks.numel() - 1, N_CHECK_CHUNKS,
                          device=dev).round().long()
    rays = (hit_chunks[pick, 0][:, None] * RB
            + torch.arange(RB, device=dev)).reshape(-1)
    a = alive0[rays][None]
    st0 = torch.cat([o[:, rays], d[:, rays], a, a,
                     torch.zeros((8, rays.numel()), device=dev)])
    cam = (st0[0:3], st0[3:6], st0[7], tabs, P, RB)
    rows0 = intersect_perlane.trace_perlane(*cam)
    _require_bitwise("B7 camera rays, several banks", rows0,
                     _plain_perlane_rows(*cam))
    live = torch.ones(st0.shape[1] // RB, dtype=torch.int32, device=dev)
    live[2::5] = 0
    rows0d = intersect_perlane.trace_perlane(*cam, chunk_live=live)
    _require_bitwise("B7 camera rays with dead chunks, several banks",
                     rows0d, _plain_perlane_rows(*cam, chunk_live=live))
    if (rows0d.reshape(16, -1, RB)[:, live == 0] != 0).any():
        raise AssertionError("B7: a dead chunk's rows are not zero")
    ones = torch.ones(st0.shape[1] // RB, dtype=torch.int32, device=dev)
    st1 = shade.shade(st0, rows0, fold_in(key, 0), RB, False, 1 / 512, ones)
    w1 = (st1[0:3], st1[3:6], st1[7], tabs, P, RB)
    rows1 = intersect_perlane.trace_perlane(*w1)
    _require_bitwise("B7 wave-1 rays, several banks", rows1,
                     _plain_perlane_rows(*w1))
    so, sd, hit, excl = eng_mod.shadow_rays(st1, rows1, key, 1, False, LIGHT)
    sh = (so, sd, hit.float(), tabs, P, RB)
    occ = intersect_perlane.trace_perlane(*sh, excl=excl, any_hit=True)
    occ_p = _plain_perlane_rows(*sh, excl=excl, any_hit=True)
    if not torch.equal(occ[1] != 0, occ_p[1] != 0):
        raise AssertionError("B7 any-hit, several banks: occlusion bits "
                             "differ")
    print(f"B7 on a resident sphere of {len(scene.tris) - 1} triangles, "
          f"{eng.pages.num_pages} pages of {P} in {NB} banks, "
          f"{N_CHECK_CHUNKS} chunks: camera rays ({int((rows0[1] != 0).sum())}"
          f" hits; again with every fifth chunk dead) and wave-1 rays "
          f"({int((rows1[1] != 0).sum())} hits) "
          f"bitwise equal; any-hit occlusion bits equal ({int(hit.sum())} "
          f"shadow rays, {int((occ[1] != 0).sum())} occluded)")
    return eng, o, d, alive0 != 0, rays


def streamed_kernels(dev, card, key, results, build_log):
    """Phase 3 for the streamed regime: B10 and B9 on synthetic_1m_2k, on
    N_CHECK_CHUNKS chunks spread over those whose camera rays hit the
    sphere, and on whole waves.  Returns (scene, its default Engine,
    viewport)."""
    calls0 = dict(host_native.calls)
    t0 = time.perf_counter()
    scene = synthetic_1m_scene()
    t1 = time.perf_counter()
    eng = Engine(scene, device=dev)
    t2 = time.perf_counter()
    took = {k: host_native.calls[k] - calls0[k] for k in calls0}
    if not (took["make_triangles"] == 1 and took["kd_order"] == 1):
        raise AssertionError(f"synthetic_1m_2k's build did not take the "
                             f"native scene pipeline: {took}")
    tabs = eng.stables
    P = eng.page_size
    NB = tabs[0].shape[0]
    if not (eng.streamed and P == 224):
        raise AssertionError(f"synthetic_1m_2k: streamed {eng.streamed}, "
                             f"page size {P}")
    mb = sum(t.numel() for t in tabs[:4]) * 4 / 1e6
    mb_rec = (tabs.rec.numel() + tabs.pab.numel()) * 4 / 1e6
    print(f"synthetic_1m_2k: {len(scene.tris) - 1} triangles, "
          f"{eng.pages.num_pages} pages of {P}, {NB} banks, streamed tables "
          f"{mb:.1f} MB and page-major records {mb_rec:.1f} MB on the card; "
          f"host: scene {t1 - t0:.3f} s, Engine {t2 - t1:.3f} s (the native "
          f"scene pipeline's make_triangles and kd_order) [{card}]")
    _check_records(eng)
    page_of = _page_of(eng, len(scene.tris) - 1, dev)
    vp = synthetic_view((2560, 1440))
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d, alive0, _ = eng._camera_rays(
        vp, eng_mod.pick_tile(vp.width, vp.height), R, None)
    alive0 = alive0.to(torch.float32)[None]
    full0 = torch.cat([o, d, alive0, alive0,
                       torch.zeros((8, R), device=dev)], dim=0)
    ts, tsp = intersect_streamed.trace_streamed, \
        intersect_streamed.trace_streamed_plain
    tss, tssp = intersect_streamed.trace_shade_streamed, \
        intersect_streamed.trace_shade_streamed_plain
    # the check chunks: spread over the chunks with a hit (the sphere
    # covers a fifth of the image)
    fcam = (full0[0:3], full0[3:6], full0[7], tabs, P, RB)
    frows = ts(*fcam)
    hit_chunks = torch.nonzero((frows[1] != 0).reshape(-1, RB).any(dim=1))
    pick = torch.linspace(0, hit_chunks.numel() - 1, N_CHECK_CHUNKS,
                          device=dev).round().long()
    chunks = hit_chunks[pick, 0]
    rays = (chunks[:, None] * RB + torch.arange(RB, device=dev)).reshape(-1)
    st0 = full0[:, rays].contiguous()
    n = st0.shape[1]

    # B10: nearest on the camera rays, any-hit on their shadow rays
    cam = (st0[0:3], st0[3:6], st0[7], tabs, P, RB)
    rows_k = ts(*cam)
    err10 = _require_bitwise("B10 camera rays", rows_k, tsp(*cam))
    so, sd, hit, excl = eng_mod.shadow_rays(st0, rows_k, key, 0, False,
                                            LIGHT)
    sh = (so, sd, hit.float(), tabs, P, RB)
    occ_k = ts(*sh, excl=excl, any_hit=True)
    occ_p = tsp(*sh, excl=excl, any_hit=True)
    if not torch.equal(occ_k[1] != 0, occ_p[1] != 0):
        raise AssertionError(f"B10 any-hit: {int(((occ_k[1] != 0) != (occ_p[1] != 0)).sum())} occlusion bits differ")
    results[native.TRACE_STREAMED.name] = dict(
        rays=n, max_abs_err=err10, ms=_time_ms(lambda: ts(*cam)),
        plain_ms=_time_plain_ms(lambda: tsp(*cam)),
        **_streamed_bound(eng, page_of, st0[0:3], st0[3:6], st0[7] != 0,
                          rows_k[1], 92),
        any_hit=dict(
            ms=_time_ms(lambda: ts(*sh, excl=excl, any_hit=True)),
            plain_ms=_time_plain_ms(lambda: tsp(*sh, excl=excl, any_hit=True)),
            **_streamed_bound(eng, page_of, so, sd, hit, occ_k[1], 96,
                              any_hit=True)))
    print(f"B10 on {N_CHECK_CHUNKS} chunks of synthetic_1m_2k: camera rays "
          f"bitwise equal ({int((rows_k[1] != 0).sum())} hits); any-hit "
          f"occlusion bits equal ({int(hit.sum())} shadow rays, "
          f"{int((occ_k[1] != 0).sum())} occluded)")

    # B9: the wave-0 state with dead chunks, the wave-1 state
    nc = n // RB
    dead = torch.ones(nc, dtype=torch.int32, device=dev)
    dead[1::4] = 0
    ones = torch.ones(nc, dtype=torch.int32, device=dev)
    errs = []
    for fixed in (True, False):
        wc = 0.0 if fixed else 1 / 512
        a0 = (st0, tabs, fold_in(key, 0), P, RB, fixed, wc, dead)
        errs.append(_require_bitwise(f"B9 wave 0, fixed_rng {fixed}",
                                     tss(*a0), tssp(*a0)))
        st1 = tss(st0, tabs, fold_in(key, 0), P, RB, fixed, wc, ones)
        live1 = (st1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
        a1 = (st1, tabs, fold_in(key, 1), P, RB, fixed, wc, live1)
        errs.append(_require_bitwise(f"B9 wave 1, fixed_rng {fixed}",
                                     tss(*a1), tssp(*a1)))
    # a1: live RNG's wave 1
    rows1 = ts(st1[0:3], st1[3:6], st1[7], tabs, P, RB)
    results[native.TRACE_SHADE_STREAMED.name] = dict(
        rays=n, max_abs_err=max(errs), ms=_time_ms(lambda: tss(*a1)),
        plain_ms=_time_plain_ms(lambda: tssp(*a1)),
        **_streamed_bound(eng, page_of, st1[0:3], st1[3:6], st1[7] != 0,
                          rows1[1], 128, SHADE_FLOPS))
    print(f"B9 on {N_CHECK_CHUNKS} chunks of synthetic_1m_2k: wave 0 ("
          f"{int((dead == 0).sum())} chunks dead) and wave 1 bitwise equal "
          f"under fixed and live RNG; {int((st1[7] != 0).sum())} rays live "
          f"after wave 0, {int(live1.sum())} chunks live")

    # the kernels on whole waves: B10 and its any-hit on the lit wave 0,
    # B9 on the unlit waves 0 and 1
    fso, fsd, fhit, fexcl = eng_mod.shadow_rays(full0, frows, key, 0, False,
                                                LIGHT)
    fsh = (fso, fsd, fhit.float(), tabs, P, RB)
    focc = ts(*fsh, excl=fexcl, any_hit=True)
    fones = torch.ones(R // RB, dtype=torch.int32, device=dev)
    fa0 = (full0, tabs, fold_in(key, 0), P, RB, False, 1 / 512, fones)
    full1 = tss(*fa0)
    flive1 = (full1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    fa1 = (full1, tabs, fold_in(key, 1), P, RB, False, 1 / 512, flive1)
    frows1 = ts(full1[0:3], full1[3:6], full1[7], tabs, P, RB)
    full = {
        "B10 camera rays": (results[native.TRACE_STREAMED.name],
                            _time_ms(lambda: ts(*fcam)),
                            _streamed_bound(eng, page_of, full0[0:3],
                                            full0[3:6], full0[7] != 0,
                                            frows[1], 92)),
        "B10 any-hit shadow rays": (
            results[native.TRACE_STREAMED.name]["any_hit"],
            _time_ms(lambda: ts(*fsh, excl=fexcl, any_hit=True)),
            _streamed_bound(eng, page_of, fso, fsd, fhit, focc[1], 96,
                            any_hit=True)),
        "B9 wave 0": (results[native.TRACE_SHADE_STREAMED.name]
                      .setdefault("wave0", {}),
                      _time_ms(lambda: tss(*fa0)),
                      _streamed_bound(eng, page_of, full0[0:3], full0[3:6],
                                      full0[7] != 0, frows[1], 128,
                                      SHADE_FLOPS)),
        "B9 wave 1": (results[native.TRACE_SHADE_STREAMED.name],
                      _time_ms(lambda: tss(*fa1)),
                      _streamed_bound(eng, page_of, full1[0:3], full1[3:6],
                                      full1[7] != 0, frows1[1], 128,
                                      SHADE_FLOPS)),
    }
    for name, (res, ms, bound) in full.items():
        res.update(ms_full=ms, bound_ms_full=bound["bound_ms"],
                   bound_by_full=bound["bound_by"])
        print(f"time {name} (full synthetic_1m_2k wave, {R // RB} chunks): "
              f"kernel {ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]")
    print(f"synthetic_1m_2k wave 0: {int((frows[1] != 0).sum())} hits of "
          f"{R0} rays, {int((focc[1] != 0).sum())} shadowed; wave 1: "
          f"{int((full1[7] != 0).sum())} live rays, "
          f"{int((frows1[1] != 0).sum())} hits")
    del fso, fsd, fhit, fexcl, fsh, focc, full1, frows1, frows
    # B9 on the whole waves 0-2 against its plain version, the counting
    # phase, and wave 2's time beside its bound
    res9 = results[native.TRACE_SHADE_STREAMED.name]
    res9["whole_wave_plain_ms"], waves = b9_whole_waves(eng, full0, key,
                                                        card)
    res9["counts"] = streamed_counts(waves, card)
    fa2 = waves["wave 2"]
    full2 = fa2[0]
    frows2 = ts(full2[0:3], full2[3:6], full2[7], tabs, P, RB,
                chunk_live=fa2[-1])
    bound2 = _streamed_bound(eng, page_of, full2[0:3], full2[3:6],
                             full2[7] != 0, frows2[1], 128, SHADE_FLOPS)
    ms2 = _time_ms(lambda: tss(*fa2))
    res9["wave2"] = dict(ms_full=ms2, bound_ms_full=bound2["bound_ms"],
                         bound_by_full=bound2["bound_by"])
    print(f"time B9 wave 2 (full synthetic_1m_2k wave, {R // RB} chunks, "
          f"{int(fa2[-1].sum())} live): kernel {ms2:.4f} ms, bound "
          f"{bound2['bound_ms']:.4f} ms ({bound2['bound_by']}) [{card}]")
    del waves, fa2, full2, frows2
    _print_ptxas(build_log, "B9/B10", ("trace_streamed_kernel",
                                       "stream_list_kernel",
                                       "stream_trace_kernel"))
    bankmajor_kernels(eng, page_of, full0, card, key, results, build_log)
    return scene, eng, vp


def _b11_need(O, D, PK, best_t, best_id, live=None) -> dict:
    """What B11's exact function needs on these rays, counted from its
    result (best_t, best_id): every live ray's t against every triangle (a
    slot whose normal is zero, a padding row, never wins: its t is +-inf or
    NaN); one plane distance of each candidate, a pair whose t >= 0 beats
    the ray's winner lexicographically (a smaller t, or an equal finite t
    and a smaller id), which only a plane distance past 1 can reject,
    whatever the order of the visits; and the winner's three plane
    distances and update.  t as the kernel and the plain version round it.
    Returns the counts and the operations."""
    pk = PK.reshape(-1, PK.shape[-1])
    pk = pk[(pk[:, LANE_N:LANE_N + 3] != 0).any(dim=1)]
    rays = (torch.arange(O.shape[0], device=O.device) if live is None
            else torch.nonzero(live).squeeze(1))
    n_tris = pk.shape[0]

    def dot3(f, r):
        return shade.fma(pk[:, f + 2:f + 3], r[2][None],
                         shade.fma(pk[:, f:f + 1], r[0][None],
                                   pk[:, f + 1:f + 2] * r[1][None]))

    ids = pk[:, LANE_ID:LANE_ID + 1]
    cand = 0
    block = max(1, (1 << 25) // max(1, n_tris))
    for r0 in range(0, rays.numel(), block):
        r = rays[r0:r0 + block]
        o, d = O[r].T, D[r].T
        t = (pk[:, LANE_NC:LANE_NC + 1] - dot3(LANE_N, o)) / dot3(LANE_N, d)
        bt = best_t[r][None]
        bi = best_id[r].float()[None]
        cand += int(((t >= 0) & ((t < bt) | ((t == bt) & ~torch.isinf(t)
                                             & (ids < bi)))).sum())
    hits = int((best_id[rays] != 0).sum())
    pairs = rays.numel() * n_tris
    return dict(pairs=pairs, candidates=cand, hits=hits,
                flops=pairs * PLANE_T_FLOPS + cand * PLANE_DIST_FLOPS
                + hits * (3 * PLANE_DIST_FLOPS + UPDATE_FLOPS))


def union_wave(eng, full0, pk0, key, rc, lit_wave=False):
    """B1, B6 and B2 on the whole 2560x1440 circles_2k wave 0 at ray_chunk
    rc, each against its plain version (B1 with torch.equal, the others
    bitwise): B1 on the camera rays, B6 on them (folded pages), B2 (its
    plain version's shade step on the plain B6 rows); then the shadow rays
    of their hits towards the teapot preset's light: B1 on them and B6 with
    self-exclusion.  lit_wave: also the lit wave 0's new state (B8 on the
    kernels' rows and shadow mask against its plain version on the plain
    ones).  Returns the kernels' outputs and the plain traces' rows and
    pages visited."""
    P = eng.page_size
    seed = fold_in(key, 0)

    def cull_both(o, d, valid, label):
        a = (o, d, valid, eng.aabb_lo, eng.aabb_hi, rc)
        m, t = cull.cull_mask_exact(*a)
        mp, tp = cull.cull_mask_exact_plain(*a)
        if not (torch.equal(m, mp) and torch.equal(t, tp)):
            raise AssertionError(f"B1 on {label} at ray_chunk {rc}: kernel "
                                 f"and plain differ")
        return page_lists(m, t)

    lists = cull_both(full0[0:3], full0[3:6], full0[7] != 0,
                      "the whole camera wave")
    cam = (full0[0:3], full0[3:6], pk0, *lists)
    rows = intersect.trace_chunks(*cam, P, rc, zero_origin=True)
    rows_p, vis = intersect.trace_chunks_plain(*cam, rc, True,
                                               return_visits=True)
    _require_bitwise(f"B6 on the whole camera wave at ray_chunk {rc}", rows,
                     rows_p)
    st1 = intersect.trace_shade_chunks(full0, pk0, *lists, seed, P, rc,
                                       False, 1 / 512, zero_origin=True)
    _require_bitwise(f"B2 on the whole camera wave at ray_chunk {rc}", st1,
                     intersect.shade_chunks_plain(full0, rows_p, seed, rc,
                                                  False, 1 / 512))
    so, sd, hit, excl = eng_mod.shadow_rays(full0, rows, key, 0, False,
                                            LIGHT)
    slists = cull_both(so, sd, hit, "the whole wave's shadow rays")
    sh = (so, sd, eng.PK, *slists)
    srows = intersect.trace_chunks(*sh, P, rc, excl=excl)
    srows_p, svis = intersect.trace_chunks_plain(*sh, rc, excl=excl,
                                                 return_visits=True)
    _require_bitwise(f"B6 on the whole wave's shadow rays at ray_chunk {rc}",
                     srows, srows_p)
    w = dict(lists=lists, rows=rows, rows_p=rows_p, visits=vis, state1=st1,
             shadow=sh, hit=hit, excl=excl, srows=srows, srows_p=srows_p,
             svisits=svis)
    if lit_wave:
        live = torch.ones(full0.shape[1] // rc, dtype=torch.int32,
                          device=full0.device)
        shd = (hit & (srows[1] != 0)).float()
        st1l = shade.shade(full0, rows, seed, rc, False, 1 / 512, live, shd)
        _require_bitwise(
            "the whole lit wave 0's state", st1l,
            shade.shade_plain(full0, rows_p, seed, rc, False, 1 / 512, live,
                              (hit & (srows_p[1] != 0)).float()))
        w.update(shd=shd, state1_lit=st1l)
    print(f"ray_chunk {rc}, the whole circles_2k wave 0 "
          f"({int((full0[7] != 0).sum())} camera rays, {int(hit.sum())} "
          f"shadow rays): B1 equal, B6 and B2 bitwise equal to their plain "
          f"versions" + ("; the lit wave 0's state bitwise equal"
                         if lit_wave else ""))
    return w


def _union_need(ot, dt, PK, counts, plist, visits, rows, ray_chunk: int,
                zero_origin: bool = False, excl=None) -> dict:
    """What B2's and B6's exact function needs on these rays, counted from
    the plain version's own loop: `visits` [NC], the pages each chunk
    visited before its chunk-wide exit, and `rows`, its winners.  Every
    (valid ray, triangle) pair of the visited pages (the zero-normal
    padding slots left out) pays the plane's t; a pair whose t >= 0 passes
    the exclusion and beats the ray's final winner lexicographically pays
    a plane distance (only a plane distance past 1 can reject it, whatever
    the order of the visits); a winner its three and the update.  t as the
    kernel and the plain version round it.  Returns the counts (and the
    pairs the kernel tests: every slot of a visited page against every
    lane of the chunk), the operations and the page bytes: the predicate
    lanes of every page some chunk visits, once, and the payload lanes of
    every winning triangle, once."""
    RB = ray_chunk
    NC = ot.shape[1] // RB
    P = PK.shape[1]
    pk = PK[..., :intersect.USED_LANES]
    o = ot.reshape(3, NC, 1, RB)
    d = dt.reshape(3, NC, 1, RB)
    valid = ((d[0] != 0) | (d[1] != 0) | (d[2] != 0))
    bt = rows[0].reshape(NC, 1, RB)
    bi = rows[1].reshape(NC, 1, RB)
    ex = None if excl is None else excl.reshape(NC, 1, RB)
    pairs = cand = 0
    step = max(1, (1 << 24) // (RB * P))
    for c0 in range(0, NC, step):
        v = visits[c0:c0 + step]
        for k in range(int(v.max()) if v.numel() else 0):
            c = c0 + torch.nonzero(v > k).squeeze(1)
            page = pk[plist[c, k].long()]                 # [A, P, 24]

            def col(f, page=page):
                return page[:, :, f:f + 1]

            def dot3(f, r):
                return shade.fma(col(f + 2), r[2][c],
                                 shade.fma(col(f), r[0][c],
                                           col(f + 1) * r[1][c]))

            md_n = dot3(LANE_N, d)
            t = (col(LANE_NC) / md_n if zero_origin
                 else (col(LANE_NC) - dot3(LANE_N, o)) / md_n)
            ids = col(LANE_ID)
            live = (col(LANE_N) != 0) | (col(LANE_N + 1) != 0) \
                | (col(LANE_N + 2) != 0)
            live = live & valid[c]
            ok = live & (t >= 0) & ((t < bt[c]) | ((t == bt[c])
                                                  & ~torch.isinf(t)
                                                  & (ids < bi[c])))
            if ex is not None:
                ok = ok & (ids != ex[c])
            pairs += int(live.sum())
            cand += int(ok.sum())
    hits = int((rows[1] != 0).sum())
    seen = torch.arange(plist.shape[1], device=plist.device)[None] \
        < visits[:, None]
    pages = int(torch.unique(plist[seen]).numel())
    winners = int(torch.unique(rows[1][rows[1] != 0]).numel())
    t_f, d_f = ((PLANE_T_FOLDED_FLOPS, PLANE_DIST_FOLDED_FLOPS) if zero_origin
                else (PLANE_T_FLOPS, PLANE_DIST_FLOPS))
    return dict(pairs=pairs, candidates=cand, hits=hits, pages=pages,
                winners=winners,
                page_bytes=pages * P * PRED_BYTES + winners * PAYLOAD_BYTES,
                valid=int(valid.sum()), tested=int(visits.sum()) * P * RB,
                visits_mean=float(visits.float().mean()),
                visits_max=int(visits.max()),
                flops=pairs * t_f + cand * d_f
                + hits * (3 * d_f + UPDATE_FLOPS))


def union_bounce(eng, st1, key, card, results) -> None:
    """B2 on a union bounce wave: circles_2k's whole wave-1 state compacted
    as the union bounce waves compact it at the first boundary (B3), then
    B1 with chunk_live and B2 with chunk_live and grid_live, as the Engine
    runs them past the resident tables' cap with streamed=False; B2 timed
    beside the bound of what its exact function needs there (`_union_need`
    on the plain trace's visits and winners, the dead lanes' directions
    zeroed)."""
    dev = st1.device
    R = st1.shape[1]
    cb = compact.pick_cb(R)
    dead = compact.make_dead_array(R, dev, 2, cb)
    base = torch.zeros((), dtype=torch.int32, device=dev)
    meta, total_a, skip, _ = compact.compact_meta(st1[7], st1[11], cb, base,
                                                  R)
    st, _ = compact.compact(st1, dead, meta, cb)
    nc = R // RB
    prefix = torch.where(skip, torch.full((), nc, dtype=torch.int32,
                                          device=dev),
                         torch.clamp((total_a + RB - 1) // RB, max=nc)
                         ).to(torch.int32)
    alive = st[7] != 0
    live = alive.reshape(-1, RB).any(dim=1).to(torch.int32)
    a1 = (st[0:3], st[3:6], alive, eng.aabb_lo, eng.aabb_hi, RB)
    lists = page_lists(*cull.cull_mask_exact(*a1, chunk_live=live))
    a2 = (st, eng.PK, *lists, fold_in(key, 1), eng.page_size, RB, False,
          1 / 512)
    kw = dict(chunk_live=live, grid_live=prefix)
    ms = _time_ms(lambda: intersect.trace_shade_chunks(*a2, **kw))
    dm = torch.where(alive[None], st[3:6], 0.0)
    rows_p, vis = intersect.trace_chunks_plain(st[0:3], dm, eng.PK, *lists,
                                               RB, return_visits=True)
    need = _union_need(st[0:3], dm, eng.PK, lists[0], lists[1], vis, rows_p,
                       RB)
    _print_need("B2 on the union bounce wave 1", need, card)
    bound = _bound(R * 128 + need["page_bytes"],
                   need["flops"] + need["valid"] * SHADE_FLOPS)
    results[native.TRACE_SHADE_UNION.name]["union_bounce"] = dict(
        ms=ms, live_rays=int(alive.sum()), live_chunks=int(live.sum()),
        grid_live=int(prefix), **bound,
        need={k: need[k] for k in ("pairs", "candidates", "hits", "tested",
                                   "visits_mean", "visits_max", "pages",
                                   "winners")})
    print(f"time B2 on the union bounce wave 1 (circles_2k, compacted: "
          f"{int(alive.sum())} live rays in {int(live.sum())} chunks, "
          f"grid_live {int(prefix)} chunks): kernel {ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}) [{card}]")


def _print_need(label, need, card):
    print(f"{label}: pages visited per chunk mean {need['visits_mean']:.3f}"
          f", max {need['visits_max']}; pairs tested {need['tested']}; "
          f"needed: {need['pairs']} pairs' t (valid rays, nonzero slots), "
          f"{need['candidates']} candidates' plane distance, "
          f"{need['hits']} winners; read once: {need['pages']} pages' "
          f"predicate lanes, {need['winners']} winning triangles' payload "
          f"[{card}]")


def wavefront_kernels(dev, card, key, results, build_log):
    """Phase 3 for the portable renderer: B11 on circles_2k at page size
    256 (WavefrontRenderer's default), bitwise against its plain version:
    on N_CHECK_CHUNKS chunks of 1,024 spread over the image, of the camera
    rays and of the wave-1 bounce rays (live RNG), with no mask and with
    the wave's `alive` mask; on the whole camera wave with no mask and the
    whole wave 1 with its mask (as trace_rays calls it); timed on whole
    waves beside its bound; and B11's ptxas report.  Returns the scene's
    WavefrontRenderer and the viewport."""
    scene, vp = circles.build(resolution="2k", maxdepth=5)
    wr = WavefrontRenderer(scene, device=dev)
    st = wr.tensors
    NP, P = st.PK.shape[0], st.page_size
    n_tris = len(scene.tris) - 1
    print(f"circles_2k for WavefrontRenderer: {n_tris} triangles in {NP} "
          f"pages of {P} ({NP * P} slots)")
    o, d = render_mod.camera_rays(vp, key, dev)
    R = o.shape[0]
    t, hid = intersect.nearest_hit(o, d, st.PK, P)
    rv = render_mod._random_unit_vec(fold_in(key, 0), R, dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    _, _, alive1, o1, d1 = render_mod.shade_active(
        st, o, d, t, hid, torch.ones(R, device=dev), alive, rv)
    chunks = torch.linspace(0, R // RB - 1, N_CHECK_CHUNKS,
                            device=dev).round().long()
    rays = (chunks[:, None] * RB + torch.arange(RB, device=dev)).reshape(-1)
    n = rays.numel()

    def bound(O, D, live, won):
        # bytes: the live rays, the mask, the pages' used lanes and the
        # winners once; operations: what the exact function needs
        n_rays = O.shape[0]
        n_live = n_rays if live is None else int(live.sum())
        need = _b11_need(O, D, st.PK, *won, live)
        print(f"B11 needs on {n_live} live rays: {need['pairs']} pairs' t, "
              f"{need['candidates']} candidates' plane distance, "
              f"{need['hits']} winners")
        return dict(_bound(n_live * 24 + n_rays * (0 if live is None else 1)
                           + NP * P * 17 * 4 + n_rays * 8, need["flops"]),
                    need={k: need[k] for k in ("pairs", "candidates",
                                               "hits")})

    def gate(label, O, D, live):
        tk, ik = intersect.nearest_hit(O, D, st.PK, P, alive=live)
        tp, ip = intersect.nearest_hit_plain(O, D, st.PK, alive=live)
        torch.cuda.synchronize()
        _require_bitwise(f"B11 {label} t", tk, tp)
        if not torch.equal(ik, ip):
            raise AssertionError(f"B11 {label}: {int((ik != ip).sum())} ids "
                                 f"differ")
        print(f"B11 on {label}: t and id bitwise equal "
              f"({int((ik != 0).sum())} hits of {O.shape[0]} rays, "
              f"{O.shape[0] if live is None else int(live.sum())} live)")
        return tk, ik

    checks = {}
    for name, (O, D, live) in (("camera rays", (o, d, None)),
                               ("wave-1 bounce rays", (o1, d1, alive1))):
        Oc, Dc, lc = O[rays].contiguous(), D[rays].contiguous(), None
        won = gate(f"{N_CHECK_CHUNKS} chunks of circles_2k {name}", Oc, Dc,
                   None)
        if live is not None:
            lc = live[rays].contiguous()
            won = gate(f"{N_CHECK_CHUNKS} chunks of circles_2k {name}, "
                       f"masked", Oc, Dc, lc)
        checks[name] = (Oc, Dc, lc, won)
    won_full = {
        "camera rays": gate("the whole circles_2k camera wave", o, d, None),
        "wave-1 bounce rays": gate("the whole circles_2k wave 1, masked", o1,
                                   d1, alive1)}
    Oc, Dc, _, won = checks["camera rays"]
    results[native.NEAREST_HIT.name] = dict(
        rays=n, max_abs_err=0.0,
        ms=_time_ms(lambda: intersect.nearest_hit(Oc, Dc, st.PK, P)),
        plain_ms=_time_plain_ms(
            lambda: intersect.nearest_hit_plain(Oc, Dc, st.PK)),
        **bound(Oc, Dc, None, won))
    Ob, Db, lb, won = checks["wave-1 bounce rays"]
    results[native.NEAREST_HIT.name]["wave1"] = dict(
        ms=_time_ms(lambda: intersect.nearest_hit(Ob, Db, st.PK, P,
                                                  alive=lb)),
        plain_ms=_time_plain_ms(lambda: intersect.nearest_hit_plain(
            Ob, Db, st.PK, alive=lb)),
        **bound(Ob, Db, lb, won))
    for name, (O, D, live) in (("camera rays", (o, d, None)),
                               ("wave-1 bounce rays", (o1, d1, alive1))):
        ms = _time_ms(lambda: intersect.nearest_hit(O, D, st.PK, P,
                                                    alive=live), reps=3)
        b = bound(O, D, live, won_full[name])
        res = results[native.NEAREST_HIT.name]
        if name != "camera rays":
            res = res["wave1"]
            res["ms_full_unmasked"] = _time_ms(
                lambda: intersect.nearest_hit(O, D, st.PK, P), reps=3)
            res["live_full"] = int(live.sum())
        res.update(ms_full=ms, bound_ms_full=b["bound_ms"],
                   bound_by_full=b["bound_by"], need_full=b["need"])
        n_live = R if live is None else int(live.sum())
        print(f"time nearest_hit B11 (full 2560x1440 wave of {name}, "
              f"{n_live} live of {R} rays x {n_tris} triangles): kernel "
              f"{ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{n_live * n_tris / ms / 1e9:.3f} G live ray-triangle "
              f"pairs/s [{card}]")
    unmasked = results[native.NEAREST_HIT.name]["wave1"]["ms_full_unmasked"]
    print(f"time nearest_hit B11 on the whole wave 1 with no mask: "
          f"{unmasked:.4f} ms [{card}]")
    print(f"circles_2k wave 0: {int((hid != 0).sum())} hits of {R}; "
          f"{int(alive1.sum())} rays live for wave 1")
    results[native.NEAREST_HIT.name]["ptxas"] = _print_ptxas(
        build_log, "B11", ("nearest_hit_kernel",))
    return scene, wr, vp


def _in_turns(fns: dict, rounds: int = 2, reps: int = 5) -> dict:
    """CUDA-event ms of each fn, in turns (a, b, ..., then again)."""
    out = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            out[k].append(_time_ms(fn, reps=reps))
    return out


def cull_sorted_kernels(cases, card, results):
    """Phase 3 for B13 (cull_sorted: B1's cull with each chunk's pages
    ranked by entry in the kernel), which no render path launches.  For
    each case (rays [3, R], valid, page AABBs, the check lanes): on the
    check chunks, with every seventh chunk dead, bitwise against its plain
    version; on the whole wave against the split form the engine uses (B1,
    then page_lists' stable sort): equal counts and page order, the hit
    pages' keys equal to B1's sorted tmin and BIGT after them; then timed
    there beside the split form, in turns."""
    res = None
    for label, (o, d, valid, blo, bhi, rays) in cases.items():
        dev = o.device
        NP = blo.shape[0]
        NPpad = -(-NP // 128) * 128
        R = o.shape[1]
        NC = R // RB
        co, cd = o[:, rays].contiguous(), d[:, rays].contiguous()
        cv = valid[rays].contiguous()
        live = torch.ones(rays.numel() // RB, dtype=torch.int32, device=dev)
        live[3::7] = 0
        args = (co, cd, cv, blo, bhi, RB)
        got = cull.cull_sorted(*args, chunk_live=live)
        want = cull.cull_sorted_plain(*args, chunk_live=live)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"B13 {label}: counts or plist differ")
        _require_bitwise(f"B13 {label} ptmin", got[2], want[2])
        full = (o, d, valid, blo, bhi, RB)
        counts, plist, ptmin = cull.cull_sorted(*full)
        c2, pl2, pt2 = page_lists(*cull.cull_mask_exact(*full))
        j = torch.arange(NP, device=dev)[None]
        split_ok = (torch.equal(counts, c2)
                    and torch.equal(plist[:, :NP], pl2)
                    and bool(torch.where(j < counts[:, None],
                                         ptmin[:, :NP] == pt2,
                                         ptmin[:, :NP] == cull.BIGT).all())
                    and bool((ptmin[:, NP:] == cull.BIGT).all()))
        if not split_ok:
            raise AssertionError(f"B13 {label}: the whole wave disagrees "
                                 f"with B1 + stable sort")

        def bound(n_rays, v, c, pt):
            # the rays once (o, d, valid), the page boxes, the outputs; the
            # slab tests of the valid rays and the rank's comparisons as
            # the kernel makes them: h^2 + NPpad a chunk of h hit pages,
            # NPpad^2 a chunk with a hit key not below BIGT
            nc = n_rays // RB
            j = torch.arange(NPpad, device=dev)[None]
            slow = ((j < c[:, None]) & ~(pt < cull.BIGT)).any(dim=1)
            ranks = int(torch.where(slow, NPpad ** 2,
                                    c.long() ** 2 + NPpad).sum())
            return _bound(n_rays * 25 + NP * 24 + nc * (NPpad * 8 + 4),
                          int(v.sum()) * NP * SLAB_FLOPS + ranks)

        turns = _in_turns({
            "B13": lambda: cull.cull_sorted(*full),
            "B1 + sort": lambda: page_lists(*cull.cull_mask_exact(*full))})
        b1_ms = _time_ms(lambda: cull.cull_mask_exact(*full))
        bf = bound(R, valid, counts, ptmin)
        entry = dict(
            rays=int(rays.numel()), pages=NP, pages_padded=NPpad,
            max_abs_err=0.0,
            ms=_time_ms(lambda: cull.cull_sorted(*args, chunk_live=live)),
            plain_ms=_time_plain_ms(lambda: cull.cull_sorted_plain(
                *args, chunk_live=live)),
            **bound(rays.numel(), cv, *got[0::2]),
            ms_full=min(turns["B13"]), bound_ms_full=bf["bound_ms"],
            bound_by_full=bf["bound_by"], turns_full=turns,
            b1_alone_ms_full=b1_ms)
        print(f"B13 {label} ({NP} pages, NPpad {NPpad}): {rays.numel() // RB}"
              f" check chunks bitwise equal (dead chunks included), the "
              f"whole wave ({NC} chunks, {int(counts.sum())} chunk-page "
              f"hits) equal to B1 + stable sort; time on the whole wave in "
              f"turns B13 {turns['B13']} ms, B1 + sort {turns['B1 + sort']} "
              f"ms (B1 alone {b1_ms:.4f} ms), bound {bf['bound_ms']:.4f} ms "
              f"({bf['bound_by']}) [{card}]")
        if res is None:
            res = entry
        else:
            res[label] = entry
    results[native.CULL_SORTED.name] = res


def _b13_branch_case(dev):
    """Four chunks of 1,024 rays against 40 page boxes: chunk 0 random
    rays (some with a zero direction component) and boxes, every hit key
    below BIGT (the kernel's fast path); chunk 1 rays d = (0, 0, 1), half
    from the origin and half from y = 2e9, against far pages 37 (entered
    beyond BIGT by the first half only: key BIGT) and 38 (by all: key
    3.2e38) and page 39, whose x = 0 plane holds their origins (key 0), so
    it takes the all-pairs rank; chunk 2 flagged dead; chunk 3 with no
    valid ray (tests/cull_sorted_cases.py builds the same for the tests).
    No key can be NaN: a hit needs tlo <= thi."""
    rc, nc, n_pages = 1024, 4, 40
    rng = np.random.default_rng(5)
    o = rng.uniform(-1.0, 1.0, (3, nc * rc)).astype(np.float32)
    d = rng.normal(size=(3, nc * rc)).astype(np.float32)
    d[0, :64] = 0.0
    valid = rng.uniform(size=nc * rc) > 0.2
    c = rng.uniform(-24.0, 24.0, (n_pages, 3)).astype(np.float32)
    h = rng.uniform(0.2, 1.0, (n_pages, 3)).astype(np.float32)
    blo, bhi = c - h, c + h
    o[:, rc:2 * rc] = 0.0
    o[1, rc + rc // 2:2 * rc] = 2e9
    d[:, rc:2 * rc] = np.asarray([[0.0], [0.0], [1.0]], np.float32)
    valid[rc:2 * rc] = True
    blo[37], bhi[37] = (3.2e8, -1e9, -1.0), (3.3e8, 1e9, 3.35e38)
    blo[38], bhi[38] = (3.2e8, -1e10, -1.0), (3.3e8, 1e10, 3.35e38)
    blo[39], bhi[39] = (0.0, -1.0, -1.0), (1.0, 1.0, 6.0)
    valid[3 * rc:] = False
    live = np.asarray([1, 1, 0, 1], np.int32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (o, d, valid, blo, bhi, live)), rc


def cull_sorted_branches(dev, results):
    """B13's fast path and its all-pairs branch, each bitwise against the
    plain version on `_b13_branch_case`; the case holds what each branch
    is for: chunk 0's plain page order is the fast rank's, chunk 1's is
    not (a hit key equal to BIGT ties its page with the missed ones, and
    one beyond BIGT sorts after them)."""
    (o, d, valid, blo, bhi, live), rc = _b13_branch_case(dev)
    args = (o, d, valid, blo, bhi, rc)
    got = cull.cull_sorted(*args, chunk_live=live)
    want = cull.cull_sorted_plain(*args, chunk_live=live)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("B13 branch case: counts or plist differ")
    _require_bitwise("B13 branch case ptmin", got[2], want[2])
    mask = cull.cull_mask_exact_plain(*args)[0]
    NPpad = want[1].shape[1]
    hit_keys = {}
    for c, fast_expected in ((0, True), (1, False)):
        key = torch.empty(NPpad, device=dev)
        key[want[1][c].long()] = want[2][c]
        m = torch.zeros(NPpad, dtype=torch.bool, device=dev)
        m[:blo.shape[0]] = mask[c]
        pages = torch.arange(NPpad, device=dev)
        order = sorted(pages[m].tolist(), key=lambda p: (float(key[p]), p))
        fast = torch.tensor(order + pages[~m].tolist(), device=dev)
        hit_keys[c] = key[m].tolist()
        if fast_expected != all(k < cull.BIGT for k in hit_keys[c]) or (
                fast_expected != torch.equal(fast, want[1][c].long())):
            raise AssertionError(f"B13 branch case: chunk {c} does not "
                                 f"take the path it is built for")
    results[native.CULL_SORTED.name]["branches"] = dict(
        chunks=4, max_abs_err=0.0, all_pairs_hit_keys=hit_keys[1])
    print(f"B13 branch case: the fast-path chunk ({len(hit_keys[0])} hit "
          f"pages) and the all-pairs chunk (hit keys {hit_keys[1]}), a dead "
          f"chunk and one with no valid ray: bitwise equal")


def bucket_kernels(full1, card, results):
    """Phase 3 for B14a/B14b (the bucketed compaction and its inverse),
    which no render path launches: circles_2k's state after wave 0 (the
    state B3 compacts at the first boundary) with codes 1 for retired lanes
    and 2 + the direction's octant for live ones.  If the eight buckets
    overflow R, one kernel-vs-plain run shows the kernel stays in bounds
    and equals the plain version; the timed state takes two buckets (the
    sign of d.x).  Gates: both kernels bitwise against their plain
    versions, and the round trip gives back rows 8..15 of every live and
    retired lane and 0 on gaps.  Timed in turns beside B3 and B5 on the
    same state and masks."""
    dev = full1.device
    R = full1.shape[1]
    cb = compact.pick_cb(R)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    alive = full1[7] != 0
    dead = (full1[11] != 0) & ~alive
    d = full1[3:6]
    octant = ((d[0] < 0).int() + 2 * (d[1] < 0).int()
              + 4 * (d[2] < 0).int()).float()

    def with_codes(bucket):
        st = full1.clone()
        st[compact.ROW_CODE] = torch.where(alive, 2.0 + bucket,
                                           torch.where(dead, 1.0, 0.0))
        return st

    def run(st, label):
        code = st[compact.ROW_CODE].contiguous()
        meta, total_a, overflow, dead_end = compact.compact_meta_buckets(
            code, cb, zero, R)
        dead_arr = compact.make_dead_array(R, dev)
        out_k, dead_k = compact.compact_buckets(st, dead_arr.clone(), meta,
                                                cb)
        out_p, dead_p = compact.compact_buckets_plain(st, dead_arr.clone(),
                                                      meta, cb)
        torch.cuda.synchronize()
        _require_bitwise(f"B14a {label} state", out_k, out_p)
        _require_bitwise(f"B14a {label} dead", dead_k, dead_p)
        y = out_k[8:16].contiguous()
        back_k = compact.expand_buckets(y, dead_k, code[None], meta, cb)
        back_p = compact.expand_buckets_plain(y, dead_k, code[None], meta,
                                              cb)
        torch.cuda.synchronize()
        _require_bitwise(f"B14b {label}", back_k, back_p)
        print(f"B14 {label}, cb {cb}: total_a / R = "
              f"{int(total_a) / R:.4f}, overflow {bool(overflow)}; B14a "
              f"(state and dead array) and B14b bitwise equal to their "
              f"plain versions")
        return meta, total_a, overflow, dead_arr, out_k, dead_k, back_k, code

    meta8, total8, over8, *_ = run(with_codes(octant), "8 octant buckets")
    st = with_codes((d[0] < 0).float())
    meta, total_a, overflow, dead_arr, out_k, dead_k, back, code = run(
        st, "2 buckets (sign of d.x)")
    if bool(overflow):
        raise AssertionError("B14: the two-bucket state overflows")
    both = alive | dead
    if not (torch.equal(back[:, both].view(torch.int32),
                        st[8:16, both].view(torch.int32))
            and not back[:, ~both].view(torch.int32).any()):
        raise AssertionError("B14: the round trip lost a lane's payload")
    y = out_k[8:16].contiguous()
    m3_, _, _, _ = compact.compact_meta(st[7], st[11], cb, zero, R)
    masks = torch.stack([st[7], st[11]])
    y3 = compact.compact(st, dead_arr.clone(), m3_, cb)[0][8:12].contiguous()
    scratch = dead_arr.clone()
    fwd = _in_turns({
        "B14a": lambda: compact.compact_buckets(st, scratch, meta, cb),
        "B3": lambda: compact.compact(st, scratch, m3_, cb)})
    inv = _in_turns({
        "B14b": lambda: compact.expand_buckets(y, dead_k, code[None], meta,
                                               cb),
        "B5": lambda: compact.expand(y3, dead_k, masks, m3_, cb)})
    n_a, n_d = int(alive.sum()), int(dead.sum())
    pad_d = int(meta[:, compact.M9_DEAD + 1].sum()) * compact.ALIGN
    b14a = _bound((R + 16 * n_a + 8 * n_d) * 4 + (16 * R + 8 * pad_d) * 4, 0)
    b14b = _bound((R + 8 * n_a + 8 * n_d) * 4 + 8 * R * 4, 0)
    common = dict(rays=R, max_abs_err=0.0, total_a_over_R=int(total_a) / R,
                  octants_total_a_over_R=int(total8) / R,
                  octants_overflow=bool(over8))
    results[native.COMPACT_BUCKETS.name] = dict(
        common, ms=min(fwd["B14a"]),
        plain_ms=_time_plain_ms(lambda: compact.compact_buckets_plain(
            st, scratch, meta, cb)),
        **b14a, turns=fwd)
    results[native.EXPAND_BUCKETS.name] = dict(
        common, ms=min(inv["B14b"]),
        plain_ms=_time_plain_ms(lambda: compact.expand_buckets_plain(
            y, dead_k, code[None], meta, cb)),
        **b14b, turns=inv)
    print(f"B14 round trip at {R} rays: rows 8..15 of {n_a} live and {n_d} "
          f"retired lanes back, gaps 0; in turns B14a {fwd['B14a']} ms vs "
          f"B3 {fwd['B3']} ms, B14b {inv['B14b']} ms vs B5 {inv['B5']} ms; "
          f"bounds B14a {b14a['bound_ms']:.4f} ms, B14b "
          f"{b14b['bound_ms']:.4f} ms (bytes) [{card}]")


def untile_kernel(dev, card, results, build_log) -> None:
    """The un-tiling (csrc/untile.cu), which replaces no TPU kernel, on the
    image the unlit 2560x1440 spp 4 render dispatches: a random tile-order
    u8 [3, 3,686,400] (tile 32).  Gates: one launch, the [1440, 2560, 3]
    image byte for byte the plain version's and the one PyTorch call's
    (`permute(...).contiguous()`).  Timed in turns beside that call (CUDA
    events), each one's device time, the plain version once, and the plain
    version on a host tensor (the per-rank path un-tiles there); the bound
    is bytes: the image read once and written once."""
    W, H = 2560, 1440
    T = eng_mod.pick_tile(W, H)
    gen = torch.Generator(device="cpu").manual_seed(20)
    src = torch.randint(0, 256, (3, H * W), generator=gen,
                        dtype=torch.uint8).to(dev)

    def kernel():
        return untile.untile_u8(src, H, W, T)

    def library():
        return src.view(3, H // T, W // T, T, T).permute(
            1, 3, 2, 4, 0).contiguous()

    n0 = native.UNTILE.launches
    got = kernel()
    torch.cuda.synchronize()
    launched = native.UNTILE.launches - n0
    if launched != 1 or not torch.equal(
            got, untile.untile_u8_plain(src, H, W, T)) \
            or not torch.equal(got, library().view(H, W, 3)):
        raise AssertionError(f"untile_u8 at {W}x{H} ({launched} launches) "
                             f"differs from its plain version or the "
                             f"permuted copy")
    turns = _in_turns({"kernel": kernel, "library": library}, reps=20)
    host = src.cpu()
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        untile.untile_u8_plain(host, H, W, T)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    bound = _bound(2 * src.numel(), 0)
    results[native.UNTILE.name] = dict(
        rays=4 * H * W, max_abs_err=0.0, ms=min(turns["kernel"]),
        device_ms=_device_ms(kernel),
        plain_ms=_time_plain_ms(lambda: untile.untile_u8_plain(src, H, W,
                                                                T)),
        library_ms=min(turns["library"]),
        library_device_ms=_device_ms(library), host_plain_ms=min(host_ms),
        **bound, turns=turns,
        ptxas=_print_ptxas(build_log, "untile", ("untile_kernel",)))
    r = results[native.UNTILE.name]
    print(f"untile_u8 at {W}x{H} (tile {T}, {src.numel()} bytes in and "
          f"out): byte-equal to its plain version and the permuted copy; "
          f"in turns kernel {turns['kernel']} ms vs permute().contiguous() "
          f"{turns['library']} ms; device time kernel {r['device_ms']:.4f} "
          f"ms, library {r['library_device_ms']:.4f} ms; plain "
          f"{r['plain_ms']:.4f} ms; plain on the host {min(host_ms):.3f} ms "
          f"(best of {[round(t, 3) for t in host_ms]}); bound "
          f"{bound['bound_ms']:.4f} ms (bytes) [{card}]")


def camera_kernel(dev, card, results, build_log) -> None:
    """The camera (csrc/camera.cu), which replaces no TPU kernel (the JAX
    package computes it in XLA, rust_raytrace_tpu/engine.py:159-198), on
    the ray set of a 2560x1440 spp 4 render (circles_2k's camera, padded as
    the default Engine pads) under a live key, with the pinhole.  Gates:
    one launch, o, d and the live mask bit for bit its plain version's.
    Timed by CUDA events and its device time, the plain version once; the
    bound is its bytes: o, d and the live byte written, 25 B a lane, and
    nothing read but the rsqrt table."""
    _, vp = circles.build(resolution=(2560, 1440), samples=4)
    eng = Engine(circles.build(resolution=(64, 36))[0], device=dev)
    tile = eng_mod.pick_tile(vp.width, vp.height)
    R0 = vp.width * vp.height * 4
    R = -(-R0 // eng._quantum(4)) * eng._quantum(4)
    key = prng_key(2 ** 31 + 5)

    def kernel():
        return camera.camera_rays_tiled(vp, tile, R, dev, key, pinhole=True)

    def plain():
        return camera.camera_rays_tiled_plain(vp, tile, R, dev, key,
                                              pinhole=True)

    n0 = native.CAMERA.launches
    got = kernel()
    torch.cuda.synchronize()
    launched = native.CAMERA.launches - n0
    want = plain()
    same = all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
               for g, w in zip(got, want))
    if launched != 1 or not same:
        raise AssertionError(f"camera at {vp.width}x{vp.height} spp 4 "
                             f"({launched} launches) differs from its plain "
                             f"version")
    del got, want
    bound = _bound(25 * R, 0)
    results[native.CAMERA.name] = dict(
        rays=R, max_abs_err=0.0, ms=_time_ms(kernel, reps=20),
        device_ms=_device_ms(kernel), plain_ms=_time_plain_ms(plain),
        **bound,
        ptxas=_print_ptxas(build_log, "camera", ("camera_kernel",)))
    r = results[native.CAMERA.name]
    print(f"camera at {vp.width}x{vp.height} spp 4 ({R} lanes, "
          f"{launched} launch): bit for bit its plain version's; kernel "
          f"{r['ms']:.4f} ms by events, device time {r['device_ms']:.4f} "
          f"ms; plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
          f"(bytes, 25 a lane): {100 * r['bound_ms'] / r['device_ms']:.1f}% "
          f"of the device time [{card}]")


def ray_chunk_kernels(eng, full0, pk0, s_eng, card, key, results):
    """Phase 3 for ray_chunk 2048 and 4096 (B1, B2 and B6 blocks of 512 or
    1024 threads, each owning 2 or 4 rays of the chunk; B12a's 1024
    threads): B1, B2, B6 (camera rays, and shadow rays with
    self-exclusion) on 16 chunks of circles_2k's camera rays that hit a
    page and on the whole wave (union_wave), and B12a on 16 chunks of
    synthetic_1m_2k's that enter a bank (every fourth then flagged dead),
    against their plain versions (B1 with torch.equal as at 1024, the
    others bitwise); then B1, B2 and B12a timed on the whole wave at each
    ray_chunk beside 1024."""
    dev = full0.device
    R = full0.shape[1]
    P = eng.page_size
    svp = synthetic_view((2560, 1440))
    so_, sd_, sa = eng_mod.camera_rays_tiled(
        svp, eng_mod.pick_tile(svp.width, svp.height), R, dev)
    sa = sa.float()[None]
    s_full = torch.cat([so_, sd_, sa, sa, torch.zeros((8, R), device=dev)])
    stabs = s_eng.stables
    NB = stabs[0].shape[0]
    times = {}

    def spread_over(demand, rc):
        # 16 chunks spread over those with some demand: an even spread over
        # all chunks lands on one tile column of the image
        hit = torch.nonzero(demand)[:, 0]
        pick = torch.linspace(0, hit.numel() - 1, 16,
                              device=dev).round().long()
        return (hit[pick][:, None] * rc
                + torch.arange(rc, device=dev)).reshape(-1)

    for rc in (1024, 2048, 4096):
        if rc != 1024:
            union_wave(eng, full0, pk0, key, rc)
            m_all, _ = cull.cull_mask_exact(full0[0:3], full0[3:6],
                                            full0[7] != 0, eng.aabb_lo,
                                            eng.aabb_hi, rc)
            rays = spread_over(m_all.any(dim=1), rc)
            st = full0[:, rays].contiguous()
            a1 = (st[0:3], st[3:6], st[7] != 0, eng.aabb_lo, eng.aabb_hi, rc)
            mask, tmin = cull.cull_mask_exact(*a1)
            mask_p, tmin_p = cull.cull_mask_exact_plain(*a1)
            torch.cuda.synchronize()
            if not (torch.equal(mask, mask_p) and torch.equal(tmin, tmin_p)):
                raise AssertionError(f"B1 at ray_chunk {rc}: kernel and "
                                     f"plain differ")
            lists = page_lists(mask, tmin)
            a2 = (st, pk0, *lists, fold_in(key, 0), P, rc, False, 1 / 512)
            _require_bitwise(
                f"B2 at ray_chunk {rc}",
                intersect.trace_shade_chunks(*a2, zero_origin=True),
                intersect.trace_shade_chunks_plain(*a2, zero_origin=True))
            rows = intersect.trace_chunks(st[0:3], st[3:6], pk0, *lists, P,
                                          rc, zero_origin=True)
            _require_bitwise(f"B6 camera rays at ray_chunk {rc}", rows,
                             intersect.trace_chunks_plain(
                                 st[0:3], st[3:6], pk0, *lists, rc, True))
            so, sd, hit, excl = eng_mod.shadow_rays(st, rows, key, 0, False,
                                                    LIGHT)
            sl = page_lists(*cull.cull_mask_exact(so, sd, hit, eng.aabb_lo,
                                                  eng.aabb_hi, rc))
            _require_bitwise(
                f"B6 shadow rays at ray_chunk {rc}",
                intersect.trace_chunks(so, sd, eng.PK, *sl, P, rc, excl=excl),
                intersect.trace_chunks_plain(so, sd, eng.PK, *sl, rc,
                                             excl=excl))
            _, gm_all = intersect_streamed.bankmajor_prep(s_full, stabs[3],
                                                          NB, rc)
            srays = spread_over((gm_all != 0).any(dim=0), rc)
            sst = s_full[:, srays].contiguous()
            live = torch.ones(16, dtype=torch.int32, device=dev)
            live[1::4] = 0
            win, gm = intersect_streamed.bankmajor_prep(sst, stabs[3], NB,
                                                        rc, live)
            win_p, gm_p = intersect_streamed.bankmajor_prep_plain(
                sst, stabs[3], NB, rc, live)
            torch.cuda.synchronize()
            _require_bitwise(f"B12a winners at ray_chunk {rc}", win, win_p)
            if not torch.equal(gm, gm_p) or not bool((gm != 0).any()):
                raise AssertionError(f"B12a demand at ray_chunk {rc}: "
                                     f"differs or empty")
            print(f"ray_chunk {rc} on 16 chunks: B1 equal, B2, B6 (camera "
                  f"rays; {int(hit.sum())} shadow rays with "
                  f"self-exclusion) and B12a (winner init; "
                  f"{int((gm != 0).sum())} bank-chunk demands, group bits "
                  f"up to {rc // 128 - 1}) bitwise equal to their plain "
                  f"versions")
        fa = (full0[0:3], full0[3:6], full0[7] != 0, eng.aabb_lo,
              eng.aabb_hi, rc)
        flists = page_lists(*cull.cull_mask_exact(*fa))
        flive = torch.ones(R // rc, dtype=torch.int32, device=dev)
        times[rc] = dict(
            b1_ms_full=_time_ms(lambda: cull.cull_mask_exact(*fa)),
            b2_ms_full=_time_ms(lambda: intersect.trace_shade_chunks(
                full0, pk0, *flists, fold_in(key, 0), P, rc, False, 1 / 512,
                zero_origin=True)),
            b12a_ms_full=_time_ms(lambda: intersect_streamed.bankmajor_prep(
                s_full, stabs[3], NB, rc, flive)))
        print(f"time at ray_chunk {rc} (whole 2560x1440 waves): B1 "
              f"{times[rc]['b1_ms_full']:.4f} ms, B2 "
              f"{times[rc]['b2_ms_full']:.4f} ms (circles_2k camera rays), "
              f"B12a {times[rc]['b12a_ms_full']:.4f} ms (synthetic_1m_2k "
              f"camera rays, {NB} banks) [{card}]")
    for k, field in ((native.CULL, "b1_ms_full"),
                     (native.TRACE_SHADE_UNION, "b2_ms_full"),
                     (native.BM_PREP, "b12a_ms_full")):
        results[k.name]["ray_chunk_ms_full"] = {
            rc: t[field] for rc, t in times.items()}


#: the command line's slow runs (a Python loop over the pixels, the
#: numpy oracle), each in a process of its own, started before phase 5 and
#: read by cli_phase; {tmp}: their scratch directory
SLOW_CLI = {
    "debug": ["render", "--scene", "circles", "--resolution", "640x360",
              "--debug-csv", "{tmp}/debug.csv", "--out", "{tmp}/debug.png"],
    "diff16": ["diff", "--scene", "circles", "--resolution", "16x16",
               "--maxdepth", "2", "--a", "engine", "--b", "oracle"],
    "diff48": ["diff", "--scene", "circles", "--resolution", "48x27", "--a",
               "engine", "--b", "oracle"],
}
#: the processes this script started, and their scratch directories:
#: stopped and removed when it ends
_CHILDREN: list = []
_SCRATCH: list = []


def run_cli(argv) -> dict:
    """The command line's `main(argv)` in this process: its rc, wall ms,
    printed text, the launch counts of its kernels and (seconds, Mrays/s,
    rays) of each render it ran."""
    from rust_raytrace_tpu_torch import cli

    renders = []
    run_render = cli.run_render

    def spy(*a, **kw):
        r = run_render(*a, **kw)
        renders.append((r.seconds, r.mrays_per_sec, r.rays_traced))
        return r

    buf = io.StringIO()
    torch.cuda.synchronize()
    native.reset_launch_counts()
    cli.run_render = spy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        cli.run_render = run_render
    torch.cuda.synchronize()
    return dict(rc=rc, wall_ms=(time.perf_counter() - t0) * 1e3,
                text=buf.getvalue(), launches=_counts(), renders=renders)


def start_slow_cli() -> dict:
    """SLOW_CLI's runs, each started in a process of its own (`--cli`),
    its output and errors written to files of a new scratch directory:
    name -> (argv, process, path of the output; the errors' is it with
    .err for .out)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    _SCRATCH.append(tmp)
    started = {}
    for name, argv in SLOW_CLI.items():
        argv = [a.format(tmp=tmp) for a in argv]
        out = os.path.join(tmp, f"{name}.out")
        with open(out, "w") as f, open(out[:-4] + ".err", "w") as e:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cli", *argv],
                stdout=f, stderr=e)
        _CHILDREN.append(proc)
        started[name] = (argv, proc, out)
    return started


def cli_phase(dev, card, slow):
    """Phase 6k: the command line on the card, in process (so that launch
    counts show): render circles_2k (byte-equal to the first render of a
    fresh Engine under key 0; B1-B5 launched), with --band-rows 480
    (byte-equal to render_banded), with --backend simple; tune at 640x360
    (it finishes; the runtimes it walked).  From `slow` (start_slow_cli's
    runs, each in its own process, with its own launch counts): render
    with --debug-csv at 640x360; diff engine vs oracle at 16x16 (rc 0, no
    error) and at 48x27 (its report printed).  Returns the launch counts
    of the circles_2k render."""
    from rust_raytrace_tpu_torch import cli

    def report(argv, r, ok):
        for seconds, mrays, rays in r["renders"]:
            print(f"  cli {' '.join(argv)}: render {seconds * 1e3:.3f} ms, "
                  f"{mrays:.3f} Mrays/s ({rays} rays) [{card}]")
        launched = {k: c for k, c in r["launches"].items() if c}
        print(f"cli {' '.join(argv)}: rc {r['rc']}, command wall "
              f"{r['wall_ms']:.1f} ms, launches {launched}")
        if r["rc"] not in ok:
            raise AssertionError(f"cli {argv}: rc {r['rc']}\n{r['text']}")
        return r["text"], r["launches"]

    def run(argv, ok=(0,)):
        return report(argv, run_cli(argv), ok)

    def collect(name, ok=(0,)):
        argv, proc, out = slow[name]
        rc = proc.wait()
        with open(out) as f:
            lines = f.read().splitlines()
        if rc != 0 or not lines:
            with open(out[:-4] + ".err") as f:
                err = f.read().splitlines()
            raise AssertionError(f"cli {argv} in its own process: exit "
                                 f"{rc}\n" + "\n".join(lines[-10:]
                                                        + err[-20:]))
        return report(argv, json.loads(lines[-1]), ok)

    def fresh_png(path, banded=False):
        scene, vp = circles.build(resolution="2k", maxdepth=5)
        e = Engine(scene, device=dev)
        r = (e.render_banded(vp, key=prng_key(0), band_rows=480) if banded
             else e.render(vp, key=prng_key(0)))
        png.write_png(path, r.image)
        return open(path, "rb").read()

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.png")
        ref = os.path.join(tmp, "ref.png")
        _, counts = run(["render", "--scene", "circles", "--resolution",
                         "2k", "--out", out, "--stats"])
        cli_counts = counts
        missing = [k for k in UNLIT_PATH if counts[k] == 0]
        if open(out, "rb").read() != fresh_png(ref) or missing:
            raise AssertionError(f"cli render 2k: PNG differs from the "
                                 f"Engine's, or never launched {missing}")
        shape_2k = png.read_png(out).shape
        print(f"cli render circles 2k: PNG {shape_2k} byte-equal to a "
              f"fresh Engine's first render under key 0")
        run(["render", "--scene", "circles", "--resolution", "2k",
             "--band-rows", "480", "--out", out])
        if open(out, "rb").read() != fresh_png(ref, banded=True):
            raise AssertionError("cli --band-rows 480: PNG differs from "
                                 "render_banded's")
        print("cli render --band-rows 480: PNG byte-equal to "
              "render_banded's")
        _, counts = run(["render", "--scene", "circles", "--resolution",
                         "2k", "--backend", "simple", "--out", out])
        if counts["nearest_hit"] == 0 or png.read_png(
                out).shape != shape_2k:
            raise AssertionError("cli --backend simple: B11 never "
                                 "launched, or a bad image")
    _, counts = collect("debug")
    argv = slow["debug"][0]
    with open(argv[argv.index("--debug-csv") + 1]) as f:
        n_lines = sum(1 for _ in f)
    missing = [k for k in DEBUG_PATH if counts[k] == 0]
    if n_lines != 1 + 640 * 360 or missing:
        raise AssertionError(f"cli --debug-csv: {n_lines} lines, never "
                             f"launched {missing}")
    print(f"cli --debug-csv 640x360: {n_lines} lines")
    # the ray differ: at 16x16 (maxdepth 2) the JAX CLI finds no error and
    # so must the port; at 48x27 the centre row's rays run exactly through
    # shared triangle edges, where the engine's and the numpy oracle's
    # winners may differ (the JAX CLI reports 7 such rays on an x86 CPU),
    # so that report is printed, not gated
    text, _ = collect("diff16")
    print("  " + "\n  ".join(text.strip().splitlines()[-2:]))
    if "Found 0 errors" not in text:
        raise AssertionError(f"cli diff engine oracle:\n{text}")
    text, _ = collect("diff48", ok=(0, 1))
    print("  " + "\n  ".join(text.strip().splitlines()[1:]))
    if "Found " not in text:
        raise AssertionError(f"cli diff 48x27 reported nothing:\n{text}")
    text, _ = run(["tune", "--scene", "circles", "--resolution", "640x360"])
    walked = [line for line in text.splitlines()
              if line.startswith(("Running", "Runtime", "Found"))]
    print("  " + "\n  ".join(walked))
    chunks = sorted({int(line.rsplit("=", 1)[1]) for line in walked
                     if line.startswith("Running")})
    print(f"cli tune walked ray_chunk {chunks} of the grid "
          f"{list(cli.CHUNK_OPTS)} [{card}]")
    if not any(line.startswith("Found minimum") for line in walked):
        raise AssertionError("cli tune did not finish")
    if max(cli.CHUNK_OPTS) not in chunks:
        # the hill climb stopped short of the grid's top: walk the top two
        # values of the same grid, so that tune runs at 4096 too
        grid = cli.CHUNK_OPTS
        cli.CHUNK_OPTS = grid[-2:]
        try:
            text, _ = run(["tune", "--scene", "circles", "--resolution",
                           "640x360"])
        finally:
            cli.CHUNK_OPTS = grid
        print("  " + "\n  ".join(line for line in text.splitlines()
                                 if line.startswith(("Running", "Runtime",
                                                     "Found"))))
        if f"ray_chunk={max(grid)}" not in text:
            raise AssertionError("cli tune never ran the grid's top")
    return cli_counts


#: the kernels' function names in csrc/*.cu
class _Sharded:
    """`render` of an Engine as its render_sharded over SHARDS shards."""

    def __init__(self, eng):
        self.eng = eng

    def render(self, v, **kw):
        return self.eng.render_sharded(v, n_devices=SHARDS, **kw)


def last_paths(dev) -> dict:
    """The Engine's last paths, label -> maker of a renderer of a scene:
    the union bounce waves (a table_slot_cap below the scene's page slots,
    streamed=False: no per-lane tables), bounce_chunk and render_sharded
    over SHARDS shards of the card."""
    def union(sc):
        e = Engine(sc, table_slot_cap=len(sc.tris) - 1, streamed=False,
                   device=dev)
        if e.streamed or e.ptables is not None or e.PK is None:
            raise AssertionError("the union bounce Engine holds per-lane "
                                 "or streamed tables")
        return e

    return {"union bounce waves (streamed=False past a lowered cap)": union,
            f"bounce_chunk {BOUNCE_CHUNK}": lambda sc: Engine(
                sc, bounce_chunk=BOUNCE_CHUNK, device=dev),
            f"sharded render_sharded(n_devices={SHARDS})": lambda sc:
                _Sharded(Engine(sc, device=dev))}


def union_flags(eng, st1, key, results):
    """B1 with chunk_live and B2 with chunk_live and grid_live (the union
    bounce waves) on the check chunks' wave-1 state, bitwise against their
    plain versions: the chunks with no live ray and every eighth chunk
    flagged dead, grid_live 3/4 of the chunks; the chunks B2 passes
    through must keep their state words."""
    dev = st1.device
    n = st1.shape[1] // RB
    alive = st1[7] != 0
    idx = torch.arange(n, device=dev)
    flags = (alive.reshape(n, RB).any(dim=1) & (idx % 8 != 3)).to(torch.int32)
    gl = torch.tensor(3 * n // 4, dtype=torch.int32, device=dev)
    a1 = (st1[0:3], st1[3:6], alive, eng.aabb_lo, eng.aabb_hi, RB)
    mk, tk = cull.cull_mask_exact(*a1, chunk_live=flags)
    mp, tp = cull.cull_mask_exact_plain(*a1, chunk_live=flags)
    torch.cuda.synchronize()
    if not (torch.equal(mk, mp) and torch.equal(tk, tp)):
        raise AssertionError("B1 with chunk_live: kernel and plain differ")
    if mk[flags == 0].any():
        raise AssertionError("B1 with chunk_live: a dead chunk hit a page")
    lists = page_lists(mk, tk)
    a2 = (st1, eng.PK, *lists, fold_in(key, 1), eng.page_size, RB, False,
          1 / 512)
    kw = dict(chunk_live=flags, grid_live=gl)
    out_k = intersect.trace_shade_chunks(*a2, **kw)
    _require_bitwise("B2 with chunk_live and grid_live", out_k,
                     intersect.trace_shade_chunks_plain(*a2, **kw))
    passed = ((flags == 0) | (idx >= gl)).repeat_interleave(RB)
    if not torch.equal(out_k[:, passed].view(torch.int32),
                       st1[:, passed].view(torch.int32)):
        raise AssertionError("B2 with flags: a passed-through chunk changed")
    results[native.CULL.name]["chunk_live"] = dict(
        ms=_time_ms(lambda: cull.cull_mask_exact(*a1, chunk_live=flags)),
        dead_chunks=int((flags == 0).sum()))
    results[native.TRACE_SHADE_UNION.name]["chunk_live_grid_live"] = dict(
        ms=_time_ms(lambda: intersect.trace_shade_chunks(*a2, **kw)),
        dead_chunks=int((flags == 0).sum()), grid_live=int(gl))
    print(f"B1 with chunk_live and B2 with chunk_live and grid_live on "
          f"{n} chunks of the wave-1 state ({int((flags == 0).sum())} "
          f"flagged dead, grid_live {int(gl)}): bitwise equal to the plain "
          f"versions; {int(passed.sum())} lanes passed through word for "
          f"word")


PORT_KERNELS = ("cull_kernel", "trace_union_kernel", "compact_kernel",
                "trace_shade_perlane_kernel", "expand_kernel",
                "shade_kernel", "trace_streamed_kernel", "stream_list_kernel",
                "stream_trace_kernel", "live_list_kernel",
                "nearest_hit_kernel", "trace_perlane_kernel", "bm_prep_kernel",
                "bm_sweep_kernel", "bm_finish_kernel", "cull_sorted_kernel",
                "compact_buckets_kernel", "expand_buckets_kernel")


def _groups(per_name) -> dict:
    """Device ms of a profiled render by kind: the port's kernels, torch's
    int64 and float64 elementwise kernels (the threefry draw and the
    emulated fma), copies, the rest."""
    out = {"port kernels": 0.0, "torch int64 ops": 0.0,
           "torch float64 ops": 0.0, "copies": 0.0, "other": 0.0}
    for name, ms in per_name.items():
        if any(f"::{k}{c}" in name for k in PORT_KERNELS for c in "(<"):
            out["port kernels"] += ms
        elif "Memcpy" in name or "Memset" in name:
            out["copies"] += ms
        elif "<long" in name:
            out["torch int64 ops"] += ms
        elif "double" in name:
            out["torch float64 ops"] += ms
        else:
            out["other"] += ms
    return out


#: the fp32 probe's sweep: chains a thread and blocks an SM, 256 threads a
#: block; the kept shape is roofline.NCHAINS and roofline.BLOCKS_PER_SM
PROBE_CHAINS = roofline.CHAINS
PROBE_BLOCKS_PER_SM = (1, 2, 4, 8)
#: a reading outside [0.5, 1.05] x the published peak fails: above, the
#: count is wrong (folded chains); below, the probe is latency-bound
PEAK_GATE = (0.5, 1.05)
#: B11 against the numpy oracle: circles' camera rays at this resolution
#: and page size (tests/test_intersect.py's tolerances)
ORACLE_RES = (320, 180)
ORACLE_PAGE = 64
SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"


@contextlib.contextmanager
def _smi_samples(out: list):
    """nvidia-smi's SMI_QUERY every 100 ms while the block runs, its lines
    appended to `out`; the sampler is stopped when the block ends."""
    proc = subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        yield
    finally:
        proc.terminate()
        text, _ = proc.communicate()
        out.extend(line.strip() for line in text.splitlines()
                   if line.strip())


def _gate_peak(label: str, rate: float, peak: float) -> float:
    share = rate / peak
    if not PEAK_GATE[0] <= share <= PEAK_GATE[1]:
        raise AssertionError(f"{label}: {rate:.6e} is {share:.4f} of the "
                             f"published {peak:.6e}, outside {PEAK_GATE}")
    return share


def roofline_phase(dev, card) -> dict:
    """The card's measured fp32 FMA rate (rt_fma_peak: a sweep over the
    chains a thread and the blocks an SM, then the kept shape) and stream
    bandwidth, each within PEAK_GATE of the published peak, with the
    clocks and power sampled beside the window."""
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = {}
    for nch in PROBE_CHAINS:
        for bps in PROBE_BLOCKS_PER_SM:
            sweep[nch, bps] = roofline.measure_fp32_peak(
                nchains=nch, blocks_per_sm=bps, device=dev)
    best = max(sweep.values())
    print(f"roofline: fp32 FMA probe sweep, TFLOP/s by chains a thread "
          f"(rows) and blocks of {roofline.THREADS} threads an SM "
          f"(columns {PROBE_BLOCKS_PER_SM}), {sm} SMs [{card}]")
    for nch in PROBE_CHAINS:
        print(f"  chains {nch:2d}: " + "  ".join(
            f"{sweep[nch, b] / 1e12:8.3f}" for b in PROBE_BLOCKS_PER_SM))
    knee = min((k for k, r in sweep.items() if r >= 0.97 * best),
               key=lambda k: (k[0] * k[1], k))
    print(f"roofline: the knee (fewest chains x blocks within 3% of the "
          f"sweep's best {best / 1e12:.3f} TFLOP/s): chains {knee[0]}, "
          f"{knee[1]} blocks an SM; kept shape chains {roofline.NCHAINS}, "
          f"{roofline.BLOCKS_PER_SM} blocks an SM")
    smi = []
    n0 = native.FMA_PEAK.launches
    with _smi_samples(smi):
        time.sleep(0.3)
        # ~1.6 s of probe launches, so the sampler sees the load's clock
        fp32 = roofline.measure_fp32_peak(nruns=400, device=dev)
        fp32_launches = native.FMA_PEAK.launches - n0
        hbm = roofline.measure_hbm_bw(nruns=20, device=dev)
    fp32_share = _gate_peak("fp32 FMA rate", fp32,
                            roofline.PUBLISHED_FP32_FLOP_PER_S)
    hbm_share = _gate_peak("stream bandwidth", hbm,
                           roofline.PUBLISHED_HBM_BYTES_PER_S)
    print(f"roofline: fp32 FMA rate {fp32 / 1e12:.3f} TFLOP/s "
          f"({fp32_share:.4f} of the published 67 TFLOP/s; chains "
          f"{roofline.NCHAINS}, {roofline.BLOCKS_PER_SM} blocks of "
          f"{roofline.THREADS} threads an SM, {fp32_launches} launches); "
          f"stream bandwidth {hbm / 1e12:.4f} TB/s ({hbm_share:.4f} of the "
          f"published 3.35 TB/s; x.add_(y) over 2 x 256 MB) [{card}]")
    print(f"roofline: nvidia-smi {SMI_QUERY} beside the window "
          f"({len(smi)} samples): {smi[0] if smi else 'none'} .. "
          f"{smi[-1] if smi else 'none'}")
    for line in smi[::max(1, len(smi) // 8)]:
        print(f"  smi: {line}")
    out = {"name": native.FMA_PEAK.name, "route": "cuda",
           "source": native.FMA_PEAK.source,
           "replaces": native.FMA_PEAK.replaces,
           "fp32_flop_per_s": fp32, "fp32_share_of_published": fp32_share,
           "nchains": roofline.NCHAINS,
           "blocks_per_sm": roofline.BLOCKS_PER_SM,
           "threads": roofline.THREADS, "knee": list(knee),
           "sweep_tflop_per_s": {f"{c}x{b}": r / 1e12
                                 for (c, b), r in sweep.items()},
           "hbm_bytes_per_s": hbm, "hbm_share_of_published": hbm_share,
           "smi": smi, "card": card}
    print(json.dumps({"roofline": out}))
    return out


def _count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): returns (its
    value, the synchronizing calls it made, their distinct sites)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            value = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return value, len(syncs), sorted(set(syncs))


def device_metric_phase(card, cases) -> dict:
    """devbench.device_metric on each (label, engine, viewport, the
    phase-6 best render) of `cases`, beside that render's Mrays/s; then one
    ND loop of the first case's Engine under sync-debug mode, which must
    launch its path's kernels."""
    out = {}
    for label, e, v, render in cases:
        runs = []
        mr, sec, rays = devbench.device_metric(e, v, runs_out=runs)
        R0 = v.width * v.height
        if not (mr > 0 and sec > 0 and rays >= R0 and len(runs) == 2):
            raise AssertionError(f"device metric {label}: {mr} Mrays/s, "
                                 f"{sec} s, {rays} rays, runs {runs}")
        host = 1 - sec / render.seconds
        print(f"device metric {label}: {mr:.3f} Mrays/s, {sec * 1e3:.3f} ms "
              f"a render, {rays} rays a render (ND 8, best of "
              f"{[(round(m, 3), round(s * 1e3, 3)) for m, s in runs]} as "
              f"(Mrays/s, ms)); the render (phase 6): "
              f"{render.mrays_per_sec:.3f} Mrays/s, {render.seconds * 1e3:.3f}"
              f" ms; device-only / render Mrays/s "
              f"{mr / render.mrays_per_sec:.4f}, the host's share of a "
              f"render {host:.4f} [{card}]")
        out[label] = {"mrays_per_sec": mr, "seconds": sec, "rays": rays,
                      "runs": runs, "render_mrays_per_sec":
                      render.mrays_per_sec, "render_seconds": render.seconds}
    label, e, v, _ = cases[0]
    rays = devbench.primary_rays(e, v)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    total, n_sync, msgs = _count_syncs(
        lambda: devbench.device_loop(e, v, 8, prng_key(200), rays=rays))
    torch.cuda.synchronize()
    missing = [k for k in UNLIT_PATH if _counts()[k] == 0]
    if missing:
        raise AssertionError(f"device_loop {label}: never launched "
                             f"{missing}")
    print(f"device_loop {label} under sync-debug mode: {n_sync} "
          f"synchronizing calls in 8 renders ({int(total)} rays); launches "
          f"{_counts()}")
    for m in msgs[:8]:
        print(f"  synchronizing call at {m}")
    out["sync_calls"] = n_sync
    return out


ENGINE_SPANS = ("engine.prep", "engine.dispatch", "engine.unpermute",
                "engine.readback")
#: the most of a render's CUDA-event time its four spans may leave
#: uncovered: the largest gap read on the H100 was 0.714 ms (126.606 against
#: 125.892 ms, PERF.md §6's tracing entry), with 12% room above it
SPAN_GAP_MS = 0.8


def profiling_phase(dev, card, eng, vp) -> None:
    """One default circles_2k render inside `trace` and an `annotate`
    span: the exported trace holds the render's four engine.* spans once
    each, inside that span, in order and on its thread; B4's kernels, each
    launched inside `engine.dispatch` (the runtime call of the kernel's
    correlation id), the un-tiling's one kernel inside `engine.unpermute`,
    one launch call inside `engine.prep`, the camera's (its launch count
    rises by one, and where the trace holds that call's kernel it is the
    camera kernel), with no synchronizing call there; and the spans' sum
    within SPAN_GAP_MS of the
    render's CUDA-event time (outside the spans the render takes its key
    and makes its result, and the profiler enters the first span: a fixed
    0.4-0.7 ms on the H100, whatever the render's length: of a 99 ms
    circles_2k render before the card un-tiled the image, of a 25 ms one
    after)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    logdir = Path(__file__).resolve().parent / "build" / "profile"
    torch.cuda.synchronize()
    n_cam = native.CAMERA.launches
    with trace(str(logdir)) as prof:
        with annotate("render"):
            start.record()
            eng.render(vp)
            end.record()
    event_ms = start.elapsed_time(end)
    n_cam = native.CAMERA.launches - n_cam
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]

    def host(e, names):
        return (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") in names)

    outer = [e for e in events if host(e, ("render",))]
    spans = sorted((e for e in events if host(e, ENGINE_SPANS)),
                   key=lambda e: e["ts"])
    ok = len(outer) == 1
    if ok:
        lo, hi, tid = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"], \
            outer[0]["tid"]
        ok = (tuple(e["name"] for e in spans) == ENGINE_SPANS
              and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                      and e["tid"] == tid for e in spans)
              and all(a["ts"] + a["dur"] <= b["ts"]
                      for a, b in zip(spans, spans[1:])))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    def kernels(name):
        return [e for e in events if e.get("cat") == "kernel"
                and name in e.get("name", "")]

    def launched_in(ks, span):
        found = [e for e in spans if e["name"] == span]
        return [e for e in ks if found and found[0]["ts"]
                <= launch_ts.get(e["args"].get("correlation"), -1)
                <= found[0]["ts"] + found[0]["dur"]]

    b4 = kernels("trace_shade_perlane_kernel")
    in_dispatch = launched_in(b4, "engine.dispatch")
    unt = kernels("untile_kernel")
    in_unpermute = launched_in(unt, "engine.unpermute")
    # the camera: gated on its launch call, which the host records.  In a
    # process that has run for a while the trace can hold no kernel for
    # the window's first launch calls (on the H100 this render lost its
    # first six to nine, the camera's among them, while the calls and the
    # launch counter were there; in a fresh process none; PERF.md §6)
    prep = [e for e in spans if e["name"] == "engine.prep"]
    in_prep = [e for e in events if e.get("cat") == "cuda_runtime" and prep
               and prep[0]["ts"] <= e["ts"] <= prep[0]["ts"] + prep[0]["dur"]]
    prep_launches = [e for e in in_prep if "Launch" in e.get("name", "")]
    prep_syncs = [e for e in in_prep if "Synchronize" in e.get("name", "")]
    kernel_of = {e["args"].get("correlation"): e["name"] for e in events
                 if e.get("cat") == "kernel"}
    prep_kernels = [kernel_of.get(e["args"].get("correlation"))
                    for e in prep_launches]
    cam = [k for k in prep_kernels if k and "camera_kernel" in k]
    unrecorded = sum(e.get("cat") == "cuda_runtime"
                     and "LaunchKernel" in e.get("name", "")
                     and e["args"].get("correlation") not in kernel_of
                     for e in events)
    span_ms = sum(e["dur"] for e in spans) * 1e-3
    n_dev = sum(e.get("cat") == "kernel" for e in events)
    print(f"profiling: trace {prof.trace_path} ({len(events)} events, "
          f"{n_dev} device kernels, {len(b4)} of B4, {len(in_dispatch)} "
          f"launched in engine.dispatch, {len(unt)} un-tiling, "
          f"{len(in_unpermute)} launched in engine.unpermute; "
          f"engine.prep: {len(prep_launches)} launch call, the camera's "
          f"count +{n_cam}, its kernel {'recorded' if cam else 'not recorded'}"
          f", {len(prep_syncs)} synchronizing calls; {unrecorded} kernel "
          f"launch calls of the window with no kernel in the trace); spans "
          + ", ".join(f"{e['name']} {e['dur'] * 1e-3:.3f}" for e in spans)
          + f" ms, sum {span_ms:.3f} ms against CUDA events "
          f"{event_ms:.3f} ms [{card}]")
    if (not ok or not b4 or len(in_dispatch) != len(b4)
            or len(unt) != 1 or len(in_unpermute) != 1
            or len(prep_launches) != 1 or n_cam != 1
            or any(k and "camera_kernel" not in k for k in prep_kernels)
            or prep_syncs
            or event_ms - span_ms > SPAN_GAP_MS):
        raise AssertionError("profiling: the trace lacks the render's four "
                             "engine spans in order, B4 launched in "
                             "engine.dispatch, the one un-tiling kernel "
                             "launched in engine.unpermute or the one "
                             "camera launch in engine.prep, engine.prep "
                             "synchronizes, or the spans leave more than "
                             f"{SPAN_GAP_MS} ms of the CUDA-event time "
                             f"uncovered")


def oracle_phase(dev) -> None:
    """B11 on circles' camera rays at ORACLE_RES, page size ORACLE_PAGE,
    against intersect_ref.nearest_hit_model(tie="lex"): hit/miss sets
    equal, ids on at least 99.9% of rays, t within rtol 1e-5 and atol 1e-6
    where both hit."""
    o_scene, o_vp = circles.build(resolution=ORACLE_RES, maxdepth=5)
    pages = build_pages(o_scene.tris, page_size=ORACLE_PAGE)
    O, D = render_mod.camera_rays(o_vp, prng_key(0), dev)
    O, D = O.contiguous(), D.contiguous()
    n0 = native.NEAREST_HIT.launches
    t, i = intersect.nearest_hit(O, D, torch.from_numpy(pages.PK).to(dev),
                                 ORACLE_PAGE)
    torch.cuda.synchronize()
    launched = native.NEAREST_HIT.launches - n0
    t, i = t.cpu().numpy(), i.cpu().numpy()
    t0 = time.perf_counter()
    t_m, id_m = nearest_hit_model(O.cpu().numpy(), D.cpu().numpy(), pages,
                                  tie="lex")
    model_s = time.perf_counter() - t0
    same_hits = bool(((i == 0) == (id_m == 0)).all())
    id_share = float((i == id_m).mean())
    both = np.isfinite(t_m) & np.isfinite(t)
    rel = (np.abs(t[both] - t_m[both]) / np.maximum(np.abs(t_m[both]), 1e-30))
    close = bool(np.allclose(t[both], t_m[both], rtol=1e-5, atol=1e-6))
    print(f"oracle: B11 ({launched} launch) vs nearest_hit_model(tie='lex') "
          f"on {len(t)} circles camera rays at {ORACLE_RES[0]}x"
          f"{ORACLE_RES[1]}, {pages.num_pages} pages of {ORACLE_PAGE}: "
          f"hit/miss sets equal {same_hits} ({int((i != 0).sum())} hits), "
          f"ids equal on {id_share:.6f}, t max rel diff "
          f"{float(rel.max()) if rel.size else 0.0:.3e} (within rtol 1e-5, "
          f"atol 1e-6: {close}); the model took {model_s:.2f} s")
    if not (launched == 1 and same_hits and id_share >= 0.999 and close
            and (i != 0).any()):
        raise AssertionError("oracle: B11 disagrees with the numpy model")


def parity_phase(dev, golden) -> None:
    """utils/parity on the card's 96x54 circles render against the golden:
    exact parity."""
    g_scene, g_vp = circles.build(resolution=(96, 54), maxdepth=5)
    img = Engine(g_scene, device=dev).render(g_vp, fixed_rng=True).image
    stats = parity.parity_stats(img, golden)
    print(f"parity: circles 96x54 on the card vs the golden: {stats}")
    if not (stats["rmse"] == 0.0 and stats["mae"] == 0.0
            and stats["sky_mean_abs_diff"] == 0.0
            and stats["silhouette_iou"] == 1.0):
        raise AssertionError("parity: the card's image is not the golden's")


#: phase 6n: the render across processes, DIST_RANKS ranks, each with its
#: own Engine of circles_2k; trace_rays_distributed on one slab of camera
#: rays; a spawn's deadline (rendezvous, builds and renders), seconds
DIST_RANKS = 2
DIST_SLAB = 1 << 20
DIST_DEADLINE = 300.0


def distributed_rank(rank: int, out: str, device=None,
                     resolution="2k") -> None:
    """Phase 6n's program of one rank (`distributed.spawn` starts it; the
    new process imports this script as a module): circles at `resolution`
    (maxdepth 5) through `engine_render_distributed`, under live key 0 a
    warm-up and then one render with the launch counts set to 0 just before
    it, then one under fixed_rng; then `trace_rays_distributed(backend=
    "kernel")` on the first DIST_SLAB camera rays, counts set to 0 before
    it.  Rank 0 then renders the references on its own Engine, which has
    the ranks' schedule: render_sharded(n_devices=n) under key 0 (a
    warm-up, then one timed), trace_rays_sharded over make_mesh(n) (the
    shards on the card, or one a card) and render() under fixed_rng; n is
    the world size.  Writes its numbers, counts and verdicts to
    OUT/rank<r>.json.  device: None for `rank_device()`'s card; device
    and resolution are for a rehearsal on the CPU."""
    dev = distributed.rank_device(device)
    n = dist.get_world_size()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    scene, vp = circles.build(resolution=resolution, maxdepth=5)
    eng = Engine(scene, device=dev)
    key = prng_key(0)
    distributed.engine_render_distributed(eng, vp, key=key)
    sync()
    dist.barrier()
    native.reset_launch_counts()
    live = distributed.engine_render_distributed(eng, vp, key=key)
    sync()
    rec = {"backend": str(dist.get_backend()), "device": str(dev),
           "render_launches": _counts(), "ms": live.seconds * 1e3,
           "rays_traced": live.rays_traced,
           "wave_rays": live.wave_rays.tolist()}
    fixed = distributed.engine_render_distributed(eng, vp, key=key,
                                                  fixed_rng=True)
    o, d = render_mod.camera_rays(vp, key, dev)
    o, d = o[:DIST_SLAB], d[:DIST_SLAB]
    st = render_mod.upload_scene(scene, page_size=256, device=dev)
    trace_kw = dict(maxdepth=vp.maxdepth, backend="kernel", ray_chunk=1024)
    distributed.trace_rays_distributed(st, o, d, key, **trace_kw)
    sync()
    dist.barrier()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    colors, waves = distributed.trace_rays_distributed(st, o, d, key,
                                                       **trace_kw)
    sync()
    rec.update(trace_ms=(time.perf_counter() - t0) * 1e3,
               trace_launches=_counts(), trace_rays=int(o.shape[0]),
               trace_waves=waves.cpu().tolist())
    dist.barrier()
    if rank == 0:
        eng.render_sharded(vp, n_devices=n, key=key)
        sync()
        ref = eng.render_sharded(vp, n_devices=n, key=key)
        mesh = make_mesh(n)
        trace_rays_sharded(st, o, d, key, mesh, **trace_kw)
        sync()
        t0 = time.perf_counter()
        ref_c, ref_w = trace_rays_sharded(st, o, d, key, mesh, **trace_kw)
        sync()
        ref_trace_ms = (time.perf_counter() - t0) * 1e3
        full_f = eng.render(vp, fixed_rng=True)
        img = live.image
        rec.update(
            image_ok=bool(img.shape == (vp.height, vp.width, 3)
                          and img.dtype == np.uint8 and img.max() > 0
                          and live.wave_rays[0] == vp.width * vp.height),
            live_equal=bool(np.array_equal(img, ref.image) and np.array_equal(
                live.wave_rays, ref.wave_rays)),
            fixed_equal=bool(np.array_equal(fixed.image, full_f.image)
                             and np.array_equal(fixed.wave_rays,
                                                full_f.wave_rays)),
            trace_equal=bool(torch.equal(colors.view(torch.int32),
                                         ref_c.view(torch.int32))
                             and torch.equal(waves, ref_w)),
            sharded_ms=ref.seconds * 1e3,
            sharded_rays_traced=ref.rays_traced, sharded_trace_ms=ref_trace_ms,
            mesh=[str(m) for m in mesh])
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(rec))


def shared_card_rank(rank: int, out: str) -> None:
    """A rank of an nccl group whose ranks share the one card: its render
    must raise before any collective.  Writes the message (or null)."""
    scene, vp = circles.build(resolution=(64, 36), maxdepth=2)
    eng = Engine(scene, device=distributed.rank_device())
    msg = None
    try:
        distributed.engine_render_distributed(eng, vp)
    except RuntimeError as e:
        msg = str(e)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(msg))


def _spawn_ranks(backend: str, fn=distributed_rank,
                 n: int = DIST_RANKS) -> list:
    """fn's n ranks under `backend`, within DIST_DEADLINE; each rank's
    record.  A rank that fails fails the phase."""
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-ranks-"))
    _SCRATCH.append(out)
    distributed.spawn(fn, n, args=(str(out),), backend=backend,
                      timeout=DIST_DEADLINE)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


def _gate_ranks(label: str, recs: list, card) -> None:
    """Rank 0's images equal the single controller's, the trace's colors
    and counts too; each rank launched the unlit path's kernels (B1, B2
    and the camera once) in its render and B11 alone in its trace, and
    under nccl rank 0 the un-tiling once (on its card, after the gather;
    under gloo the image is un-tiled on the host)."""
    r0 = recs[0]
    print(f"{label}: rank 0 render {r0['ms']:.3f} ms "
          f"({r0['rays_traced'] / r0['ms'] / 1e3:.3f} Mrays/s), other ranks "
          f"{[round(r['ms'], 3) for r in recs[1:]]} ms; "
          f"render_sharded(n_devices={len(recs)}) "
          f"{r0['sharded_ms']:.3f} ms "
          f"({r0['sharded_rays_traced'] / r0['sharded_ms'] / 1e3:.3f} "
          f"Mrays/s); wave_rays {r0['wave_rays']} [{card}]")
    print(f"{label}: trace_rays_distributed(backend='kernel') on "
          f"{r0['trace_rays']} camera rays {r0['trace_ms']:.3f} ms, "
          f"trace_rays_sharded over {r0['mesh']} {r0['sharded_trace_ms']:.3f}"
          f" ms; wave_rays {r0['trace_waves']} [{card}]")
    print(f"{label}: live key 0 image byte-equal to render_sharded: "
          f"{r0['live_equal']}; fixed_rng image byte-equal to render(): "
          f"{r0['fixed_equal']}; trace colors and counts bitwise equal to "
          f"trace_rays_sharded: {r0['trace_equal']}")
    if not (r0["image_ok"] and r0["live_equal"] and r0["fixed_equal"]
            and r0["trace_equal"]):
        raise AssertionError(f"{label}: rank 0's results differ from the "
                             f"single controller's")
    for r, rec in enumerate(recs):
        rl, tl = rec["render_launches"], rec["trace_launches"]
        print(f"{label}: rank {r} on {rec['device']}: render launches {rl}; "
              f"trace launches {tl}")
        untiles = int(r == 0 and rec["backend"] == "nccl")
        bad = ([k for k in UNLIT_PATH if rl[k] == 0]
               + [k for k in ("cull_mask_exact", "trace_shade_chunks",
                              "camera_rays_tiled") if rl[k] != 1]
               + ["untile_u8"] * (rl["untile_u8"] != untiles)
               + [k for k, c in rl.items() if c and k not in UNLIT_PATH
                  + ("untile_u8", "camera_rays_tiled")]
               + [k for k, c in tl.items() if bool(c) != (k == "nearest_hit")])
        if bad:
            raise AssertionError(f"{label}: rank {r}'s launches of {bad} are "
                                 f"not its path's")


def distributed_phase(card) -> dict:
    """Phase 6n: the render across processes.  DIST_RANKS gloo ranks on
    cuda:(rank % cards), so sharing the card where there is one (their
    collectives on the host); where torch sees DIST_RANKS or more cards,
    nccl ranks one a card too, DIST_RANKS of them and then one on every
    card, else DIST_RANKS nccl ranks on the one card must each raise
    before any collective, and one nccl rank alone on it renders (rank 0
    un-tiles on its card).  Returns the gloo ranks' launch counts summed,
    by path ("distributed" the render, "distributed_trace" the trace)."""
    recs = _spawn_ranks("gloo")
    _gate_ranks(f"circles_2k across processes ({DIST_RANKS} gloo ranks, "
                f"{recs[0]['device']})", recs, card)
    cards = torch.cuda.device_count()
    if cards >= DIST_RANKS:
        for n in sorted({DIST_RANKS, cards}):
            _gate_ranks(f"circles_2k across processes ({n} nccl ranks, one "
                        f"a card)", _spawn_ranks("nccl", n=n), card)
    else:
        print(f"across processes under nccl, one rank a card: not run "
              f"(torch sees {cards} card(s))")
        msgs = _spawn_ranks("nccl", shared_card_rank)
        print(f"{DIST_RANKS} nccl ranks on one card: {msgs}")
        if not all(m and "NCCL refuses" in m for m in msgs):
            raise AssertionError("nccl ranks sharing a card did not all "
                                 "raise")
        _gate_ranks("circles_2k across processes (1 nccl rank)",
                    _spawn_ranks("nccl", n=1), card)
    return {p: {k: sum(r[f"{p}_launches"][k] for r in recs)
                for k in recs[0][f"{p}_launches"]}
            for p in ("render", "trace")}


#: phase 6o's self-gating fraction and compaction chunk
GATE_FRAC = 0.7
CB_KNOB = 256
#: the chunks of synthetic_1m_2k's camera wave held against the exact test
N_SPHERE_CHUNKS = 8


def _b4_bound(eng, page_of, state, lit_: bool = False) -> dict:
    """What B4's rays in `state` need at least: bytes, the state in and
    out, the page boxes and the records of every page that holds a found
    triangle; operations as `_perlane_bound` counts a trace (every valid
    ray's slab test of every page, the hit tests of its found triangle's
    page), each valid ray's shade, and, lit, every hit ray's feeler (a slab
    test of every page and one hit test)."""
    NP, P = eng.pages.num_pages, eng.page_size
    valid = state[7] != 0
    ids = intersect_perlane.trace_perlane(state[0:3], state[3:6], state[7],
                                          eng.ptables, P, RB)[1]
    hit = valid & (ids != 0)
    hits = int(hit.sum())
    pages = torch.unique(page_of[ids[hit].long()])
    return _bound(state.shape[1] * 128 + NP * 32 + pages.numel() * P * 96,
                  int(valid.sum()) * (NP * SLAB_FLOPS + SHADE_FLOPS)
                  + hits * P * HIT_FLOPS
                  + (hits * (NP * SLAB_FLOPS + HIT_FLOPS) if lit_ else 0))


def _occupancy(build_log: str, name: str, threads: int) -> dict:
    """The registers ptxas gave kernel `name` (a mangled-name fragment) and
    the blocks of `threads` an H100 SM holds at that count (65,536
    registers an SM, allocated 8 a thread, at most 2,048 threads and 32
    blocks; the kernel takes no shared memory)."""
    lines = build_log.splitlines()
    regs = None
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            for rep in lines[i:i + 4]:
                if "registers" in rep:
                    regs = int(rep.split("Used ")[1].split(" registers")[0])
            break
    if regs is None:
        raise AssertionError(f"ptxas reported no registers for {name}")
    per_block = -(-regs // 8) * 8 * threads
    blocks = min(32, 2048 // threads, 65536 // per_block)
    return {"registers": regs, "blocks_per_sm": blocks,
            "occupancy": blocks * threads / 2048}


@contextlib.contextmanager
def _knobs(eng, **knobs):
    """The Engine's renders with the wave loop's knobs (`_dispatch`)."""
    eng._dispatch = functools.partial(type(eng)._dispatch, eng, **knobs)
    try:
        yield eng
    finally:
        del eng._dispatch


def _metric_turns(card, label, cases: dict, rounds: int = 2) -> dict:
    """devbench.device_metric of each (engine, knobs) of `cases` in turns,
    `rounds` times; prints each case's best and its runs.  Returns {case:
    (Mrays/s, ms a render, rays a render) of the best run}."""
    runs = {k: [] for k in cases}
    for _ in range(rounds):
        for k, (e, v, kw) in cases.items():
            runs[k].append(devbench.device_metric(e, v, **kw))
    best = {k: max(r, key=lambda x: x[0]) for k, r in runs.items()}
    print(f"device metric, {label}, in turns ({rounds} rounds of ND 8, "
          f"best of 2 runs each) [{card}]:")
    for k, (mr, sec, rays) in best.items():
        print(f"  {k}: {mr:.3f} Mrays/s, {sec * 1e3:.3f} ms a render, "
              f"{rays} rays a render; each round "
              f"{[round(r[1] * 1e3, 3) for r in runs[k]]} ms")
    return {k: {"mrays_per_sec": b[0], "ms": b[1] * 1e3, "rays": b[2],
                "rounds_ms": [r[1] * 1e3 for r in runs[k]]}
            for k, b in best.items()}


def _fixed_equal(label, got, want) -> None:
    n_px = int((got.image != want.image).any(axis=-1).sum())
    print(f"{label} fixed_rng vs the default path: {n_px} pixels differ; "
          f"wave_rays {got.wave_rays.tolist()}")
    if n_px or not np.array_equal(got.wave_rays, want.wave_rays):
        raise AssertionError(f"{label}: not byte-equal to the default path "
                             f"under fixed_rng")


def jax_last_paths(dev, card, key, eng, eng_l, eng_s, vp, s_vp, st0, mask0,
                   default_best, results, build_log) -> dict:
    """Phase 6o, the JAX package's last paths on the card at 2560x1440:
    the fused lit wave 0 (B4 with its feeler on the camera wave), the
    self-gating compaction (gate_frac), wave0_skippable and cb, and the
    reference helpers (A12) against the kernels.  eng, eng_l: the default
    unlit and lit circles_2k Engines (autotuned); eng_s: synthetic_1m_2k's;
    st0, mask0: phase 3's check chunks of the circles_2k camera wave and
    their B1 mask;
    default_best: phase 6's best default render.  Returns each new path's
    launch counts."""
    launches = {}
    P, NP = eng.page_size, eng.pages.num_pages
    R = st0.shape[1]
    page_of = _page_of(eng, len(eng.scene.tris) - 1, dev)
    n_bound = sum(eng_l._compacts_after(w, vp.maxdepth)
                  for w in range(vp.maxdepth))

    # the fused lit wave 0: B4 with its feeler on the camera wave
    ones = torch.ones(R // RB, dtype=torch.int32, device=dev)
    b4 = results[native.TRACE_SHADE_PERLANE.name]
    cam = {}
    for fixed in (False, True):
        args = (st0, eng.ptables, fold_in(key, 0), P, RB, fixed, 1 / 512,
                ones, LIGHT)
        got = intersect_perlane.trace_shade_perlane(*args)
        _require_bitwise(f"B4 lit on the camera wave (fixed_rng {fixed})",
                         got, intersect_perlane.trace_shade_perlane_plain(
                             *args))
        if not fixed:
            cam.update(
                ms=_time_ms(lambda: intersect_perlane.trace_shade_perlane(
                    *args)),
                plain_ms=_time_plain_ms(
                    lambda: intersect_perlane.trace_shade_perlane_plain(
                        *args)),
                check_bound_ms=_b4_bound(eng, page_of, st0, True)[
                    "bound_ms"])
    full0 = _synthetic_wave0(eng, vp, dev)
    nc = full0.shape[1] // RB
    fargs = (full0, eng.ptables, fold_in(key, 0), P, RB, False, 1 / 512,
             torch.ones(nc, dtype=torch.int32, device=dev), LIGHT)
    cam["ms_full"] = _time_ms(
        lambda: intersect_perlane.trace_shade_perlane(*fargs))
    fb = _b4_bound(eng, page_of, full0, True)
    cam.update(bound_ms_full=fb["bound_ms"], bound_by_full=fb["bound_by"])
    occ = _occupancy(build_log, "trace_shade_perlane_kernelILb1", 128)
    cam.update(launch={"blocks": -(-full0.shape[1] // 128), "threads": 128,
                       **occ})
    print(f"B4 with the feeler on {N_CHECK_CHUNKS} chunks of the circles_2k "
          f"camera wave: bitwise equal (live and fixed RNG); kernel "
          f"{cam['ms']:.4f} ms, plain {cam['plain_ms']:.4f} ms, bound "
          f"{cam['check_bound_ms']:.4f} ms [{card}]")
    print(f"time trace_shade_perlane B4 lit, the whole camera wave "
          f"({full0.shape[1]} rays, all live): {cam['ms_full']:.4f} ms, "
          f"bound {cam['bound_ms_full']:.4f} ms ({cam['bound_by_full']}); "
          f"launch {cam['launch']['blocks']} blocks of 128 threads, "
          f"{occ['registers']} registers a thread, {occ['blocks_per_sm']} "
          f"blocks an SM, occupancy {occ['occupancy']:.3f} [{card}]")
    b4["camera_wave"] = cam

    with _knobs(eng_l, wave0_fused_lights=True):
        fused_fixed = eng_l.render(vp, fixed_rng=True)
        torch.cuda.synchronize()
        native.reset_launch_counts()
        fused = eng_l.render(vp)
        torch.cuda.synchronize()
        launches["fused_lit_wave0"] = counts = _counts()
    _fixed_equal("circles_2k lit, fused wave 0,", fused_fixed,
                 eng_l.render(vp, fixed_rng=True))
    print(f"circles_2k lit through _dispatch(wave0_fused_lights=True): "
          f"{fused.seconds * 1e3:.3f} ms, {fused.mrays_per_sec:.3f} Mrays/s, "
          f"wave_rays {fused.wave_rays.tolist()}; launches {counts} [{card}]")
    want = {"trace_shade_perlane": vp.maxdepth, "compact": n_bound,
            "expand": n_bound, "cull_mask_exact": 0, "trace_chunks": 0,
            "shade": 0, "trace_shade_chunks": 0}
    bad = {k: counts[k] for k, n in want.items() if counts[k] != n}
    if bad or int(fused.wave_rays[0]) != vp.width * vp.height:
        raise AssertionError(f"fused lit wave 0: launches {bad}, not "
                             f"{want}")
    b4["camera_wave"]["launches"] = counts["trace_shade_perlane"]
    fused_dm = _metric_turns(card, "circles_2k lit", {
        "unfused wave 0": (eng_l, vp, {}),
        "wave0_fused_lights": (eng_l, vp, {"wave0_fused_lights": True})})

    # gate_frac: every boundary eligible, each gated on the device
    eng_g = Engine(eng.scene, ncompact=-1, gate_frac=GATE_FRAC, device=dev)
    skips = []
    meta_fn = eng_mod.compact_meta

    def recording_meta(*args, **kw):
        out = meta_fn(*args, **kw)
        skips.append(out[2])
        return out

    eng_mod.compact_meta = recording_meta
    try:
        torch.cuda.synchronize()
        native.reset_launch_counts()
        gated = eng_g.render(vp)
        torch.cuda.synchronize()
        launches["gate_frac"] = counts = _counts()
        identity = [bool(s) for s in skips]          # read once, after
        skips.clear()
        _fixed_equal(f"circles_2k Engine(ncompact=-1, gate_frac="
                     f"{GATE_FRAC})", eng_g.render(vp, fixed_rng=True),
                     eng.render(vp, fixed_rng=True))
    finally:
        eng_mod.compact_meta = meta_fn
    print(f"circles_2k Engine(ncompact=-1, gate_frac={GATE_FRAC}): boundaries "
          f"that went identity {identity}; {gated.seconds * 1e3:.3f} ms, "
          f"{gated.mrays_per_sec:.3f} Mrays/s (one render) against the "
          f"default's best {default_best.seconds * 1e3:.3f} ms, "
          f"{default_best.mrays_per_sec:.3f} Mrays/s (schedule "
          f"{eng.ncompact}); launches {counts} [{card}]")
    nb = vp.maxdepth - 1
    if counts["compact"] != nb or counts["expand"] != nb \
            or len(identity) != nb:
        raise AssertionError(f"gate_frac: {counts['compact']} B3 and "
                             f"{counts['expand']} B5 launches, not {nb}")
    gate_dm = _metric_turns(card, "circles_2k unlit, self-gating", {
        "default (planned schedule)": (eng, vp, {}),
        f"ncompact=-1, gate_frac={GATE_FRAC}": (eng_g, vp, {})})

    # wave0_skippable and cb on the default Engine
    base_fixed = eng.render(vp, fixed_rng=True)
    for label, kw in (("wave0_skippable", {"wave0_skippable": True}),
                      (f"cb={CB_KNOB}", {"cb": CB_KNOB})):
        with _knobs(eng, **kw):
            torch.cuda.synchronize()
            native.reset_launch_counts()
            got = eng.render(vp, fixed_rng=True)
            torch.cuda.synchronize()
            launches[label] = counts = _counts()
        _fixed_equal(f"circles_2k {label},", got, base_fixed)
        missing = [k for k in UNLIT_PATH if counts[k] == 0]
        if missing:
            raise AssertionError(f"{label}: never launched {missing}")
    knob_dm = _metric_turns(card, "circles_2k unlit, the wave-0 knobs", {
        "default": (eng, vp, {}),
        "wave0_skippable": (eng, vp, {"wave0_skippable": True}),
        f"cb={CB_KNOB}": (eng, vp, {"cb": CB_KNOB})}, rounds=1)

    # A12: B3/B5 against the numpy oracles at the first boundary (the
    # unlit render's state after wave 0)
    pk0 = eng._pinhole_fold(vp)
    full1 = eng._union_wave(full0, key, 0, fold_in(key, 0), False,
                            eng.weight_cutoff, pk0, None, None, RB,
                            False)[0]
    Rf = full1.shape[1]
    cb = compact.pick_cb(Rf)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    meta, total_a, skip, _ = compact.compact_meta(full1[7], full1[11], cb,
                                                  zero, Rf)
    dead = compact.make_dead_array(Rf, dev, 1, cb)
    st_h = full1.cpu().numpy()
    o_state, o_dead, o_meta, o_total, o_flow, _ = compact.compact_oracle(
        st_h, dead.cpu().numpy(), cb, 0)
    out, dead = compact.compact(full1, dead, meta, cb)
    alive_h, dead_h = st_h[7] != 0, st_h[11] != 0
    y = compact.expand(out[8:12].contiguous(), dead,
                       torch.stack([full1[7], full1[11]]), meta, cb)
    o_y = compact.expand_oracle(o_state[8:16], o_dead, st_h[7], st_h[11],
                                o_meta, cb)
    torch.cuda.synchronize()
    lanes = alive_h | dead_h
    ok = (np.array_equal(meta.cpu().numpy(), o_meta)
          and int(total_a) == o_total and bool(skip) == o_flow
          and np.array_equal(out.cpu().numpy().view(np.uint32),
                             o_state.view(np.uint32))
          and np.array_equal(dead.cpu().numpy().view(np.uint32),
                             o_dead.view(np.uint32))
          and np.array_equal(y.cpu().numpy().view(np.uint32)[:, lanes],
                             o_y[:4].view(np.uint32)[:, lanes]))
    print(f"B3/B5 at the first boundary of circles_2k ({int(alive_h.sum())} "
          f"live, {int(dead_h.sum())} retired of {Rf} lanes, cb {cb}, "
          f"total_a {int(total_a)}): equal to compact_oracle/expand_oracle "
          f"{ok}")
    if not ok:
        raise AssertionError("B3/B5 differ from the numpy oracles")

    # A12: every page the exact slab test finds for a ray is in its chunk's
    # B1 mask, on circles_2k's and synthetic_1m_2k's camera waves
    def misses(ot, dt, valid, blo, bhi, mask):
        hits = cull.ray_aabb_hits(ot.T.contiguous(), dt.T.contiguous(),
                                  blo, bhi) & valid[:, None]
        miss = hits.reshape(-1, RB, hits.shape[1]) & ~mask[:, None, :]
        return int(hits.sum()), int(miss.sum())

    n_hit, n_miss = misses(st0[0:3], st0[3:6], st0[7] != 0, eng.aabb_lo,
                           eng.aabb_hi, mask0)
    s0 = _synthetic_wave0(eng_s, s_vp, dev)
    s_lo = torch.from_numpy(eng_s.pages.aabb_lo).to(dev)
    s_hi = torch.from_numpy(eng_s.pages.aabb_hi).to(dev)
    s_valid = s0[7] != 0
    s_mask, _ = cull.cull_mask_exact(s0[0:3], s0[3:6], s_valid, s_lo, s_hi,
                                     RB)
    hit_chunks = torch.nonzero(s_mask.any(dim=1)).squeeze(1)
    pick = hit_chunks[torch.linspace(0, hit_chunks.numel() - 1,
                                     N_SPHERE_CHUNKS,
                                     device=dev).round().long()]
    srays = (pick[:, None] * RB + torch.arange(RB, device=dev)).reshape(-1)
    s_hit, s_miss = misses(s0[0:3, srays], s0[3:6, srays], s_valid[srays],
                           s_lo, s_hi, s_mask[pick])
    print(f"ray_aabb_hits within B1's masks: circles_2k {N_CHECK_CHUNKS} "
          f"chunks, {n_hit} ray-page hits, {n_miss} missing from the mask; "
          f"synthetic_1m_2k {N_SPHERE_CHUNKS} chunks ({s_lo.shape[0]} "
          f"pages), {s_hit} hits, {s_miss} missing")
    if n_miss or s_miss or not (n_hit and s_hit):
        raise AssertionError("B1 dropped a page that a ray hits")
    results[native.CULL.name]["exact_hits"] = {
        "circles_2k": [n_hit, n_miss], "synthetic_1m_2k": [s_hit, s_miss]}
    return {"launches": launches, "fused": fused_dm, "gate": gate_dm,
            "knobs": knob_dm, "identity": identity}


def distributed_only() -> int:
    """Phase 6n alone, after the card's line and phase 2's builds."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = _card()
    print(card)
    print(f"build: {native.build()['seconds']:.1f} s; host build: "
          f"{host_native.build()['seconds']:.1f} s")
    native.library()
    distributed_phase(card)
    return 0


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

    _phase("2 build")
    # 2. build
    built = native.build()
    print(f"build: {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    native.library()
    try:
        hb = host_native.build()
    except RuntimeError as e:
        raise AssertionError(f"the native scene pipeline did not build: {e}")
    if not host_native.available():
        raise AssertionError("the native scene pipeline does not load")
    print(f"host build: {hb['seconds']:.1f} s -> {hb['path']} (g++ "
          f"{' '.join(host_native.GXX_FLAGS)})")

    _phase("3 kernels")
    # 3. kernels against their plain versions at main-path shapes
    scene, vp = circles.build(resolution="2k", maxdepth=5)
    eng = Engine(scene, device=dev)
    P = eng.page_size
    NP = eng.pages.num_pages
    tb = eng.ptables
    print(f"circles_2k: {len(scene.tris) - 1} triangles, {NP} pages of {P}, "
          f"{tb.ab.shape[0] // 128} bank(s); page-major records "
          f"{(tb.rec.numel() + tb.pab.numel()) * 4 / 1e6:.6f} MB beside "
          f"{sum(t.numel() * 4 for t in tb[:3]) / 1e6:.6f} MB of per-lane "
          f"tables on the card")
    tile = eng_mod.pick_tile(vp.width, vp.height)
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d, alive0, pk0 = eng._camera_rays(vp, tile, R, None)
    alive0 = alive0.to(torch.float32)[None]
    full0 = torch.cat([o, d, alive0, alive0,
                       torch.zeros((8, R), device=dev)], dim=0)
    # chunks spread over the whole image
    chunks = torch.linspace(0, R // RB - 1, N_CHECK_CHUNKS,
                            device=dev).round().long()
    rays = (chunks[:, None] * RB + torch.arange(RB, device=dev)).reshape(-1)
    st0 = full0[:, rays].contiguous()
    key = prng_key(7)
    results = {}
    page_of_c = _page_of(eng, len(scene.tris) - 1, dev)

    def b1_bound(n, valid):
        nc = n // RB
        return _bound(n * 25 + NP * 24 + nc * NP * 5,
                      int(valid.sum()) * NP * SLAB_FLOPS)

    def b2_bound(n, need):
        # bytes: the state in and out, the visited pages' predicate lanes
        # and the winners' payload (_union_need); operations: what the
        # exact function needs on the pages the chunk-wide exit visits and
        # the shade
        return _bound(n * 128 + need["page_bytes"],
                      need["flops"] + need["valid"] * SHADE_FLOPS)

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
        plain_ms=_time_plain_ms(lambda: cull.cull_mask_exact_plain(*args1)),
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
    cam_p, cam_vis = intersect.trace_chunks_plain(
        st0[0:3], st0[3:6], pk0, counts, plist, ptmin, RB, True,
        return_visits=True)
    need_c = _union_need(st0[0:3], st0[3:6], pk0, counts, plist, cam_vis,
                         cam_p, RB, True)
    results[native.TRACE_SHADE_UNION.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err,
        ms=_time_ms(lambda: intersect.trace_shade_chunks(
            *args2, zero_origin=True)),
        plain_ms=_time_plain_ms(lambda: intersect.trace_shade_chunks_plain(
            *args2, zero_origin=True)),
        **b2_bound(st0.shape[1], need_c))
    print(f"B2 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st1_k[7] != 0).sum())} rays live after wave 0")

    live = (st1_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args4 = (st1_k, eng.ptables, fold_in(key, 1), P, RB, False, 1 / 512,
             live)
    st2_k = intersect_perlane.trace_shade_perlane(*args4)
    st2_p = intersect_perlane.trace_shade_perlane_plain(*args4)
    torch.cuda.synchronize()
    err = _require_bitwise("B4", st2_k, st2_p)
    results[native.TRACE_SHADE_PERLANE.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err,
        ms=_time_ms(lambda: intersect_perlane.trace_shade_perlane(*args4)),
        plain_ms=_time_plain_ms(
            lambda: intersect_perlane.trace_shade_perlane_plain(*args4)),
        **_b4_bound(eng, page_of_c, st1_k))
    print(f"B4 on {N_CHECK_CHUNKS} chunks: max |diff| {err}; "
          f"{int((st2_k[7] != 0).sum())} rays live after wave 1")
    union_flags(eng, st1_k, key, results)

    # the lights path's kernels on the same chunks, lit by the teapot
    # preset's light (live RNG, as the circles_2k renders)
    def b6_bound(n, need, zero_origin, with_excl):
        # as B2's, with the rays in (the directions only on folded pages),
        # the excluded ids and the rows out, and no shade
        return _bound(n * (12 * (2 - zero_origin) + 4 * with_excl + 64)
                      + need["page_bytes"], need["flops"])

    def b8_bound(n, live):
        return _bound(n * (64 + 44 + 64 + 4), int(live.sum()) * SHADE_FLOPS)

    def rows_plain(ot, dt, PK, c, pl, pt, zero_origin=False, excl=None):
        return intersect.trace_chunks_plain(ot, dt, PK, c, pl, pt, RB,
                                            zero_origin, excl)

    def shadow_inputs(state, rows):
        so, sd, hit, excl = eng_mod.shadow_rays(state, rows, key, 0, False,
                                                LIGHT)
        sm, stm = cull.cull_mask_exact(so, sd, hit, eng.aabb_lo,
                                       eng.aabb_hi, RB)
        return (so, sd, eng.PK, *page_lists(sm, stm)), hit, excl

    cam = (st0[0:3], st0[3:6], pk0, counts, plist, ptmin)
    rows_k = intersect.trace_chunks(*cam, P, RB, zero_origin=True)
    err6 = _require_bitwise("B6 camera rays", rows_k, cam_p)
    sargs, hit, excl = shadow_inputs(st0, rows_k)
    srows_k = intersect.trace_chunks(*sargs, P, RB, excl=excl)
    srows_p, sh_vis = intersect.trace_chunks_plain(
        *sargs, RB, excl=excl, return_visits=True)
    err6s = _require_bitwise("B6 shadow rays", srows_k, srows_p)
    need_s = _union_need(*sargs[:5], sh_vis, srows_p, RB, excl=excl)
    shd = (hit & (srows_k[1] != 0)).float()
    results[native.TRACE_UNION_ROWS.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=max(err6, err6s),
        ms=_time_ms(lambda: intersect.trace_chunks(*cam, P, RB,
                                                   zero_origin=True)),
        plain_ms=_time_plain_ms(lambda: rows_plain(*cam, zero_origin=True)),
        **b6_bound(st0.shape[1], need_c, True, False),
        shadow=dict(
            ms=_time_ms(lambda: intersect.trace_chunks(*sargs, P, RB,
                                                       excl=excl)),
            plain_ms=_time_plain_ms(lambda: rows_plain(*sargs, excl=excl)),
            **b6_bound(st0.shape[1], need_s, False, True)))
    print(f"B6 on {N_CHECK_CHUNKS} chunks: camera rays and shadow rays "
          f"bitwise equal; {int(hit.sum())} hits, {int(shd.sum())} shadowed")
    ones = torch.ones(st0.shape[1] // RB, dtype=torch.int32, device=dev)
    args8 = (st0, rows_k, fold_in(key, 0), RB, False, 1 / 512, ones, shd)
    st1l_k = shade.shade(*args8)
    err8 = _require_bitwise("B8", st1l_k, shade.shade_plain(*args8))
    results[native.SHADE.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err8,
        ms=_time_ms(lambda: shade.shade(*args8)),
        plain_ms=_time_plain_ms(lambda: shade.shade_plain(*args8)),
        **b8_bound(st0.shape[1], st0[7] != 0))
    print(f"B8 on {N_CHECK_CHUNKS} chunks: bitwise equal; "
          f"{int((st1l_k[7] != 0).sum())} rays live after wave 0")
    livel = (st1l_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    args4l = (st1l_k, eng.ptables, fold_in(key, 1), P, RB, False, 1 / 512,
              livel, LIGHT)
    st2l_k = intersect_perlane.trace_shade_perlane(*args4l)
    err4l = _require_bitwise(
        "B4 with light", st2l_k,
        intersect_perlane.trace_shade_perlane_plain(*args4l))
    rows1 = intersect_perlane.trace_perlane_plain(
        st1l_k[0:3], st1l_k[3:6], st1l_k[7], *tb[:3], P)
    hits1 = int(((st1l_k[7] != 0) & (rows1[1] != 0)).sum())
    unlit4 = {k: results[native.TRACE_SHADE_PERLANE.name][k]
              for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    results[native.TRACE_SHADE_PERLANE.name].update(
        max_abs_err=max(err4l, results[native.TRACE_SHADE_PERLANE.name][
            "max_abs_err"]),
        ms=_time_ms(lambda: intersect_perlane.trace_shade_perlane(*args4l)),
        plain_ms=_time_plain_ms(
            lambda: intersect_perlane.trace_shade_perlane_plain(*args4l)),
        **_b4_bound(eng, page_of_c, st1l_k, lit_=True),
        feeler=True, unlit=unlit4)
    print(f"B4 with the shadow feeler on {N_CHECK_CHUNKS} chunks: bitwise "
          f"equal; {hits1} hit rays ran the feeler")
    results[native.TRACE_SHADE_PERLANE.name]["ptxas"] = _print_ptxas(
        built["log"], "B4", ("trace_shade_perlane_kernel",))

    # B7 (trace_perlane, the trace of the per-lane shadow pass) on the same
    # chunks' lit wave-1 rays: nearest rows, then any-hit with each ray's
    # own triangle excluded on their shadow rays
    ray7 = (st1l_k[0:3], st1l_k[3:6], st1l_k[7], tb, P, RB)
    rows7 = intersect_perlane.trace_perlane(*ray7)
    err7 = _require_bitwise("B7 lit wave-1 rays", rows7,
                            _plain_perlane_rows(*ray7))
    so7, sd7, hit7, excl7 = eng_mod.shadow_rays(st1l_k, rows7, key, 1, False,
                                                LIGHT)
    sh7 = (so7, sd7, hit7.float(), tb, P, RB)
    occ7 = intersect_perlane.trace_perlane(*sh7, excl=excl7, any_hit=True)
    occ7_p = _plain_perlane_rows(*sh7, excl=excl7, any_hit=True)
    n_bits = int(((occ7[1] != 0) != (occ7_p[1] != 0)).sum())
    if n_bits:
        raise AssertionError(f"B7 any-hit: {n_bits} occlusion bits differ")
    results[native.TRACE_PERLANE.name] = dict(
        rays=int(st0.shape[1]), max_abs_err=err7,
        ms=_time_ms(lambda: intersect_perlane.trace_perlane(*ray7)),
        plain_ms=_time_plain_ms(lambda: _plain_perlane_rows(*ray7)),
        **_perlane_bound(eng, page_of_c, st1l_k[0:3], st1l_k[7] != 0,
                         rows7[1], 92),
        any_hit=dict(
            ms=_time_ms(lambda: intersect_perlane.trace_perlane(
                *sh7, excl=excl7, any_hit=True)),
            plain_ms=_time_plain_ms(lambda: _plain_perlane_rows(
                *sh7, excl=excl7, any_hit=True)),
            **_perlane_bound(eng, page_of_c, so7, hit7, occ7[1], 96,
                             any_hit=True)))
    print(f"B7 on {N_CHECK_CHUNKS} chunks of lit circles_2k's wave-1 rays "
          f"(1 bank): nearest rows bitwise equal "
          f"({int((rows7[1] != 0).sum())} hits); any-hit occlusion bits "
          f"equal ({int(hit7.sum())} shadow rays, "
          f"{int((occ7[1] != 0).sum())} occluded)")
    banks = perlane_banks(dev, key)
    _print_ptxas(built["log"], "B7", ("trace_perlane_kernel",))

    # the kernels alone at full 2k size (3,600 chunks): B1, B2 and B6
    # (camera and shadow rays) and the lit wave 0 against their plain
    # versions on the whole wave, and what B2/B6 need there
    alive_f = full0[7] != 0.0
    wv = union_wave(eng, full0, pk0, key, RB, lit_wave=True)
    fc, fpl, fpt = wv["lists"]
    full1 = wv["state1"]
    need_f = _union_need(full0[0:3], full0[3:6], pk0, fc, fpl, wv["visits"],
                         wv["rows_p"], RB, True)
    _print_need("B2/B6 on the whole camera wave", need_f, card)
    need_fs = _union_need(*wv["shadow"][:5], wv["svisits"], wv["srows_p"], RB,
                          excl=wv["excl"])
    _print_need("B6 on the whole wave's shadow rays", need_fs, card)
    kept = ("pairs", "candidates", "hits", "tested", "visits_mean",
            "visits_max", "pages", "winners")
    results[native.TRACE_UNION_ROWS.name].update(
        need_full={k: need_f[k] for k in kept})
    results[native.TRACE_UNION_ROWS.name]["shadow"]["need_full"] = {
        k: need_fs[k] for k in kept}
    union_bounce(eng, full1, key, card, results)
    flive = (full1[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    # B4 on the whole unlit wave 1, bitwise
    fargs4 = (full1, eng.ptables, fold_in(key, 1), P, RB, False, 1 / 512,
              flive)
    _require_bitwise("B4, the whole wave 1",
                     intersect_perlane.trace_shade_perlane(*fargs4),
                     intersect_perlane.trace_shade_perlane_plain(*fargs4))
    print(f"B4 on the whole circles_2k wave 1 ({int((full1[7] != 0).sum())} "
          f"live rays): bitwise equal")
    full_ms = {
        native.CULL.name: (_time_ms(lambda: cull.cull_mask_exact(
            full0[0:3], full0[3:6], alive_f, eng.aabb_lo, eng.aabb_hi, RB)),
            b1_bound(R, alive_f)),
        native.TRACE_SHADE_UNION.name: (_time_ms(
            lambda: intersect.trace_shade_chunks(
                full0, pk0, fc, fpl, fpt, fold_in(key, 0), P, RB, False,
                1 / 512, zero_origin=True)), b2_bound(R, need_f)),
        native.TRACE_SHADE_PERLANE.name: (_time_ms(
            lambda: intersect_perlane.trace_shade_perlane(*fargs4)),
            _b4_bound(eng, page_of_c, full1)),
    }
    for name, (ms, bound) in full_ms.items():
        results[name].update(ms_full=ms, bound_ms_full=bound["bound_ms"],
                             bound_by_full=bound["bound_by"])
        print(f"time {name} (full 2k wave, {R // RB} chunks): kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]")

    # the lights path's kernels on the full lit wave 0 and wave 1
    unlit4 = results[native.TRACE_SHADE_PERLANE.name]["unlit"]
    unlit4.update({k: results[native.TRACE_SHADE_PERLANE.name].pop(k)
                   for k in ("ms_full", "bound_ms_full", "bound_by_full")})
    fcam = (full0[0:3], full0[3:6], pk0, fc, fpl, fpt)
    frows = wv["rows"]
    fsargs, fhit, fexcl = wv["shadow"], wv["hit"], wv["excl"]
    fsrows, fshd, full1l = wv["srows"], wv["shd"], wv["state1_lit"]
    fones = torch.ones(R // RB, dtype=torch.int32, device=dev)
    del wv
    flivel = (full1l[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    # B4 with the feeler on the whole lit wave 1, bitwise
    fargs4l = (full1l, eng.ptables, fold_in(key, 1), P, RB, False, 1 / 512,
               flivel, LIGHT)
    _require_bitwise("B4 with light, the whole wave 1",
                     intersect_perlane.trace_shade_perlane(*fargs4l),
                     intersect_perlane.trace_shade_perlane_plain(*fargs4l))
    print(f"B4 with the shadow feeler on the whole lit circles_2k wave 1 "
          f"({int((full1l[7] != 0).sum())} live rays): bitwise equal")
    lit_full = {
        "B6 camera rays": (results[native.TRACE_UNION_ROWS.name],
                           _time_ms(lambda: intersect.trace_chunks(
                               *fcam, P, RB, zero_origin=True)),
                           b6_bound(R, need_f, True, False)),
        "B6 shadow rays": (results[native.TRACE_UNION_ROWS.name]["shadow"],
                           _time_ms(lambda: intersect.trace_chunks(
                               *fsargs, P, RB, excl=fexcl)),
                           b6_bound(R, need_fs, False, True)),
        "B8": (results[native.SHADE.name],
               _time_ms(lambda: shade.shade(full0, frows, fold_in(key, 0),
                                            RB, False, 1 / 512, fones, fshd)),
               b8_bound(R, full0[7] != 0)),
        "B4 with light": (results[native.TRACE_SHADE_PERLANE.name],
                          _time_ms(lambda: intersect_perlane
                                   .trace_shade_perlane(*fargs4l)),
                          _b4_bound(eng, page_of_c, full1l, lit_=True)),
    }
    for name, (res, ms, bound) in lit_full.items():
        res.update(ms_full=ms, bound_ms_full=bound["bound_ms"],
                   bound_by_full=bound["bound_by"])
        print(f"time {name} (full lit 2k wave, {R // RB} chunks): kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]")
    skey = fold_in(key, 7_000_000)
    t_rng = _time_ms(lambda: (uniform(fold_in(skey, 0), (3, R), dev),
                              uniform(fold_in(skey, 1), (1, R), dev)))
    print(f"time threefry glue (jax.random.uniform of [3, {R}] and [1, {R}]"
          f", torch ops): {t_rng:.4f} ms per wave-0 shadow pass [{card}]; "
          f"{int(fhit.sum())} hits, {int(fshd.sum())} shadowed")

    # B7 on the full lit wave 1, and the per-lane shadow pass
    # (shadow_mask_perlane, B7's path) beside the B1/B6 one on its rows
    fray7 = (full1l[0:3], full1l[3:6], full1l[7], tb, P, RB)
    frows7 = intersect_perlane.trace_perlane(*fray7)
    fso7, fsd7, fhit7, fexcl7 = eng_mod.shadow_rays(full1l, frows7, key, 1,
                                                    False, LIGHT)
    fsh7 = (fso7, fsd7, fhit7.float(), tb, P, RB)
    focc7 = intersect_perlane.trace_perlane(*fsh7, excl=fexcl7, any_hit=True)
    # the whole wave against the plain version: nearest, all 16 rows
    # bitwise; any-hit with self-exclusion, the occlusion bits (and the
    # words of its rows that differ: only the bit is contractual, C5)
    _require_bitwise("B7 nearest, the whole lit wave 1", frows7,
                     _plain_perlane_whole(*fray7[:5]))
    focc7_p = _plain_perlane_whole(*fsh7[:5], excl=fexcl7, any_hit=True)
    n_bits = int(((focc7[1] != 0) != (focc7_p[1] != 0)).sum())
    n_words = int((focc7.view(torch.int32) != focc7_p.view(torch.int32))
                  .sum())
    print(f"B7 on the whole lit circles_2k wave 1 "
          f"({int((full1l[7] != 0).sum())} live rays): nearest rows bitwise "
          f"equal ({int((frows7[1] != 0).sum())} hits); any-hit on its "
          f"{int(fhit7.sum())} shadow rays: {n_bits} occlusion bits differ "
          f"({int((focc7[1] != 0).sum())} occluded), {n_words} row words")
    if n_bits:
        raise AssertionError(f"B7 any-hit, the whole wave: {n_bits} "
                             f"occlusion bits differ")
    del focc7_p
    for name, res, fn, bound in (
            ("B7 nearest, lit wave-1 rays",
             results[native.TRACE_PERLANE.name],
             lambda: intersect_perlane.trace_perlane(*fray7),
             _perlane_bound(eng, page_of_c, full1l[0:3], full1l[7] != 0,
                            frows7[1], 92)),
            ("B7 any-hit, their shadow rays",
             results[native.TRACE_PERLANE.name]["any_hit"],
             lambda: intersect_perlane.trace_perlane(*fsh7, excl=fexcl7,
                                                     any_hit=True),
             _perlane_bound(eng, page_of_c, fso7, fhit7, focc7[1], 96,
                            any_hit=True))):
        ms = _time_ms(fn)
        res.update(ms_full=ms, bound_ms_full=bound["bound_ms"],
                   bound_by_full=bound["bound_by"])
        print(f"time {name} (full lit 2k wave, {R // RB} chunks): kernel "
              f"{ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) [{card}]")
    spass = (full1l, frows7, key, 1, False, LIGHT)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    smask7 = eng_mod.shadow_mask_perlane(*spass, tb, P, RB)
    torch.cuda.synchronize()
    perlane_launches = _counts()
    smask6 = eng_mod.shadow_mask(*spass, eng.aabb_lo, eng.aabb_hi, eng.PK, P,
                                 RB)
    n_lanes = int((smask7 != smask6).sum())
    t7 = [_time_ms(lambda: eng_mod.shadow_mask_perlane(*spass, tb, P,
                                                       RB), reps=3)]
    t6 = [_time_ms(lambda: eng_mod.shadow_mask(
        *spass, eng.aabb_lo, eng.aabb_hi, eng.PK, P, RB), reps=3)]
    t7.append(_time_ms(lambda: eng_mod.shadow_mask_perlane(*spass, tb,
                                                           P, RB), reps=3))
    t6.append(_time_ms(lambda: eng_mod.shadow_mask(
        *spass, eng.aabb_lo, eng.aabb_hi, eng.PK, P, RB), reps=3))
    results[native.TRACE_PERLANE.name]["shadow_pass"] = dict(
        perlane_ms=t7, union_ms=t6, lanes_differ=n_lanes)
    print(f"shadow pass on the full lit circles_2k wave-1 rows "
          f"({int(fhit7.sum())} shadow rays, {int(smask7.sum())} shadowed): "
          f"per-lane (B7) vs B1/B6 branch, {n_lanes} of {R} lanes differ; "
          f"in turns per-lane {t7[0]:.4f}, B1/B6 {t6[0]:.4f}, per-lane "
          f"{t7[1]:.4f}, B1/B6 {t6[1]:.4f} ms; launches of the per-lane "
          f"pass {perlane_launches} [{card}]")
    if n_lanes > 1e-4 * R or perlane_launches["trace_perlane"] != 1 or any(
            c for k, c in perlane_launches.items() if k != "trace_perlane"):
        raise AssertionError("per-lane shadow pass: lanes differ beyond "
                             "0.01%, or launched other than B7 once")
    del fray7, frows7, fso7, fsd7, fhit7, fexcl7, fsh7, focc7, spass
    del smask7, smask6
    del frows, fsargs, fhit, fexcl, fsrows, fshd, full1l

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
        plain_ms=_time_plain_ms(
            lambda: compact.compact_plain(full1, scratch, meta, cb)),
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
        plain_ms=_time_plain_ms(lambda: compact.expand_plain(y, dead_k, masks,
                                                       meta, cb)),
        **_bound((2 * R + 4 * n_a + 4 * n_d) * 4 + 4 * R * 4, 0))

    # the second boundary, as the default schedule runs it: wave 1 (B4) on
    # the survivor prefix, then B3 with grid_live = the prefix and the dead
    # array filled from dead_end on; B5 with grid_live writes only the
    # prefix, so it is compared there
    clive = (out_k[7] != 0).reshape(-1, RB).any(dim=1).to(torch.int32)
    full2 = intersect_perlane.trace_shade_perlane(
        out_k, eng.ptables, fold_in(key, 1), P, RB, False, 1 / 512, clive)
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
    _phase("3 streamed kernels")
    s_scene, eng_s, s_vp = streamed_kernels(dev, card, key, results,
                                            built["log"])
    _phase("3 B11")
    w_scene, wr, w_vp = wavefront_kernels(dev, card, key, results,
                                          built["log"])
    _phase("3 B13, B14, ray_chunk")
    # B13 and B14, which no render path launches, and the chunk-block
    # kernels at ray_chunk 2048 and 4096
    b_eng, b_o, b_d, b_valid, b_rays = banks
    cull_sorted_kernels({
        "circles_2k camera rays": (full0[0:3], full0[3:6], full0[7] != 0,
                                   eng.aabb_lo, eng.aabb_hi, rays),
        "4-bank sphere camera rays": (b_o, b_d, b_valid, b_eng.aabb_lo,
                                      b_eng.aabb_hi, b_rays)}, card, results)
    cull_sorted_branches(dev, results)
    del banks, b_eng, b_o, b_d, b_valid, b_rays
    bucket_kernels(full1, card, results)
    ray_chunk_kernels(eng, full0, pk0, eng_s, card, key, results)
    untile_kernel(dev, card, results, built["log"])
    camera_kernel(dev, card, results, built["log"])
    _print_ptxas(built["log"], "B13", ("cull_sorted_kernel",))
    _print_ptxas(built["log"], "B14", ("compact_buckets_kernel",
                                       "expand_buckets_kernel"))
    for k, label, names in ((native.CULL, "B1/B13",
                             ("cull_kernel", "cull_sorted_kernel")),
                            (native.TRACE_UNION_ROWS, "B2/B6",
                             ("trace_union_kernel",))):
        results[k.name]["ptxas"] = _print_ptxas(built["log"], label, names)
    t_zero = _time_ms(lambda: torch.zeros_like(full1))
    for k in native.KERNELS:
        r = results[k.name]
        print(f"time {k.name} ({r['rays']} rays): kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]")
    print(f"time torch.zeros [16, {R}] (inside B3's wrapper): {t_zero:.4f} ms "
          f"[{card}]")
    del full0, full1, fc, fpl, fpt, out_k, out_p, dead, dead_k
    del dead_p, scratch, back_k, back_p, y, masks

    _phase("4 golden")
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
    for label, render, path in (
            ("WavefrontRenderer(backend='kernel')",
             lambda: png.quantize_u8(WavefrontRenderer(
                 g_scene, backend="kernel", device=dev).render(
                     g_vp, fixed_rng=True).image), ("nearest_hit",)),
            ("Engine(compact=False)",
             lambda: Engine(g_scene, compact=False, device=dev).render(
                 g_vp, fixed_rng=True).image, LEGACY_PATH)):
        native.reset_launch_counts()
        img = render()
        torch.cuda.synchronize()
        n_bad = int((img != golden).any(axis=-1).sum())
        missing = [k for k in path if _counts()[k] == 0]
        if n_bad or missing:
            raise AssertionError(f"golden, {label}: {n_bad} pixels differ, "
                                 f"never launched {missing}")
        print(f"golden: circles 96x54 fixed_rng byte-equal on the card "
              f"({label}; launches {_counts()})")

    # the command line's slow runs, in processes of their own meanwhile
    slow_cli = start_slow_cli()
    _phase("5 paths")
    # 5. kernel path vs plain path on the card, default Engine, unlit and
    # lit, on circles and in the streamed regime on the synthetic_1m sphere
    # (one Engine for both paths there, at a fixed schedule: the scene's
    # host build takes seconds)
    def check_paths(label, render_k, render_p):
        t0 = time.perf_counter()
        img_k = render_k()
        t1 = time.perf_counter()
        with plain_path():
            img_p = render_p()
        t2 = time.perf_counter()
        n_px = img_k.shape[0] * img_k.shape[1]
        n_diff = int((img_k != img_p).any(axis=-1).sum())
        print(f"kernel vs plain path {img_k.shape[1]}x{img_k.shape[0]} "
              f"fixed_rng, {label}: {n_diff} of {n_px} pixels differ "
              f"(kernel {t1 - t0:.1f} s, plain {t2 - t1:.1f} s)")
        if n_diff > 1e-4 * n_px:
            raise AssertionError(f"{label}: kernel and plain paths differ "
                                 f"beyond 0.01%")

    for label, make in (("unlit", lambda s: s), ("lit", lit)):
        m_scene, m_vp = circles.build(resolution=(640, 360), maxdepth=5)
        m_scene = make(m_scene)
        check_paths(f"circles {label}",
                    lambda: Engine(m_scene, device=dev).render(
                        m_vp, fixed_rng=True).image,
                    lambda: Engine(m_scene, device=dev).render(
                        m_vp, fixed_rng=True).image)
    # ray_chunk 4096: 2 chunk-block kernels' blocks own 4 rays a thread
    rc_scene, rc_vp = circles.build(resolution=(640, 360), maxdepth=5)
    check_paths("circles Engine(ray_chunk=4096)",
                lambda: Engine(rc_scene, ray_chunk=4096, device=dev).render(
                    rc_vp, fixed_rng=True).image,
                lambda: Engine(rc_scene, ray_chunk=4096, device=dev).render(
                    rc_vp, fixed_rng=True).image)
    # the Engine's last paths: the union bounce waves past a lowered cap,
    # bounce_chunk and render_sharded
    for label, make in last_paths(dev).items():
        check_paths(f"circles {label}",
                    lambda: make(rc_scene).render(rc_vp, fixed_rng=True).image,
                    lambda: make(rc_scene).render(rc_vp, fixed_rng=True).image)
    s_vp5 = synthetic_view(STREAMED_CHECK_RES)
    for label in ("unlit", "lit"):
        if label == "lit":
            lit(s_scene)        # eng_s keeps the unlit scene it was made for
        e5 = Engine(s_scene, ncompact=2, device=dev)
        if not e5.streamed:
            raise AssertionError("synthetic_1m: not the streamed regime")
        check_paths(f"synthetic_1m streamed {label}",
                    lambda: e5.render(s_vp5, fixed_rng=True).image,
                    lambda: e5.render(s_vp5, fixed_rng=True).image)
        if label == "unlit":
            # the bank-major sweep (B12) on the same Engine: kernel vs
            # plain path, and the bits of the worklist Engine (B9)
            e5.bank_major = True
            check_paths("synthetic_1m streamed bank-major",
                        lambda: e5.render(s_vp5, fixed_rng=True).image,
                        lambda: e5.render(s_vp5, fixed_rng=True).image)
            native.reset_launch_counts()
            bm_f = e5.render(s_vp5, fixed_rng=True, quantize=False)
            bm5 = _counts()
            e5.bank_major = False
            wl_f = e5.render(s_vp5, fixed_rng=True, quantize=False)
            n_px = int((png.quantize_u8(bm_f.image)
                        != png.quantize_u8(wl_f.image)).any(axis=-1).sum())
            same_f = np.array_equal(bm_f.image.view(np.uint32),
                                    wl_f.image.view(np.uint32))
            print(f"bank-major vs worklist Engine, synthetic_1m "
                  f"{s_vp5.width}x{s_vp5.height} fixed_rng: {n_px} pixels "
                  f"differ, float images equal {same_f}, wave_rays "
                  f"{bm_f.wave_rays.tolist()}; bank-major launches {bm5}")
            if n_px or not same_f or not np.array_equal(
                    bm_f.wave_rays, wl_f.wave_rays) or any(
                        bm5[k] == 0 for k in BANK_MAJOR_KERNELS):
                raise AssertionError("bank-major and worklist Engines "
                                     "differ, or B12 never launched")
        del e5

    # the per-lane shadow pass (B7) against the B1/B6 one on lit circles'
    # wave-1 rows: both ask whether another triangle passes the predicate
    c_scene, c_vp = circles.build(resolution=(640, 360), maxdepth=5)
    ec = Engine(lit(c_scene), device=dev)
    cP = ec.page_size
    cR0 = c_vp.width * c_vp.height
    cR = -(-cR0 // RB) * RB
    co, cd, ca, cpk0 = ec._camera_rays(
        c_vp, eng_mod.pick_tile(c_vp.width, c_vp.height), cR, None)
    ca = ca.to(torch.float32)[None]
    cst0 = torch.cat([co, cd, ca, ca, torch.zeros((8, cR), device=dev)])
    ckey = prng_key(5)
    cm, ct = cull.cull_mask_exact(cst0[0:3], cst0[3:6], cst0[7] != 0,
                                  ec.aabb_lo, ec.aabb_hi, RB)
    crows0 = intersect.trace_chunks(cst0[0:3], cst0[3:6], cpk0,
                                    *page_lists(cm, ct), cP, RB,
                                    zero_origin=True)
    cshd0 = eng_mod.shadow_mask(cst0, crows0, ckey, 0, True, LIGHT,
                                ec.aabb_lo, ec.aabb_hi, ec.PK, cP, RB)
    cst1 = shade.shade(cst0, crows0, fold_in(ckey, 0), RB, True, 0.0,
                       torch.ones(cR // RB, dtype=torch.int32, device=dev),
                       cshd0)
    ctabs = ec.ptables
    crows1 = intersect_perlane.trace_perlane(cst1[0:3], cst1[3:6], cst1[7],
                                             ctabs, cP, RB)
    cm7 = eng_mod.shadow_mask_perlane(cst1, crows1, ckey, 1, True, LIGHT,
                                      ctabs, cP, RB)
    cm6 = eng_mod.shadow_mask(cst1, crows1, ckey, 1, True, LIGHT, ec.aabb_lo,
                              ec.aabb_hi, ec.PK, cP, RB)
    n_lanes = int((cm7 != cm6).sum())
    print(f"shadow_mask_perlane vs shadow_mask, lit circles "
          f"{c_vp.width}x{c_vp.height} wave-1 rows, fixed_rng: {n_lanes} of "
          f"{cR} lanes differ ({int(cm7.sum())} shadowed of "
          f"{int(((cst1[7] != 0) & (crows1[1] != 0)).sum())} hits)")
    if n_lanes > 1e-4 * cR or not cm7.any():
        raise AssertionError("the two shadow passes differ beyond 0.01%")
    del cst0, cst1, crows0, crows1, cm, ct, cm7, cm6, ec

    # 5b. the portable renderer and the Engine's other paths at 640x360:
    # B11 against its plain version through the whole WavefrontRenderer, the
    # two nearest-hit backends, the Engine against the portable renderer
    # (the reference's engine == xla cross-check), compacted against legacy
    def compare(label, img_a, img_b):
        n_px = img_a.shape[0] * img_a.shape[1]
        n_diff = int((img_a != img_b).any(axis=-1).sum())
        print(f"{label} {img_a.shape[1]}x{img_a.shape[0]} fixed_rng: "
              f"{n_diff} of {n_px} pixels differ")
        if n_diff > 1e-4 * n_px:
            raise AssertionError(f"{label}: images differ beyond 0.01%")

    p_scene, p_vp = circles.build(resolution=(640, 360), maxdepth=5)

    def wr_image(backend):
        return png.quantize_u8(WavefrontRenderer(
            p_scene, backend=backend, device=dev).render(
                p_vp, fixed_rng=True).image)

    check_paths("WavefrontRenderer kernel", lambda: wr_image("kernel"),
                lambda: wr_image("kernel"))
    img_wk = wr_image("kernel")
    compare("WavefrontRenderer kernel vs portable", img_wk,
            wr_image("portable"))
    compare("Engine vs WavefrontRenderer (kernel)",
            Engine(p_scene, device=dev).render(p_vp, fixed_rng=True).image,
            img_wk)
    for label, make in (("unlit", lambda sc: sc), ("lit", lit)):
        sc = make(circles.build(resolution=(640, 360), maxdepth=5)[0])
        compare(f"Engine compacted vs legacy, {label}",
                Engine(sc, device=dev).render(p_vp, fixed_rng=True).image,
                Engine(sc, compact=False, device=dev).render(
                    p_vp, fixed_rng=True).image)
    # render_banded in three bands of 120 rows vs render()
    e_band = Engine(p_scene, device=dev)
    band5 = e_band.render_banded(p_vp, fixed_rng=True, band_rows=120)
    full5 = e_band.render(p_vp, fixed_rng=True)
    n_px = int((band5.image != full5.image).any(axis=-1).sum())
    print(f"render_banded (3 bands of 120 rows) vs render, circles "
          f"{p_vp.width}x{p_vp.height} fixed_rng: {n_px} pixels differ, "
          f"wave_rays {band5.wave_rays.tolist()} vs "
          f"{full5.wave_rays.tolist()}")
    if n_px or not np.array_equal(band5.wave_rays, full5.wave_rays):
        raise AssertionError("render_banded and render differ")
    q_scene, q_vp = circles.build(resolution=(640, 360), maxdepth=5,
                                  samples=4)
    compare("Engine spp 4 compacted vs legacy",
            Engine(q_scene, device=dev).render(q_vp, fixed_rng=True).image,
            Engine(q_scene, compact=False, device=dev).render(
                q_vp, fixed_rng=True).image)

    _phase("6 renders")
    for _, proc, _ in slow_cli.values():    # none runs beside the timings
        proc.wait()
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
    missing = [n for n in UNLIT_PATH if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the unlit path: "
                             f"{missing}")

    # 6b. circles_2k lit: the default Engine, three renders after a warm-up
    # (the autotune plans on it)
    eng_l = Engine(lit(circles.build(resolution="2k", maxdepth=5)[0]),
                   device=dev)
    eng_l.render(vp)
    torch.cuda.synchronize()
    print(f"lit autotune: planned schedule {eng_l.ncompact}")
    lit_runs = []
    lit_launches = {k.name: 0 for k in native.KERNELS}
    for _ in range(3):
        torch.cuda.synchronize()
        native.reset_launch_counts()
        lit_runs.append(eng_l.render(vp))
        torch.cuda.synchronize()
        for k, c in _counts().items():
            lit_launches[k] += c
    best_l = min(lit_runs, key=lambda r: r.seconds)
    img_l = best_l.image
    if img_l.shape != (vp.height, vp.width, 3) or img_l.dtype != np.uint8:
        raise AssertionError(f"lit circles_2k image {img_l.shape}")
    if int(best_l.wave_rays[0]) != R0 or not (img_l.max() > 0):
        raise AssertionError(f"lit circles_2k wave_rays {best_l.wave_rays}")
    unlit_img = min(runs["default"], key=lambda r: r.seconds).image
    darker = float(((unlit_img.astype(int) - img_l) > 1).any(-1).mean())
    print(f"circles_2k lit: best {best_l.seconds:.6f} s of "
          f"{[round(r.seconds, 6) for r in lit_runs]}, rays_traced "
          f"{best_l.rays_traced}, {best_l.mrays_per_sec:.3f} Mrays/s, "
          f"wave_rays {best_l.wave_rays.tolist()} [{card}]; {darker:.4f} of "
          f"pixels darker than unlit")
    if not 0.05 < darker < 0.95:
        raise AssertionError("the light cast no shadow, or shadowed all")
    print(f"launches in the 3 lit renders: {lit_launches}")
    missing = [n for n in LIT_PATH if lit_launches[n] == 0]
    if missing or lit_launches["trace_shade_chunks"]:
        raise AssertionError(f"lit path: kernels never launched {missing}, "
                             f"or B2 launched")

    # 6c. synthetic_1m_2k at full width: the default Engine takes the
    # streamed regime; three timed renders after the autotune's, then the
    # lit scene (lit since phase 5) once after a warm-up
    R0s = s_vp.width * s_vp.height
    eng_s.render(s_vp)                   # the autotune plans on this render
    torch.cuda.synchronize()
    print(f"synthetic_1m_2k autotune: planned schedule {eng_s.ncompact}")
    s_runs = []
    s_launches = {k.name: 0 for k in native.KERNELS}
    for _ in range(3):
        torch.cuda.synchronize()
        native.reset_launch_counts()
        s_runs.append(eng_s.render(s_vp))
        torch.cuda.synchronize()
        for k, c in _counts().items():
            s_launches[k] += c
    best_s = min(s_runs, key=lambda r: r.seconds)
    if best_s.image.shape != (s_vp.height, s_vp.width, 3) \
            or int(best_s.wave_rays[0]) != R0s or not best_s.image.max() > 0:
        raise AssertionError(f"synthetic_1m_2k image {best_s.image.shape}, "
                             f"wave_rays {best_s.wave_rays}")
    print(f"synthetic_1m_2k (streamed, page size {eng_s.page_size}, "
          f"{eng_s.stables[0].shape[0]} banks): best {best_s.seconds:.6f} s "
          f"of {[round(r.seconds, 6) for r in s_runs]}, rays_traced "
          f"{best_s.rays_traced}, {best_s.mrays_per_sec:.3f} Mrays/s, "
          f"wave_rays {best_s.wave_rays.tolist()} [{card}]")
    print(f"launches in the 3 synthetic_1m_2k renders: {s_launches}")
    missing = [n for n in STREAMED_PATH if s_launches[n] == 0]
    other = [n for n in RESIDENT_ONLY + ("trace_streamed", "trace_chunks",
                                         "shade") if s_launches[n]]
    if missing or other:
        raise AssertionError(f"streamed path: never launched {missing}, "
                             f"launched {other}")
    eng_sl = Engine(s_scene, device=dev)
    if not (eng_sl.streamed and eng_sl.light is not None):
        raise AssertionError("lit synthetic_1m: not streamed and lit")
    eng_sl.render(s_vp)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    sl_run = eng_sl.render(s_vp)
    torch.cuda.synchronize()
    sl_launches = _counts()
    darker = float(((best_s.image.astype(int) - sl_run.image) > 1)
                   .any(-1).mean())
    print(f"synthetic_1m_2k lit (schedule {eng_sl.ncompact}): "
          f"{sl_run.seconds:.6f} s, rays_traced {sl_run.rays_traced}, "
          f"{sl_run.mrays_per_sec:.3f} Mrays/s, wave_rays "
          f"{sl_run.wave_rays.tolist()} [{card}]; {darker:.4f} of pixels "
          f"darker than unlit")
    print(f"launches in the lit synthetic_1m_2k render: {sl_launches}")
    missing = [n for n in STREAMED_LIT_PATH if sl_launches[n] == 0]
    other = [n for n in RESIDENT_ONLY + ("trace_shade_streamed",
                                         "trace_chunks") if sl_launches[n]]
    if missing or other or int(sl_run.wave_rays[0]) != R0s \
            or not 0.01 < darker < 0.99:
        raise AssertionError(f"lit streamed path: never launched {missing}, "
                             f"launched {other}, or no shadow cast")

    # 6d. the portable renderer on circles_2k at its defaults (page size
    # 256, ray chunk 1024, slabs of 2^20 rays): B11 every wave of every slab
    def timed(label, renderer, tvp, path, absent, warm=True, reps=3):
        """`reps` renders after a warm-up, launch counts summed over them;
        fails unless every kernel of `path` launched and none of
        `absent`."""
        if warm:
            renderer.render(tvp)
            torch.cuda.synchronize()
        runs, counts = [], {k.name: 0 for k in native.KERNELS}
        for _ in range(reps):
            torch.cuda.synchronize()
            native.reset_launch_counts()
            runs.append(renderer.render(tvp))
            torch.cuda.synchronize()
            for k, c in _counts().items():
                counts[k] += c
        best = min(runs, key=lambda r: r.seconds)
        n0 = tvp.width * tvp.height * tvp.samples_per_pixel
        if best.image.shape != (tvp.height, tvp.width, 3) \
                or int(best.wave_rays[0]) != n0 \
                or not np.isfinite(best.image).all() \
                or not best.image.max() > 0:
            raise AssertionError(f"{label}: image {best.image.shape}, "
                                 f"wave_rays {best.wave_rays}")
        print(f"{label}: best {best.seconds:.6f} s of "
              f"{[round(r.seconds, 6) for r in runs]}, rays_traced "
              f"{best.rays_traced}, {best.mrays_per_sec:.3f} Mrays/s, "
              f"wave_rays {best.wave_rays.tolist()} [{card}]")
        print(f"launches in the {reps} {label} renders: {counts}")
        missing = [k for k in path if counts[k] == 0]
        other = [k for k in absent if counts[k]]
        if missing or other:
            raise AssertionError(f"{label}: never launched {missing}, "
                                 f"launched {other}")
        return best, counts

    not_b11 = [k.name for k in native.KERNELS if k.name != "nearest_hit"]
    _, w_launches = timed(
        "WavefrontRenderer circles_2k (page size 256, 4 slabs)", wr, w_vp,
        ("nearest_hit",), not_b11)

    # 6e. the legacy loop on circles_2k: B1 and B6 every wave
    eng_leg = Engine(scene, compact=False, device=dev)
    _, leg_launches = timed("Engine(compact=False) circles_2k", eng_leg, vp,
                            LEGACY_PATH, NOT_LEGACY)

    # 6f. spp 4 on circles 512x512 (1,048,576 rays), the default Engine
    q4_scene, q4_vp = circles.build(resolution=(512, 512), maxdepth=5,
                                    samples=4)
    eng_q4 = Engine(q4_scene, device=dev)
    q4_best, q4_launches = timed("Engine spp 4 circles 512x512", eng_q4,
                                 q4_vp, UNLIT_PATH, ("nearest_hit",))
    if q4_best.image.dtype != np.uint8:
        raise AssertionError("spp 4: not quantized on the device")

    # 6g. one debug render of circles_2k: wave 0 unfused (B1, B6, B8)
    native.reset_launch_counts()
    dbg = eng.render(vp, debug=True)
    torch.cuda.synchronize()
    dbg_launches = _counts()
    n_tris = len(scene.tris) - 1
    nc = R // RB
    ok = (dbg.primary_t.shape == (vp.height, vp.width)
          and dbg.primary_id.shape == (vp.height, vp.width)
          and dbg.primary_id.min() >= 0 and dbg.primary_id.max() <= n_tris
          and (dbg.primary_id != 0).mean() > 0.1
          and np.isfinite(dbg.primary_t[dbg.primary_id != 0]).all()
          and np.isinf(dbg.primary_t[dbg.primary_id == 0]).all()
          and dbg.primary_chunk.shape == (vp.height, vp.width)
          and dbg.primary_chunk.max() == nc - 1 and len(dbg.chunk_tris) == nc
          and all(((c > 0) & (c <= n_tris)).all() for c in dbg.chunk_tris))
    missing = [k for k in DEBUG_PATH if dbg_launches[k] == 0]
    if not ok or missing or dbg_launches["trace_shade_chunks"]:
        raise AssertionError(f"debug render: buffers ok {ok}, never "
                             f"launched {missing}, launches {dbg_launches}")
    print(f"debug render of circles_2k: {dbg.seconds:.6f} s, "
          f"{int((dbg.primary_id != 0).sum())} primary hits, candidate sets "
          f"of {nc} chunks (mean {np.mean([len(c) for c in dbg.chunk_tris]):.1f}"
          f" triangles); launches {dbg_launches} [{card}]")

    # 6h. synthetic_1m_2k through Engine(bank_major=True): three timed
    # renders after the autotune's; B9 on waves 0-1, B12 on waves 2-4
    s_lights, s_scene.lights = s_scene.lights, None
    eng_bm = Engine(s_scene, bank_major=True, device=dev)
    s_scene.lights = s_lights
    if not (eng_bm.streamed and eng_bm.bank_major
            and eng_bm.light is None):
        raise AssertionError("bank-major synthetic_1m: not streamed unlit")
    bm_best, bm_launches = timed(
        "synthetic_1m_2k Engine(bank_major=True)", eng_bm, s_vp,
        BANK_MAJOR_PATH, RESIDENT_ONLY + ("nearest_hit", "trace_streamed",
                                          "trace_chunks", "shade",
                                          "trace_perlane"))
    print(f"synthetic_1m_2k bank-major schedule {eng_bm.ncompact}; the "
          f"default streamed Engine's best {best_s.seconds:.6f} s "
          f"({best_s.mrays_per_sec:.3f} Mrays/s, schedule {eng_s.ncompact})")
    n_w = s_vp.maxdepth
    if bm_launches["trace_shade_streamed"] != 3 * 2 or any(
            bm_launches[k] != 3 * (n_w - 2) for k in BANK_MAJOR_KERNELS):
        raise AssertionError(f"bank-major: B9 not on waves 0-1 only, or "
                             f"B12 not on every later wave: {bm_launches}")
    bm_fixed = eng_bm.render(s_vp, fixed_rng=True)
    wl_fixed = eng_s.render(s_vp, fixed_rng=True)
    n_px = int((bm_fixed.image != wl_fixed.image).any(axis=-1).sum())
    print(f"synthetic_1m_2k fixed_rng, bank-major vs default Engine: {n_px} "
          f"pixels differ; wave_rays {bm_fixed.wave_rays.tolist()}")
    if n_px or not np.array_equal(bm_fixed.wave_rays, wl_fixed.wave_rays):
        raise AssertionError("bank-major synthetic_1m_2k differs from the "
                             "default Engine under fixed_rng")

    # 6i. circles_2k through render_banded, three bands of 480 rows, on the
    # autotuned default Engine
    banded = SimpleNamespace(
        render=lambda tvp: eng.render_banded(tvp, band_rows=480))
    _, band_launches = timed("circles_2k render_banded (3 bands of 480 rows)",
                             banded, vp, UNLIT_PATH,
                             ("nearest_hit", "trace_perlane")
                             + BANK_MAJOR_KERNELS)
    band_f = eng.render_banded(vp, fixed_rng=True, band_rows=480)
    full_f = eng.render(vp, fixed_rng=True)
    n_px = int((band_f.image != full_f.image).any(axis=-1).sum())
    print(f"circles_2k fixed_rng, render_banded vs render: {n_px} pixels "
          f"differ; wave_rays {band_f.wave_rays.tolist()} vs "
          f"{full_f.wave_rays.tolist()}")
    if n_px or not np.array_equal(band_f.wave_rays, full_f.wave_rays):
        raise AssertionError("render_banded differs from render()")

    # 6j. circles_2k through Engine(ray_chunk=4096): three timed renders
    # after the autotune's, beside the default Engine's (ray_chunk 1024)
    eng_rc = Engine(scene, ray_chunk=4096, device=dev)
    rc_best, rc_launches = timed("circles_2k Engine(ray_chunk=4096)", eng_rc,
                                 vp, UNLIT_PATH, ("nearest_hit",))
    d_best = min(runs["default"], key=lambda r: r.seconds)
    print(f"circles_2k ray_chunk 4096 (schedule {eng_rc.ncompact}): "
          f"{rc_best.mrays_per_sec:.3f} Mrays/s vs the default's (ray_chunk "
          f"1024) {d_best.mrays_per_sec:.3f} Mrays/s [{card}]")
    del eng_rc

    # 6l. the Engine's last paths at full width, one timed render after a
    # warm-up each: the union bounce waves (circles_2k past a lowered cap,
    # streamed=False), bounce_chunk and render_sharded; each fixed_rng
    # image byte-equal to the default Engine's (full_f, 6i)
    last_launches, last_engines = {}, {}
    for label, make in last_paths(dev).items():
        e = make(scene)
        path, absent = ((UNION_BOUNCE_PATH, NOT_UNION_BOUNCE)
                        if "union" in label else
                        (UNLIT_PATH, ("nearest_hit", "trace_perlane",
                                      "trace_chunks", "shade",
                                      "trace_shade_streamed",
                                      "trace_streamed")
                         + BANK_MAJOR_KERNELS))
        _, counts = timed(f"circles_2k {label}", e, vp, path, absent,
                          reps=1)
        want = {"union": {"cull_mask_exact": vp.maxdepth,
                          "trace_shade_chunks": vp.maxdepth},
                "sharded": {"cull_mask_exact": SHARDS,
                            "trace_shade_chunks": SHARDS}}
        for k, n in want.get(label.split()[0], {}).items():
            if counts[k] != n:
                raise AssertionError(f"{label}: {counts[k]} {k} launches in "
                                     f"a render, not {n}")
        f_img = e.render(vp, fixed_rng=True).image
        n_px = int((f_img != full_f.image).any(axis=-1).sum())
        print(f"circles_2k fixed_rng, {label} vs the default Engine: {n_px} "
              f"pixels differ")
        if n_px:
            raise AssertionError(f"{label} differs from the default Engine "
                                 f"under fixed_rng")
        last_launches[label.split()[0]] = counts
        last_engines[label.split()[0]] = e

    # 6k. the command line on the card
    cli_launches = cli_phase(dev, card, slow_cli)

    _phase("6m utilities")
    # 6m. the measurement and parity utilities on the card
    roofline_phase(dev, card)
    device_metric_phase(card, [
        ("circles_2k default", eng, vp,
         min(runs["default"], key=lambda r: r.seconds)),
        ("circles_2k lit", eng_l, vp, best_l),
        ("synthetic_1m_2k", eng_s, s_vp, best_s)])
    profiling_phase(dev, card, eng, vp)
    oracle_phase(dev)
    parity_phase(dev, golden)

    _phase("6n across processes")
    # 6n. the render across processes: ranks of torch.distributed, one a
    # shard, the kernels built above (each rank loads the library)
    dist_launches = distributed_phase(card)

    _phase("6o the JAX package's last paths")
    # 6o. the fused lit wave 0, gate_frac, wave0_skippable, cb and the
    # reference helpers against the kernels
    last_jax = jax_last_paths(
        dev, card, key, eng, eng_l, eng_s, vp, s_vp, st0, mask_k,
        min(runs["default"], key=lambda r: r.seconds), results, built["log"])

    _phase("7 profile")
    # 7. where the time of one circles_2k and one synthetic_1m_2k render goes
    for name, e, pvp in (("default", eng, vp), ("ncompact=0", eng0, vp),
                         ("lit", eng_l, vp),
                         ("WavefrontRenderer", wr, w_vp),
                         ("legacy", eng_leg, vp),
                         ("union bounce waves", last_engines["union"], vp),
                         ("synthetic_1m_2k", eng_s, s_vp),
                         ("synthetic_1m_2k bank-major", eng_bm, s_vp),
                         ("synthetic_1m_2k lit", eng_sl, s_vp)):
        wall_ms, per_name, busy_ms, n_name = _profile_render(e, pvp)
        print(f"profile {name}: render {wall_ms:.3f} ms under the profiler, "
              f"device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%) [{card}]")
        for n, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:24]:
            print(f"  device {ms:9.3f} ms  {n[:90]}")
        print(f"  by kind: " + ", ".join(f"{g} {ms:.3f} ms" for g, ms in
                                         _groups(per_name).items()))
        b11 = sum(ms for n, ms in per_name.items()
                  if "nearest_hit_kernel" in n or "live_list_kernel" in n)
        if b11:
            print(f"  of which B11 (live_list_kernel and nearest_hit_kernel)"
                  f" {b11:.3f} ms")
        kinds = {k: sum(ms for n, ms in per_name.items()
                        if any(p in n for p in pats))
                 for k, pats in (("B9", ("stream_list_kernel",
                                         "stream_trace_kernel")),
                                 ("B12a", ("bm_prep_kernel",)),
                                 ("B12b", ("bm_sweep_kernel",)),
                                 ("B12c", ("bm_finish_kernel",)))}
        if kinds["B9"] or kinds["B12b"]:
            print("  of which " + ", ".join(f"{k} {ms:.3f} ms"
                                            for k, ms in kinds.items()))
        sweeps = sum(c for n, c in n_name.items() if "bm_sweep_kernel" in n)
        if e is eng_bm and sweeps != pvp.maxdepth - 2:
            raise AssertionError(f"bank-major render: {sweeps} B12b grids, "
                                 f"not one a wave >= 2")
        if sweeps:
            print(f"  B12b grids in the render: {sweeps} (one a wave >= 2)")

    # launches: B9 of the streamed path, B10 of the lit streamed path; the
    # others of the lit circles path for its kernels, else of the unlit one
    paths = {"unlit": launches, "lit": lit_launches, "streamed": s_launches,
             "streamed_lit": sl_launches, "wavefront": w_launches,
             "legacy": leg_launches, "spp4": q4_launches,
             "debug": dbg_launches, "bank_major": bm_launches,
             "perlane_shadow": perlane_launches, "banded": band_launches,
             "ray_chunk_4096": rc_launches, "cli": cli_launches,
             "union_bounce": last_launches["union"],
             "bounce_chunk": last_launches["bounce_chunk"],
             "sharded": last_launches["sharded"],
             "distributed": dist_launches["render"],
             "distributed_trace": dist_launches["trace"],
             **last_jax["launches"]}
    main_path = {"trace_shade_streamed": "streamed",
                 "trace_streamed": "streamed_lit",
                 "nearest_hit": "wavefront",
                 "trace_perlane": "perlane_shadow",
                 **{k: "bank_major" for k in BANK_MAJOR_KERNELS}}

    def path_of(name):
        return main_path.get(name, "lit" if name in LIT_PATH else "unlit")

    # B13 and B14 launch on no render path (the JAX package calls neither):
    # phase 3 drives them directly, and every path's count is 0
    direct = (native.CULL_SORTED.name, native.COMPACT_BUCKETS.name,
              native.EXPAND_BUCKETS.name)

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": paths[path_of(k.name)][k.name],
         "path": "driven directly" if k.name in direct else path_of(k.name),
         "launches_by_path": {p: c[k.name] for p, c in paths.items()},
         "library_ms": None, **results[k.name]} for k in native.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ca0d7908_wrappers(lib) -> dict:
    """`trace_perlane` and `cull_sorted` with the port's arguments,
    launching the kernels of commit a0d7908's library `lib`: its B7 (one
    thread a lane of the wave over the per-lane tables, whose
    rt_trace_perlane takes plt_i, plt_s and ab) and its B13 (the all-pairs
    rank)."""
    def ok(err, name):
        if err != 0:
            raise RuntimeError(f"earlier build's {name}: CUDA error {err}")

    def b7(ot, dt, alive, tables, page_size, ray_chunk, chunk_live=None,
           excl=None, any_hit=False):
        dev = ot.device
        R = ot.shape[1]
        out = torch.empty((16, R), dtype=torch.float32, device=dev)
        ok(lib.rt_trace_perlane(
            ot.data_ptr(), dt.data_ptr(), ot.stride(0), alive.data_ptr(), R,
            0 if excl is None else excl.data_ptr(), int(any_hit),
            tables.plt_i.data_ptr(), tables.plt_s.data_ptr(),
            tables.ab.data_ptr(), page_size, tables.ab.shape[0] // 128,
            ray_chunk, 0 if chunk_live is None else chunk_live.data_ptr(),
            out.data_ptr(), native.stream(dev)), "rt_trace_perlane")
        return out

    def b13(ot, dt, valid, blo, bhi, ray_chunk, chunk_live=None):
        dev = ot.device
        NP = blo.shape[0]
        NPpad = -(-NP // 128) * 128
        NC = ot.shape[1] // ray_chunk
        counts = torch.empty((NC,), dtype=torch.int32, device=dev)
        plist = torch.empty((NC, NPpad), dtype=torch.int32, device=dev)
        ptmin = torch.empty((NC, NPpad), dtype=torch.float32, device=dev)
        ok(lib.rt_cull_sorted(
            ot.data_ptr(), dt.data_ptr(), ot.stride(0), valid.data_ptr(),
            blo.data_ptr(), bhi.data_ptr(), NP, NPpad, NC, ray_chunk,
            0 if chunk_live is None else chunk_live.data_ptr(),
            counts.data_ptr(), plist.data_ptr(), ptmin.data_ptr(),
            native.stream(dev)), "rt_cull_sorted")
        return counts, plist, ptmin

    return {"trace_perlane": b7, "cull_sorted": b13}


def _occlusion(out):
    """Any-hit rows compared by their occlusion bit only (C5)."""
    return (out[1] != 0).to(torch.int32)


def ca0d7908_cases(dev, key, old):
    """What `--turns` times against commit a0d7908 (`old`: its wrappers):
    B7 on four whole waves, nearest rows bitwise between the builds and
    any-hit by the occlusion bit: the lit circles_2k wave-1 rows (B1, B6,
    the B1/B6 shadow pass and B8 on the camera wave), their shadow rays
    (any-hit with self-exclusion), the camera rays of the 4-bank sphere
    of `perlane_banks` and its wave-1 rays; the per-lane shadow pass
    (`shadow_mask_perlane`, B7's path) beside the B1/B6 one on the circles
    rows; B13 on the circles_2k and sphere camera waves beside the split
    form (B1, then `page_lists`) and B1 alone; and the default circles_2k
    render, whose path neither kernel is on.
    Returns (kernel cases: label -> {"fns": build -> fn, "same": the
    builds whose outputs must equal "new"'s, "key": what is compared},
    renderers: label -> (renderer, viewport), the live rays of each
    B7 wave)."""
    scene, vp = circles.build(resolution="2k", maxdepth=5)
    eng = Engine(scene, device=dev)
    P = eng.page_size
    R0 = vp.width * vp.height
    R = -(-R0 // RB) * RB
    o, d, alive, pk0 = eng._camera_rays(
        vp, eng_mod.pick_tile(vp.width, vp.height), R, None)
    alive = alive.to(torch.float32)[None]
    full0 = torch.cat([o, d, alive, alive, torch.zeros((8, R), device=dev)])
    lists = page_lists(*cull.cull_mask_exact(
        full0[0:3], full0[3:6], full0[7] != 0, eng.aabb_lo, eng.aabb_hi, RB))
    rows0 = intersect.trace_chunks(full0[0:3], full0[3:6], pk0, *lists, P,
                                   RB, zero_origin=True)
    shd0 = eng_mod.shadow_mask(full0, rows0, key, 0, False, LIGHT,
                               eng.aabb_lo, eng.aabb_hi, eng.PK, P, RB)
    ones = torch.ones(R // RB, dtype=torch.int32, device=dev)
    st1 = shade.shade(full0, rows0, fold_in(key, 0), RB, False, 1 / 512, ones,
                      shd0)
    del rows0, shd0, lists
    tb = eng.ptables
    ray1 = (st1[0:3], st1[3:6], st1[7], tb, P, RB)
    rows1 = intersect_perlane.trace_perlane(*ray1)
    so, sd, hit, excl = eng_mod.shadow_rays(st1, rows1, key, 1, False, LIGHT)
    sh1 = (so, sd, hit.float(), tb, P, RB)
    # the 4-bank sphere's camera rays and wave-1 rays
    b_eng, b_o, b_d, b_valid, _ = perlane_banks(dev, key)
    bP = b_eng.page_size
    b_alive = b_valid.to(torch.float32)[None]
    b_st0 = torch.cat([b_o, b_d, b_alive, b_alive,
                       torch.zeros((8, b_o.shape[1]), device=dev)])
    b_cam = (b_st0[0:3], b_st0[3:6], b_st0[7], b_eng.ptables, bP, RB)
    b_st1 = shade.shade(b_st0, intersect_perlane.trace_perlane(*b_cam),
                        fold_in(key, 0), RB, False, 1 / 512, ones)
    b_w1 = (b_st1[0:3], b_st1[3:6], b_st1[7], b_eng.ptables, bP, RB)

    def b7_case(args, kw):
        return {"fns": {
            "new": lambda: intersect_perlane.trace_perlane(*args, **kw),
            "earlier": lambda: old["trace_perlane"](*args, **kw)},
            "same": ("earlier",),
            "key": _occlusion if kw.get("any_hit") else None}

    cases = {
        "B7 nearest, lit circles_2k wave-1 rows": b7_case(ray1, {}),
        "B7 any-hit, their shadow rays": b7_case(
            sh1, {"excl": excl, "any_hit": True}),
        "B7 nearest, 4-bank sphere camera rays": b7_case(b_cam, {}),
        "B7 nearest, 4-bank sphere wave-1 rays": b7_case(b_w1, {})}

    spass = (st1, rows1, key, 1, False, LIGHT)

    def shadow_earlier():
        with patched(old):
            return eng_mod.shadow_mask_perlane(*spass, tb, P, RB)

    cases["per-lane shadow pass, lit circles_2k wave-1 rows"] = {
        "fns": {"new": lambda: eng_mod.shadow_mask_perlane(*spass, tb, P,
                                                           RB),
                "earlier": shadow_earlier,
                "B1/B6 pass": lambda: eng_mod.shadow_mask(
                    *spass, eng.aabb_lo, eng.aabb_hi, eng.PK, P, RB)},
        "same": ("earlier",), "key": None}
    for label, full in (
            ("circles_2k", (full0[0:3], full0[3:6], full0[7] != 0,
                            eng.aabb_lo, eng.aabb_hi, RB)),
            ("4-bank sphere", (b_o, b_d, b_valid, b_eng.aabb_lo,
                               b_eng.aabb_hi, RB))):
        cases[f"B13 {label} camera wave"] = {
            "fns": {"new": lambda a=full: cull.cull_sorted(*a),
                    "earlier": lambda a=full: old["cull_sorted"](*a),
                    "B1 + sort": lambda a=full: page_lists(
                        *cull.cull_mask_exact(*a)),
                    "B1 alone": lambda a=full: cull.cull_mask_exact(*a)},
            "same": ("earlier",), "key": None}
    live = {"lit circles_2k wave 1": int((st1[7] != 0).sum()),
            "their shadow rays": int(hit.sum()),
            "4-bank sphere camera rays": int(b_valid.sum()),
            "4-bank sphere wave 1": int((b_st1[7] != 0).sum())}
    return cases, {"circles_2k": (eng, vp)}, live


#: `--turns`'s table, the one part of it that names an earlier commit:
#: `commit`, whose csrc/ the tool builds (`git archive COMMIT
#: rust_raytrace_tpu_torch/csrc`); `entries`, the C entry points of that
#: build with their argument types (a0d7908's rt_trace_perlane takes the
#: per-lane tables); `wrap(lib)`, the port's wrappers of those entry
#: points; `patches`, the (module, name) under which the render paths look
#: the wrappers up; `kernels`, the kernel functions whose ptxas reports it
#: prints; `cases(dev, key, wrappers)`, what it times.  The next redesign
#: edits this table and the functions it names, not `turns`.
TURNS_AGAINST = SimpleNamespace(
    commit="a0d7908",
    entries={"rt_trace_perlane": [native.P, native.P, native.I64, native.P,
                                  native.I64, native.P, native.I32, native.P,
                                  native.P, native.P, native.I32, native.I32,
                                  native.I32, native.P, native.P, native.P],
             "rt_cull_sorted": native.CULL_SORTED.argtypes},
    wrap=ca0d7908_wrappers,
    patches=((eng_mod, "trace_perlane"), (cull, "cull_sorted")),
    kernels=("trace_perlane_kernel", "cull_sorted_kernel"),
    cases=ca0d7908_cases)


#: launches a `--turns` kernel timing averages
TURNS_REPS = 50


@contextlib.contextmanager
def patched(wrappers: dict):
    """The render paths launch `wrappers` (TURNS_AGAINST.wrap's) inside."""
    saved = [getattr(m, n) for m, n in TURNS_AGAINST.patches]
    for m, n in TURNS_AGAINST.patches:
        setattr(m, n, wrappers[n])
    try:
        yield
    finally:
        for (m, n), fn in zip(TURNS_AGAINST.patches, saved):
            setattr(m, n, fn)


def _words(out, rows, bitwise=True):
    """A wrapper's outputs as int32 words, on `rows` of each if given;
    bitwise=False: values (a -0 as +0, a bool as 0 or 1)."""
    outs = out if isinstance(out, tuple) else (out,)
    words = []
    for x in outs:
        x = (x if rows is None else x[..., rows]).reshape(-1)
        if not bitwise and x.dtype == torch.bool:
            x = x.to(torch.int32)
        elif not bitwise and x.is_floating_point():
            x = torch.where(x == 0, 0.0, x)
        words.append(x.view(torch.int32))
    return torch.cat(words)


def scene_build() -> int:
    """`--scene-build`: synthetic_1m_2k's host build, timed: the scene
    (make_triangles), then its Engine on the card (the KD page order, the
    pages and the streamed tables, uploaded)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = _card()
    lib_s = None
    if not os.environ.get("RUST_RAYTRACE_NO_NATIVE"):
        lib_s = host_native.build()["seconds"]
    native_ok = host_native.available()
    t0 = time.perf_counter()
    scene = synthetic_1m_scene()
    t1 = time.perf_counter()
    eng = Engine(scene, device=torch.device(DEVICE))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"synthetic_1m_2k host build ({'native scene pipeline' if native_ok else 'numpy'}, "
          f"calls {host_native.calls}): scene {t1 - t0:.3f} s, Engine "
          f"{t2 - t1:.3f} s, {len(scene.tris) - 1} triangles, "
          f"{eng.pages.num_pages} pages of {eng.page_size}; the library's "
          f"g++ build {lib_s} s [{card}]")
    return 0


def turns(csrc: Path, out: Path) -> int:
    """`--turns CSRC`: the kernels and renders of TURNS_AGAINST.cases in
    turns against a build of CSRC, the csrc/ of TURNS_AGAINST.commit, whose
    entry points TURNS_AGAINST binds; every other kernel is the
    checkout's in both builds.

    Kernels: each case first checks the outputs of the builds it names
    equal to the new build's, bit for bit or by the case's key (any-hit
    rows by the occlusion bit), then times every function of the case
    (the two builds and the case's other functions) with CUDA events,
    TURNS_REPS launches after a warm-up, in turns, two rounds, and each
    one's device time a call (`_device_ms`).  Renders (live RNG, key 0):
    best of three after a warm-up each round, the earlier build's kernels
    patched in; images byte-equal.  Prints the card, both builds' ptxas reports and
    every number, and writes them as JSON to `out`."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    T = TURNS_AGAINST
    dev = torch.device(DEVICE)
    card = _card()
    print(f"{card}; against commit {T.commit}")
    report = {"card": card, "commit": T.commit, "ptxas": {
        "new": _print_ptxas(native.build()["log"], "new", T.kernels)}}
    with tempfile.TemporaryDirectory() as tmp:
        built = native.build(csrc=csrc, build_dir=Path(tmp))
        lib = ctypes.CDLL(built["path"])
    report["ptxas"]["earlier"] = _print_ptxas(built["log"], "earlier",
                                              T.kernels)
    for name, argtypes in T.entries.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    old = T.wrap(lib)
    cases, renders, live = T.cases(dev, prng_key(7), old)
    report.update(live_rays=live, kernels={}, renders={})
    print(f"live rays: {live}")
    for label, case in cases.items():
        fns = case["fns"]
        key = case["key"] or (lambda x: _words(x, None))
        want = key(fns["new"]())
        for b in case["same"]:
            got = key(fns[b]())
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: {b} and new differ in "
                                     f"{int((got != want).sum())} words")
        # 50 launches a timing: the first launch's wrapper time (the
        # checkout's validates its arguments, the earlier build's bare
        # wrapper does not) falls inside the events and would otherwise
        # weigh on the mean
        tt = _in_turns(fns, reps=TURNS_REPS)
        dt = {b: _device_ms(fn) for b, fn in fns.items()}
        report["kernels"][label] = dict(tt, device_ms=dt)
        print(f"{label} (in turns, ms; {', '.join(case['same'])} equal to "
              f"new{' by the occlusion bit' if case['key'] else ''}): "
              + "; ".join(f"{b} {v[0]:.4f} / {v[1]:.4f}, device "
                          f"{dt[b]:.4f}" for b, v in tt.items())
              + f" [{card}]")

    def best_render(e, rvp):
        e.render(rvp)
        runs = [e.render(rvp) for _ in range(3)]
        return min(runs, key=lambda r: r.seconds)

    for label, (e, rvp) in renders.items():
        by = {"new": [], "earlier": []}
        images = {}
        for _ in range(2):
            r = best_render(e, rvp)
            with patched(old):
                r_old = best_render(e, rvp)
            for b, res in (("new", r), ("earlier", r_old)):
                by[b].append({"ms": res.seconds * 1e3,
                              "mrays_per_s": res.mrays_per_sec})
                images[b] = res.image
        if not np.array_equal(images["new"].view(np.uint8),
                              images["earlier"].view(np.uint8)):
            raise AssertionError(f"{label}: the two builds' images differ")
        report["renders"][label] = by
        print(f"{label} render (best of 3, in turns new, earlier, new, "
              f"earlier; images byte-equal): " + "; ".join(
                  f"{b} " + ", ".join(f"{x['ms']:.3f} ms ({x['mrays_per_s']:.3f}"
                                      " Mrays/s)" for x in v)
                  for b, v in by.items()) + f" [{card}]")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=Path, metavar="CSRC",
                    help="instead of the smoke run, time the kernels and "
                         "renders of TURNS_AGAINST in turns against a build "
                         "of CSRC, the csrc/ of its commit")
    ap.add_argument("--out", type=Path,
                    help="JSON file for the numbers of --turns (default "
                         "build/turns.json) or --counts (default "
                         "build/counts.json)")
    ap.add_argument("--scene-build", action="store_true",
                    help="instead of the smoke run, time synthetic_1m_2k's "
                         "host build")
    ap.add_argument("--counts", action="store_true",
                    help="instead of the smoke run, run B9's whole-wave "
                         "checks and its counting phase alone, on "
                         "synthetic_1m_2k")
    ap.add_argument("--distributed", action="store_true",
                    help="instead of the smoke run, run phase 6n alone: "
                         "the render across processes")
    ap.add_argument("--cli", nargs=argparse.REMAINDER, metavar="ARGV",
                    help="run the command line's main(ARGV) and print, as "
                         "the last line, what run_cli returns as JSON (the "
                         "smoke run starts its slow commands so)")
    args = ap.parse_args()
    try:
        if args.cli is not None:
            print(json.dumps(run_cli(args.cli)))
            rc = 0
        elif args.scene_build:
            rc = scene_build()
        elif args.counts:
            rc = counts_only(args.out or Path("build/counts.json"))
        elif args.distributed:
            rc = distributed_only()
        else:
            rc = main() if args.turns is None else turns(
                args.turns, args.out or Path("build/turns.json"))
    finally:
        for proc in _CHILDREN:
            proc.kill()
            proc.wait()
        for tmp in _SCRATCH:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
