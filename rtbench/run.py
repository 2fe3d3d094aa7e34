"""Run one cell of the benchmark once.

    python -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`, from the process's start to the first timed frame):
torch and the port are imported, the port's kernel and host libraries are
loaded from the build caches inside the checkout (`build/kernels/`,
`build/host/`; built there by the first run), the scene is built through
the port's API, the Engine made, and `traffic.WARMUP_FRAMES` frames
rendered (the first is a one-card Engine's planning frame); the seconds of
each phase are printed on standard error.  Then frames are rendered
back to back through `Engine.render(view, key=frame_key(seed, i))` (live
RNG, quantize=True) for `--seconds`; across processes each rank calls
`parallel.distributed.engine_render_distributed` and a frame ends when
rank 0 holds the image.  With `--trace 1` the window is profiled
(`torch.profiler`, at most `traffic.TRACE_FRAMES` frames) and the per-layer
metrics are reported in place of the end-to-end ones.

After the window the peak of device memory over the window is read, the
program's state freed, and the plain reference renders the checked frames again (`check`);
the numbers compared and their limits are the last lines on standard
error and the last key of the result, the one JSON line printed last on
standard output.  No result is printed, and the exit code is not 0, where
torch sees no card or fewer than the cell asks for, or where the process
holds `jax`, `jaxlib`, `flax` or the JAX package once the window has
closed.
"""

import time

_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from . import bench, check, profile, traffic  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "rust_raytrace_tpu")
_T_IMPORTS = time.time()


@dataclass
class Run:
    """What the metrics read: the window's frames (start, end, rays), the
    set-up seconds and the traced window (None untraced)."""

    frames: list
    setup_s: float
    trace: object = None


def banned_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: `rust_raytrace_tpu_torch` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def _cache_dirs() -> None:
    """Every kernel cache the process could use, at fixed paths inside the
    checkout (the port's own nvcc and host builds are there already)."""
    build = bench.ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))


def render_process(rank: int, cell_name: str, seed: int, seconds: float,
                   trace_frames: int, j: int, out_dir: str, t0: float,
                   bench_path: str, data_dir: str, phases: list,
                   device=None) -> None:
    """One process's part of a run: set-up, warm-up, the window, and a
    record of it in out_dir/rank<r>.pkl.  rank 0 of a one-card cell is the
    run's own process; across processes each rank is spawned with the
    default process group set up (nccl, one card each).  trace_frames: the
    most frames profiled, 0 untraced; j: the checked frame; phases: (name,
    time it ended) of the set-up before this call, from t0 on."""
    import numpy as np
    import torch

    from rust_raytrace_tpu_torch.engine import Engine

    phases = list(phases) + [("port_import", time.time())]
    cell = bench.load_cell(cell_name, Path(bench_path), Path(data_dir))
    tr = cell.traffic
    ranks = int(tr["ranks"])
    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    device = torch.device(device)
    if device.type == "cuda":
        from rust_raytrace_tpu_torch.utils import native, xla_rsqrt

        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        phases.append(("cuda_init", time.time()))
        native.library()
        phases.append(("kernel_library", time.time()))
        xla_rsqrt.host_table()
        xla_rsqrt.host_wide_table()
        phases.append(("rsqrt_table", time.time()))
    scene, view = bench.recipe(cell.config["recipe"]).build(
        cell.config, int(tr["spp"]), bool(tr["lit"]))
    phases.append(("scene", time.time()))
    engine = Engine(scene, device=device)
    phases.append(("engine", time.time()))
    if ranks > 1:
        import torch.distributed as dist

        from rust_raytrace_tpu_torch.parallel.distributed import (
            engine_render_distributed)

        flag_group = dist.new_group(backend="gloo")

        def frame(key):
            return engine_render_distributed(engine, view, key=key)

        def agree(go):
            flag = torch.tensor([int(go)], dtype=torch.int32)
            dist.broadcast(flag, src=0, group=flag_group)
            return bool(flag.item())
    else:
        agree = None

        def frame(key):
            return engine.render(view, key=key)

    planning = None
    for w in range(traffic.WARMUP_FRAMES):
        res = frame(traffic.frame_key(seed, j + w))
        if w == 0 and res.image is not None:
            planning = (res.image, np.asarray(res.wave_rays))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        phases.append((f"warmup{w}", time.time()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t0
    marks = [t0] + [t for _, t in phases]
    print(f"rtbench: rank {rank} set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f}" for (name, _), a, b
        in zip(phases, marks, marks[1:])), file=sys.stderr, flush=True)

    def render(i):
        return frame(traffic.frame_key(seed, i))

    prof = None
    if trace_frames:
        from torch.profiler import ProfilerActivity, record_function
        from torch.profiler import profile as torch_profile

        inner = render

        def render(i):
            with record_function(profile.FRAME_SPAN):
                return inner(i)

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = torch_profile(activities=acts)
        prof.__enter__()
    frames, attempted, failed, kept = traffic.closed_loop(
        render, seconds, j, trace_frames, agree, needs_image=rank == 0)
    rank_trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        rank_trace = profile.reduce(prof)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    record = {"rank": rank, "frames": frames, "attempted": attempted,
              "failed": failed, "setup_s": setup_s, "peak": peak,
              "banned": banned_modules(), "trace": rank_trace, "j": j,
              "planning": planning if rank == 0 else None,
              "kept": kept if rank == 0 else None}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(record, f)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             bench_path: Path = bench.ROOT / "BENCHMARK.json",
             data_dir: Path = bench.HERE, device=None, t0: float = None,
             phases: list = None):
    """Run a cell once; returns (the result line's dict, the JAX modules
    found loaded in any of the run's processes).
    device: None on the card(s); "cpu" drives a run without a card (the
    tests), the plain versions in place of the kernels.  t0, phases: the
    set-up's start and its phases so far (default: this module's import)."""
    import torch

    t0 = _T0 if t0 is None else t0
    cell = bench.load_cell(cell_name, bench_path, data_dir)
    ranks = int(cell.traffic["ranks"])
    out_dir = tempfile.mkdtemp(prefix="rtbench-")
    try:
        args = (cell_name, seed, seconds,
                traffic.TRACE_FRAMES if trace else 0,
                traffic.check_index(seed), out_dir, t0, str(bench_path),
                str(data_dir), phases or [("imports", _T_IMPORTS)], device)
        if ranks > 1:
            from rust_raytrace_tpu_torch.parallel.distributed import spawn
            from rust_raytrace_tpu_torch.utils import native

            if device is None:
                native.build()      # once, before the ranks load it
            spawn(render_process, ranks, args=args,
                  backend="nccl" if device is None else "gloo",
                  timeout=300.0)
        else:
            render_process(0, *args)
        recs = []
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    if device is None:
        torch.cuda.empty_cache()
    r0 = recs[0]
    ref_device = "cpu" if device is not None else "cuda:0"
    t_ref = time.perf_counter()
    numbers = check.compare(cell, seed, r0["j"], r0["planning"], r0["kept"],
                            ref_device)
    print(f"rtbench: {len(r0['frames'])} frames in the window; the reference "
          f"took {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    tr = None
    if trace:
        names = [ev[0] for r in recs for ev in r["trace"].device]
        tr = profile.Trace([r["trace"] for r in recs],
                           profile.port_kernel_ids(names, bench.ROOT))
    run = Run(r0["frames"], r0["setup_s"], tr)
    metrics = {}
    for m in cell.metrics:
        if m.per_layer != bool(trace):
            continue
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {"platform": "gpu" if device is None else str(device),
           "kind": (torch.cuda.get_device_name(0) if device is None
                    else str(device)),
           "count": ranks,
           "memory_peak_bytes": max(int(r["peak"]) for r in recs)}
    result = {"correct": check.correct(numbers) and r0["kept"] is not None,
              "attempted": r0["attempted"], "failed": r0["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(profile.busy_s(r) for r in tr.ranks) / ranks
        lo, hi = tr.ranks[0].window
        dev["window_s"] = hi - lo
        result["breakdown"] = profile.breakdown(tr.ranks[0])
    result["check"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                       for k in check.LIMITS}
    banned = sorted({m for r in recs for m in r["banned"]}
                    | set(banned_modules()))
    return result, banned


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rtbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _cache_dirs()
    import torch

    chips = bench.load_cell(a.workload).chips
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    phases = [("imports", _T_IMPORTS), ("card_probe", time.time())]
    if found < chips:
        print(f"rtbench: the cell {a.workload} needs {chips} CUDA card(s); "
              f"torch sees {found}", file=sys.stderr)
        return 2
    result, banned = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                              phases=phases)
    if banned:
        print(f"rtbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
