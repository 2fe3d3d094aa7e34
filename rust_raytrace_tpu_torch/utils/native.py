"""Build, load and launch the port's CUDA kernels (`csrc/*.cu`).

Counterpart: `rust_raytrace_tpu/utils/native.py`, the on-demand g++ build of
the host scene pipeline bound through ctypes.  Here nvcc compiles every
CUDA source under `csrc/` (one process per source, in parallel) and links
them into one shared library with a plain C interface, at first use, into
`build/kernels/` at the repository root, named by a hash of the sources and
flags so an edit forces a rebuild.  The JAX package has no
build step of its own: Mosaic compiles each Pallas kernel inside
`pl.pallas_call`.

Each kernel is a `Kernel`: its C entry point, its argument types, the source
it lives in, the TPU kernel it replaces, and a count of the launches made
through it.  A C entry launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises if that is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
    "--prec-div=true", "--prec-sqrt=true", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
U32 = ctypes.c_uint
F32 = ctypes.c_float


def _sources(csrc: Path = CSRC) -> list:
    return sorted(p for p in Path(csrc).iterdir()
                  if p.suffix in (".cu", ".cuh"))


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir) / f"libraytrace-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> dict:
    """Compile the kernel library of the sources in `csrc` into
    `build_dir` unless the hashed build exists: one nvcc per source, all
    started together, then one link.

    Returns {"path", "seconds", "log"}: seconds is 0.0, and log the saved
    one, when the library was already built.  The compiler's `-Xptxas -v`
    report (registers, shared memory and spills per kernel) is the log."""
    so = library_path(csrc, build_dir)
    if so.exists():
        saved = so.with_suffix(".log")
        return {"path": str(so), "seconds": 0.0,
                "log": saved.read_text() if saved.exists() else ""}
    so.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in _sources(csrc):
        if src.suffix != ".cu":
            continue
        obj = so.parent / f"{tag}.{src.stem}.o"
        procs.append((obj, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(obj.name)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *(str(o) for o, _ in procs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append("link")
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(log)
    return {"path": str(so), "seconds": seconds, "log": log}


_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build()["path"])
    return _LIB


class Kernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


CULL = Kernel(
    "cull_mask_exact", "rt_cull",
    [P, P, I64, P, P, P, I32, I32, I32, P, P, P, P],
    "rust_raytrace_tpu_torch/csrc/cull.cu",
    "rust_raytrace_tpu/ops/cull_pallas.py:271")
TRACE_SHADE_UNION = Kernel(
    "trace_shade_chunks", "rt_trace_shade_union",
    [P, P, I64, P, I32, I32, P, P, P, U32, U32, I32, F32, I32, I32, P, P, P,
     P],
    "rust_raytrace_tpu_torch/csrc/trace_shade_union.cu",
    "rust_raytrace_tpu/ops/intersect_pallas.py:520")
TRACE_SHADE_PERLANE = Kernel(
    "trace_shade_perlane", "rt_trace_shade_perlane",
    [P, P, I64, P, P, P, I32, I32, I32, P, U32, U32, I32, F32, I32, F32, F32,
     F32, F32, P, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_shade_perlane.cu",
    "rust_raytrace_tpu/ops/intersect_perlane.py:772")
TRACE_UNION_ROWS = Kernel(
    "trace_chunks", "rt_trace_union_rows",
    [P, P, I64, I64, P, P, I32, I32, P, P, P, I32, I32, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_shade_union.cu",
    "rust_raytrace_tpu/ops/intersect_pallas.py:442")
SHADE = Kernel(
    "shade", "rt_shade",
    [P, P, P, I64, I32, P, P, U32, U32, I32, F32, P, P],
    "rust_raytrace_tpu_torch/csrc/shade.cu",
    "rust_raytrace_tpu/ops/shade.py:259")

COMPACT = Kernel(
    "compact", "rt_compact",
    [P, P, P, I64, I64, P, I32, P, P],
    "rust_raytrace_tpu_torch/csrc/compact.cu",
    "rust_raytrace_tpu/ops/compact.py:485")
EXPAND = Kernel(
    "expand", "rt_expand",
    [P, P, P, P, I32, I64, I64, P, I32, P, P],
    "rust_raytrace_tpu_torch/csrc/compact.cu",
    "rust_raytrace_tpu/ops/compact.py:640")

TRACE_SHADE_STREAMED = Kernel(
    "trace_shade_streamed", "rt_trace_shade_streamed",
    [P, P, I64, P, P, P, P, I32, I32, I32, P, U32, U32, I32, F32, P, P, P,
     P],
    "rust_raytrace_tpu_torch/csrc/trace_streamed.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:687")
#: B9's counting instance (chip_smoke.py's counting phase).  No render
#: path launches it, so it is not in KERNELS
TRACE_SHADE_STREAMED_COUNTS = Kernel(
    "trace_shade_streamed_counts", "rt_trace_shade_streamed_counts",
    [P, P, I64, P, P, P, P, I32, I32, I32, P, U32, U32, I32, F32, P, P, P,
     P, P],
    "rust_raytrace_tpu_torch/csrc/trace_streamed.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:687")
TRACE_STREAMED = Kernel(
    "trace_streamed", "rt_trace_streamed",
    [P, P, I64, P, I64, P, I32, P, P, P, I32, I32, I32, P, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_streamed.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:612")

NEAREST_HIT = Kernel(
    "nearest_hit", "rt_nearest_hit",
    [P, P, P, I64, P, I32, I32, P, P, P, P, P],
    "rust_raytrace_tpu_torch/csrc/nearest_hit.cu",
    "rust_raytrace_tpu/ops/intersect_pallas.py:163")

TRACE_PERLANE = Kernel(
    "trace_perlane", "rt_trace_perlane",
    [P, P, I64, P, I64, P, I32, P, P, P, P, I32, I32, I32, P, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_perlane.cu",
    "rust_raytrace_tpu/ops/intersect_perlane.py:679")

#: B12's three phases, one grid a call each (the sweep's is persistent
#: and walks every bank)
BM_PREP = Kernel(
    "bankmajor_prep", "rt_bm_prep",
    [P, I64, P, I32, I32, P, P, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_bankmajor.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:795")
BM_SWEEP = Kernel(
    "bankmajor_sweep", "rt_bm_sweep",
    [P, I64, P, P, P, P, P, P, P, I32, I32, I32, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_bankmajor.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:848")
BM_FINISH = Kernel(
    "bankmajor_finish", "rt_bm_finish",
    [P, P, I64, P, P, P, I32, I32, P, U32, U32, I32, F32, P, P],
    "rust_raytrace_tpu_torch/csrc/trace_bankmajor.cu",
    "rust_raytrace_tpu/ops/intersect_streamed.py:970")

#: B13, the cull with the page sort in the kernel; B14a and B14b, the
#: bucketed compaction and its inverse.  No render path launches them: the
#: JAX package calls neither its fused cull nor its bucketed compaction
CULL_SORTED = Kernel(
    "cull_sorted", "rt_cull_sorted",
    [P, P, I64, P, P, P, I32, I32, I32, I32, P, P, P, P, P],
    "rust_raytrace_tpu_torch/csrc/cull.cu",
    "rust_raytrace_tpu/ops/cull_pallas.py:122")
COMPACT_BUCKETS = Kernel(
    "compact_buckets", "rt_compact_buckets",
    [P, P, P, I64, I64, P, I32, P],
    "rust_raytrace_tpu_torch/csrc/compact_buckets.cu",
    "rust_raytrace_tpu/ops/compact.py:918")
EXPAND_BUCKETS = Kernel(
    "expand_buckets", "rt_expand_buckets",
    [P, P, P, P, I64, I64, P, I32, P],
    "rust_raytrace_tpu_torch/csrc/compact_buckets.cu",
    "rust_raytrace_tpu/ops/compact.py:1032")

#: the fp32 FMA-rate probe of `utils/roofline.measure_fp32_peak`, a
#: measurement of the card: no render path launches it, so it is not in
#: KERNELS
FMA_PEAK = Kernel(
    "fma_peak", "rt_fma_peak",
    [P, F32, F32, I32, I32, I32, I32, P],
    "rust_raytrace_tpu_torch/csrc/roofline.cu",
    "rust_raytrace_tpu/utils/roofline.py:39")

KERNELS = (CULL,TRACE_SHADE_UNION, COMPACT, TRACE_SHADE_PERLANE, EXPAND,
           TRACE_UNION_ROWS, SHADE, TRACE_SHADE_STREAMED, TRACE_STREAMED,
           NEAREST_HIT, TRACE_PERLANE, BM_PREP, BM_SWEEP, BM_FINISH,
           CULL_SORTED, COMPACT_BUCKETS, EXPAND_BUCKETS)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def require(ok: bool, msg: str) -> None:
    """Raise ValueError(msg) unless ok: wrappers validate what they pass."""
    if not ok:
        raise ValueError(msg)


#: the largest ray_chunk the kernels take: the JAX Engine's and `cli
#: tune`'s largest.  A kernel whose block is one chunk runs at most 1024
#: threads, each owning ceil(ray_chunk / 1024) of the chunk's rays.
MAX_RAY_CHUNK = 4096


#: the most banks the streamed kernels (B9, B10, B12's sweep) take: a
#: block of B9 or B10 stages every bank's AABB in shared memory, 32 B each
#: (128 KiB at the cap, within the 227 KiB a Hopper block may hold)
MAX_STREAMED_BANKS = 4096


def check_ray_chunk(R: int, ray_chunk: int) -> None:
    """Whole warps, at most MAX_RAY_CHUNK rays, dividing the ray count."""
    require(R % ray_chunk == 0 and ray_chunk % 32 == 0
            and 32 <= ray_chunk <= MAX_RAY_CHUNK,
            f"ray_chunk {ray_chunk} must be a multiple of 32 in "
            f"[32, {MAX_RAY_CHUNK}] dividing R = {R}")


def check_tensor(name: str, x, device, shape: tuple, dtype,
                 contiguous: bool = True) -> None:
    """A kernel argument's device, shape, dtype and layout (with
    contiguous=False only the last dim must be dense)."""
    dense = x.is_contiguous() if contiguous else x.stride(-1) == 1
    require(x.device == device and tuple(x.shape) == tuple(shape)
            and x.dtype == dtype and dense,
            f"{name}: want {dtype} {tuple(shape)} on {device} "
            f"({'contiguous' if contiguous else 'last dim dense'}), got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")


def stream(device) -> int:
    """The current CUDA stream of `device`, as the C entries take it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
