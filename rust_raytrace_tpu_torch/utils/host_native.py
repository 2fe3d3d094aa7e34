"""ctypes loader for the native C++ scene pipeline
(`rust_raytrace_tpu_torch/native/scene_pipeline.cc`).

Counterpart: `rust_raytrace_tpu/utils/native.py`.  The port keeps its own
copy of the source (byte for byte the JAX package's `native/
scene_pipeline.cc`), builds it with the same g++ flags and binds the same
entry points, so both packages build every scene with the same bits: the
triangle precompute of parts of 1,024 or more triangles
(`geometry.make_triangles`), the Morton and KD page orders
(`ops.pages.morton_order`, `kd_order`) and the octree
(`octree.build_bounding_box`).  The library is built at first use into
`build/host/libscene-<source hash>.so` at the repository root, written
under a temporary name and renamed into place, so that concurrent
processes never load a half-written file.  Every entry point has a numpy
fallback: `available()` gates use, the build falls back when g++ is
missing or fails, and RUST_RAYTRACE_NO_NATIVE=1 disables it, as it does in
the JAX package.

`utils/native.py` is the CUDA kernels' loader; this module is the host's.
"""

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "scene_pipeline.cc"
BUILD_DIR = _PKG.parent / "build" / "host"
#: the JAX package's flags: contraction off keeps the float32 order of the
#: numpy path
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
#: calls that took the C++ path, by entry point (callers read it to show
#: which path a build took)
calls = {"make_triangles": 0, "morton_order": 0, "kd_order": 0,
         "build_octree": 0}

F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """The shared library's path, keyed by the source's content hash."""
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libscene-{h}.so"


def build() -> dict:
    """Compile the library unless the hashed build exists.  Returns
    {"path", "seconds"} (seconds 0.0 when it was already built); raises
    RuntimeError when g++ is missing or fails."""
    so = library_path()
    if so.exists():
        return {"path": str(so), "seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("host_native: g++ not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host_native: g++ failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0}


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RUST_RAYTRACE_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(build()["path"])
    except (RuntimeError, OSError):
        return None
    lib.rt_make_triangles.argtypes = [F32P, ctypes.c_int64, F32P, F32P, F32P,
                                      F32P, F32P]
    lib.rt_morton_order.argtypes = [F32P, ctypes.c_int64, I64P]
    lib.rt_kd_order.argtypes = [F32P, ctypes.c_int64, ctypes.c_int64, I64P]
    lib.rt_build_octree.argtypes = [
        F32P, F32P, F32P, ctypes.c_int64, F32P, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.rt_build_octree.restype = ctypes.c_int32
    lib.rt_octree_fetch.argtypes = [F32P, F32P, I32P, I32P, I32P, I32P,
                                    I64P, I64P, I64P]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def make_triangles_native(points: np.ndarray):
    """C++ triangle precompute: (incenter, norm, sides, side_lens,
    bounding_r2), or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    incenter = np.empty((n, 3), np.float32)
    norm = np.empty((n, 3), np.float32)
    sides = np.empty((n, 3, 3), np.float32)
    side_lens = np.empty((n, 3), np.float32)
    r2 = np.empty(n, np.float32)
    calls["make_triangles"] += 1
    lib.rt_make_triangles(pts.reshape(n, 9), n, incenter, norm,
                          sides.reshape(n, 9), side_lens, r2)
    return incenter, norm, sides, side_lens, r2


def morton_order_native(incenter: np.ndarray):
    """C++ Morton page order (`ops.pages.morton_order`), or None."""
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(incenter, dtype=np.float32)
    n = inc.shape[0]
    out = np.empty(max(n - 1, 0), np.int64)
    calls["morton_order"] += 1
    lib.rt_morton_order(inc, n, out)
    return out


def kd_order_native(incenter: np.ndarray, page_size: int):
    """C++ KD page order (an exact behavioral copy of
    `ops.pages.kd_order`), or None."""
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(incenter, dtype=np.float32)
    n = inc.shape[0]
    out = np.empty(max(n - 1, 0), np.int64)
    calls["kd_order"] += 1
    lib.rt_kd_order(inc, n, int(page_size), out)
    return out


def build_octree_native(tris, orig, len2: float, maxdepth: int, minobjs: int):
    """C++ octree build: the flat node arrays, or None.

    A dict of node_orig [m, 3], node_len2 [m], node_depth [m],
    children_start [m], num_children [m], child_indices [e], leaf_start
    [m], leaf_count [m], leaf_tris [k] and root (int; negative when no
    triangle lies inside the root box)."""
    lib = _load()
    if lib is None:
        return None
    inc = np.ascontiguousarray(tris.incenter, dtype=np.float32)
    nrm = np.ascontiguousarray(tris.norm, dtype=np.float32)
    cor = np.ascontiguousarray(tris.corners, dtype=np.float32)
    n = inc.shape[0]
    o = np.ascontiguousarray(np.asarray(orig, dtype=np.float32))
    nn = ctypes.c_int64()
    nl = ctypes.c_int64()
    ne = ctypes.c_int64()
    calls["build_octree"] += 1
    root = lib.rt_build_octree(inc, nrm, cor.reshape(n, 9), n, o,
                               ctypes.c_float(len2), maxdepth, minobjs,
                               ctypes.byref(nn), ctypes.byref(nl),
                               ctypes.byref(ne))
    m, k, e = nn.value, nl.value, ne.value
    out = {
        "root": int(root),
        "node_orig": np.empty((m, 3), np.float32),
        "node_len2": np.empty(m, np.float32),
        "node_depth": np.empty(m, np.int32),
        "children_start": np.empty(m, np.int32),
        "num_children": np.empty(m, np.int32),
        "child_indices": np.empty(max(e, 1), np.int32),
        "leaf_start": np.empty(m, np.int64),
        "leaf_count": np.empty(m, np.int64),
        "leaf_tris": np.empty(max(k, 1), np.int64),
    }
    lib.rt_octree_fetch(out["node_orig"].reshape(m * 3), out["node_len2"],
                        out["node_depth"], out["children_start"],
                        out["num_children"], out["child_indices"],
                        out["leaf_start"], out["leaf_count"],
                        out["leaf_tris"])
    out["child_indices"] = out["child_indices"][:e]
    out["leaf_tris"] = out["leaf_tris"][:k]
    return out
