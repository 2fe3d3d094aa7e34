"""XLA-CPU's float32 rsqrt, reproduced bit for bit (ROADMAP C1).

The JAX package normalizes vectors with `jax.lax.rsqrt`, which XLA on the
CPU lowers to the x86 estimate `rsqrtps` refined by two Newton steps
`y = fma(-0.5*y, fma(x*y, y, -1), y)`; inputs that are not positive normal
numbers (zeros, subnormals, infinities, negatives) keep the bare estimate,
NaN takes the Newton steps.  The estimate is a table in the CPU that differs
between vendors, so `csrc/rsqrt_capture.c` reads it on this host at first
use: it is built with the host C compiler into `build/host/`, checks that
its model of the estimate (a 2,048-entry table over exponent parity and the
top 10 mantissa bits, scaled by the exponent, plus one estimate per special
class) holds on every float in [1, 4) and on samples of every other class,
and prints the table; it exits non-zero, and this module raises, when the
model does not describe the CPU.  Nothing falls back to 1/sqrt.  The words
are kept beside the binary, keyed by the CPU model, so the check runs once
per host rather than once per process.

`rsqrt` is the plain torch version; the CUDA kernels take `device_table`,
the same 2,055 words uploaded once per device, and compute the same
sequence in `csrc/common.cuh` (`rt::rsqrt_xla`).
"""

import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .native import BUILD_DIR, CSRC

SOURCE = CSRC / "rsqrt_capture.c"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
#: table entries, then one estimate per class in this order
TABLE_SIZE = 2048
CLASSES = ("+0", "-0", "+inf", "-inf", "+subnormal", "-subnormal", "-normal")
WORDS = TABLE_SIZE + len(CLASSES)


def _compiler() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("rsqrt table capture: no C compiler (set CC)")


def _binary() -> Path:
    """The capture program, compiled unless the hashed build exists."""
    if platform.machine() not in ("x86_64", "AMD64", "i686", "i386"):
        raise RuntimeError(
            f"rsqrt table capture: XLA-CPU's estimate is an x86 instruction; "
            f"this host is {platform.machine()}")
    cc = _compiler()
    h = hashlib.sha256(SOURCE.read_bytes() + cc.encode()).hexdigest()[:12]
    exe = HOST_BUILD_DIR / f"rsqrt_capture-{h}"
    if exe.exists():
        return exe
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc, "-O2", "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"rsqrt table capture: {cc} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, exe)
    return exe


def _cpu_id() -> str:
    """The CPU's vendor, family, model and stepping (the estimate is the
    silicon's), from /proc/cpuinfo where there is one."""
    fields = ("vendor_id", "cpu family", "model", "model name", "stepping")
    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
    except OSError:
        return platform.processor() or platform.machine()
    return "|".join(line.split(":", 1)[1].strip()
                    for line in first.splitlines()
                    if line.split(":", 1)[0].strip() in fields)


@functools.lru_cache(maxsize=None)
def host_table() -> np.ndarray:
    """The captured estimate words ([WORDS] uint32) of this host's CPU.

    The capture runs once per binary and CPU model: its words are kept
    beside the binary, keyed by both, and read back by later processes."""
    exe = _binary()
    cpu = hashlib.sha256(_cpu_id().encode()).hexdigest()[:12]
    cached = exe.with_name(f"{exe.name}-table-{cpu}.bin")
    if cached.exists():
        words = np.fromfile(cached, dtype="<u4")
    else:
        proc = subprocess.run([str(exe)], capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError("rsqrt table capture failed: "
                               + proc.stderr.decode(errors="replace"))
        words = np.frombuffer(proc.stdout, dtype="<u4")
        if words.size == WORDS:
            tmp = cached.with_name(f"{cached.name}.{os.getpid()}.tmp")
            words.tofile(tmp)
            os.replace(tmp, cached)
    if words.size != WORDS:
        raise RuntimeError(f"rsqrt table capture: {words.size} words, "
                           f"want {WORDS}")
    return words.astype(np.uint32)


_DEVICE_TABLES = {}


def device_table(device) -> torch.Tensor:
    """`host_table` as an int32 tensor on `device`, uploaded once."""
    device = torch.device(device)
    if device not in _DEVICE_TABLES:
        _DEVICE_TABLES[device] = torch.from_numpy(
            host_table().view(np.int32).copy()).to(device)
    return _DEVICE_TABLES[device]


def estimate(x: torch.Tensor) -> torch.Tensor:
    """rsqrtps(x) elementwise, from the captured table (float32)."""
    words = device_table(x.device)
    b = x.contiguous().view(torch.int32)
    mag = b & 0x7FFFFFFF
    neg = b < 0
    e = ((b >> 23) & 0xFF) - 127
    key = ((e & 1) << 10) | ((b >> 13) & 0x3FF)
    k = (e - (e & 1)) >> 1
    normal = (mag >= 0x00800000) & (mag < 0x7F800000)
    scaled = words[key.clamp(0, TABLE_SIZE - 1).long()] - (k << 23)

    def cls(pos: int, negative: int):
        return torch.where(neg, words[TABLE_SIZE + negative],
                           words[TABLE_SIZE + pos])

    special = torch.where(mag == 0, cls(0, 1),
                          torch.where(mag == 0x7F800000, cls(2, 3),
                                      cls(4, 5)))
    out = torch.where(normal, torch.where(neg, words[TABLE_SIZE + 6], scaled),
                      special)
    # NaN: the estimate is the quieted input
    out = torch.where(mag > 0x7F800000, b | 0x00400000, out)
    return out.view(torch.float32)
