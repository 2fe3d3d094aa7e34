"""The float rules of a frame: the exact fma, XLA-CPU's rsqrt, the
Threefry keys and draws, and the scatter hash.

The benchmark reference's frozen copy of the port's `ops/shade.py` helpers
(`fma`, `rsqrt`, `norm2`, `sum3`, `unit3`, the lowbias32 hash and the
scatter and feeler uniforms), `utils/rng.py` and `utils/xla_rsqrt.py`'s
narrow estimate.  The estimate is read off this host's CPU by the
reference's own copy of the capture program, `rsqrt_capture.c`, built with
the host C compiler into `build/rtbench/` of the checkout.

`lowered()` is the control of the benchmark's check: inside it `fma` is a
float32 multiply and add, rounded twice, and `rsqrt` is torch's, the
float32 arithmetic a port would reach for without the exactness rules.
"""

import contextlib
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
CAPTURE_SOURCE = _HERE / "rsqrt_capture.c"
BUILD_DIR = _HERE.parents[1] / "build" / "rtbench"
TABLE_SIZE = 2048
WORDS = TABLE_SIZE + 7

_M32 = 0xFFFFFFFF
_EXACT = [True]


@contextlib.contextmanager
def lowered():
    """Compute inside the block without the exactness rules (the control)."""
    _EXACT[0] = False
    try:
        yield
    finally:
        _EXACT[0] = True


def fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once: a*b is exact in float64, the float64
    sum is rounded to odd from its TwoSum error, then to float32."""
    if not _EXACT[0]:
        a, b, c = (x if torch.is_tensor(x) else float(np.float32(x))
                   for x in (a, b, c))
        return a * b + c
    a, b, c = (x.double() if torch.is_tensor(x)
               else float(np.float32(x)) for x in (a, b, c))
    p = a * b
    s = p + c
    pv = s - c
    err = (p - pv) + (c - (s - pv))
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact, bits + step, bits).view(
        torch.float64).to(torch.float32)


def _capture_words() -> np.ndarray:
    if platform.machine() not in ("x86_64", "AMD64"):
        raise RuntimeError(f"rsqrt capture: an x86 instruction; this host "
                           f"is {platform.machine()}")
    cc = next((shutil.which(n) for n in (os.environ.get("CC"), "cc", "gcc")
               if n and shutil.which(n)), None)
    if cc is None:
        raise RuntimeError("rsqrt capture: no C compiler (set CC)")
    h = hashlib.sha256(CAPTURE_SOURCE.read_bytes() + cc.encode()).hexdigest()
    exe = BUILD_DIR / f"rsqrt_capture-{h[:12]}"
    if not exe.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        subprocess.run([cc, "-O2", "-o", str(tmp), str(CAPTURE_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, exe)
    try:
        with open("/proc/cpuinfo") as f:
            cpu = f.read().split("\n\n")[0]
    except OSError:
        cpu = platform.processor()
    cached = exe.with_name(
        f"{exe.name}-{hashlib.sha256(cpu.encode()).hexdigest()[:12]}.bin")
    if cached.exists():
        words = np.fromfile(cached, dtype="<u4")
    else:
        proc = subprocess.run([str(exe)], capture_output=True, check=True)
        words = np.frombuffer(proc.stdout, dtype="<u4")
        tmp = cached.with_name(f"{cached.name}.{os.getpid()}.tmp")
        words.tofile(tmp)
        os.replace(tmp, cached)
    if words.size != WORDS:
        raise RuntimeError(f"rsqrt capture: {words.size} words, want {WORDS}")
    return words.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _table(device) -> torch.Tensor:
    return torch.from_numpy(_capture_words().view(np.int32).copy()).to(device)


def _estimate(x: torch.Tensor) -> torch.Tensor:
    """rsqrtps(x) from the captured table: 2,048 entries over exponent
    parity and the top 10 mantissa bits, scaled by the exponent, plus one
    estimate a special class; NaN quieted."""
    words = _table(x.device)
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
    out = torch.where(mag > 0x7F800000, b | 0x00400000, out)
    return out.view(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 rsqrt: the estimate, then two Newton steps on
    positive normal inputs."""
    if not _EXACT[0]:
        return torch.rsqrt(x)
    est = _estimate(x)
    y = est
    for _ in range(2):
        y = fma(-0.5 * y, fma(x * y, y, -1.0), y)
    pos_normal = (x > 0.0) & (x < torch.inf) & (x.abs() >= 2.0 ** -126)
    return torch.where(pos_normal, y, est)


def norm2(v0, v1, v2):
    """fma(v2, v2, fma(v0, v0, v1*v1))."""
    return fma(v2, v2, fma(v0, v0, v1 * v1))


def sum3(a, b):
    """fma(a2, b2, fma(a1, b1, a0*b0 + 0))."""
    return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0] + 0.0))


def unit3(v0, v1, v2):
    inv = rsqrt(norm2(v0, v1, v2))
    return v0 * inv, v1 * inv, v2 * inv


# Threefry-2x32 (Salmon et al., SC'11), jax.random's keys and draws

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0, x1) -> tuple:
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0, x1


def fold_in(key, data: int) -> np.ndarray:
    """jax.random.fold_in's key words: threefry2x32(key, (0, data))."""
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32))
    return np.asarray(threefry2x32(k0, k1, 0, int(data) & _M32),
                      dtype=np.uint32)


def uniform(key, shape: tuple, device) -> torch.Tensor:
    """jax.random.uniform(key, shape) (threefry partitionable): element i
    hashes (0, i), the xor of both words' top 23 bits a mantissa in
    [1, 2), less 1."""
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32))
    n = int(np.prod(shape))
    a, b = threefry2x32(k0, k1, 0, torch.arange(n, device=device))
    bits = (((a ^ b) >> 9) | 0x3F800000).to(torch.int32)
    return (bits.view(torch.float32) - 1.0).reshape(shape)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(word, seed, chunk, salt: int = 0) -> torch.Tensor:
    """lowbias32 of (seed, chunk, word) plus salt: a uniform in [0, 1)."""
    s0, s1 = (int(w) & _M32 for w in seed)
    x = word ^ s1
    x = (_mul32(x, 747796405) + s0 + _mul32(chunk, 2654435761)
         + salt) & _M32
    for mul, sh in ((0xED5AD4BB, 17), (0xAC4C1B51, 11), (0x31848BAB, 15)):
        x = x ^ (x >> sh)
        x = _mul32(x, mul)
    x = x ^ (x >> 14)
    bits = ((x >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


SALT_U3 = 0x7EE3D0B1
SALT_U1 = 0x51AB7F03


def scatter_rv(seed, rays: torch.Tensor, ray_chunk: int):
    """((v0, v1, v2), inv) of the rays at lanes `rays`: v = u - 0.5, u the
    hash of (seed, chunk = r // ray_chunk, word = c*ray_chunk + r %
    ray_chunk), inv its rsqrt norm."""
    rays = rays.to(torch.int64)
    chunk = rays // ray_chunk
    lane = rays % ray_chunk
    v = tuple(_mix32(lane + c * ray_chunk, seed, chunk) - 0.5
              for c in range(3))
    return v, rsqrt(norm2(*v))


def shadow_uvs(seed, rays: torch.Tensor, ray_chunk: int):
    """The bounce waves' shadow-feeler jitter: (u3, u1), keyed as the
    scatter hash with salts, u1's word the lane alone."""
    rays = rays.to(torch.int64)
    chunk = rays // ray_chunk
    lane = rays % ray_chunk
    u3 = tuple(_mix32(lane + c * ray_chunk, seed, chunk, SALT_U3)
               for c in range(3))
    return u3, _mix32(lane, seed, chunk, SALT_U1)
