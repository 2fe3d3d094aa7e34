"""One wave of shading from the trace winner rows, and B8, the standalone
shade.

Counterpart: `rust_raytrace_tpu/ops/shade.py` — `_unit3`, `scatter_rv`,
`shadow_uvs`, `_shade_state_rows` (the fused shade both JAX trace kernels
inline) and `shade_pallas` (B8, after an unfused trace: the lights path's
wave 0).  The CUDA kernels carry the same arithmetic as `__device__`
functions in `csrc/common.cuh` (`unit3`, `scatter_rv`, `shadow_uvs`,
`shade_ray`); every expression here keeps the association order written
there, so a kernel and its plain version agree bit for bit on the card.
`shade` runs the CUDA kernel `csrc/shade.cu` on CUDA tensors and
`shade_plain` on CPU tensors.

Three choices of the port:

- `fma(a, b, c)` fuses a multiply-add where XLA on the CPU fuses it when it
  compiles the JAX version (ROADMAP C2), and nowhere else; the CUDA sources
  call `fmaf` at the same places and are otherwise built with -fmad=false.
  The sites were read off the machine code XLA emits for the interpret-mode
  kernels (LLVM contracts a multiply into the add that consumes it, inside
  one fusion): the hit predicate's dot products and plane distances, the
  hit point o + t*d, the camera, and in the shade every sum of squares
  (`norm2`), the new origin p + 0.001*dir, the reflection
  d + 2*nf*|d.nf| + rv*scat and the matte direction nf + v*inv (the scatter
  vector's product is re-formed inside that fusion, so it fuses unrounded).
  XLA evaluates |d.nf| once per reflected component, in separate fusions,
  and the first one associates differently (`REFLECT_DOT`).
- `rsqrt(x)` is XLA-CPU's: this host's `rsqrtps` estimate followed by two
  Newton steps (ROADMAP C1, utils/xla_rsqrt.py), bitwise equal to
  `jax.lax.rsqrt` under jit on the same CPU.
- The scatter hash runs in int64 masked to 32 bits (torch has no wrapping
  uint32 multiply); products are split into 16-bit halves so that no
  intermediate leaves the int64 range.
"""

import numpy as np
import torch

from ..materials import KIND_MATTE, KIND_REFLECTIVE
from ..utils import native, xla_rsqrt
from .state import (ROW_ACC, ROW_ALIVE, ROW_ALPHA, ROW_COLOR, ROW_DEAD,
                    ROW_ENC, ROW_ID, ROW_NORM, ROW_SCAT, ROW_T, ROW_W,
                    STATE_ROWS)

#: sky color (128, 180, 255)/255, as float32 like the JAX constants
SKY = (128.0 / 255.0, 180.0 / 255.0, 255.0 / 255.0)

#: fixed_rng scatter vector: unit(0.36, 0.48, 0.8) == itself (3-4-5 scaled)
FIXED_RV = (0.36, 0.48, 0.8)

_M32 = 0xFFFFFFFF


def fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add a*b + c, rounded once (CUDA's fmaf).

    Operands are float32 tensors or Python floats, which are rounded to
    float32 first, as a float32 constant in the CUDA source is.  a*b is
    exact in float64; the float64 sum is rounded to odd (its exact error
    from TwoSum decides the last bit), and then to float32, which rounds the
    exact value correctly because float64 carries more than 24 + 1 bits."""
    a, b, c = (x.double() if torch.is_tensor(x)
               else float(np.float32(x)) for x in (a, b, c))
    p = a * b
    s = p + c
    pv = s - c                      # TwoSum: the part of s that is p's
    err = (p - pv) + (c - (s - pv))
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact, bits + step, bits).view(
        torch.float64).to(torch.float32)


def rsqrt(x: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """XLA-CPU's float32 rsqrt: this host's rsqrtps estimate (wide: the
    vrsqrt14ps estimate of a fusion XLA vectorizes 16 floats wide), then
    two Newton steps on positive normal inputs (utils/xla_rsqrt.py)."""
    est = xla_rsqrt.estimate_wide(x) if wide else xla_rsqrt.estimate(x)
    y = est
    for _ in range(2):
        y = fma(-0.5 * y, fma(x * y, y, -1.0), y)
    pos_normal = (x > 0.0) & (x < torch.inf) & (x.abs() >= 2.0 ** -126)
    return torch.where(pos_normal, y, est)


def norm2(v0, v1, v2):
    """v0*v0 + v1*v1 + v2*v2 as XLA contracts it inside a fusion:
    fma(v2, v2, fma(v0, v0, v1*v1))."""
    return fma(v2, v2, fma(v0, v0, v1 * v1))


def sum3(a, b):
    """a0*b0 + a1*b1 + a2*b2 as XLA-CPU compiles `jnp.sum(a * b, axis)`
    over an axis of three: x, y, z in order, each product fused into the
    running sum from +0: fma(a2, b2, fma(a1, b1, a0*b0 + 0)).  a, b: the
    three components each (a [3, ...] tensor or a sequence)."""
    return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0] + 0.0))


def unit_rows(v: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """Normalize [3, R] column vectors (`jnp.sum(v * v, axis=0)` is XLA's
    `sum3`, measured against the jitted camera).  wide: the rsqrt of a
    fusion XLA vectorizes 16 floats wide (C7)."""
    return v * rsqrt(sum3(v, v), wide)[None]


def unit3(v0, v1, v2):
    """Normalize a 3-vector given as three equal-shape tensors."""
    inv = rsqrt(norm2(v0, v1, v2))
    return v0 * inv, v1 * inv, v2 * inv


#: |d . nf| per reflected component k: fma(d2, nf2, fma(d_i, nf_i, d_j*nf_j))
#: with (i, j) = REFLECT_DOT[k]
REFLECT_DOT = ((1, 0), (0, 1), (0, 1))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(word, seed, chunk, salt: int = 0) -> torch.Tensor:
    """lowbias32 of (seed, chunk, word) plus `salt` (JAX: `_mix32`): a
    uniform in [0, 1) per element of the int64 tensors word and chunk."""
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


def scatter_uniforms(seed, rays: torch.Tensor, ray_chunk: int):
    """The three [0, 1) uniforms behind each ray's scatter vector.

    seed: the wave's two key words (`utils.rng.fold_in(key, wave)`).
    Component c of the ray at global position r is a lowbias32 hash of
    (seed, chunk = r // ray_chunk, word = c * ray_chunk + r % ray_chunk),
    exactly as the JAX kernels key it, so the chunk width is part of the
    stream's definition.  Returns three [n] float32 tensors.
    """
    rays = rays.to(torch.int64)
    chunk = rays // ray_chunk
    lane = rays % ray_chunk
    return tuple(_mix32(lane + comp * ray_chunk, seed, chunk)
                 for comp in range(3))


#: salts of the shadow feeler's jitter (JAX: `shadow_uvs`)
SALT_U3 = 0x7EE3D0B1
SALT_U1 = 0x51AB7F03


def shadow_uvs(seed, rays: torch.Tensor, ray_chunk: int, fixed_rng: bool):
    """The fused shadow feeler's jitter of the rays at global positions
    `rays`: (u3, u1), three [n] light-point offsets and one [n] origin
    offset, all in [0, 1).  Keyed as `scatter_uniforms`, with salts; u1's
    word is the lane alone.  Under fixed_rng every value is 0.5."""
    if fixed_rng:
        half = torch.full((rays.shape[0],), 0.5, dtype=torch.float32,
                          device=rays.device)
        return (half, half, half), half
    rays = rays.to(torch.int64)
    chunk = rays // ray_chunk
    lane = rays % ray_chunk
    u3 = tuple(_mix32(lane + comp * ray_chunk, seed, chunk, SALT_U3)
               for comp in range(3))
    return u3, _mix32(lane, seed, chunk, SALT_U1)


def scatter_rv(seed, rays: torch.Tensor, ray_chunk: int, fixed_rng: bool):
    """Scatter vector source (`random_vec`) for the rays at global
    positions `rays`: ((v0, v1, v2), inv) with the scatter vector
    rv = v * inv, v = u - 0.5 of `scatter_uniforms` and inv its rsqrt norm;
    under fixed_rng (FIXED_RV, None).  The shade takes both factors: the
    matte direction fuses nf + v*inv into one fma, and XLA folds the fixed
    vector's products into constants."""
    if fixed_rng:
        return (tuple(torch.full((rays.shape[0],), v, dtype=torch.float32,
                                 device=rays.device) for v in FIXED_RV),
                None)
    v = tuple(u - 0.5 for u in scatter_uniforms(seed, rays, ray_chunk))
    return v, rsqrt(norm2(*v))


def shade_state_rows(st, rows, rv, weight_cutoff: float, shd=None):
    """One wave's shade + scatter + state update.

    st: [16, n] ray state; rows: [16, n] trace winner rows; rv: the scatter
    source ((v0, v1, v2), inv) of `scatter_rv`, each [n]; shd: optional [n]
    shadow mask (nonzero: the hit point sees no light, and its color counts
    as black in both the terminal and the scatter contribution).  Returns
    the new [16, n] state.  Mirrors the JAX `_shade_state_rows` op for op,
    with XLA's contractions.
    """
    v, inv_v = rv
    weight = st[ROW_W]
    valid = st[ROW_ALIVE] != 0.0
    o0, o1, o2 = st[0], st[1], st[2]
    d0, d1, d2 = st[3], st[4], st[5]
    t = rows[ROW_T]
    miss = rows[ROW_ID] == 0.0
    n0, n1, n2 = rows[ROW_NORM], rows[ROW_NORM + 1], rows[ROW_NORM + 2]
    enc = rows[ROW_ENC]
    back = enc >= 8.0
    e2 = enc - torch.where(back, 8.0, 0.0)
    edge = e2 >= 4.0
    kind = e2 - torch.where(edge, 4.0, 0.0)
    c0, c1, c2 = rows[ROW_COLOR], rows[ROW_COLOR + 1], rows[ROW_COLOR + 2]
    if shd is not None:
        shadowed = shd != 0.0
        c0, c1, c2 = (torch.where(shadowed, 0.0, c) for c in (c0, c1, c2))
    alpha = rows[ROW_ALPHA]
    scat = rows[ROW_SCAT]

    nf0 = torch.where(back, -n0, n0)
    nf1 = torch.where(back, -n1, n1)
    nf2 = torch.where(back, -n2, n2)
    is_scatter = (~miss) & (~edge) & ((kind == KIND_MATTE)
                                      | (kind == KIND_REFLECTIVE))
    is_terminal = valid & ~is_scatter
    scatter_live = valid & is_scatter

    one_m_a = 1.0 - alpha
    contrib = []
    for c, sky in ((c0, SKY[0]), (c1, SKY[1]), (c2, SKY[2])):
        tc = torch.where(miss, sky, torch.where(edge, 0.0, c))
        contrib.append(torch.where(is_terminal, weight * tc, 0.0)
                       + torch.where(scatter_live, weight * c * one_m_a, 0.0))
    new_w = torch.where(scatter_live, weight * alpha, weight)

    d = (d0, d1, d2)
    nf = (nf0, nf1, nf2)
    p = [fma(t, dk, ok) for dk, ok in zip(d, (o0, o1, o2))]
    fixed = inv_v is None
    if fixed:                       # a constant vector: nothing to fuse
        rvs = list(v)
        m = unit3(*(nk + vk for vk, nk in zip(v, nf)))
    else:
        rvs = [vk * inv_v for vk in v]
        m = unit3(*(fma(vk, inv_v, nk) for vk, nk in zip(v, nf)))
    rx = []
    for k in range(3):
        i, j = REFLECT_DOT[k]
        ddot = torch.abs(fma(d2, nf2, fma(d[i], nf[i], d[j] * nf[j])))
        rx.append(fma(rvs[k], scat, fma(2.0 * nf[k], ddot, d[k])))
    r = unit3(*rx)
    is_matte = kind == KIND_MATTE
    nd = [torch.where(is_matte, mk, rk) for mk, rk in zip(m, r)]
    # the new origin p + 0.001*(matte ? rv : r): XLA hoists p out of the
    # select; with live RNG the product then fuses into the add, while under
    # fixed_rng the matte side is a folded constant and nothing fuses
    if fixed:
        no = [pk + torch.where(is_matte, rvk * 0.001, rk * 0.001)
              for rvk, rk, pk in zip(rvs, r, p)]
    else:
        no = [fma(torch.where(is_matte, rvk, rk), 0.001, pk)
              for rvk, rk, pk in zip(rvs, r, p)]

    alive2 = scatter_live
    if weight_cutoff > 0.0:
        alive2 = alive2 & (new_w > weight_cutoff)
    died = valid & ~alive2

    out = torch.empty((STATE_ROWS,) + weight.shape, dtype=st.dtype,
                      device=st.device)
    for k, (new, old) in enumerate(zip(no + nd, (o0, o1, o2, d0, d1, d2))):
        out[k] = torch.where(alive2, new, old)
    out[ROW_W] = new_w
    out[ROW_ALIVE] = alive2.to(st.dtype)
    for k in range(3):
        out[ROW_ACC + k] = st[ROW_ACC + k] + contrib[k]
    out[ROW_DEAD] = torch.maximum(st[ROW_DEAD], died.to(st.dtype))
    out[ROW_DEAD + 1:] = st[ROW_DEAD + 1:]
    return out


def shade_plain(state, rows, seed, ray_chunk: int, fixed_rng: bool,
                weight_cutoff: float, chunk_live, shadowed=None):
    """Plain torch version of `shade`."""
    rays = torch.arange(state.shape[1], device=state.device)
    rv = scatter_rv(seed, rays, ray_chunk, fixed_rng)
    new = shade_state_rows(state, rows, rv, weight_cutoff, shadowed)
    live = torch.repeat_interleave(chunk_live != 0, ray_chunk)
    return torch.where(live[None], new, state)


def shade(state, rows, seed, ray_chunk: int, fixed_rng: bool,
          weight_cutoff: float, chunk_live, shadowed=None):
    """One wave's shade + scatter + state update after an unfused trace.

    state: [16, R] float32 ray state; rows: [16, R] winner rows of the
    trace (`intersect.trace_chunks`); seed: the wave's two uint32 key
    words; ray_chunk: the RNG chunk width (scatter_rv); chunk_live: [NC]
    int32 flags, chunks flagged 0 pass their state through; shadowed:
    optional [R] float32 shadow mask (nonzero: shadowed).  Returns the new
    state.
    """
    dev = state.device
    if dev.type == "cpu":
        return shade_plain(state, rows, seed, ray_chunk, fixed_rng,
                           weight_cutoff, chunk_live, shadowed)
    native.require(dev.type == "cuda", f"shade: no kernel for device {dev}")
    R = state.shape[1]
    native.check_ray_chunk(R, ray_chunk)
    native.check_tensor("state", state, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("rows", rows, dev, (STATE_ROWS, R), torch.float32)
    native.check_tensor("chunk_live", chunk_live, dev, (R // ray_chunk,),
                        torch.int32)
    if shadowed is not None:
        native.check_tensor("shadowed", shadowed, dev, (R,), torch.float32)
    out = torch.empty_like(state)
    s0, s1 = (int(w) for w in seed)
    native.SHADE(
        state.data_ptr(), rows.data_ptr(), out.data_ptr(), R, ray_chunk,
        chunk_live.data_ptr(), 0 if shadowed is None else shadowed.data_ptr(),
        s0, s1, int(fixed_rng), float(weight_cutoff),
        xla_rsqrt.device_table(dev).data_ptr(), native.stream(dev))
    return out
