"""One wave of shading from the trace winner rows, in plain torch.

Counterpart: `rust_raytrace_tpu/ops/shade.py` — `_unit3`, `scatter_rv` and
`_shade_state_rows` (the fused shade both JAX trace kernels inline).  The CUDA
kernels carry the same arithmetic as `__device__` functions in
`csrc/common.cuh` (`unit3`, `scatter_rv`, `shade_ray`); every expression here
keeps the association order written there, so a kernel and its plain version
agree bit for bit on the card.

Three choices of the port:

- `fma(a, b, c)` fuses a multiply-add where XLA on the CPU fuses it when it
  compiles the JAX version (ROADMAP C2, measured against the interpret-mode
  kernels): in the hit predicate's dot products and plane distances, in the
  hit point o + t*d, and in the camera.  Everywhere else each op rounds.
  The CUDA sources call `fmaf` at the same places and are otherwise built
  with -fmad=false.
- `rsqrt(x)` is `1 / sqrt(x)`, two correctly rounded steps that torch on the
  CPU, torch on the card and `1.0f / sqrtf(x)` under nvcc's `--prec-div=true
  --prec-sqrt=true` all compute alike.  XLA on the CPU uses an AVX estimate
  refined by Newton steps, which differs from it by at most one ulp (C1), so
  new directions match the JAX package within ulps, not bitwise.
- The scatter hash runs in int64 masked to 32 bits (torch has no wrapping
  uint32 multiply); products are split into 16-bit halves so that no
  intermediate leaves the int64 range.
"""

import torch

from rust_raytrace_tpu.materials import KIND_MATTE, KIND_REFLECTIVE

from .state import (ROW_ACC, ROW_ALIVE, ROW_ALPHA, ROW_COLOR, ROW_DEAD,
                    ROW_ENC, ROW_ID, ROW_NORM, ROW_SCAT, ROW_T, ROW_W,
                    STATE_ROWS)

#: sky color (128, 180, 255)/255, as float32 like the JAX constants
SKY = (128.0 / 255.0, 180.0 / 255.0, 255.0 / 255.0)

#: fixed_rng scatter vector: unit(0.36, 0.48, 0.8) == itself (3-4-5 scaled)
FIXED_RV = (0.36, 0.48, 0.8)

_M32 = 0xFFFFFFFF


def fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c with the product unrounded: a*b is exact in float64,
    and the float64 sum rounded to float32 differs from a true fused
    multiply-add (CUDA's fmaf) only where the first rounding lands on a
    float32 tie."""
    a, b, c = (x.double() if torch.is_tensor(x) else x for x in (a, b, c))
    return (a * b + c).to(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.sqrt(x))


def unit3(v0, v1, v2):
    """Normalize a 3-vector given as three equal-shape tensors."""
    inv = rsqrt(v0 * v0 + v1 * v1 + v2 * v2)
    return v0 * inv, v1 * inv, v2 * inv


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def scatter_uniforms(seed, rays: torch.Tensor, ray_chunk: int):
    """The three [0, 1) uniforms behind each ray's scatter vector.

    seed: the wave's two key words (`utils.rng.fold_in(key, wave)`).
    Component c of the ray at global position r is a lowbias32 hash of
    (seed, chunk = r // ray_chunk, word = c * ray_chunk + r % ray_chunk),
    exactly as the JAX kernels key it, so the chunk width is part of the
    stream's definition.  Returns three [n] float32 tensors.
    """
    s0, s1 = (int(w) & _M32 for w in seed)
    rays = rays.to(torch.int64)
    chunk = rays // ray_chunk
    lane = rays % ray_chunk
    cterm = _mul32(chunk, 2654435761)
    out = []
    for comp in range(3):
        x = (lane + comp * ray_chunk) ^ s1
        x = (_mul32(x, 747796405) + s0 + cterm) & _M32
        for mul, sh in ((0xED5AD4BB, 17), (0xAC4C1B51, 11),
                        (0x31848BAB, 15)):
            x = x ^ (x >> sh)
            x = _mul32(x, mul)
        x = x ^ (x >> 14)
        bits = ((x >> 9) | 0x3F800000).to(torch.int32)
        out.append(bits.view(torch.float32) - 1.0)
    return tuple(out)


def scatter_rv(seed, rays: torch.Tensor, ray_chunk: int, fixed_rng: bool):
    """Scatter vectors (`random_vec`) for the rays at global positions
    `rays`: unit(u - 0.5) of `scatter_uniforms`, or the fixed vector.
    Returns three [n] float32 tensors."""
    if fixed_rng:
        return tuple(torch.full((rays.shape[0],), v, dtype=torch.float32,
                                device=rays.device) for v in FIXED_RV)
    return unit3(*(u - 0.5 for u in scatter_uniforms(seed, rays, ray_chunk)))


def shade_state_rows(st, rows, rv0, rv1, rv2, weight_cutoff: float):
    """One wave's shade + scatter + state update.

    st: [16, n] ray state; rows: [16, n] trace winner rows; rv*: [n] scatter
    source.  Returns the new [16, n] state.  Mirrors the JAX
    `_shade_state_rows` op for op.
    """
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

    p0 = fma(t, d0, o0)
    p1 = fma(t, d1, o1)
    p2 = fma(t, d2, o2)
    m0, m1, m2 = unit3(nf0 + rv0, nf1 + rv1, nf2 + rv2)
    ddot = torch.abs(d0 * nf0 + d1 * nf1 + d2 * nf2)
    r0, r1, r2 = unit3(d0 + 2.0 * nf0 * ddot + rv0 * scat,
                       d1 + 2.0 * nf1 * ddot + rv1 * scat,
                       d2 + 2.0 * nf2 * ddot + rv2 * scat)
    is_matte = kind == KIND_MATTE
    no = [torch.where(is_matte, p + rv * 0.001, p + r * 0.001)
          for p, rv, r in ((p0, rv0, r0), (p1, rv1, r1), (p2, rv2, r2))]
    nd = [torch.where(is_matte, m, r)
          for m, r in ((m0, r0), (m1, r1), (m2, r2))]

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
