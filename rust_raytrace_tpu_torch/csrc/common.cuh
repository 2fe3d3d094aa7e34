// Device functions shared by the port's kernels: the packed-triangle hit
// predicate (the JAX package's ops/intersect_pallas.py:packed_hit_predicate),
// the ray/page slab test (ops/cull_pallas.py:_slab_rows and
// ops/intersect_perlane.py:_slab), and one wave of shading with its scatter
// hash and the shadow feeler's jitter (ops/shade.py:_shade_state_rows,
// scatter_rv, shadow_uvs, _unit3).
//
// Every expression keeps the association order of the plain torch versions
// (rust_raytrace_tpu_torch/ops/*.py).  The library is compiled with
// -fmad=false --prec-div=true --prec-sqrt=true, so each * + - / sqrt rounds
// once, as a torch elementwise op does; multiply-adds are fused only by the
// explicit fmaf calls below, at the places where XLA fuses them when it
// compiles the JAX package (ROADMAP C2) and the plain versions call
// ops.shade.fma.  A kernel thus agrees with its plain version on the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// packed page lanes (rust_raytrace_tpu/ops/pages.py)
constexpr int LANE_N = 0;
constexpr int LANE_S0 = 3;
constexpr int LANE_S1 = 6;
constexpr int LANE_S2 = 9;
constexpr int LANE_NC = 12;
constexpr int LANE_S0C = 13;
constexpr int LANE_S1C = 14;
constexpr int LANE_S2C = 15;
constexpr int LANE_ID = 16;
constexpr int LANE_ET = 17;
constexpr int LANE_KIND = 18;
constexpr int LANE_COLOR = 19;
constexpr int LANE_ALPHA = 22;
constexpr int LANE_SCAT = 23;
constexpr int PACK_LANES = 128;
constexpr int USED_LANES = 24;     // lanes 24..127 of a page are zero

// trace winner rows and ray state rows (rust_raytrace_tpu_torch/ops/state.py)
constexpr int ROW_T = 0;
constexpr int ROW_ID = 1;
constexpr int ROW_NORM = 2;
constexpr int ROW_ENC = 5;
constexpr int ROW_COLOR = 6;
constexpr int ROW_ALPHA = 9;
constexpr int ROW_SCAT = 10;
constexpr int TRACE_ROWS = 16;
constexpr int ROW_W = 6;
constexpr int ROW_ALIVE = 7;
constexpr int ROW_ACC = 8;
constexpr int ROW_DEAD = 11;
constexpr int STATE_ROWS = 16;

constexpr float BIG = 1e30f;       // slab reciprocal for a zero direction
constexpr float KIND_MATTE = 1.0f;
constexpr float KIND_REFLECTIVE = 2.0f;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The block of a kernel whose block is one ray chunk: at most 1024 threads,
// whole warps, each thread owning rpt (1, 2 or 4) of the chunk's rays, lane
// s * threads + threadIdx.x for its slot s; slots past ray_chunk hold no
// ray (ray_chunk <= 4096, utils/native.py MAX_RAY_CHUNK).
struct ChunkBlock {
  int threads;
  int rpt;
};

inline ChunkBlock chunk_block(int ray_chunk) {
  const int rpt = ray_chunk <= 1024 ? 1 : (ray_chunk <= 2048 ? 2 : 4);
  const int per = (ray_chunk + rpt - 1) / rpt;
  return {(per + 31) / 32 * 32, rpt};
}

// Reciprocal direction for slab tests: +-BIG where a component is zero.
__device__ __forceinline__ float slab_inv(float d) {
  return d != 0.0f ? 1.0f / d : (d >= 0.0f ? BIG : -BIG);
}

// Slab interval of one AABB for one ray: t1/t2 per axis, min/max folded
// across axes in x, y, z order.
__device__ __forceinline__ void slab(const float lo[3], const float hi[3],
                                     const float o[3], const float inv[3],
                                     float& tlo, float& thi) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t1 = (lo[k] - o[k]) * inv[k];
    float t2 = (hi[k] - o[k]) * inv[k];
    float alo = fminf(t1, t2);
    float ahi = fmaxf(t1, t2);
    tlo = k == 0 ? alo : fmaxf(tlo, alo);
    thi = k == 0 ? ahi : fminf(thi, ahi);
  }
}

struct HitTerms {
  float t;
  float md_n;
  float dv0, dv1, dv2;
  bool ok;
};

// XLA's contraction of a*x + b*y + c*z: fma(c, z, fma(a, x, b*y)).
template <class Col>
__device__ __forceinline__ float dot3(const Col& col, int f, float r0,
                                      float r1, float r2) {
  return fmaf(col(f + 2), r2, fmaf(col(f), r0, col(f + 1) * r1));
}

// B0a: plane hit t = (n.c - n.o)/(n.d) and the three incenter half-plane
// distances dv_k <= 1 of one packed triangle.  ZERO_ORIGIN: the caller folded
// the o-dot terms into the NC/S*C lanes (fold_pages_origin).
template <bool ZERO_ORIGIN, class Col>
__device__ __forceinline__ HitTerms hit_predicate(const Col& col,
                                                  const float o[3],
                                                  const float d[3]) {
  HitTerms h;
  h.md_n = dot3(col, LANE_N, d[0], d[1], d[2]);
  float sd0 = dot3(col, LANE_S0, d[0], d[1], d[2]);
  float sd1 = dot3(col, LANE_S1, d[0], d[1], d[2]);
  float sd2 = dot3(col, LANE_S2, d[0], d[1], d[2]);
  if (ZERO_ORIGIN) {
    h.t = col(LANE_NC) / h.md_n;
    h.dv0 = fmaf(h.t, sd0, -col(LANE_S0C));
    h.dv1 = fmaf(h.t, sd1, -col(LANE_S1C));
    h.dv2 = fmaf(h.t, sd2, -col(LANE_S2C));
  } else {
    h.t = (col(LANE_NC) - dot3(col, LANE_N, o[0], o[1], o[2])) / h.md_n;
    h.dv0 = fmaf(h.t, sd0, dot3(col, LANE_S0, o[0], o[1], o[2]))
        - col(LANE_S0C);
    h.dv1 = fmaf(h.t, sd1, dot3(col, LANE_S1, o[0], o[1], o[2]))
        - col(LANE_S1C);
    h.dv2 = fmaf(h.t, sd2, dot3(col, LANE_S2, o[0], o[1], o[2]))
        - col(LANE_S2C);
  }
  h.ok = (h.t >= 0.0f) & (h.dv0 <= 1.0f) & (h.dv1 <= 1.0f) & (h.dv2 <= 1.0f);
  return h;
}

// The running winner of one ray and the payload the shade reads.
struct Winner {
  float t, id;
  float n0, n1, n2, enc, c0, c1, c2, alpha, scat;
};

// Invalid lanes start at -inf so that they never hold an early exit back.
__device__ __forceinline__ Winner winner_init(bool valid) {
  Winner w;
  w.t = valid ? inf_f() : -inf_f();
  w.id = w.n0 = w.n1 = w.n2 = w.enc = 0.0f;
  w.c0 = w.c1 = w.c2 = w.alpha = w.scat = 0.0f;
  return w;
}

// Winner rows [16, R] of ray r: t, id, the payload; rows 11..15 are 0.
// The TPU kernel extracts the payload as a one-hot masked sum over the
// page, which turns a -0 into +0; so does this store.
__device__ __forceinline__ void store_winner(const Winner& w,
                                             float* __restrict__ out,
                                             long long R, long long r) {
  const float v[11] = {w.t, w.id, w.n0, w.n1, w.n2, w.enc,
                       w.c0, w.c1, w.c2, w.alpha, w.scat};
  out[ROW_T * R + r] = v[0];
  out[ROW_ID * R + r] = v[1];
#pragma unroll
  for (int i = 2; i < 11; ++i) out[i * R + r] = v[i] == 0.0f ? 0.0f : v[i];
#pragma unroll
  for (int i = 11; i < TRACE_ROWS; ++i) out[i * R + r] = 0.0f;
}

// The winner of ray r from [16, R] winner rows.
__device__ __forceinline__ Winner load_winner(const float* __restrict__ rows,
                                              long long R, long long r) {
  Winner w;
  w.t = rows[ROW_T * R + r];
  w.id = rows[ROW_ID * R + r];
  w.n0 = rows[ROW_NORM * R + r];
  w.n1 = rows[(ROW_NORM + 1) * R + r];
  w.n2 = rows[(ROW_NORM + 2) * R + r];
  w.enc = rows[ROW_ENC * R + r];
  w.c0 = rows[ROW_COLOR * R + r];
  w.c1 = rows[(ROW_COLOR + 1) * R + r];
  w.c2 = rows[(ROW_COLOR + 2) * R + r];
  w.alpha = rows[ROW_ALPHA * R + r];
  w.scat = rows[ROW_SCAT * R + r];
  return w;
}

// Lexicographic (t, id) order: ties break to the smallest triangle id, and
// an infinite t never wins a tie, so visit order cannot change the winner.
__device__ __forceinline__ bool lex_better(float t, float id, const Winner& w) {
  return (t < w.t) | ((t == w.t) & !isinf(t) & (id < w.id));
}

// enc = kind + 4*edge + 8*back of a winning triangle.
__device__ __forceinline__ float encode_face(const HitTerms& h, float et,
                                             float kind) {
  float inv_et = 1.0f - et;
  bool edge = (h.dv0 > inv_et) | (h.dv1 > inv_et) | (h.dv2 > inv_et);
  bool back = h.md_n > 0.0f;
  return kind + 4.0f * (edge ? 1.0f : 0.0f) + 8.0f * (back ? 1.0f : 0.0f);
}

// XLA-CPU's float32 rsqrt (ROADMAP C1; utils/xla_rsqrt.py): the host CPU's
// rsqrtps estimate from the captured table `rsq` (2,048 entries over
// exponent parity and the top 10 mantissa bits, then the estimates of +0,
// -0, +inf, -inf, +subnormal, -subnormal, -normal), refined by two Newton
// steps on positive normal inputs only.
constexpr int RSQ_TABLE = 2048;

__device__ __forceinline__ float rsqrt_newton(float x, float y) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    y = fmaf(-0.5f * y, fmaf(x * y, y, -1.0f), y);
  return y;
}

__device__ __forceinline__ float rsqrt_xla(float x,
                                           const uint32_t* __restrict__ rsq) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t mag = b & 0x7FFFFFFFu;
  const bool neg = (b >> 31) != 0;
  if (mag > 0x7F800000u) return __uint_as_float(b | 0x00400000u);  // NaN
  if (mag < 0x00800000u)                   // zero or subnormal
    return __uint_as_float(rsq[RSQ_TABLE + (mag == 0 ? 0 : 4) + neg]);
  if (mag == 0x7F800000u) return __uint_as_float(rsq[RSQ_TABLE + 2 + neg]);
  if (neg) return __uint_as_float(rsq[RSQ_TABLE + 6]);
  const int e = (int)(b >> 23) - 127;
  const uint32_t key = ((uint32_t)(e & 1) << 10) | ((b >> 13) & 0x3FFu);
  const int k = (e - (e & 1)) / 2;
  return rsqrt_newton(
      x, __uint_as_float(__ldg(rsq + key) - (uint32_t)(k * (1 << 23))));
}

// The same where XLA vectorizes the fusion 16 floats wide (ROADMAP C7): the
// vrsqrt14ps estimate from its captured table `rsq14` (2^24 entries over
// exponent parity and the whole mantissa, then the estimates of +0, -0,
// +inf, -inf, -subnormal, -normal); a positive subnormal is estimated at
// x * 2^64 and scaled by 2^32.  rsq14 null (a host CPU without AVX-512F):
// the rsqrtps sequence.
constexpr int RSQ14_TABLE = 1 << 24;

__device__ __forceinline__ float rsqrt_xla_wide(
    float x, const uint32_t* __restrict__ rsq14,
    const uint32_t* __restrict__ rsq) {
  if (rsq14 == nullptr) return rsqrt_xla(x, rsq);
  uint32_t b = __float_as_uint(x);
  const uint32_t mag = b & 0x7FFFFFFFu;
  const bool neg = (b >> 31) != 0;
  if (mag > 0x7F800000u) return __uint_as_float(b | 0x00400000u);  // NaN
  if (mag == 0) return __uint_as_float(rsq14[RSQ14_TABLE + neg]);
  if (mag == 0x7F800000u) return __uint_as_float(rsq14[RSQ14_TABLE + 2 + neg]);
  if (neg)
    return __uint_as_float(
        rsq14[RSQ14_TABLE + (mag < 0x00800000u ? 4 : 5)]);
  const bool sub = mag < 0x00800000u;
  if (sub) b = __float_as_uint(x * 18446744073709551616.0f);
  const int e = (int)(b >> 23) - 127;
  const uint32_t idx = ((uint32_t)(e & 1) << 23) | (b & 0x7FFFFFu);
  const int k = (e - (e & 1)) / 2;
  const uint32_t est = __ldg(rsq14 + idx) - (uint32_t)(k * (1 << 23))
      + (sub ? (32u << 23) : 0u);
  return sub ? __uint_as_float(est) : rsqrt_newton(x, __uint_as_float(est));
}

// v0*v0 + v1*v1 + v2*v2 as XLA contracts it: fma(v2, v2, fma(v0, v0, v1*v1)).
__device__ __forceinline__ float norm2(float v0, float v1, float v2) {
  return fmaf(v2, v2, fmaf(v0, v0, v1 * v1));
}

__device__ __forceinline__ void unit3(float& v0, float& v1, float& v2,
                                      const uint32_t* __restrict__ rsq) {
  float inv = rsqrt_xla(norm2(v0, v1, v2), rsq);
  v0 = v0 * inv;
  v1 = v1 * inv;
  v2 = v2 * inv;
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t word, uint32_t s0,
                                              uint32_t s1, uint32_t chunk,
                                              uint32_t salt = 0u) {
  uint32_t x = word ^ s1;
  x = x * 747796405u + s0 + chunk * 2654435761u + salt;
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// [0, 1) from the top 23 bits of a hash word
__device__ __forceinline__ float unit_float(uint32_t x) {
  return __uint_as_float((x >> 9) | 0x3F800000u) - 1.0f;
}

// Scatter source of the ray at (chunk, lane) of a ray_chunk-wide chunk:
// v = u - 0.5 and inv = rsqrt(|v|^2), the scatter vector being v * inv
// (ops/shade.py:scatter_rv).  fixed_rng: the fixed vector, inv unused.
__device__ __forceinline__ void scatter_rv(uint32_t s0, uint32_t s1,
                                           uint32_t chunk, uint32_t lane,
                                           uint32_t ray_chunk, bool fixed_rng,
                                           const uint32_t* __restrict__ rsq,
                                           float v[3], float& inv) {
  if (fixed_rng) {
    v[0] = 0.36f;
    v[1] = 0.48f;
    v[2] = 0.8f;
    inv = 1.0f;
    return;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = unit_float(lowbias32(c * ray_chunk + lane, s0, s1, chunk)) - 0.5f;
  }
  inv = rsqrt_xla(norm2(v[0], v[1], v[2]), rsq);
}

// The shadow feeler's jitter of the ray at (chunk, lane)
// (ops/shade.py:shadow_uvs): u3 offsets the point on the light, u1 the
// origin; 0.5 each under fixed_rng.
constexpr uint32_t SALT_U3 = 0x7EE3D0B1u;
constexpr uint32_t SALT_U1 = 0x51AB7F03u;

__device__ __forceinline__ void shadow_uvs(uint32_t s0, uint32_t s1,
                                           uint32_t chunk, uint32_t lane,
                                           uint32_t ray_chunk, bool fixed_rng,
                                           float u3[3], float& u1) {
  if (fixed_rng) {
    u3[0] = u3[1] = u3[2] = u1 = 0.5f;
    return;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    u3[c] = unit_float(lowbias32(c * ray_chunk + lane, s0, s1, chunk,
                                 SALT_U3));
  u1 = unit_float(lowbias32(lane, s0, s1, chunk, SALT_U1));
}

// |d . nf| for reflected component k: fma(d2, nf2, fma(d_i, nf_i,
// d_j*nf_j)), (i, j) = (1, 0) for k = 0 and (0, 1) otherwise
// (ops/shade.py:REFLECT_DOT).
__device__ __forceinline__ float reflect_dot(const float d[3],
                                             const float nf[3], int k) {
  const int i = k == 0 ? 1 : 0;
  const int j = 1 - i;
  return fabsf(fmaf(d[2], nf[2], fmaf(d[i], nf[i], d[j] * nf[j])));
}

// B0b: one wave's shade + scatter + state update of one ray, in place on
// its 16 state values.  v/inv: the scatter source (scatter_rv); shadowed:
// the hit point sees no light, so its color counts as black.
__device__ __forceinline__ void shade_ray(float s[STATE_ROWS], const Winner& w,
                                          const float v[3], float inv,
                                          bool fixed_rng, float weight_cutoff,
                                          bool shadowed,
                                          const uint32_t* __restrict__ rsq) {
  const float sky[3] = {128.0f / 255.0f, 180.0f / 255.0f, 255.0f / 255.0f};
  float weight = s[ROW_W];
  bool valid = s[ROW_ALIVE] != 0.0f;
  bool miss = w.id == 0.0f;
  bool back = w.enc >= 8.0f;
  float e2 = w.enc - (back ? 8.0f : 0.0f);
  bool edge = e2 >= 4.0f;
  float kind = e2 - (edge ? 4.0f : 0.0f);
  const float c[3] = {shadowed ? 0.0f : w.c0, shadowed ? 0.0f : w.c1,
                      shadowed ? 0.0f : w.c2};
  float nf[3] = {back ? -w.n0 : w.n0, back ? -w.n1 : w.n1,
                 back ? -w.n2 : w.n2};
  bool is_scatter = !miss & !edge & ((kind == KIND_MATTE) |
                                     (kind == KIND_REFLECTIVE));
  bool is_terminal = valid & !is_scatter;
  bool scatter_live = valid & is_scatter;

  float one_m_a = 1.0f - w.alpha;
  float contrib[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tc = miss ? sky[k] : (edge ? 0.0f : c[k]);
    contrib[k] = (is_terminal ? weight * tc : 0.0f)
        + (scatter_live ? weight * c[k] * one_m_a : 0.0f);
  }
  float new_w = scatter_live ? weight * w.alpha : weight;

  const float* o = s;
  const float* d = s + 3;
  float p[3], rv[3], m[3], r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = fmaf(w.t, d[k], o[k]);
  // fixed_rng: a constant vector, nothing to fuse
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rv[k] = fixed_rng ? v[k] : v[k] * inv;
    m[k] = fixed_rng ? nf[k] + v[k] : fmaf(v[k], inv, nf[k]);
  }
  unit3(m[0], m[1], m[2], rsq);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r[k] = fmaf(rv[k], w.scat,
                fmaf(2.0f * nf[k], reflect_dot(d, nf, k), d[k]));
  unit3(r[0], r[1], r[2], rsq);
  bool is_matte = kind == KIND_MATTE;

  bool alive2 = scatter_live;
  if (weight_cutoff > 0.0f) alive2 = alive2 & (new_w > weight_cutoff);
  bool died = valid & !alive2;

  if (alive2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // p + 0.001*(matte ? rv : r), fused with live RNG only (shade.py)
      float no = fixed_rng
          ? p[k] + (is_matte ? rv[k] * 0.001f : r[k] * 0.001f)
          : fmaf(is_matte ? rv[k] : r[k], 0.001f, p[k]);
      s[3 + k] = is_matte ? m[k] : r[k];
      s[k] = no;
    }
  }
  s[ROW_W] = new_w;
  s[ROW_ALIVE] = alive2 ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) s[ROW_ACC + k] = s[ROW_ACC + k] + contrib[k];
  s[ROW_DEAD] = fmaxf(s[ROW_DEAD], died ? 1.0f : 0.0f);
}

}  // namespace rt
