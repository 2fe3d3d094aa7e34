// B4: per-lane bounce trace fused with the shade.
//
// Replaces: rust_raytrace_tpu/ops/intersect_perlane.py:
// trace_shade_perlane_pallas (inner _kernel_fused, _trace_chunk, _group) —
// every ray gets its own page list from slab tests against the page AABBs
// of each bank of <= 128 pages, visits its pages nearest entry first,
// drops pages whose entry lies beyond its current best hit (within a bank
// and across banks), keeps the lexicographic (t, id) winner with its
// payload, and then shades the wave (B0b).  With a light, the shadow feeler
// runs between the two (_kernel_fused's has_lights): each hit ray builds its
// jittered ray to the light and an any-hit traversal of the same tables,
// with its own triangle excluded, decides whether its color counts as
// black.
//
// Bound on this card: latency of scattered reads.  Bounce rays are
// incoherent, so the threads of a warp test different pages; each triangle
// costs ~40 flops of predicate against 17 features read from the page
// tables (plt_i, 17 * P * 128 floats per bank, 487 KB at P = 56), which
// stay in global memory behind L1/L2: they do not fit the 227 KB of shared
// memory a block may use, and the whole table fits the 50 MB L2.
//
// Design: one thread per ray, blocks of 128.  Per bank a thread runs
// rt::bank_pass (perlane.cuh, shared with B9 and B10): it keeps a
// 128-bit mask of slab-hit pages in registers; each step recomputes the
// entry distance of the remaining pages, drops those beyond the best hit,
// and tests the nearest (ties to the lower page index), which is the visit
// order and cut of the TPU kernel's one-page-per-step loop.  The TPU's
// in-chunk count sort, PAGES_PER_STEP and bank gating only balanced
// 128-lane vector groups and are not carried over: winners do not depend on
// how rays are grouped.  Chunks whose rays have all retired (chunk_live)
// copy their state through.  The feeler visits a bank's slab-hit pages in
// index order and stops at the first triangle that hits: occlusion is
// order-free (ROADMAP C5), so this equals the TPU kernel's any-hit loop.  It
// is a function of its own, so its traversal state is dead before the
// shade.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::GROUP;
using rt::N_INT;
using rt::N_SHD;
using rt::page_tlo;

// Any-hit query of the shadow ray (so, sd): whether a triangle other than
// `excl` hits it at a finite t (the nearest-hit update's condition from an
// empty winner).
__device__ bool occluded(const float so[3], const float sd[3], float excl,
                         const float* __restrict__ plt_i,
                         const float* __restrict__ ab, int P, int NB) {
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = rt::slab_inv(sd[k]);
  for (int b = 0; b < NB; ++b) {
    const float* abb = ab + (long long)b * GROUP * AB_LANES;
    const float* ti = plt_i + (long long)b * N_INT * P * GROUP;
    for (int p = 0; p < GROUP; ++p) {
      if (abb[p * AB_LANES + 6] == 0.0f) continue;      // padding page
      float thi;
      const float tlo = page_tlo(abb, p, so, inv, thi);
      if (!((tlo <= thi) & (thi >= 0.0f))) continue;
      for (int j = 0; j < P; ++j) {
        const float* f = ti + (long long)j * GROUP + p;
        auto col = [f, P](int lane_f) {
          return f[(long long)lane_f * P * GROUP];
        };
        const rt::HitTerms h = rt::hit_predicate<false>(col, so, sd);
        if (h.ok && col(rt::LANE_ID) != excl && h.t < rt::inf_f())
          return true;
      }
    }
  }
  return false;
}

// LIGHT: run the shadow feeler (a template parameter, so the unlit kernel
// keeps its own register budget).
template <bool LIGHT>
__global__ void __launch_bounds__(128)
trace_shade_perlane_kernel(const float* __restrict__ st,
                           float* __restrict__ out, long long R,
                           const float* __restrict__ plt_i,
                           const float* __restrict__ plt_s,
                           const float* __restrict__ ab, int P, int NB,
                           int ray_chunk, const int* __restrict__ chunk_live,
                           uint32_t s0, uint32_t s1, bool fixed_rng,
                           float weight_cutoff, float lx, float ly,
                           float lz, float l2,
                           const uint32_t* __restrict__ rsq,
                           const uint32_t* __restrict__ rsq14) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long chunk = r / ray_chunk;
  float s[rt::STATE_ROWS];
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
  if (chunk_live[chunk] == 0) {
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
    return;
  }

  const float o[3] = {s[0], s[1], s[2]};
  const float d[3] = {s[3], s[4], s[5]};
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = rt::slab_inv(d[k]);
  const bool valid = s[rt::ROW_ALIVE] != 0.0f;
  rt::Winner w = rt::winner_init(valid);

  for (int b = 0; valid && b < NB; ++b) {
    const float* abb = ab + (long long)b * GROUP * AB_LANES;
    const float* ti = plt_i + (long long)b * N_INT * P * GROUP;
    const float* ts = plt_s + (long long)b * N_SHD * P * GROUP;
    rt::bank_pass<false, false>(abb, ti, ts, P, o, d, inv, 0.0f, w);
  }

  const uint32_t lane = (uint32_t)(r - chunk * ray_chunk);
  bool shadowed = false;
  if (LIGHT && valid && w.id != 0.0f) {
    // the jittered ray from the hit point to the light, with XLA's
    // contractions and, under fixed_rng, its 16-wide rsqrt (ROADMAP C7)
    const bool back = w.enc >= 8.0f;
    const float n[3] = {w.n0, w.n1, w.n2};
    const float l[3] = {lx, ly, lz};
    float u3[3], u1;
    rt::shadow_uvs(s0, s1, (uint32_t)chunk, lane, ray_chunk, fixed_rng, u3,
                   u1);
    float p[3], a[3], so[3], sd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = fmaf(w.t, d[k], o[k]);
      a[k] = fmaf(u3[k], l2, l[k]) - p[k];
    }
    const float n2 = rt::norm2(a[0], a[1], a[2]);
    const float inv = fixed_rng ? rt::rsqrt_xla_wide(n2, rsq14, rsq)
                                : rt::rsqrt_xla(n2, rsq);
    const float off = 0.005f * (u1 + 1.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sd[k] = a[k] * inv;
      so[k] = fmaf(back ? -n[k] : n[k], off, p[k]);
    }
    shadowed = occluded(so, sd, w.id, plt_i, ab, P, NB);
  }

  float rv[3], rv_inv;
  rt::scatter_rv(s0, s1, (uint32_t)chunk, lane, ray_chunk, fixed_rng, rsq, rv,
                 rv_inv);
  rt::shade_ray(s, w, rv, rv_inv, fixed_rng, weight_cutoff, shadowed, rsq);
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
}

}  // namespace

extern "C" int rt_trace_shade_perlane(const float* st, float* out,
                                      long long R, const float* plt_i,
                                      const float* plt_s, const float* ab,
                                      int P, int NB, int ray_chunk,
                                      const int* chunk_live, unsigned s0,
                                      unsigned s1, int fixed_rng,
                                      float weight_cutoff, int has_light,
                                      float lx, float ly, float lz, float l2,
                                      const unsigned* rsq,
                                      const unsigned* rsq14, void* stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  auto kernel = has_light ? trace_shade_perlane_kernel<true>
                          : trace_shade_perlane_kernel<false>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      st, out, R, plt_i, plt_s, ab, P, NB, ray_chunk, chunk_live, s0, s1,
      fixed_rng != 0, weight_cutoff, lx, ly, lz, l2, rsq, rsq14);
  return (int)cudaGetLastError();
}
