// B4: per-lane bounce trace fused with the shade.
//
// Replaces: rust_raytrace_tpu/ops/intersect_perlane.py:
// trace_shade_perlane_pallas (inner _kernel_fused, _trace_chunk, _group) —
// every ray gets its own page list from slab tests against the page AABBs
// of each bank of <= 128 pages, visits its pages nearest entry first,
// drops pages whose entry lies beyond its current best hit (within a bank
// and across banks), keeps the lexicographic (t, id) winner with its
// payload, and then shades the wave (B0b).  The optional shadow feeler
// (light=) is not ported.
//
// Bound on this card: latency of scattered reads.  Bounce rays are
// incoherent, so the threads of a warp test different pages; each triangle
// costs ~40 flops of predicate against 17 features read from the page
// tables (plt_i, 17 * P * 128 floats per bank, 487 KB at P = 56), which
// stay in global memory behind L1/L2: they do not fit the 227 KB of shared
// memory a block may use, and the whole table fits the 50 MB L2.
//
// Design: one thread per ray, blocks of 128.  Per bank a thread keeps a
// 128-bit mask of slab-hit pages in registers; each step recomputes the
// entry distance of the remaining pages, drops those beyond the best hit,
// and tests the nearest (ties to the lower page index), which is the visit
// order and cut of the TPU kernel's one-page-per-step loop.  The TPU's
// in-chunk count sort, PAGES_PER_STEP and bank gating only balanced
// 128-lane vector groups and are not carried over: winners do not depend on
// how rays are grouped.  Chunks whose rays have all retired (chunk_live)
// copy their state through.
#include "common.cuh"

namespace {

constexpr int GROUP = 128;   // pages per bank
constexpr int N_INT = 17;    // intersect features per triangle (plt_i)
constexpr int N_SHD = 7;     // shade features per triangle (plt_s)
constexpr int AB_LANES = 128;

__device__ __forceinline__ float page_tlo(const float* __restrict__ abb,
                                          int p, const float o[3],
                                          const float inv[3], float& thi) {
  const float* a = abb + p * AB_LANES;
  const float lo[3] = {a[0], a[1], a[2]};
  const float hi[3] = {a[3], a[4], a[5]};
  float tlo;
  rt::slab(lo, hi, o, inv, tlo, thi);
  return tlo;
}

__global__ void __launch_bounds__(128)
trace_shade_perlane_kernel(const float* __restrict__ st,
                           float* __restrict__ out, long long R,
                           const float* __restrict__ plt_i,
                           const float* __restrict__ plt_s,
                           const float* __restrict__ ab, int P, int NB,
                           int ray_chunk, const int* __restrict__ chunk_live,
                           uint32_t s0, uint32_t s1, bool fixed_rng,
                           float weight_cutoff,
                           const uint32_t* __restrict__ rsq) {
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
    uint32_t hit[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bits = 0;
      for (int j = 0; j < 32; ++j) {
        const int p = q * 32 + j;
        if (abb[p * AB_LANES + 6] == 0.0f) continue;   // padding page
        float thi;
        const float tlo = page_tlo(abb, p, o, inv, thi);
        if ((tlo <= thi) & (thi >= 0.0f)) bits |= 1u << j;
      }
      hit[q] = bits;
    }

    while (true) {
      // drop pages entered beyond the best hit; pick the nearest of the rest
      float kmin = rt::inf_f();
      int pidx = GROUP;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t m = hit[q];
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const int p = q * 32 + j;
          float thi;
          const float tlo = page_tlo(abb, p, o, inv, thi);
          if (tlo > w.t) {
            hit[q] &= ~(1u << j);
          } else if (tlo < kmin) {
            kmin = tlo;
            pidx = p;
          }
        }
      }
      if (pidx == GROUP) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q == (pidx >> 5)) hit[q] &= ~(1u << (pidx & 31));

      for (int j = 0; j < P; ++j) {
        const float* f = ti + (long long)j * GROUP + pidx;
        auto col = [f, P](int lane_f) {
          return f[(long long)lane_f * P * GROUP];
        };
        const rt::HitTerms h = rt::hit_predicate<false>(col, o, d);
        const float id = col(rt::LANE_ID);
        if (h.ok && rt::lex_better(h.t, id, w)) {
          const float* g = ts + (long long)j * GROUP + pidx;
          const long long fs = (long long)P * GROUP;
          w.t = h.t;
          w.id = id;
          w.n0 = col(rt::LANE_N);
          w.n1 = col(rt::LANE_N + 1);
          w.n2 = col(rt::LANE_N + 2);
          w.enc = rt::encode_face(h, g[0], g[fs]);
          w.c0 = g[2 * fs];
          w.c1 = g[3 * fs];
          w.c2 = g[4 * fs];
          w.alpha = g[5 * fs];
          w.scat = g[6 * fs];
        }
      }
    }
  }

  float rv[3], rv_inv;
  rt::scatter_rv(s0, s1, (uint32_t)chunk, (uint32_t)(r - chunk * ray_chunk),
                 ray_chunk, fixed_rng, rsq, rv, rv_inv);
  rt::shade_ray(s, w, rv, rv_inv, fixed_rng, weight_cutoff, rsq);
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
                                      float weight_cutoff, const unsigned* rsq,
                                      void* stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  trace_shade_perlane_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      st, out, R, plt_i, plt_s, ab, P, NB, ray_chunk, chunk_live, s0, s1,
      fixed_rng != 0, weight_cutoff, rsq);
  return (int)cudaGetLastError();
}
