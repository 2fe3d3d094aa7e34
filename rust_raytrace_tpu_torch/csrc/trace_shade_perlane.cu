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
// Bound on this card: issue and latency of the walk.  Bounce rays are
// incoherent, so the threads of a warp walk different pages; each
// triangle costs the hit predicate (~40 flops and an IEEE division), each
// bank visit a slab test of each of its pages.  The tables are small (at
// most 262,144 slots, 25 MB of records) and stay in L2.
//
// Design: one thread per ray, blocks of 128.  The resident tables are read
// page-major (rec, pab of ops/intersect_perlane.py:page_records, built on
// the device beside the per-lane tables that B7 and the plain versions
// read): per bank a thread runs rt::bank_walk (perlane.cuh, shared with
// B9, B10 and B12's sweep), which slab-tests the bank's pages once a visit
// (only up to the bank's last valid page, `extent`: the one bank of a small
// scene is mostly padding), keeps its nearest candidates in registers and
// reads a triangle as one 96-byte record, the payload included.  Its visit
// order and cut are the per-lane traversal's (the TPU kernel's
// one-page-per-step loop): the nearest remaining page (ties to the lower
// index), dropping pages entered beyond the best hit; banks in index
// order.  The TPU's in-chunk count sort, PAGES_PER_STEP and bank gating
// only balanced 128-lane vector groups and are not carried over: winners
// do not depend on how rays are grouped.  Chunks whose rays have all
// retired (chunk_live) copy their state through.  The feeler is
// rt::bank_walk's any-hit form with the winner excluded: nearest page
// first, it stops at the first triangle that hits; only the occlusion bit
// counts (ROADMAP C5), so it equals the TPU kernel's any-hit loop.  It is
// a function of its own, so its traversal state is dead before the shade.
#include "perlane.cuh"

namespace {

using rt::GROUP;
using rt::PAB4;
using rt::REC4;

// Any-hit query of the shadow ray (so, sd): whether a triangle other than
// `excl` hits it at a finite t (the nearest-hit update's condition from an
// empty winner).
__device__ bool occluded(const float so[3], const float sd[3], float excl,
                         const float4* __restrict__ rec,
                         const float4* __restrict__ pab,
                         const int* __restrict__ extent, int P, int NB) {
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = rt::slab_inv(sd[k]);
  rt::Winner w = rt::winner_init(true);
  for (int b = 0; b < NB; ++b) {
    rt::bank_walk<true, true>(pab + (long long)b * GROUP * PAB4,
                              rec + (long long)b * GROUP * P * REC4, P, so,
                              sd, inv, excl, w, 0, nullptr, extent[b]);
    if (w.id != 0.0f) return true;
  }
  return false;
}

// LIGHT: run the shadow feeler (a template parameter, so the unlit kernel
// keeps its own register budget).
template <bool LIGHT>
__global__ void __launch_bounds__(128)
trace_shade_perlane_kernel(const float* __restrict__ st,
                           float* __restrict__ out, long long R,
                           const float4* __restrict__ rec,
                           const float4* __restrict__ pab,
                           const int* __restrict__ extent, int P, int NB,
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

  for (int b = 0; valid && b < NB; ++b)
    rt::bank_walk<false, false>(pab + (long long)b * GROUP * PAB4,
                                rec + (long long)b * GROUP * P * REC4, P, o,
                                d, inv, 0.0f, w, 0, nullptr, extent[b]);

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
    shadowed = occluded(so, sd, w.id, rec, pab, extent, P, NB);
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
                                      long long R, const float* rec,
                                      const float* pab, const int* extent,
                                      int P, int NB, int ray_chunk,
                                      const int* chunk_live,
                                      unsigned s0, unsigned s1, int fixed_rng,
                                      float weight_cutoff, int has_light,
                                      float lx, float ly, float lz, float l2,
                                      const unsigned* rsq,
                                      const unsigned* rsq14, void* stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  auto kernel = has_light ? trace_shade_perlane_kernel<true>
                          : trace_shade_perlane_kernel<false>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      st, out, R, reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(pab), extent, P, NB, ray_chunk,
      chunk_live, s0, s1, fixed_rng != 0, weight_cutoff, lx, ly, lz, l2, rsq,
      rsq14);
  return (int)cudaGetLastError();
}
