// B2: wave-0 union trace fused with the shade.
//
// Replaces: rust_raytrace_tpu/ops/intersect_pallas.py:trace_shade_chunks_pallas
// (inner _kernel_trace_shade and _trace_pages) — each ray chunk walks its
// culled pages plist[chunk, :counts[chunk]] front to back, keeps the
// lexicographic (t, id) winner of every ray with its payload (normal, enc,
// color, alpha, scattering), stops once every ray of the chunk has a hit
// nearer than the next page's entry bound ptmin, and then shades the wave
// (B0b) into the new ray state.
//
// Bound on this card: arithmetic.  A ray tests each triangle of each visited
// page (~40 flops of the hit predicate per pair) against features that every
// thread of the chunk shares; the state is read and written once (128 B per
// ray), so memory traffic is small next to the predicate work.
//
// Design: one block per chunk, one thread per ray (blockDim = ray_chunk, at
// most 1024).  The block stages each visited page's 24 used lanes (P x 24
// floats, 5.4 KB at P = 56) in shared memory, and all threads read each
// triangle at the same address (a broadcast).  Each thread keeps its winner
// in registers.  The early exit is chunk-wide as on the TPU:
// __syncthreads_and over the rays' "best < ptmin[k + 1]", so every ray of a
// chunk tests the same pages and the winners equal the TPU kernel's.
#include "common.cuh"

namespace {

template <bool ZERO_ORIGIN>
__global__ void __launch_bounds__(1024)
trace_shade_union_kernel(const float* __restrict__ st, float* __restrict__ out,
                         long long R, const float* __restrict__ pk, int P,
                         int NP, const int* __restrict__ counts,
                         const int* __restrict__ plist,
                         const float* __restrict__ ptmin, uint32_t s0,
                         uint32_t s1, bool fixed_rng, float weight_cutoff,
                         const uint32_t* __restrict__ rsq) {
  extern __shared__ float s_page[];            // [P][USED_LANES]
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x;
  const int rb = blockDim.x;
  const long long r = (long long)chunk * rb + lane;

  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = st[k * R + r];
    d[k] = st[(3 + k) * R + r];
  }
  const bool valid = (d[0] != 0.0f) | (d[1] != 0.0f) | (d[2] != 0.0f);
  rt::Winner w = rt::winner_init(valid);

  const int n = counts[chunk];
  const int* pl = plist + (long long)chunk * NP;
  const float* ptm = ptmin + (long long)chunk * NP;
  const int page_floats = P * rt::USED_LANES;
  for (int k = 0; k < n; ++k) {
    const float* page = pk + (long long)pl[k] * P * rt::PACK_LANES;
    __syncthreads();                           // previous page fully read
    for (int i = lane; i < page_floats; i += rb)
      s_page[i] = page[(i / rt::USED_LANES) * rt::PACK_LANES
                       + i % rt::USED_LANES];
    __syncthreads();
    for (int j = 0; j < P; ++j) {
      const float* f = s_page + j * rt::USED_LANES;
      auto col = [f](int lane_f) { return f[lane_f]; };
      const rt::HitTerms h = rt::hit_predicate<ZERO_ORIGIN>(col, o, d);
      const float id = f[rt::LANE_ID];
      if (h.ok && rt::lex_better(h.t, id, w)) {
        w.t = h.t;
        w.id = id;
        w.n0 = f[rt::LANE_N];
        w.n1 = f[rt::LANE_N + 1];
        w.n2 = f[rt::LANE_N + 2];
        w.enc = rt::encode_face(h, f[rt::LANE_ET], f[rt::LANE_KIND]);
        w.c0 = f[rt::LANE_COLOR];
        w.c1 = f[rt::LANE_COLOR + 1];
        w.c2 = f[rt::LANE_COLOR + 2];
        w.alpha = f[rt::LANE_ALPHA];
        w.scat = f[rt::LANE_SCAT];
      }
    }
    if (k + 1 < n && __syncthreads_and(w.t < ptm[k + 1])) break;
  }

  float s[rt::STATE_ROWS];
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
  float v[3], inv;
  rt::scatter_rv(s0, s1, chunk, lane, rb, fixed_rng, rsq, v, inv);
  rt::shade_ray(s, w, v, inv, fixed_rng, weight_cutoff, rsq);
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
}

template <bool ZERO_ORIGIN>
int launch(const float* st, float* out, long long R, const float* pk, int P,
           int NP, const int* counts, const int* plist, const float* ptmin,
           uint32_t s0, uint32_t s1, int fixed_rng, float weight_cutoff,
           int ray_chunk, const uint32_t* rsq, cudaStream_t stream) {
  const size_t smem = (size_t)P * rt::USED_LANES * sizeof(float);
  auto kernel = trace_shade_union_kernel<ZERO_ORIGIN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nc = (int)(R / ray_chunk);
  kernel<<<nc, ray_chunk, smem, stream>>>(st, out, R, pk, P, NP, counts,
                                          plist, ptmin, s0, s1,
                                          fixed_rng != 0, weight_cutoff, rsq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_trace_shade_union(const float* st, float* out, long long R,
                                    const float* pk, int P, int NP,
                                    const int* counts, const int* plist,
                                    const float* ptmin, unsigned s0,
                                    unsigned s1, int fixed_rng,
                                    float weight_cutoff, int zero_origin,
                                    int ray_chunk, const unsigned* rsq,
                                    void* stream) {
  auto fn = zero_origin ? launch<true> : launch<false>;
  return fn(st, out, R, pk, P, NP, counts, plist, ptmin, s0, s1, fixed_rng,
            weight_cutoff, ray_chunk, rsq, (cudaStream_t)stream);
}
