// B8: one wave's standalone shade after an unfused trace, with an optional
// shadow mask.
//
// Replaces: rust_raytrace_tpu/ops/shade.py:shade_pallas (inner _kernel) —
// per chunk of ray_chunk rays, the scatter hash of (seed, chunk, lane), the
// shade + scatter + state update (B0b) from the trace's winner rows, a
// shadowed lane's color counted as black; chunks flagged dead in chunk_live
// pass their state through.
//
// Bound on this card: bytes.  Each ray reads its 16 state and 11 winner
// floats and writes 16 (~170 B) for ~100 flops of shading and two rsqrt
// table reads.
//
// Design: one thread per ray, blocks of 128; state and rows are read and
// written row-major ([16, R]), so neighbouring threads touch neighbouring
// words of every row.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(128)
shade_kernel(const float* __restrict__ st, const float* __restrict__ rows,
             float* __restrict__ out, long long R, int ray_chunk,
             const int* __restrict__ chunk_live,
             const float* __restrict__ shadowed, uint32_t s0, uint32_t s1,
             bool fixed_rng, float weight_cutoff,
             const uint32_t* __restrict__ rsq) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long chunk = r / ray_chunk;
  float s[rt::STATE_ROWS];
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
  if (chunk_live[chunk] != 0) {
    const rt::Winner w = rt::load_winner(rows, R, r);
    float v[3], inv;
    rt::scatter_rv(s0, s1, (uint32_t)chunk, (uint32_t)(r - chunk * ray_chunk),
                   ray_chunk, fixed_rng, rsq, v, inv);
    const bool shd = shadowed != nullptr && shadowed[r] != 0.0f;
    rt::shade_ray(s, w, v, inv, fixed_rng, weight_cutoff, shd, rsq);
  }
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
}

}  // namespace

extern "C" int rt_shade(const float* st, const float* rows, float* out,
                        long long R, int ray_chunk, const int* chunk_live,
                        const float* shadowed, unsigned s0, unsigned s1,
                        int fixed_rng, float weight_cutoff,
                        const unsigned* rsq, void* stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  shade_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      st, rows, out, R, ray_chunk, chunk_live, shadowed, s0, s1,
      fixed_rng != 0, weight_cutoff, rsq);
  return (int)cudaGetLastError();
}
