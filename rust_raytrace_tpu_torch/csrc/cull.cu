// B1: exact packet cull, chunk-reduced.
//
// Replaces: rust_raytrace_tpu/ops/cull_pallas.py:cull_mask_exact_pallas
// (inner _kernel and _slab_rows) — for each ray chunk and each page AABB,
// the slab test of every ray, OR-reduced into mask[chunk, page] and
// min-reduced over max(tlo, 0) into tmin[chunk, page] (+inf on a miss).
//
// Bound on this card: arithmetic and instruction throughput.  Each (ray,
// page) pair costs ~20 flops against 24 bytes of AABB that every thread of
// the block reads at the same address (an L1 broadcast); the rays are read
// once.  At the
// main path's 3,600 chunks x 1,024 rays x 37 pages that is ~2.7 GFLOP, far
// below a millisecond of the card's float rate, so launch and reduction
// overhead dominate.
//
// Design: one block per chunk, one thread per ray (blockDim = ray_chunk, at
// most 1024).  Pages run in tiles of 32: each warp reduces a page with one
// ballot (mask) and a shuffle min (tmin) and parks the result in shared
// memory; after the tile, one thread per page folds the warps.  The min of
// non-negative floats does not depend on order, so the result is
// deterministic.  The TPU's bank pre-slab and 128-page padding only saved
// vector work on that chip and are not carried over: every page is tested.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int MAX_WARPS = 32;

__global__ void __launch_bounds__(1024)
cull_kernel(const float* __restrict__ ot, const float* __restrict__ dt,
            long long ray_stride, const unsigned char* __restrict__ valid,
            const float* __restrict__ lo, const float* __restrict__ hi,
            int np, unsigned char* __restrict__ mask,
            float* __restrict__ tmin) {
  __shared__ unsigned s_any[MAX_WARPS][TILE];
  __shared__ float s_min[MAX_WARPS][TILE];
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long r = (long long)chunk * blockDim.x + lane;

  float o[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ot[k * ray_stride + r];
    inv[k] = rt::slab_inv(dt[k * ray_stride + r]);
  }
  const bool v = valid[r] != 0;

  for (int p0 = 0; p0 < np; p0 += TILE) {
    const int nt = min(TILE, np - p0);
    for (int j = 0; j < nt; ++j) {
      const int p = p0 + j;
      const float blo[3] = {lo[3 * p], lo[3 * p + 1], lo[3 * p + 2]};
      const float bhi[3] = {hi[3 * p], hi[3 * p + 1], hi[3 * p + 2]};
      float tlo, thi;
      rt::slab(blo, bhi, o, inv, tlo, thi);
      const bool hit = (tlo <= thi) & (thi >= 0.0f) & v;
      float entry = hit ? fmaxf(tlo, 0.0f) : rt::inf_f();
      const unsigned any = __any_sync(0xffffffffu, hit);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        entry = fminf(entry, __shfl_xor_sync(0xffffffffu, entry, off));
      if ((lane & 31) == 0) {
        s_any[warp][j] = any;
        s_min[warp][j] = entry;
      }
    }
    __syncthreads();
    if (lane < nt) {
      unsigned any = 0;
      float m = rt::inf_f();
      for (int w = 0; w < nwarps; ++w) {
        any |= s_any[w][lane];
        m = fminf(m, s_min[w][lane]);
      }
      const long long out = (long long)chunk * np + p0 + lane;
      mask[out] = any ? 1 : 0;
      tmin[out] = any ? m : rt::inf_f();
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int rt_cull(const float* ot, const float* dt, long long ray_stride,
                       const unsigned char* valid, const float* lo,
                       const float* hi, int np, int nc, int ray_chunk,
                       unsigned char* mask, float* tmin, void* stream) {
  cull_kernel<<<nc, ray_chunk, 0, (cudaStream_t)stream>>>(
      ot, dt, ray_stride, valid, lo, hi, np, mask, tmin);
  return (int)cudaGetLastError();
}
