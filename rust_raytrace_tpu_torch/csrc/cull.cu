// B1: exact packet cull, chunk-reduced; and B13: the same cull with the
// chunk's pages sorted front to back inside the kernel.
//
// Replaces: rust_raytrace_tpu/ops/cull_pallas.py:cull_mask_exact_pallas
// (inner _kernel and _slab_rows) — for each ray chunk and each page AABB,
// the slab test of every ray, OR-reduced into mask[chunk, page] and
// min-reduced over max(tlo, 0) into tmin[chunk, page] (+inf on a miss) —
// and cull_pallas.py:cull_sorted_pallas (inner _kernel_sorted): the same
// reduction with misses keyed BIGT, then every page ranked by (key, page
// index), so plist[chunk, rank] = page and ptmin[chunk, rank] = key, the
// chunk's hit count in counts[chunk], and a chunk that chunk_live marks
// dead given count 0, plist 0 and ptmin BIGT.  No render path launches
// B13: the JAX engine uses the split form (B1, then a sort in XLA), and so
// does the port's.
//
// Bound on this card: arithmetic and instruction throughput.  Each (ray,
// page) pair costs ~26 flops against 24 bytes of AABB that every thread of
// the block reads at the same address (an L1 broadcast); the rays are read
// once.  At the main path's 3,600 chunks x 1,024 rays x 37 pages that is
// ~3.5 GFLOP, far below a millisecond of the card's float rate, so launch
// and reduction overhead dominate.  B13's rank adds NPpad^2 comparisons a
// chunk, read from shared memory at one address per step (a broadcast).
//
// Design: one block per chunk, at most 1024 threads; a thread owns
// ceil(ray_chunk / 1024) rays of the chunk (1, 2 or 4; ray_chunk up to
// 4096), strided by the block size so that loads stay coalesced.  Pages
// run in tiles of 32: a thread folds its own rays, each warp then reduces
// a page with one ballot (OR) and a shuffle min and parks the result in
// shared memory; after the tile, one thread per page folds the warps.  The
// min of the entries does not depend on order (up to the sign of a zero
// entry, which B13 writes as +0 as the TPU kernel's one-hot sum does), so
// the result is deterministic.  B13 keeps the chunk's NPpad keys in
// shared memory (4 * NPpad bytes), and each thread ranks its pages with a
// loop over all keys: comparing floats, not their bits, so that -0 and +0
// tie as in the TPU kernel.  The TPU's bank pre-slab and 128-page padding
// only saved vector work on that chip and are not carried over: every page
// is tested.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int MAX_WARPS = 32;
constexpr float BIGT = 3.0e38f;    // B13's finite key of a missed page

// The rays a thread owns: slot s is lane s * blockDim + threadIdx.x of the
// chunk; slots past ray_chunk hold no ray.
template <int RPT>
struct ChunkRays {
  float o[RPT][3];
  float inv[RPT][3];
  bool v[RPT];
  bool in[RPT];
};

template <int RPT>
__device__ __forceinline__ ChunkRays<RPT> load_rays(
    const float* __restrict__ ot, const float* __restrict__ dt,
    long long ray_stride, const unsigned char* __restrict__ valid,
    int chunk, int ray_chunk) {
  ChunkRays<RPT> cr;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * blockDim.x + threadIdx.x;
    cr.in[s] = l < ray_chunk;
    const long long r = (long long)chunk * ray_chunk + (cr.in[s] ? l : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      cr.o[s][k] = ot[k * ray_stride + r];
      cr.inv[s][k] = rt::slab_inv(dt[k * ray_stride + r]);
    }
    cr.v[s] = cr.in[s] && valid[r] != 0;
  }
  return cr;
}

// Pages p0..p0+nt-1 against the chunk's rays: warp w's OR of the hits and
// min of the entries (max(tlo, 0) on a hit, `miss` on a miss) of page
// p0 + j land in s_any[w][j] and s_min[w][j].
template <int RPT>
__device__ __forceinline__ void reduce_tile(
    const ChunkRays<RPT>& cr, const float* __restrict__ lo,
    const float* __restrict__ hi, int p0, int nt, float miss,
    unsigned (*s_any)[TILE], float (*s_min)[TILE]) {
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < nt; ++j) {
    const int p = p0 + j;
    const float blo[3] = {lo[3 * p], lo[3 * p + 1], lo[3 * p + 2]};
    const float bhi[3] = {hi[3 * p], hi[3 * p + 1], hi[3 * p + 2]};
    bool any = false;
    float entry = rt::inf_f();
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      if (!cr.in[s]) continue;
      float tlo, thi;
      rt::slab(blo, bhi, cr.o[s], cr.inv[s], tlo, thi);
      const bool hit = (tlo <= thi) & (thi >= 0.0f) & cr.v[s];
      any |= hit;
      entry = fminf(entry, hit ? fmaxf(tlo, 0.0f) : miss);
    }
    const unsigned wany = __any_sync(0xffffffffu, any);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      entry = fminf(entry, __shfl_xor_sync(0xffffffffu, entry, off));
    if ((threadIdx.x & 31) == 0) {
      s_any[warp][j] = wany;
      s_min[warp][j] = entry;
    }
  }
}

// After reduce_tile and a barrier: page p0 + threadIdx.x's (hit, min).
__device__ __forceinline__ bool fold_page(unsigned (*s_any)[TILE],
                                          float (*s_min)[TILE], float& m) {
  const int nwarps = blockDim.x >> 5;
  unsigned any = 0;
  m = rt::inf_f();
  for (int w = 0; w < nwarps; ++w) {
    any |= s_any[w][threadIdx.x];
    m = fminf(m, s_min[w][threadIdx.x]);
  }
  return any != 0;
}

template <int RPT>
__global__ void __launch_bounds__(1024)
cull_kernel(const float* __restrict__ ot, const float* __restrict__ dt,
            long long ray_stride, const unsigned char* __restrict__ valid,
            const float* __restrict__ lo, const float* __restrict__ hi,
            int np, int ray_chunk, unsigned char* __restrict__ mask,
            float* __restrict__ tmin) {
  __shared__ unsigned s_any[MAX_WARPS][TILE];
  __shared__ float s_min[MAX_WARPS][TILE];
  const int chunk = blockIdx.x;
  const ChunkRays<RPT> cr =
      load_rays<RPT>(ot, dt, ray_stride, valid, chunk, ray_chunk);
  for (int p0 = 0; p0 < np; p0 += TILE) {
    const int nt = min(TILE, np - p0);
    reduce_tile<RPT>(cr, lo, hi, p0, nt, rt::inf_f(), s_any, s_min);
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float m;
      const bool any = fold_page(s_any, s_min, m);
      const long long out = (long long)chunk * np + p0 + threadIdx.x;
      mask[out] = any ? 1 : 0;
      tmin[out] = any ? m : rt::inf_f();
    }
    __syncthreads();
  }
}

template <int RPT>
__global__ void __launch_bounds__(1024)
cull_sorted_kernel(const float* __restrict__ ot, const float* __restrict__ dt,
                   long long ray_stride,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   int np, int npad, int ray_chunk,
                   const int* __restrict__ chunk_live,
                   int* __restrict__ counts, int* __restrict__ plist,
                   float* __restrict__ ptmin) {
  extern __shared__ float s_key[];             // [npad]
  __shared__ unsigned s_any[MAX_WARPS][TILE];
  __shared__ float s_min[MAX_WARPS][TILE];
  __shared__ int s_hits;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  int* pl = plist + (long long)chunk * npad;
  float* pt = ptmin + (long long)chunk * npad;
  if (chunk_live != nullptr && chunk_live[chunk] == 0) {
    for (int p = tid; p < npad; p += blockDim.x) {
      pl[p] = 0;
      pt[p] = BIGT;
    }
    if (tid == 0) counts[chunk] = 0;
    return;
  }
  if (tid == 0) s_hits = 0;
  const ChunkRays<RPT> cr =
      load_rays<RPT>(ot, dt, ray_stride, valid, chunk, ray_chunk);
  __syncthreads();
  for (int p0 = 0; p0 < np; p0 += TILE) {
    const int nt = min(TILE, np - p0);
    reduce_tile<RPT>(cr, lo, hi, p0, nt, BIGT, s_any, s_min);
    __syncthreads();
    if (tid < nt) {
      float m;
      const bool any = fold_page(s_any, s_min, m);
      s_key[p0 + tid] = any ? (m == 0.0f ? 0.0f : m) : BIGT;
      if (any) atomicAdd(&s_hits, 1);
    }
    __syncthreads();
  }
  for (int p = np + tid; p < npad; p += blockDim.x) s_key[p] = BIGT;
  __syncthreads();
  for (int p = tid; p < npad; p += blockDim.x) {
    const float k = s_key[p];
    int rank = 0;
    for (int q = 0; q < npad; ++q) {
      const float kq = s_key[q];
      rank += (kq < k) | ((kq == k) & (q < p));
    }
    pl[rank] = p;
    pt[rank] = k;
  }
  if (tid == 0) counts[chunk] = s_hits;
}

}  // namespace

extern "C" int rt_cull(const float* ot, const float* dt, long long ray_stride,
                       const unsigned char* valid, const float* lo,
                       const float* hi, int np, int nc, int ray_chunk,
                       unsigned char* mask, float* tmin, void* stream) {
  const rt::ChunkBlock b = rt::chunk_block(ray_chunk);
  auto kernel = b.rpt == 1 ? cull_kernel<1>
                           : (b.rpt == 2 ? cull_kernel<2> : cull_kernel<4>);
  kernel<<<nc, b.threads, 0, (cudaStream_t)stream>>>(
      ot, dt, ray_stride, valid, lo, hi, np, ray_chunk, mask, tmin);
  return (int)cudaGetLastError();
}

extern "C" int rt_cull_sorted(const float* ot, const float* dt,
                              long long ray_stride,
                              const unsigned char* valid, const float* lo,
                              const float* hi, int np, int npad, int nc,
                              int ray_chunk, const int* chunk_live,
                              int* counts, int* plist, float* ptmin,
                              void* stream) {
  const rt::ChunkBlock b = rt::chunk_block(ray_chunk);
  auto kernel = b.rpt == 1 ? cull_sorted_kernel<1>
                           : (b.rpt == 2 ? cull_sorted_kernel<2>
                                         : cull_sorted_kernel<4>);
  const size_t smem = (size_t)npad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<nc, b.threads, smem, (cudaStream_t)stream>>>(
      ot, dt, ray_stride, valid, lo, hi, np, npad, ray_chunk, chunk_live,
      counts, plist, ptmin);
  return (int)cudaGetLastError();
}
