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
// Bound on this card: operations.  Each (ray, page) pair costs ~26 flops
// (no multiply-add among them) against 24 bytes of AABB that every thread
// of the block reads at one address; the rays are read once.  At the main
// path's 3,600 chunks x 1,024 rays x 37 pages that is ~3.5 GFLOP, 0.053 ms
// at the card's FMA-counted float rate.  What holds the kernel back is the
// ALU pipe, which runs at half the float rate: the slab's ten min/max, the
// entry's two, the hit's two compares and its fold come to ~15 of a pair's
// ~27 issued instructions (SASS; PERF.md).  B13's rank adds about h^2 +
// NPpad comparisons a chunk of h hit pages (NPpad^2 on the rare chunk that
// takes the all-pairs branch), read from shared memory at one address per
// step (a broadcast).
//
// Design: one block per chunk, RPT = 4 rays a thread (256 threads at
// ray_chunk 1024, 1024 at 4096), strided by the block size so that loads
// stay coalesced.  A chunk with no valid ray (one block-wide vote) writes
// mask 0 and tmin +inf without a slab test, and so does a chunk that the
// optional chunk_live flags mark 0 (the TPU kernel's chunk_live skip: the
// bounce waves of the union path, cull_pallas.py:271-277), before it loads
// a ray; the kernel without flags (wave 0) is a separate instance.  Pages
// run in tiles of 32, their boxes staged once a block in shared memory.  A thread folds its four rays into one (hit, entry) per
// page in registers, 16 pages at a time (the hit bits a page, not a ray;
// B1's miss entry is +inf, so its min is taken only on a hit); a
// transposed butterfly then leaves lane l of a warp with page l's minimum
// over the warp in 16 + 15 shuffles for 16 pages (the warp's OR of the hit
// bits is one __reduce_or_sync a tile), and after one barrier the first
// warp folds the block's warps, a page a lane.  The min of the entries
// does not depend on order (up to the sign of a zero entry, which B13
// writes as +0 as the TPU kernel's one-hot sum does), so the result is
// deterministic.  B13 runs B1's instance (FULL where B1 takes it) and B1's
// vote that skips a chunk with no valid ray (its keys all BIGT: count 0,
// plist in page order, ptmin BIGT).  Its keys and hit bits (one warp
// ballot a tile, no atomics) go to shared memory; a warp scan of the
// bits' popcounts gives the hit count h and each page's hit or missed
// pages before it.  Where every hit key is below BIGT (a hit key is the
// least max(tlo, 0) with a missing ray's BIGT in the min, so it reaches
// BIGT only where the rays that hit the page all enter it beyond), a
// missed or padding page takes rank h + the missed pages before it, with
// no comparison, and the hit pages, compacted in page order, rank among
// the h hit keys only: what the all-pairs (key, page) rank gives there.  A
// chunk whose vote finds a hit key not below BIGT (equal to it, beyond
// it, or NaN) takes the all-pairs rank over all NPpad keys instead, in
// the same kernel.  Both compare floats, not their bits, so that -0 and
// +0 tie as in the TPU kernel, and write plist and ptmin once each.  The
// TPU's bank pre-slab and 128-page padding only saved vector work on that
// chip and are not carried over: every page is tested.
#include "common.cuh"

namespace {

constexpr int RPT = 4;             // rays a thread
constexpr int TILE = 32;           // pages a tile
constexpr int HALF = 16;           // pages folded in registers at once
constexpr int MAX_WARPS = 32;
constexpr float BIGT = 3.0e38f;    // B13's finite key of a missed page

// The rays a thread owns: slot s is lane s * blockDim + threadIdx.x of the
// chunk; slots past ray_chunk hold no ray.
struct ChunkRays {
  float o[RPT][3];
  float inv[RPT][3];
  bool v[RPT];
  bool in[RPT];
};

template <bool FULL>
__device__ __forceinline__ ChunkRays load_rays(
    const float* __restrict__ ot, const float* __restrict__ dt,
    long long ray_stride, const unsigned char* __restrict__ valid,
    int chunk, int ray_chunk) {
  ChunkRays cr;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * blockDim.x + threadIdx.x;
    cr.in[s] = FULL || l < ray_chunk;
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

// Shared memory of one tile: the page boxes (lo, hi as two float4 a page)
// and each warp's hit bits and per-page minima.
struct TileSmem {
  float4 box[TILE][2];
  unsigned any[MAX_WARPS];
  float min[MAX_WARPS][TILE];
};

// Pages p0..p0+nt-1 against the chunk's rays, with `miss` the entry of a
// ray that misses (MISS_INF: miss is +inf, so a miss leaves the minimum as
// it is); every thread of the block calls it.  Returns, on thread
// t < nt, whether a valid ray of the chunk hits page p0 + t, and in m the
// min over the chunk's rays of max(tlo, 0) on a hit and `miss` on a miss.
// Two barriers: after the staging and before the fold.
template <bool FULL, bool MISS_INF>
__device__ __forceinline__ bool tile_reduce(const ChunkRays& cr,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            int p0, int nt, float miss,
                                            TileSmem& sm, float& m) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < nt) {
    const int p = p0 + tid;
    sm.box[tid][0] = make_float4(lo[3 * p], lo[3 * p + 1], lo[3 * p + 2],
                                 0.0f);
    sm.box[tid][1] = make_float4(hi[3 * p], hi[3 * p + 1], hi[3 * p + 2],
                                 0.0f);
  }
  __syncthreads();
  unsigned any = 0u;
#pragma unroll
  for (int h0 = 0; h0 < TILE; h0 += HALF) {
    float e[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      e[j] = rt::inf_f();
      if (h0 + j < nt) {
        const float4 a = sm.box[h0 + j][0], b = sm.box[h0 + j][1];
        const float blo[3] = {a.x, a.y, a.z};
        const float bhi[3] = {b.x, b.y, b.z};
        bool page_hit = false;
#pragma unroll
        for (int s = 0; s < RPT; ++s) {
          if (!FULL && !cr.in[s]) continue;
          float tlo, thi;
          rt::slab(blo, bhi, cr.o[s], cr.inv[s], tlo, thi);
          const bool hit = (tlo <= thi) & (thi >= 0.0f) & cr.v[s];
          page_hit |= hit;
          if (MISS_INF) {
            if (hit) e[j] = fminf(e[j], fmaxf(tlo, 0.0f));
          } else {
            e[j] = fminf(e[j], hit ? fmaxf(tlo, 0.0f) : miss);
          }
        }
        any |= page_hit ? 1u << (h0 + j) : 0u;
      }
    }
    // fold lane l with lane l ^ 16, then a transposed butterfly over lane
    // bits 3..0: lane l ends with page h0 + (l & 15)'s minimum of the warp
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      e[j] = fminf(e[j], __shfl_xor_sync(0xffffffffu, e[j], 16));
#pragma unroll
    for (int b = HALF / 2; b >= 1; b >>= 1) {
      const bool up = (lane & b) != 0;
#pragma unroll
      for (int i = 0; i < b; ++i) {
        const float send = up ? e[i] : e[i + b];
        const float keep = up ? e[i + b] : e[i];
        e[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, b));
      }
    }
    if (lane < HALF) sm.min[warp][h0 + lane] = e[0];
  }
  any = __reduce_or_sync(0xffffffffu, any);
  if (lane == 0) sm.any[warp] = any;
  __syncthreads();
  bool hit = false;
  m = rt::inf_f();
  if (tid < nt) {
    const int nwarps = blockDim.x >> 5;
    unsigned bits = 0u;
    float m2 = rt::inf_f();
    for (int w = 0; w < nwarps; w += 2) {      // two chains, whole warps
      bits |= sm.any[w] | sm.any[w + 1 < nwarps ? w + 1 : w];
      m = fminf(m, sm.min[w][tid]);
      m2 = fminf(m2, sm.min[w + 1 < nwarps ? w + 1 : w][tid]);
    }
    m = fminf(m, m2);
    hit = (bits >> tid) & 1u;
  }
  return hit;
}

// Mask 0 and tmin +inf for every page of a chunk that hits none.
__device__ __forceinline__ void empty_chunk(int chunk, int np,
                                            unsigned char* __restrict__ mask,
                                            float* __restrict__ tmin) {
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    mask[(long long)chunk * np + p] = 0;
    tmin[(long long)chunk * np + p] = rt::inf_f();
  }
}

// FULL: every slot holds a ray (ray_chunk a multiple of RPT * 32).  FLAGS:
// chunk_live[chunk] == 0 skips the chunk.
template <bool FULL, bool FLAGS>
__global__ void __launch_bounds__(1024)
cull_kernel(const float* __restrict__ ot, const float* __restrict__ dt,
            long long ray_stride, const unsigned char* __restrict__ valid,
            const float* __restrict__ lo, const float* __restrict__ hi,
            int np, int ray_chunk, const int* __restrict__ chunk_live,
            unsigned char* __restrict__ mask, float* __restrict__ tmin) {
  __shared__ TileSmem sm;
  const int chunk = blockIdx.x;
  if (FLAGS && chunk_live[chunk] == 0) {       // a retired chunk
    empty_chunk(chunk, np, mask, tmin);
    return;
  }
  const ChunkRays cr =
      load_rays<FULL>(ot, dt, ray_stride, valid, chunk, ray_chunk);
  bool mine = false;
#pragma unroll
  for (int s = 0; s < RPT; ++s) mine |= cr.v[s];
  if (!__syncthreads_or(mine)) {               // no valid ray: no page hit
    empty_chunk(chunk, np, mask, tmin);
    return;
  }
  for (int p0 = 0; p0 < np; p0 += TILE) {
    const int nt = min(TILE, np - p0);
    float m;
    const bool any =
        tile_reduce<FULL, true>(cr, lo, hi, p0, nt, rt::inf_f(), sm, m);
    if ((int)threadIdx.x < nt) {
      const long long out = (long long)chunk * np + p0 + threadIdx.x;
      mask[out] = any ? 1 : 0;
      tmin[out] = any ? m : rt::inf_f();
    }
  }
}

// B13's shared memory past the tile's: the chunk's keys [npad] (BIGT for a
// missed or padding page), its hit bits [npad / 32], their popcounts'
// exclusive prefix [npad / 32], and the hit pages' keys and pages in page
// order [np] each.
__host__ __device__ constexpr size_t sorted_smem(int np, int npad) {
  return sizeof(float) * ((size_t)npad + 2 * (size_t)(npad / 32) +
                          2 * (size_t)np);
}

// FULL: every slot holds a ray (ray_chunk a multiple of RPT * 32), as B1's
// instance.  chunk_live == null: every chunk live.
template <bool FULL>
__global__ void __launch_bounds__(1024)
cull_sorted_kernel(const float* __restrict__ ot, const float* __restrict__ dt,
                   long long ray_stride,
                   const unsigned char* __restrict__ valid,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   int np, int npad, int ray_chunk,
                   const int* __restrict__ chunk_live,
                   int* __restrict__ counts, int* __restrict__ plist,
                   float* __restrict__ ptmin) {
  extern __shared__ float s_dyn[];
  __shared__ TileSmem sm;
  __shared__ int s_hits;
  const int nw = npad / 32;
  float* s_key = s_dyn;
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_key + npad);
  int* s_pre = reinterpret_cast<int*>(s_bits + nw);
  float* s_hk = reinterpret_cast<float*>(s_pre + nw);
  int* s_hp = reinterpret_cast<int*>(s_hk + np);
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
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
  const ChunkRays cr =
      load_rays<FULL>(ot, dt, ray_stride, valid, chunk, ray_chunk);
  bool mine = false;
#pragma unroll
  for (int s = 0; s < RPT; ++s) mine |= cr.v[s];
  if (!__syncthreads_or(mine)) {     // no valid ray: every key BIGT
    for (int p = tid; p < npad; p += blockDim.x) {
      pl[p] = p;
      pt[p] = BIGT;
    }
    if (tid == 0) counts[chunk] = 0;
    return;
  }
  // the cull: warp 0 holds a tile's pages, and ballots its hit bits; a hit
  // key that is not below BIGT sends the chunk to the all-pairs rank
  bool slow = false;
  for (int p0 = 0; p0 < np; p0 += TILE) {
    const int nt = min(TILE, np - p0);
    float m;
    const bool any =
        tile_reduce<FULL, false>(cr, lo, hi, p0, nt, BIGT, sm, m);
    if (tid < 32) {
      const bool hit = tid < nt && any;
      const float key = hit ? (m == 0.0f ? 0.0f : m) : BIGT;
      if (tid < nt) s_key[p0 + tid] = key;
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (tid == 0) s_bits[p0 / TILE] = bits;
      slow |= hit && !(key < BIGT);
    }
  }
  for (int p = np + tid; p < npad; p += blockDim.x) s_key[p] = BIGT;
  for (int w = (np + 31) / 32 + tid; w < nw; w += blockDim.x) s_bits[w] = 0u;
  slow = __syncthreads_or(slow);
  // the hit count and each word's hits before it (warp 0's scan)
  if (tid < 32) {
    int carry = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + lane;
      const int v = w < nw ? __popc(s_bits[w]) : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      if (w < nw) s_pre[w] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_hits = carry;
  }
  __syncthreads();
  const int h = s_hits;
  if (tid == 0) counts[chunk] = h;
  if (slow) {
    // every pair of padded pages, comparing floats (not bits), so that -0
    // and +0 tie as in the TPU kernel
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
    return;
  }
  // every hit key < BIGT: a missed or padding page takes rank h + the
  // missed pages before it; the hit pages, compacted in page order, rank
  // among themselves
  for (int p = tid; p < npad; p += blockDim.x) {
    const unsigned bits = s_bits[p >> 5];
    const int before = s_pre[p >> 5] + __popc(bits & ((1u << (p & 31)) - 1u));
    if ((bits >> (p & 31)) & 1u) {
      s_hk[before] = s_key[p];
      s_hp[before] = p;
    } else {
      pl[h + p - before] = p;
      pt[h + p - before] = BIGT;
    }
  }
  __syncthreads();
  for (int i = tid; i < h; i += blockDim.x) {
    const float k = s_hk[i];
    int rank = 0;
    for (int j = 0; j < h; ++j) {
      const float kj = s_hk[j];
      rank += (kj < k) | ((kj == k) & (j < i));
    }
    pl[rank] = s_hp[i];
    pt[rank] = k;
  }
}

}  // namespace

// chunk_live: [nc] int flags, or null (every chunk live).
extern "C" int rt_cull(const float* ot, const float* dt, long long ray_stride,
                       const unsigned char* valid, const float* lo,
                       const float* hi, int np, int nc, int ray_chunk,
                       const int* chunk_live, unsigned char* mask,
                       float* tmin, void* stream) {
  const int threads = rt::chunk_block_fixed(ray_chunk, RPT).threads;
  const bool full = ray_chunk == RPT * threads;
  auto kernel = chunk_live ? (full ? cull_kernel<true, true>
                                   : cull_kernel<false, true>)
                           : (full ? cull_kernel<true, false>
                                   : cull_kernel<false, false>);
  kernel<<<nc, threads, 0, (cudaStream_t)stream>>>(
      ot, dt, ray_stride, valid, lo, hi, np, ray_chunk, chunk_live, mask,
      tmin);
  return (int)cudaGetLastError();
}

extern "C" int rt_cull_sorted(const float* ot, const float* dt,
                              long long ray_stride,
                              const unsigned char* valid, const float* lo,
                              const float* hi, int np, int npad, int nc,
                              int ray_chunk, const int* chunk_live,
                              int* counts, int* plist, float* ptmin,
                              void* stream) {
  const int threads = rt::chunk_block_fixed(ray_chunk, RPT).threads;
  auto kernel = ray_chunk == RPT * threads ? cull_sorted_kernel<true>
                                           : cull_sorted_kernel<false>;
  const size_t smem = sorted_smem(np, npad);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<nc, threads, smem, (cudaStream_t)stream>>>(
      ot, dt, ray_stride, valid, lo, hi, np, npad, ray_chunk, chunk_live,
      counts, plist, ptmin);
  return (int)cudaGetLastError();
}
