// B3 and B5: wavefront compaction and its inverse.
//
// Replaces: rust_raytrace_tpu/ops/compact.py:compact_pallas (inner
// _kernel_compact) and expand_pallas (inner _kernel_expand).  Both move bits
// only, so each equals its plain torch version (ops/compact.py) bit for bit.
//
// Layout (compact_meta, one row per chunk of cb lanes): a chunk's survivors
// go, in lane order, to the survivor segment at off_a of the new state
// (rows 0..11; rows 12..15 and the segment's lanes past cnt_a stay zero), and
// its retired rays' payload (state rows 8..15) to the dead segment at off_d
// of the dead array, whose lanes past cnt_d are zeroed.  Segments are padded
// to 128 lanes, so the layout, and with it the scatter hash of the next wave
// (ROADMAP C3), is the JAX package's.  An overflow boundary (column M_IDENT)
// copies each chunk that holds a live or retired ray through unpermuted and
// harvests nothing.  A chunk with neither writes nothing.
//
// Bound on this card: memory.  Each lane reads its state column once and
// writes it once; the TPU kernel's one-hot MXU ranks, byte-split
// permutations and DMA pipelining have no counterpart here.
//
// Design: one block per chunk, one thread per lane (cb <= 1024).  A lane's
// rank among the chunk's survivors (or retired rays) is the popcount of a
// warp ballot below it plus an exclusive scan of the per-warp counts in
// shared memory.  grid_live (optional, a device int32, no host sync): the
// lane extent of the input's content; blocks past ceil(grid_live / cb)
// return at once, as the TPU kernel's dynamic grid skips them.
#include "common.cuh"

namespace {

constexpr int ALIGN = 128;
constexpr int META_COLS = 8;
constexpr int M_CNT_A = 0, M_OFF_A = 2, M_CNT_D = 3, M_OFF_D = 5, M_IDENT = 6;
constexpr int ROW_CODE = 12;      // state rows a survivor carries
constexpr int PAYLOAD = 8;        // dead array rows (state rows 8..15)

__device__ __forceinline__ bool past_grid(const int* grid_live, int chunk,
                                          int cb, int nc) {
  if (grid_live == nullptr) return false;
  int n = (*grid_live + cb - 1) / cb;
  n = n < 1 ? 1 : (n > nc ? nc : n);
  return chunk >= n;
}

// Exclusive ranks of the lanes flagged `a` and `d` within the block.
__device__ __forceinline__ void block_ranks(bool a, bool d, int& rank_a,
                                            int& rank_d) {
  __shared__ int warp_a[32], warp_d[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const unsigned ba = __ballot_sync(0xFFFFFFFFu, a);
  const unsigned bd = __ballot_sync(0xFFFFFFFFu, d);
  if (lane == 0) {
    warp_a[warp] = __popc(ba);
    warp_d[warp] = __popc(bd);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sa = 0, sd = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int ca = warp_a[w], cd = warp_d[w];
      warp_a[w] = sa;
      warp_d[w] = sd;
      sa += ca;
      sd += cd;
    }
  }
  __syncthreads();
  rank_a = warp_a[warp] + __popc(ba & below);
  rank_d = warp_d[warp] + __popc(bd & below);
}

__global__ void compact_kernel(const float* __restrict__ st,
                               float* __restrict__ out,
                               float* __restrict__ dead, long long R,
                               long long RD, const int* __restrict__ meta,
                               int cb, const int* __restrict__ grid_live) {
  const int chunk = blockIdx.x;
  const int nc = (int)(R / cb);
  if (past_grid(grid_live, chunk, cb, nc)) return;
  const int* m = meta + (long long)chunk * META_COLS;
  const int cnt_a = m[M_CNT_A], cnt_d = m[M_CNT_D];
  if (cnt_a + cnt_d == 0) return;
  const int l = threadIdx.x;
  const long long r = (long long)chunk * cb + l;
  if (m[M_IDENT] != 0) {
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = st[i * R + r];
    return;
  }
  const bool a = st[rt::ROW_ALIVE * R + r] != 0.0f;
  const bool d = st[rt::ROW_DEAD * R + r] != 0.0f;
  int rank_a, rank_d;
  block_ranks(a, d, rank_a, rank_d);
  if (a) {
    const long long dst = m[M_OFF_A] + rank_a;
#pragma unroll
    for (int i = 0; i < ROW_CODE; ++i) out[i * R + dst] = st[i * R + r];
  }
  if (d) {
    const long long dst = m[M_OFF_D] + rank_d;
#pragma unroll
    for (int i = 0; i < PAYLOAD; ++i)
      dead[i * RD + dst] = st[(rt::ROW_ACC + i) * R + r];
  }
  // the dead segment's padding lanes
  const int pad_d = (cnt_d + ALIGN - 1) / ALIGN * ALIGN;
  if (l >= cnt_d && l < pad_d) {
    const long long dst = m[M_OFF_D] + l;
#pragma unroll
    for (int i = 0; i < PAYLOAD; ++i) dead[i * RD + dst] = 0.0f;
  }
}

__global__ void expand_kernel(const float* __restrict__ y,
                              const float* __restrict__ dead,
                              const float* __restrict__ masks,
                              float* __restrict__ out, int rows, long long R,
                              long long RD, const int* __restrict__ meta,
                              int cb, const int* __restrict__ grid_live) {
  const int chunk = blockIdx.x;
  const int nc = (int)(R / cb);
  if (past_grid(grid_live, chunk, cb, nc)) return;
  const int* m = meta + (long long)chunk * META_COLS;
  const int cnt_a = m[M_CNT_A], cnt_d = m[M_CNT_D];
  const int l = threadIdx.x;
  const long long r = (long long)chunk * cb + l;
  if (m[M_IDENT] != 0) {
    for (int i = 0; i < rows; ++i) out[i * R + r] = y[i * R + r];
    return;
  }
  const bool a = masks[r] != 0.0f;
  const bool d = masks[R + r] != 0.0f;
  int rank_a, rank_d;
  block_ranks(a, d, rank_a, rank_d);
  // as the TPU kernel: a chunk whose lanes all retired reads its dead
  // segment whole; otherwise survivors win over retired lanes, gaps are 0
  const float* src = nullptr;
  long long at = 0, stride = R;
  if (cnt_a + cnt_d > 0) {
    if (cnt_d == cb) {
      src = dead, at = m[M_OFF_D] + l, stride = RD;
    } else if (a) {
      src = y, at = m[M_OFF_A] + rank_a;
    } else if (d) {
      src = dead, at = m[M_OFF_D] + rank_d, stride = RD;
    }
  }
  for (int i = 0; i < rows; ++i)
    out[i * R + r] = src == nullptr ? 0.0f : src[i * stride + at];
}

}  // namespace

extern "C" int rt_compact(const float* st, float* out, float* dead,
                          long long R, long long RD, const int* meta, int cb,
                          const int* grid_live, void* stream) {
  compact_kernel<<<(unsigned)(R / cb), cb, 0, (cudaStream_t)stream>>>(
      st, out, dead, R, RD, meta, cb, grid_live);
  return (int)cudaGetLastError();
}

extern "C" int rt_expand(const float* y, const float* dead, const float* masks,
                         float* out, int rows, long long R, long long RD,
                         const int* meta, int cb, const int* grid_live,
                         void* stream) {
  expand_kernel<<<(unsigned)(R / cb), cb, 0, (cudaStream_t)stream>>>(
      y, dead, masks, out, rows, R, RD, meta, cb, grid_live);
  return (int)cudaGetLastError();
}
