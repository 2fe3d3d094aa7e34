// B14a and B14b: the bucketed ("ray sorting") compaction and its inverse.
//
// Replaces: rust_raytrace_tpu/ops/compact.py:compact_pallas_buckets (inner
// _kernel_compact_b) and expand_pallas_buckets (inner _kernel_expand_b).
// No render path launches them: the JAX package measured the bucketed
// layout slower end to end on the TPU and wires neither in, and neither
// does the port.  Both move 32-bit words only (no arithmetic touches a
// value), so -0, NaN payloads and denormals come through as they are and
// each kernel equals its plain torch version (ops/compact.py) bit for bit.
//
// Layout (compact_meta_buckets, one row of 32 int32 per chunk of cb
// lanes): a lane's code (state row 12) is 0 for a gap, 1 for a retired ray
// and 2 + q for a ray alive in bucket q (NB = 8).  Bucket q's members of a
// chunk go, in lane order, to the (chunk, bucket) segment at off_q of the
// new state, all 16 rows; the segments are bucket-major (every chunk's
// bucket 0, then bucket 1, ...) and each is padded to 128 lanes, whose
// padding stays 0 as every lane in no segment does (the output is a zeros
// buffer).  A retired ray's payload (state rows 8..15) goes to the dead
// segment at off_d of the dead array, whose padding lanes are zeroed, as
// the TPU kernel writes whole 128-lane tiles.  A chunk whose busy flag
// (column 27) is 0 writes nothing.  A segment that would end past its
// array (off + 128 * case > R, or > RD for the dead array: an overflowing
// layout, which the JAX engine never launches) is not written, so a call
// never writes out of bounds.
//
// B14b: every lane of a busy chunk takes its 8 payload rows from its
// bucket's segment, or from the dead segment for a retired lane, at its
// rank; gaps, lanes of an idle chunk and lanes whose segment does not fit
// get 0.  Buckets are disjoint, so each lane has one source and copies its
// bits (the TPU kernel's OR of disjoint one-hot products is that copy).
//
// Bound on this card: memory.  Each lane reads and writes its column once;
// the TPU kernel's one-hot MXU ranks, byte-split permutations and
// per-bucket DMA rings have no counterpart here.
//
// Design: one block per chunk, one thread per lane (cb <= 1024).  A lane's
// rank within its bucket is the popcount of its warp's ballot for that
// bucket below it, plus an exclusive scan of the nine buckets' per-warp
// counts in shared memory: B3's ranking (compact.cu) with nine masks in
// place of two.
#include "common.cuh"

namespace {

constexpr int ALIGN = 128;
constexpr int NB = 8;                  // alive buckets
constexpr int NMASK = NB + 1;          // and the retired rays
constexpr int META9_COLS = 32;
constexpr int M9_DEAD = 3 * NB;
constexpr int M9_BUSY = 27;
constexpr int ROW_CODE = 12;
constexpr int PAYLOAD = 8;             // dead array rows (state rows 8..15)

// The lane's mask: bucket q for code 2 + q, NB for a retired ray, -1 for
// anything else.
__device__ __forceinline__ int mask_of(float code) {
  if (code == 1.0f) return NB;
  for (int q = 0; q < NB; ++q)
    if (code == (float)(2 + q)) return q;
  return -1;
}

// Exclusive rank of the lane among the chunk's lanes of its mask k
// (k = -1: none, rank 0).
__device__ __forceinline__ int bucket_rank(int k) {
  __shared__ int warp_cnt[NMASK][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned mine = 0u;
#pragma unroll
  for (int j = 0; j < NMASK; ++j) {
    const unsigned b = __ballot_sync(0xFFFFFFFFu, k == j);
    if (lane == 0) warp_cnt[j][warp] = __popc(b);
    if (k == j) mine = b;
  }
  __syncthreads();
  if (threadIdx.x < NMASK) {
    int sum = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = warp_cnt[threadIdx.x][w];
      warp_cnt[threadIdx.x][w] = sum;
      sum += c;
    }
  }
  __syncthreads();
  return k < 0 ? 0 : warp_cnt[k][warp] + __popc(mine & ((1u << lane) - 1u));
}

// Segment (off, fits) of mask k in meta row m: fits when its 128-padded
// extent ends within n lanes.
__device__ __forceinline__ long long seg_off(const int* m, int k) {
  return k == NB ? m[M9_DEAD + 2] : m[3 * k + 2];
}

__device__ __forceinline__ bool seg_fits(const int* m, int k, long long n) {
  const int cnt = k == NB ? m[M9_DEAD] : m[3 * k];
  const int cs = k == NB ? m[M9_DEAD + 1] : m[3 * k + 1];
  return cnt > 0 && seg_off(m, k) + (long long)cs * ALIGN <= n;
}

__global__ void compact_buckets_kernel(const uint32_t* __restrict__ st,
                                       uint32_t* __restrict__ out,
                                       uint32_t* __restrict__ dead,
                                       long long R, long long RD,
                                       const int* __restrict__ meta) {
  const int chunk = blockIdx.x;
  const int* m = meta + (long long)chunk * META9_COLS;
  if (m[M9_BUSY] == 0) return;
  const int l = threadIdx.x;
  const long long r = (long long)chunk * blockDim.x + l;
  const int k = mask_of(__uint_as_float(st[ROW_CODE * R + r]));
  const int rank = bucket_rank(k);
  if (k >= 0 && k < NB && seg_fits(m, k, R)) {
    const long long dst = seg_off(m, k) + rank;
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + dst] = st[i * R + r];
  }
  if (!seg_fits(m, NB, RD)) return;
  const long long off_d = seg_off(m, NB);
  if (k == NB) {
#pragma unroll
    for (int i = 0; i < PAYLOAD; ++i)
      dead[i * RD + off_d + rank] = st[(rt::ROW_ACC + i) * R + r];
  }
  // the dead segment's padding lanes (its extent is at most cb lanes)
  const int cnt_d = m[M9_DEAD];
  if (l >= cnt_d && l < m[M9_DEAD + 1] * ALIGN) {
#pragma unroll
    for (int i = 0; i < PAYLOAD; ++i) dead[i * RD + off_d + l] = 0u;
  }
}

__global__ void expand_buckets_kernel(const uint32_t* __restrict__ y,
                                      const uint32_t* __restrict__ dead,
                                      const float* __restrict__ code,
                                      uint32_t* __restrict__ out, long long R,
                                      long long RD,
                                      const int* __restrict__ meta) {
  const int chunk = blockIdx.x;
  const int* m = meta + (long long)chunk * META9_COLS;
  const long long r = (long long)chunk * blockDim.x + threadIdx.x;
  const bool busy = m[M9_BUSY] != 0;
  // the busy flag is the chunk's, so the branch is block-uniform
  const int k = busy ? mask_of(code[r]) : -1;
  const int rank = busy ? bucket_rank(k) : 0;
  const uint32_t* src = nullptr;
  long long stride = R;
  if (k >= 0 && k < NB && seg_fits(m, k, R)) {
    src = y + seg_off(m, k) + rank;
  } else if (k == NB && seg_fits(m, NB, RD)) {
    src = dead + seg_off(m, NB) + rank;
    stride = RD;
  }
#pragma unroll
  for (int i = 0; i < PAYLOAD; ++i)
    out[i * R + r] = src == nullptr ? 0u : src[i * stride];
}

}  // namespace

extern "C" int rt_compact_buckets(const float* st, float* out, float* dead,
                                  long long R, long long RD, const int* meta,
                                  int cb, void* stream) {
  compact_buckets_kernel<<<(unsigned)(R / cb), cb, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)st, (uint32_t*)out, (uint32_t*)dead, R, RD, meta);
  return (int)cudaGetLastError();
}

extern "C" int rt_expand_buckets(const float* y, const float* dead,
                                 const float* code, float* out, long long R,
                                 long long RD, const int* meta, int cb,
                                 void* stream) {
  expand_buckets_kernel<<<(unsigned)(R / cb), cb, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)y, (const uint32_t*)dead, code, (uint32_t*)out, R, RD,
      meta);
  return (int)cudaGetLastError();
}
