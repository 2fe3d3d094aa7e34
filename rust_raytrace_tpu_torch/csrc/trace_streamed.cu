// B9 and B10: the streamed regime's bank-worklist trace, fused with the
// shade (B9) or writing the winner rows (B10, nearest or any-hit).
//
// Replaces: rust_raytrace_tpu/ops/intersect_streamed.py:
// trace_shade_streamed_pallas (inner _kernel_streamed_fused,
// _streamed_trace_chunk, _bank_group_pass, _bank_extract) and
// trace_streamed_pallas (inner _kernel_streamed) — scenes past the resident
// tables' cap keep their banks' tables in device memory (here as page-major
// records, [NB*128, P, 24], and page boxes, [NB*128, 8]); every ray walks a worklist of banks front to back (a
// slab test against the bank AABBs, the nearest remaining bank first, a
// bank dropped once its entry lies beyond the ray's best hit) and runs the
// per-lane page traversal inside each bank it visits.  B9 then shades the
// wave (B0b) with the scatter hash keyed on (chunk, lane); B10 writes
// [16, R] winner rows, with an optional excluded triangle per ray and an
// any-hit mode (stop at the first hit; only ROW_ID != 0 is meaningful,
// ROADMAP C5).  Chunks flagged dead in chunk_live pass their state through
// (B9) or get all-zero rows (B10), as on the TPU.
//
// Bound on this card: the hit predicate's arithmetic on the pages each ray
// visits (~40 flops and an IEEE division a triangle, P = 224 triangles a
// page at 1M triangles) and the divergence of a warp whose rays visit
// different numbers of pages; then the reads of those pages' records for
// incoherent bounce rays, whose warps touch many pages of the 96 MB of
// records (past the 50 MB L2).
//
// Design: one thread per ray, blocks of THREADS = 128 (the fastest of 64,
// 128 and 256 on the H100, PERF.md).  The TPU kernel streamed one bank at a time into VMEM
// for a whole chunk (a chunk-wide worklist, a guess prefetch, an in-chunk
// sort by primary bank, payload re-extraction at every bank visit); none of
// that is needed when each thread reads the tables where they lie.  A
// block stages the NB bank AABBs in shared memory once.  A thread keeps no
// worklist state but the last bank it visited: each step re-runs the slab
// test of every bank (from shared memory) and takes the nearest bank after
// that one in (entry, index) order, which visits the banks in the same
// order a visited mask would, for any NB.  Inside a bank it runs
// rt::bank_walk (perlane.cuh) over the page-major records (rec, pab of
// ops/intersect_perlane.py:page_records): six float4 a triangle, each
// page's slab tested once a visit, candidates kept sorted in registers.
// The winner is the lexicographic (t, id) minimum with exact pruning, so it
// equals the TPU kernel's whatever the visit order; any-hit keeps the
// per-lane walk's visit order, so it returns the same first hit.  B9 and
// B10 are one template over SHADE, ANY_HIT and EXCL.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::GROUP;
using rt::PAB4;
using rt::REC4;

// floats of a staged bank AABB (lanes 0..2 lo, 3..5 hi, 6 valid, 7 zero)
constexpr int BOX = 8;
// threads a block, one ray each; eight blocks an SM cap the walk at 64
// registers, which runs faster than the uncapped walk despite its spills
constexpr int THREADS = 128;

// The bank worklist of the ray (o, d): visit the slab-hit banks in (entry,
// index) order, each unless its entry lies beyond the best hit so far.
// s_bank: the NB bank AABBs in shared memory, PAB4 float4 each; rec/pab:
// the page-major records and page boxes of every bank.
template <bool ANY_HIT, bool EXCL>
__device__ __forceinline__ void trace_banks(
    const float o[3], const float d[3], float ex,
    const float4* __restrict__ rec, const float4* __restrict__ pab,
    const float4* s_bank, int P, int NB, rt::Winner& w) {
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) inv[k] = rt::slab_inv(d[k]);
  float prev_t = -rt::inf_f();
  int prev_b = -1;
  while (true) {
    float kmin = rt::inf_f();
    int bsel = NB;
    for (int b = 0; b < NB; ++b) {
      float thi;
      bool valid;
      const float tlo = rt::box_tlo(s_bank + b * PAB4, o, inv, thi, valid);
      if (!(valid & (tlo <= thi) & (thi >= 0.0f) & (tlo <= w.t))) continue;
      const bool after = (tlo > prev_t) | ((tlo == prev_t) & (b > prev_b));
      if (after & (tlo < kmin)) {
        kmin = tlo;
        bsel = b;
      }
    }
    if (bsel == NB) return;
    prev_t = kmin;
    prev_b = bsel;
    rt::bank_walk<ANY_HIT, EXCL>(pab + (long long)bsel * GROUP * PAB4,
                                 rec + (long long)bsel * GROUP * P * REC4, P,
                                 o, d, inv, ex, w);
    if (ANY_HIT && w.id != 0.0f) return;
  }
}

// SHADE (B9): st is the [16, R] state, o/d/alive its rows, out the new
// state.  Otherwise (B10): o_rows/d_rows three rows each, row_stride floats
// apart, alive [R], and out the [16, R] winner rows.  Dynamic shared
// memory: NB * BOX floats.
template <bool SHADE, bool ANY_HIT, bool EXCL>
__global__ void __launch_bounds__(THREADS, 8)
trace_streamed_kernel(const float* __restrict__ o_rows,
                      const float* __restrict__ d_rows,
                      const float* __restrict__ alive, long long row_stride,
                      long long R, const float* __restrict__ excl,
                      const float4* __restrict__ rec,
                      const float4* __restrict__ pab,
                      const float* __restrict__ bank_ab, int P, int NB,
                      int ray_chunk, const int* __restrict__ chunk_live,
                      const float* __restrict__ st, float* __restrict__ out,
                      uint32_t s0, uint32_t s1, bool fixed_rng,
                      float weight_cutoff, const uint32_t* __restrict__ rsq) {
  extern __shared__ float4 s_bank[];
  float* sb = reinterpret_cast<float*>(s_bank);
  for (int i = threadIdx.x; i < NB * BOX; i += blockDim.x)
    sb[i] = bank_ab[(long long)(i / BOX) * AB_LANES + i % BOX];
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long chunk = r / ray_chunk;
  const bool live = chunk_live == nullptr || chunk_live[chunk] != 0;
  if constexpr (SHADE) {
    float s[rt::STATE_ROWS];
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
    if (live) {
      const float o[3] = {s[0], s[1], s[2]};
      const float d[3] = {s[3], s[4], s[5]};
      const bool valid = s[rt::ROW_ALIVE] != 0.0f;
      rt::Winner w = rt::winner_init(valid);
      if (valid)
        trace_banks<false, false>(o, d, 0.0f, rec, pab, s_bank, P, NB, w);
      float v[3], inv;
      rt::scatter_rv(s0, s1, (uint32_t)chunk,
                     (uint32_t)(r - chunk * ray_chunk), ray_chunk, fixed_rng,
                     rsq, v, inv);
      rt::shade_ray(s, w, v, inv, fixed_rng, weight_cutoff, false, rsq);
    }
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
  } else {
    if (!live) {
#pragma unroll
      for (int i = 0; i < rt::TRACE_ROWS; ++i) out[i * R + r] = 0.0f;
      return;
    }
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = o_rows[k * row_stride + r];
      d[k] = d_rows[k * row_stride + r];
    }
    const bool valid = alive[r] != 0.0f;
    rt::Winner w = rt::winner_init(valid);
    if (valid)
      trace_banks<ANY_HIT, EXCL>(o, d, EXCL ? excl[r] : 0.0f, rec, pab,
                                 s_bank, P, NB, w);
    rt::store_winner(w, out, R, r);
  }
}

template <bool SHADE, bool ANY_HIT, bool EXCL>
int launch(const float* o_rows, const float* d_rows, const float* alive,
           long long row_stride, long long R, const float* excl,
           const float* rec, const float* pab, const float* bank_ab, int P,
           int NB, int ray_chunk, const int* chunk_live, const float* st,
           float* out, uint32_t s0, uint32_t s1, int fixed_rng,
           float weight_cutoff, const uint32_t* rsq, cudaStream_t stream) {
  const size_t smem = (size_t)NB * BOX * sizeof(float);
  auto kernel = trace_streamed_kernel<SHADE, ANY_HIT, EXCL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (R + THREADS - 1) / THREADS;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      o_rows, d_rows, alive, row_stride, R, excl,
      reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(pab), bank_ab, P, NB, ray_chunk,
      chunk_live, st, out, s0, s1, fixed_rng != 0, weight_cutoff, rsq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_trace_shade_streamed(const float* st, float* out,
                                       long long R, const float* rec,
                                       const float* pab, const float* bank_ab,
                                       int P, int NB, int ray_chunk,
                                       const int* chunk_live, unsigned s0,
                                       unsigned s1, int fixed_rng,
                                       float weight_cutoff,
                                       const unsigned* rsq, void* stream) {
  return launch<true, false, false>(
      st, st + 3 * R, st + rt::ROW_ALIVE * R, R, R, nullptr, rec, pab,
      bank_ab, P, NB, ray_chunk, chunk_live, st, out, s0, s1, fixed_rng,
      weight_cutoff, rsq, (cudaStream_t)stream);
}

extern "C" int rt_trace_streamed(const float* ot, const float* dt,
                                 long long row_stride, const float* alive,
                                 long long R, const float* excl, int any_hit,
                                 const float* rec, const float* pab,
                                 const float* bank_ab, int P, int NB,
                                 int ray_chunk, const int* chunk_live,
                                 float* out, void* stream) {
  auto fn = any_hit ? (excl ? launch<false, true, true>
                            : launch<false, true, false>)
                    : (excl ? launch<false, false, true>
                            : launch<false, false, false>);
  return fn(ot, dt, alive, row_stride, R, excl, rec, pab, bank_ab, P, NB,
            ray_chunk, chunk_live, nullptr, out, 0u, 0u, 0, 0.0f, nullptr,
            (cudaStream_t)stream);
}
