// B7: per-lane trace to winner rows, nearest or any-hit, with an optional
// excluded triangle per ray.
//
// Replaces: rust_raytrace_tpu/ops/intersect_perlane.py:trace_perlane_pallas
// (inner _kernel, _trace_chunk, _group) — the resident per-lane tables
// ([NB*17P, 128] and [NB*7P, 128], at most 16 banks of 128 pages) against
// rays given as [3, R] rows; every ray slab-tests each bank's page AABBs,
// visits its pages nearest entry first and drops those entered beyond its
// best hit, and the [16, R] winner rows (t, id, payload) are written out.
// Its one caller is the per-lane branch of the shadow pass
// (engine.shadow_mask_perlane: any-hit with each ray's own triangle
// excluded).  Chunks flagged dead in chunk_live get all-zero rows, as the
// TPU kernel zeroes its output block.
//
// Bound on this card: latency of scattered reads, as B4: each ray reads
// the pages its slab tests select, ~40 flops of predicate against 17
// features a triangle; the tables (487 KB a bank at P = 56) stay in L2.
//
// Design: one thread per ray, blocks of 128, banks in index order through
// rt::bank_pass (perlane.cuh), the page loop of B4, B9 and B10; the winner
// is the lexicographic (t, id) minimum, so it equals the TPU kernel's
// whatever the visit order.  The payload is stored as B4/B10 store it (a
// -0 as +0, as the TPU kernel's one-hot masked sum does).  Any-hit stops a
// ray at its first hit and leaves its payload rows 0: only ROW_ID != 0 is
// meaningful (ROADMAP C5).  The TPU kernel's in-chunk lane sort, permuted
// gathers and page-count classes balance its 128-lane vector groups and
// round-trip bit-exactly; they are not carried.  One template over ANY_HIT
// and EXCL.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::GROUP;
using rt::N_INT;
using rt::N_SHD;

template <bool ANY_HIT, bool EXCL>
__global__ void __launch_bounds__(128)
trace_perlane_kernel(const float* __restrict__ o_rows,
                     const float* __restrict__ d_rows, long long row_stride,
                     const float* __restrict__ alive, long long R,
                     const float* __restrict__ excl,
                     const float* __restrict__ plt_i,
                     const float* __restrict__ plt_s,
                     const float* __restrict__ ab, int P, int NB,
                     int ray_chunk, const int* __restrict__ chunk_live,
                     float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  if (chunk_live != nullptr && chunk_live[r / ray_chunk] == 0) {
#pragma unroll
    for (int i = 0; i < rt::TRACE_ROWS; ++i) out[i * R + r] = 0.0f;
    return;
  }
  float o[3], d[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = o_rows[k * row_stride + r];
    d[k] = d_rows[k * row_stride + r];
    inv[k] = rt::slab_inv(d[k]);
  }
  const bool valid = alive[r] != 0.0f;
  const float ex = EXCL ? excl[r] : 0.0f;
  rt::Winner w = rt::winner_init(valid);
  for (int b = 0; valid && b < NB; ++b) {
    rt::bank_pass<ANY_HIT, EXCL>(ab + (long long)b * GROUP * AB_LANES,
                                 plt_i + (long long)b * N_INT * P * GROUP,
                                 plt_s + (long long)b * N_SHD * P * GROUP, P,
                                 o, d, inv, ex, w);
    if (ANY_HIT && w.id != 0.0f) break;
  }
  rt::store_winner(w, out, R, r);
}

template <bool ANY_HIT, bool EXCL>
int launch(const float* ot, const float* dt, long long row_stride,
           const float* alive, long long R, const float* excl,
           const float* plt_i, const float* plt_s, const float* ab, int P,
           int NB, int ray_chunk, const int* chunk_live, float* out,
           cudaStream_t stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  trace_perlane_kernel<ANY_HIT, EXCL><<<(unsigned)blocks, threads, 0,
                                        stream>>>(
      ot, dt, row_stride, alive, R, excl, plt_i, plt_s, ab, P, NB, ray_chunk,
      chunk_live, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_trace_perlane(const float* ot, const float* dt,
                                long long row_stride, const float* alive,
                                long long R, const float* excl, int any_hit,
                                const float* plt_i, const float* plt_s,
                                const float* ab, int P, int NB, int ray_chunk,
                                const int* chunk_live, float* out,
                                void* stream) {
  auto fn = any_hit ? (excl ? launch<true, true> : launch<true, false>)
                    : (excl ? launch<false, true> : launch<false, false>);
  return fn(ot, dt, row_stride, alive, R, excl, plt_i, plt_s, ab, P, NB,
            ray_chunk, chunk_live, out, (cudaStream_t)stream);
}
