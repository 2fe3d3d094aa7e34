// B7: per-lane trace to winner rows, nearest or any-hit, with an optional
// excluded triangle per ray.
//
// Replaces: rust_raytrace_tpu/ops/intersect_perlane.py:trace_perlane_pallas
// (inner _kernel, _trace_chunk, _group) — the resident tables (at most 16
// banks of 128 pages) against rays given as [3, R] rows; every ray
// slab-tests each bank's page AABBs, visits its pages nearest entry first
// and drops those entered beyond its best hit, and the [16, R] winner rows
// (t, id, payload) are written out.  Its one caller is the per-lane branch
// of the shadow pass (engine.shadow_mask_perlane: any-hit with each ray's
// own triangle excluded).  Chunks flagged dead in chunk_live get all-zero
// rows, as the TPU kernel zeroes its output block.
//
// Bound on this card: the hit predicate's arithmetic (~40 flops and an
// IEEE division a triangle) on the pages each ray visits, the slab tests
// of the boxes it meets, and divergence, each thread walking its own
// pages; the resident records (at most 25 MB) stay in L2.
//
// Design: one thread per lane, blocks of 128, banks in index order, each
// through rt::bank_walk (perlane.cuh) over the resident page-major records
// (ops/intersect_perlane.py PerlaneTables: rec, pab, extent, as B4 reads
// them) behind the bank's 16 group boxes of 8 pages (gab): a ray slab-tests
// the group boxes, then only the pages of the groups it enters, once a
// bank visit, and reads a triangle as one record.  The walk visits the
// per-lane traversal's pages in its (entry, page) order with its pruning,
// so the nearest winner is the plain version's and the TPU kernel's bit for
// bit; any-hit stops at the first hit in that order (only ROW_ID != 0 is
// meaningful, ROADMAP C5) and leaves the payload rows 0.  The payload is
// stored as B4/B10 store it (a -0 as +0, as the TPU kernel's one-hot
// masked sum does).  Timed in turns against a group of 8, 16 or 32 lanes
// a listed ray (B9's form) on four whole waves, this walk was the fastest
// on two of them, within 7% on the other two, and took 8% less time over
// the four (PERF.md, PR 13).  The TPU kernel's in-chunk lane sort,
// permuted gathers and page-count classes balanced its 128-lane vector
// groups; they are not carried.  One template over ANY_HIT and EXCL.
#include "perlane.cuh"

namespace {

using rt::BANK_BOXES;
using rt::GROUP;
using rt::PAB4;
using rt::REC4;

constexpr int THREADS = 128;

template <bool ANY_HIT, bool EXCL>
__global__ void __launch_bounds__(THREADS)
trace_perlane_kernel(const float* __restrict__ o_rows,
                     const float* __restrict__ d_rows, long long row_stride,
                     const float* __restrict__ alive, long long R,
                     const float* __restrict__ excl,
                     const float4* __restrict__ rec,
                     const float4* __restrict__ pab,
                     const float4* __restrict__ gab,
                     const int* __restrict__ extent, int P, int NB,
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
    rt::bank_walk<ANY_HIT, EXCL, false, true>(
        pab + (long long)b * GROUP * PAB4,
        rec + (long long)b * GROUP * P * REC4, P, o, d, inv, ex, w, 0,
        nullptr, extent[b], gab + (long long)b * BANK_BOXES * PAB4);
    if (ANY_HIT && w.id != 0.0f) break;
  }
  rt::store_winner(w, out, R, r);
}

template <bool ANY_HIT, bool EXCL>
int launch(const float* ot, const float* dt, long long row_stride,
           const float* alive, long long R, const float* excl,
           const float* rec, const float* pab, const float* gab,
           const int* extent, int P, int NB, int ray_chunk,
           const int* chunk_live, float* out, cudaStream_t stream) {
  const long long blocks = (R + THREADS - 1) / THREADS;
  trace_perlane_kernel<ANY_HIT, EXCL><<<(unsigned)blocks, THREADS, 0,
                                        stream>>>(
      ot, dt, row_stride, alive, R, excl,
      reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(pab),
      reinterpret_cast<const float4*>(gab), extent, P, NB, ray_chunk,
      chunk_live, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_trace_perlane(const float* ot, const float* dt,
                                long long row_stride, const float* alive,
                                long long R, const float* excl, int any_hit,
                                const float* rec, const float* pab,
                                const float* gab, const int* extent, int P,
                                int NB, int ray_chunk, const int* chunk_live,
                                float* out, void* stream) {
  auto fn = any_hit ? (excl ? launch<true, true> : launch<true, false>)
                    : (excl ? launch<false, true> : launch<false, false>);
  return fn(ot, dt, row_stride, alive, R, excl, rec, pab, gab, extent, P, NB,
            ray_chunk, chunk_live, out, (cudaStream_t)stream);
}
