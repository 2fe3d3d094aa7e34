// The per-lane traversal of one bank of <= 128 pages, shared by B4
// (trace_shade_perlane.cu) and B7 (trace_perlane.cu), banks in index order;
// B9/B10 (trace_streamed.cu), banks on a per-ray worklist; and B12's sweep
// (trace_bankmajor.cu), one bank per launch.
//
// Counterpart: rust_raytrace_tpu/ops/intersect_perlane.py:_group and
// ops/intersect_streamed.py:_bank_group_pass — each ray slab-tests the bank's
// page AABBs, tests its nearest remaining page (ties to the lower page
// index), and drops every page whose entry lies beyond its best hit.  The
// winner is the lexicographic (t, id) minimum, so the visit order of banks
// and pages does not change it (exact pruning only).
#pragma once

#include "common.cuh"

namespace rt {

constexpr int GROUP = 128;   // pages per bank
constexpr int N_INT = 17;    // intersect features per triangle (plt_i)
constexpr int N_SHD = 7;     // shade features per triangle (plt_s)
constexpr int AB_LANES = 128;

// Slab interval of page p of a bank's AABB rows `abb` (lanes 0..2 lo, 3..5
// hi, 6 valid; rows STRIDE floats apart): returns tlo, writes thi.
template <int STRIDE = AB_LANES>
__device__ __forceinline__ float page_tlo(const float* __restrict__ abb,
                                          int p, const float o[3],
                                          const float inv[3], float& thi) {
  const float* a = abb + p * STRIDE;
  const float lo[3] = {a[0], a[1], a[2]};
  const float hi[3] = {a[3], a[4], a[5]};
  float tlo;
  slab(lo, hi, o, inv, tlo, thi);
  return tlo;
}

// The payload of the winning triangle j of page p of a bank (f points at its
// plt_i lane, f = ti + j*128 + p; g at its plt_s lane) for the hit terms h.
__device__ __forceinline__ void winner_payload(const float* __restrict__ f,
                                               const float* __restrict__ g,
                                               int P, const HitTerms& h,
                                               Winner& w) {
  const long long fs = (long long)P * GROUP;
  w.n0 = f[LANE_N * fs];
  w.n1 = f[(LANE_N + 1) * fs];
  w.n2 = f[(LANE_N + 2) * fs];
  w.enc = encode_face(h, g[0], g[fs]);
  w.c0 = g[2 * fs];
  w.c1 = g[3 * fs];
  w.c2 = g[4 * fs];
  w.alpha = g[5 * fs];
  w.scat = g[6 * fs];
}

// One bank's traversal for the ray (o, d) with slab reciprocals inv: abb the
// bank's page AABB rows (STRIDE floats apart), ti/ts its plt_i/plt_s slabs
// ([17P, 128] and [7P, 128], pages on lanes).  Updates the winner w in
// place.  EXCL: the triangle ex may not win (a shadow ray's own).  ANY_HIT:
// return at the first triangle that hits, with t and id only (the occlusion
// query: only id != 0 is meaningful, ROADMAP C5).  SLOT: record the
// winner's slot (slot_base + page * P + triangle) in *slot instead of its
// payload (B12's sweep extracts the payload once, at the end).
template <bool ANY_HIT, bool EXCL, bool SLOT = false, int STRIDE = AB_LANES>
__device__ __forceinline__ void bank_pass(const float* __restrict__ abb,
                                          const float* __restrict__ ti,
                                          const float* __restrict__ ts, int P,
                                          const float o[3], const float d[3],
                                          const float inv[3], float ex,
                                          Winner& w, int slot_base = 0,
                                          int* slot = nullptr) {
  uint32_t hit[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int p = q * 32 + j;
      if (abb[p * STRIDE + 6] == 0.0f) continue;     // padding page
      float thi;
      const float tlo = page_tlo<STRIDE>(abb, p, o, inv, thi);
      if ((tlo <= thi) & (thi >= 0.0f)) bits |= 1u << j;
    }
    hit[q] = bits;
  }

  while (true) {
    // drop pages entered beyond the best hit; pick the nearest of the rest
    float kmin = inf_f();
    int pidx = GROUP;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t m = hit[q];
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int p = q * 32 + j;
        float thi;
        const float tlo = page_tlo<STRIDE>(abb, p, o, inv, thi);
        if (tlo > w.t) {
          hit[q] &= ~(1u << j);
        } else if (tlo < kmin) {
          kmin = tlo;
          pidx = p;
        }
      }
    }
    if (pidx == GROUP) return;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q == (pidx >> 5)) hit[q] &= ~(1u << (pidx & 31));

    for (int j = 0; j < P; ++j) {
      const float* f = ti + (long long)j * GROUP + pidx;
      auto col = [f, P](int lane_f) {
        return f[(long long)lane_f * P * GROUP];
      };
      const HitTerms h = hit_predicate<false>(col, o, d);
      const float id = col(LANE_ID);
      if (h.ok && (!EXCL || id != ex) && lex_better(h.t, id, w)) {
        w.t = h.t;
        w.id = id;
        if (ANY_HIT) return;
        if (SLOT)
          *slot = slot_base + pidx * P + j;
        else
          winner_payload(f, ts + (long long)j * GROUP + pidx, P, h, w);
      }
    }
  }
}

}  // namespace rt
