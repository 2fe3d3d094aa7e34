// The per-bank traversals of <= 128 pages.
//
// rt::bank_pass walks the per-lane tables (pages on lanes, the TPU's
// layout), for B7 (trace_perlane.cu) over the resident tables, banks in
// index order.  rt::bank_walk walks the page-major records: the resident
// regime's for B4 (trace_shade_perlane.cu), banks in index order, and the
// streamed regime's for B10 (trace_streamed.cu), banks on a per-ray
// worklist, and B12's sweep (trace_bankmajor.cu), one bank per item.  (B9
// walks the same records in the same order with a warp a ray,
// trace_streamed.cu.)
//
// Counterpart: rust_raytrace_tpu/ops/intersect_perlane.py:_group and
// ops/intersect_streamed.py:_bank_group_pass — each ray slab-tests the bank's
// page AABBs, tests its nearest remaining page (ties to the lower page
// index), and drops every page whose entry lies beyond its best hit.  The
// winner is the lexicographic (t, id) minimum, so the visit order of banks
// and pages does not change it (exact pruning only); any-hit returns the
// first hit in that same visit order, so both walks keep it exactly.
//
// Why the walks left the TPU layout.  Pages on lanes
// ([17P, 128] a bank) suit the TPU's 128-lane vectors: one vector load
// reads one feature of 128 pages.  A CUDA thread tests one page at a time,
// so there a triangle costs 17 scalar loads one feature row (P * 512 B,
// 114,688 B at P = 224) apart, each in its own 32-byte sector, and each
// selection step re-runs the slab test of every remaining page.  At 1M
// triangles the 68 MB of plt_i do not fit the 50 MB L2, so those sectors
// come from device memory.  bank_walk reads a triangle as one 96-byte
// record of six float4 (the predicate's 17 lanes in the first five; the
// sixth only for a winner's payload), and the threads of a warp on one page
// read one address; it slab-tests the bank's pages once per visit and keeps
// its candidates in a short sorted list.  What bounds it now: the hit
// predicate's arithmetic (an IEEE division a triangle) on the pages a ray
// visits, and divergence, each thread walking its own number of pages.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int GROUP = 128;   // pages per bank
constexpr int N_INT = 17;    // intersect features per triangle (plt_i)
constexpr int N_SHD = 7;     // shade features per triangle (plt_s)
constexpr int AB_LANES = 128;

// Slab interval of page p of a bank's AABB rows `abb` (lanes 0..2 lo, 3..5
// hi, 6 valid; rows 128 floats apart): returns tlo, writes thi.
__device__ __forceinline__ float page_tlo(const float* __restrict__ abb,
                                          int p, const float o[3],
                                          const float inv[3], float& thi) {
  const float* a = abb + p * AB_LANES;
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
// bank's page AABB rows, ti/ts its plt_i/plt_s slabs ([17P, 128] and
// [7P, 128], pages on lanes).  Updates the winner w in place.  EXCL: the
// triangle ex may not win (a shadow ray's own).  ANY_HIT: return at the
// first triangle that hits, with t and id only (the occlusion query: only
// id != 0 is meaningful, ROADMAP C5).
template <bool ANY_HIT, bool EXCL>
__device__ __forceinline__ void bank_pass(const float* __restrict__ abb,
                                          const float* __restrict__ ti,
                                          const float* __restrict__ ts, int P,
                                          const float o[3], const float d[3],
                                          const float inv[3], float ex,
                                          Winner& w) {
  uint32_t hit[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int p = q * 32 + j;
      if (abb[p * AB_LANES + 6] == 0.0f) continue;   // padding page
      float thi;
      const float tlo = page_tlo(abb, p, o, inv, thi);
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
        const float tlo = page_tlo(abb, p, o, inv, thi);
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
        winner_payload(f, ts + (long long)j * GROUP + pidx, P, h, w);
      }
    }
  }
}

// ---- the streamed regime's page-major walk ----

// A triangle's record: the packed lanes 0..23 (ops/pages.py), six float4;
// the predicate reads lanes 0..16, the first five.  A page's AABB: two
// float4, lanes 0..2 lo, 3..5 hi, 6 valid, 7 zero.
constexpr int REC4 = 6;
constexpr int PRED4 = 5;
constexpr int PAB4 = 2;
// candidate pages a walk keeps sorted at once
constexpr int CAND = 4;

// Slab interval of the page box b (two float4): returns tlo, writes thi
// and whether the page is valid.
__device__ __forceinline__ float box_tlo(const float4* b, const float o[3],
                                         const float inv[3], float& thi,
                                         bool& valid) {
  const float4 a = b[0], c = b[1];
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, c.x, c.y};
  valid = c.z != 0.0f;
  float tlo;
  slab(lo, hi, o, inv, tlo, thi);
  return tlo;
}

// The walk's candidate pages: the n (<= CAND) least (tlo, page) keys not
// yet visited, ascending; over: some slab-hit page was left out.
struct Cands {
  float t[CAND];
  int p[CAND];
  int n;
  bool over;
};

// Insert page p entered at tlo.  Pages come in index order, so a page
// whose tlo ties a listed one goes after it: the list stays in (tlo, page)
// order.  A full list drops its greatest key.
__device__ __forceinline__ void cand_insert(Cands& c, float tlo, int p) {
  if (c.n == CAND) {
    c.over = true;
    if (!(tlo < c.t[CAND - 1])) return;
  }
  bool shift = false;
#pragma unroll
  for (int k = 0; k < CAND; ++k) {
    shift = shift | (k >= c.n) | (tlo < c.t[k]);
    if (shift) {
      const float tk = c.t[k];
      const int pk = c.p[k];
      c.t[k] = tlo;
      c.p[k] = p;
      tlo = tk;
      p = pk;
    }
  }
  c.n = min(c.n + 1, CAND);
}

// (Re)fill the list from the pages whose bits remain in hit[4], re-testing
// their slabs; a page entered beyond t_max leaves the mask for good.
__device__ __forceinline__ void cand_fill(Cands& c, uint32_t hit[4],
                                          const float4* __restrict__ box,
                                          const float o[3],
                                          const float inv[3], float t_max) {
  c.n = 0;
  c.over = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t m = hit[q];
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int p = q * 32 + j;
      float thi;
      bool valid;
      const float tlo = box_tlo(box + p * PAB4, o, inv, thi, valid);
      if (tlo > t_max)
        hit[q] &= ~(1u << j);
      else
        cand_insert(c, tlo, p);
    }
  }
}

// One bank's traversal over the page-major records for the ray (o, d) with
// slab reciprocals inv: box the bank's 128 page boxes (PAB4 float4 each,
// device or shared memory), rec its records ([128, P] records of REC4
// float4).  Same contract as bank_pass: the winner w updated in place, EXCL
// the excluded triangle ex, ANY_HIT a return at the first hit.  SLOT:
// record the winner's slot (slot_base + page * P + triangle) in *slot
// instead of its payload (B12's sweep extracts the payload once, at the
// end).  n_pages: the bank's pages past it are padding (invalid), so
// their slab tests are skipped.
//
// The visit order is bank_pass's: the least (tlo, page) of the slab-hit
// pages not yet visited, while its tlo <= w.t.  The slab tests run
// once; the CAND least keys sit in registers in order, and only when more
// pages than that were entered is the mask re-tested once the list runs
// dry.  A popped page entered beyond w.t ends the bank: every page left,
// listed or not, enters no nearer.
template <bool ANY_HIT, bool EXCL, bool SLOT = false>
__device__ __forceinline__ void bank_walk(const float4* __restrict__ box,
                                          const float4* __restrict__ rec,
                                          int P, const float o[3],
                                          const float d[3],
                                          const float inv[3], float ex,
                                          Winner& w, int slot_base = 0,
                                          int* slot = nullptr,
                                          int n_pages = GROUP) {
  uint32_t hit[4];
  Cands c;
#pragma unroll
  for (int k = 0; k < CAND; ++k) {
    c.t[k] = 0.0f;
    c.p[k] = 0;
  }
  c.n = 0;
  c.over = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t bits = 0;
    for (int j = 0; j < 32 && q * 32 + j < n_pages; ++j) {
      const int p = q * 32 + j;
      float thi;
      bool valid;
      const float tlo = box_tlo(box + p * PAB4, o, inv, thi, valid);
      if (valid & (tlo <= thi) & (thi >= 0.0f) & (tlo <= w.t)) {
        bits |= 1u << j;
        cand_insert(c, tlo, p);
      }
    }
    hit[q] = bits;
  }

  while (true) {
    if (c.n == 0) {
      if (!c.over) return;
      cand_fill(c, hit, box, o, inv, w.t);
      if (c.n == 0) return;
    }
    const float kmin = c.t[0];
    const int pidx = c.p[0];
#pragma unroll
    for (int k = 0; k + 1 < CAND; ++k) {
      c.t[k] = c.t[k + 1];
      c.p[k] = c.p[k + 1];
    }
    c.n -= 1;
    if (kmin > w.t) return;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q == (pidx >> 5)) hit[q] &= ~(1u << (pidx & 31));

    const float4* page = rec + (long long)pidx * P * REC4;
    for (int j = 0; j < P; ++j) {
      const float4* r4 = page + j * REC4;
      float f[4 * PRED4];
#pragma unroll
      for (int q = 0; q < PRED4; ++q) {
        const float4 v = __ldg(r4 + q);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      auto col = [&f](int lane_f) { return f[lane_f]; };
      const HitTerms h = hit_predicate<false>(col, o, d);
      const float id = f[LANE_ID];
      if (h.ok && (!EXCL || id != ex) && lex_better(h.t, id, w)) {
        w.t = h.t;
        w.id = id;
        if (ANY_HIT) return;
        if (SLOT) {
          *slot = slot_base + pidx * P + j;
        } else {
          const float4 v = __ldg(r4 + PRED4);     // lanes 20..23
          w.n0 = f[LANE_N];
          w.n1 = f[LANE_N + 1];
          w.n2 = f[LANE_N + 2];
          w.enc = encode_face(h, f[LANE_ET], f[LANE_KIND]);
          w.c0 = f[LANE_COLOR];
          w.c1 = v.x;
          w.c2 = v.y;
          w.alpha = v.z;
          w.scat = v.w;
        }
      }
    }
  }
}

}  // namespace rt
