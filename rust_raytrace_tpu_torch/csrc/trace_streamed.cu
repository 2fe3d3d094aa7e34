// B9 and B10: the streamed regime's bank-worklist trace, fused with the
// shade (B9) or writing the winner rows (B10, nearest or any-hit).
//
// Replaces: rust_raytrace_tpu/ops/intersect_streamed.py:
// trace_shade_streamed_pallas (inner _kernel_streamed_fused,
// _streamed_trace_chunk, _bank_group_pass, _bank_extract) and
// trace_streamed_pallas (inner _kernel_streamed) — scenes past the resident
// tables' cap keep their banks' tables in device memory (here as page-major
// records, [NB*128, P, 24], and page boxes, [NB*128, 8]); every ray walks a
// worklist of banks front to back (a slab test against the bank AABBs, the
// nearest remaining bank first, a bank dropped once its entry lies beyond
// the ray's best hit) and the pages inside each bank it visits (the nearest
// remaining page first, the walk over once the nearest lies beyond the best
// hit).  B9 then shades the wave (B0b) with the scatter hash keyed on
// (chunk, lane); B10 writes [16, R] winner rows, with an optional excluded
// triangle per ray and an any-hit mode (stop at the first hit; only ROW_ID
// != 0 is meaningful, ROADMAP C5).  Chunks flagged dead in chunk_live pass
// their state through (B9) or get all-zero rows (B10), as on the TPU.
//
// Bound on this card: the hit predicate's arithmetic on the pages each ray
// visits (~40 flops and an IEEE division a triangle, P = 224 triangles a
// page at 1M triangles), and the reads of those pages' records: 80 B a
// triangle for each (ray, page) pair, since incoherent bounce rays share
// few pages and the 96 MB of records do not fit the 50 MB L2.
//
// B9's design, measured on synthetic_1m_2k (PERF.md, Findings; NVIDIA H100
// 80GB HBM3, 700 W).  The per-thread walk it replaced ran one
// thread a lane of the whole state; its counting instance gave, per live
// ray of wave 2 (407,965 live rays inside the closed sphere), 4.7 bank
// visits, 200 bank-box and 604 page-box slab tests and 2.05 pages (459
// triangles) tested, with the triangle loop at 13.6% active lanes (wave
// 0: 57%, wave 1: 31%): a warp's rays each on a page of their own.  So:
//   list grid: one thread a lane, LIST_BLOCK lanes a block.  A dead
//     chunk's lanes copy their 16 state words.  A live chunk's lane that
//     is invalid, or whose ray enters no bank box, is shaded here with the
//     winner it would get (no hit).  The rest go into the live list, a
//     block's by direction octant and in lane order within one (warp
//     ballots), at positions claimed with one atomic add a block: rays
//     leaving nearby points in like directions sit side by side.  It also
//     counts the listed rays whose origin lies in no bank box they enter.
//   trace grid: persistent, a group of G lanes a ray, G = LANES_OUTSIDE =
//     16 where more than half the listed rays start outside every bank box
//     they enter, else LANES = 32 (a warp); both widths are launched and
//     the other returns at once.  A warp claims CLAIM rays a group at a
//     time from a counter.  The group slab-tests the NB bank boxes (staged in shared memory)
//     once, a lane keeping its banks' entries as bits in registers (lane
//     l owns banks l, l + G, ...; MW words cover MAX_BANKS), and each
//     step takes the least (entry, bank) of the set bits by a shuffle
//     reduction, pruning the banks entered beyond the best hit: the visit
//     order of the per-step rescan, without it.  That order matters for
//     the bits: a page box whose entry rounds past an equal-t copy's hit is
//     pruned, as the plain version and the TPU kernel prune it.  In a bank
//     the group first slab-tests the 16 group boxes of 8 pages
//     (ops/intersect_perlane.py:group_boxes; a page that passes passes
//     its group's), then the page boxes of the groups that pass, 4 a lane,
//     read coalesced from L1/L2, and keeps each page's entry in registers;
//     each step takes the least (entry, page) by shuffles.  A page's P
//     triangles are strided over the lanes, so a group reads a page's
//     records as one contiguous stream; each lane first computes the
//     plane's t from two float4, and only a t that could win goes on to
//     the plane distances (two more float4) and the id (a fifth), the
//     predicate's own arithmetic (the hit test needs all three distances
//     <= 1, so the order of the tests changes nothing).  The page's winner
//     is the lexicographic (t, id) minimum of the lanes' by shuffles (a
//     copy of a triangle within a page: the lower slot, as a scan in slot
//     order keeps), and the walk prunes with it after each page.  The
//     winner's page and slot are kept; at the end the group's first lane
//     re-tests that triangle (the same hit terms, hence the same face
//     bits), reads its payload as the per-thread walk stored it, shades
//     the ray and writes its state at its own lane.  The winner is the
//     lexicographic (t, id) minimum in the plain version's visit order,
//     and the scatter hash is keyed on the ray's (chunk, lane), so neither
//     the list's order nor the lanes' split of a page changes a bit.
//   Why these widths and the group boxes: 8, 16 and 32 lanes a ray, with
//     and without the group boxes, timed in turns on whole waves 0 / 1 /
//     2, ms (one H100 call): 32 lanes 5.05 / 2.69 / 2.42 with the group
//     boxes, 5.43 / 2.87 / 2.55 without; 16 lanes 4.58 / 2.72 / 2.89 and
//     4.94 / 2.84 / 2.96; 8 lanes 5.52 / 3.49 / 4.69 (the per-thread walk:
//     4.68 / 3.81 / 8.57).  16 lanes win on wave 0, whose listed rays are
//     camera rays from outside the scene in tile order; 32 win on the
//     bounce waves,
//     whose rays start on a surface, inside a bank box.  The group boxes
//     cut wave 2's page-box tests from 604 to 56 (and 75 group tests) a
//     ray and win at every width.  Past them the reads of the visited
//     pages' records bound the walk: 64 B a triangle (the two sectors of
//     its plane and side terms) for each (ray, page) pair, 1.2-2.1 pages
//     of 224 a ray.
//
// B10 keeps the per-thread walk (its any-hit mode returns the first hit in
// that walk's visit order): one thread a ray, blocks of THREADS = 128 that
// stage the NB bank AABBs in shared memory once; each step re-runs the
// slab test of every bank and takes the nearest bank after the last one in
// (entry, index) order, then rt::bank_walk (perlane.cuh) over its
// page-major records.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::BANK_BOXES;
using rt::BOX_PAGES;
using rt::GROUP;
using rt::PAB4;
using rt::REC4;
using rt::box_entered;

// floats of a staged bank AABB (lanes 0..2 lo, 3..5 hi, 6 valid, 7 zero)
constexpr int BOX = 8;
// B10: threads a block, one ray each; eight blocks an SM cap the walk at
// 64 registers, which runs faster than the uncapped walk despite its
// spills
constexpr int THREADS = 128;

__device__ void stage_banks(float* sb, const float* __restrict__ bank_ab,
                            int NB) {
  for (int i = threadIdx.x; i < NB * BOX; i += blockDim.x)
    sb[i] = bank_ab[(long long)(i / BOX) * AB_LANES + i % BOX];
}

// ---- B10: the per-thread walk ----

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

// o_rows/d_rows three rows each, row_stride floats apart, alive [R], and
// out the [16, R] winner rows.  Dynamic shared memory: NB * BOX floats.
template <bool ANY_HIT, bool EXCL>
__global__ void __launch_bounds__(THREADS, 8)
trace_streamed_kernel(const float* __restrict__ o_rows,
                      const float* __restrict__ d_rows,
                      const float* __restrict__ alive, long long row_stride,
                      long long R, const float* __restrict__ excl,
                      const float4* __restrict__ rec,
                      const float4* __restrict__ pab,
                      const float* __restrict__ bank_ab, int P, int NB,
                      int ray_chunk, const int* __restrict__ chunk_live,
                      float* __restrict__ out) {
  extern __shared__ float4 s_bank[];
  stage_banks(reinterpret_cast<float*>(s_bank), bank_ab, NB);
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long chunk = r / ray_chunk;
  if (chunk_live != nullptr && chunk_live[chunk] == 0) {
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
    trace_banks<ANY_HIT, EXCL>(o, d, EXCL ? excl[r] : 0.0f, rec, pab, s_bank,
                               P, NB, w);
  rt::store_winner(w, out, R, r);
}

template <bool ANY_HIT, bool EXCL>
int launch_b10(const float* o_rows, const float* d_rows, const float* alive,
               long long row_stride, long long R, const float* excl,
               const float* rec, const float* pab, const float* bank_ab,
               int P, int NB, int ray_chunk, const int* chunk_live,
               float* out, cudaStream_t stream) {
  const size_t smem = (size_t)NB * BOX * sizeof(float);
  auto kernel = trace_streamed_kernel<ANY_HIT, EXCL>;
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
      chunk_live, out);
  return (int)cudaGetLastError();
}

// ---- B9: the live list, then a group of lanes a ray ----

constexpr int LIST_BLOCK = 1024;    // lanes a block of the list grid
constexpr int TRACE_THREADS = 128;  // threads a block of the trace grid
// lanes a ray: where most listed rays start outside every bank box they
// enter (camera rays), else
constexpr int LANES_OUTSIDE = 16;
constexpr int LANES = 32;
constexpr int CLAIM = 4;            // rays a group takes a claim
// the most banks the wrapper takes (utils/native.py MAX_STREAMED_BANKS)
constexpr int MAX_BANKS = 4096;
constexpr int NO_KEY = 0x7fffffff;

// Work counters of one ray, kept by B9's counting instance (a diagnostic;
// chip_smoke.py's counting phase): rows of cnt [N_COUNT, R] int32 at the
// ray's lane.  bank_steps: bank selection steps (the last, which finds
// none, included); bank_tests: bank-box slab tests; bank_visits;
// group_tests: group-box slab tests; page_tests: page-box slab tests;
// pages: pages whose triangles were tested; tris: triangles tested (P a
// page); led: the triangle-loop iterations that the ray's lanes led (the
// lowest active lane of a warp's converged set, so summed over rays the
// iterations the warps issued); lane_iters: the triangle-loop iterations
// the ray's lanes ran.  lane_iters / (32 * led) over a wave is the
// triangle loop's active-lane share.
constexpr int N_COUNT = 9;
struct Count {
  int bank_steps, bank_tests, bank_visits, group_tests, page_tests, pages,
      tris, led, lane_iters;
};

// Whether a bank box counts for the walk: slab-hit, valid, entered no later
// than t_max, and at a finite entry (the per-step rescan selects a bank
// only below +inf).
__device__ __forceinline__ bool bank_entered(const float4* s_bank, int b,
                                             const float o[3],
                                             const float inv[3], float t_max,
                                             float& tlo) {
  float thi;
  bool valid;
  tlo = rt::box_tlo(s_bank + b * PAB4, o, inv, thi, valid);
  return valid & (tlo <= thi) & (thi >= 0.0f) & (tlo <= t_max) &
         (tlo < rt::inf_f());
}

// The list grid.  Dynamic shared memory: NB * BOX floats.  count[0]: the
// list's length; count[2]: the listed rays whose origin lies in no bank
// box they enter (zeros at launch).
__global__ void __launch_bounds__(LIST_BLOCK)
stream_list_kernel(const float* __restrict__ st, float* __restrict__ out,
                   long long R, const float* __restrict__ bank_ab, int NB,
                   int ray_chunk, const int* __restrict__ chunk_live,
                   uint32_t s0, uint32_t s1, bool fixed_rng,
                   float weight_cutoff, const uint32_t* __restrict__ rsq,
                   int* __restrict__ list, int* __restrict__ count) {
  extern __shared__ float4 s_bank[];
  __shared__ int s_warp[8][LIST_BLOCK / 32];
  __shared__ int s_outside[LIST_BLOCK / 32];
  __shared__ int s_base;
  stage_banks(reinterpret_cast<float*>(s_bank), bank_ab, NB);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = (long long)blockIdx.x * LIST_BLOCK + tid;
  bool queued = false, inside = false;
  int oct = 0;
  if (r < R) {
    const long long chunk = r / ray_chunk;
    float s[rt::STATE_ROWS];
#pragma unroll
    for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
    if (chunk_live[chunk] != 0) {
      const bool valid = s[rt::ROW_ALIVE] != 0.0f;
      if (valid) {
        const float o[3] = {s[0], s[1], s[2]};
        float inv[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) inv[k] = rt::slab_inv(s[3 + k]);
        // listed if it enters a bank box; the scan goes on until a box
        // holds its origin (an entry at t <= 0) for the trace grid's
        // choice of lanes
        for (int b = 0; b < NB && !inside; ++b) {
          float tlo;
          if (bank_entered(s_bank, b, o, inv, rt::inf_f(), tlo)) {
            queued = true;
            inside = tlo <= 0.0f;
          }
        }
        oct = (s[3] < 0.0f) * 4 + (s[4] < 0.0f) * 2 + (s[5] < 0.0f);
      }
      if (!queued) {
        float v[3], inv;
        rt::scatter_rv(s0, s1, (uint32_t)chunk,
                       (uint32_t)(r - chunk * ray_chunk), ray_chunk,
                       fixed_rng, rsq, v, inv);
        rt::shade_ray(s, rt::winner_init(valid), v, inv, fixed_rng,
                      weight_cutoff, false, rsq);
      }
    }
    if (!queued) {
#pragma unroll
      for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
    }
  }
  uint32_t mine = 0u;
  for (int q = 0; q < 8; ++q) {
    const uint32_t m = __ballot_sync(0xffffffffu, queued && oct == q);
    if (lane == 0) s_warp[q][warp] = __popc(m);
    if (queued && oct == q) mine = m;
  }
  const uint32_t outside = __ballot_sync(0xffffffffu, queued && !inside);
  if (lane == 0) s_outside[warp] = __popc(outside);
  __syncthreads();
  if (tid == 0) {
    int total = 0, n_out = 0;
    for (int q = 0; q < 8; ++q)
      for (int w = 0; w < LIST_BLOCK / 32; ++w) {
        const int c = s_warp[q][w];
        s_warp[q][w] = total;
        total += c;
      }
    for (int w = 0; w < LIST_BLOCK / 32; ++w) n_out += s_outside[w];
    s_base = total ? atomicAdd(count, total) : 0;
    if (n_out) atomicAdd(count + 2, n_out);
  }
  __syncthreads();
  if (queued)
    list[s_base + s_warp[oct][warp] + __popc(mine & ((1u << lane) - 1u))] =
        (int)r;
}

// The n <= 32 low bits set.
__device__ __forceinline__ constexpr uint32_t low_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// The lexicographic (t, id) order of rt::lex_better on bare values.
__device__ __forceinline__ bool lex_less(float t, float id, float bt,
                                         float bid) {
  return (t < bt) | ((t == bt) & !isinf(t) & (id < bid));
}

// The least (key, index) over a group of G lanes (mask gm), in every lane.
template <int G>
__device__ __forceinline__ void group_min(unsigned gm, float& k, int& i) {
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    const float ok = __shfl_xor_sync(gm, k, m);
    const int oi = __shfl_xor_sync(gm, i, m);
    if ((ok < k) | ((ok == k) & (oi < i))) {
      k = ok;
      i = oi;
    }
  }
}

template <int G>
__device__ __forceinline__ int group_sum(unsigned gm, int v) {
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) v += __shfl_xor_sync(gm, v, m);
  return v;
}

// One page of P triangles for the group's ray: lane gl tests slots gl, gl
// + G, ...; returns, in every lane, whether the group's least (t, id)
// beats (wt, wid), and then sets wt, wid and the winning slot wj.
template <int G, bool COUNT>
__device__ __forceinline__ bool group_page(const float4* __restrict__ page,
                                           int P, int gl, unsigned gm,
                                           const float o[3], const float d[3],
                                           float& wt, float& wid, int& wj,
                                           Count& c) {
  float lt = wt, lid = wid;
  int lj = NO_KEY;
  for (int j = gl; j < P; j += G) {
    if (COUNT) {
      const unsigned am = __activemask();
      c.lane_iters += 1;
      if ((int)(threadIdx.x & 31) == __ffs(am) - 1) c.led += 1;
    }
    const float4* r4 = page + j * REC4;
    // lanes 0..3 (n, s0.x) and 12..15 (nc, s0c, s1c, s2c)
    const float4 a = __ldg(r4), e = __ldg(r4 + 3);
    // rt::hit_predicate's t: (nc - n.o) / (n.d)
    const float md_n = fmaf(a.z, d[2], fmaf(a.x, d[0], a.y * d[1]));
    const float t =
        (e.x - fmaf(a.z, o[2], fmaf(a.x, o[0], a.y * o[1]))) / md_n;
    if (!((t >= 0.0f) & ((t < lt) | ((t == lt) & !isinf(t))))) continue;
    // lanes 4..11: the rest of s0, s1, s2
    const float4 b = __ldg(r4 + 1), q = __ldg(r4 + 2);
    const float dv0 =
        fmaf(t, fmaf(b.y, d[2], fmaf(a.w, d[0], b.x * d[1])),
             fmaf(b.y, o[2], fmaf(a.w, o[0], b.x * o[1]))) - e.y;
    const float dv1 =
        fmaf(t, fmaf(q.x, d[2], fmaf(b.z, d[0], b.w * d[1])),
             fmaf(q.x, o[2], fmaf(b.z, o[0], b.w * o[1]))) - e.z;
    const float dv2 =
        fmaf(t, fmaf(q.w, d[2], fmaf(q.y, d[0], q.z * d[1])),
             fmaf(q.w, o[2], fmaf(q.y, o[0], q.z * o[1]))) - e.w;
    if (!((dv0 <= 1.0f) & (dv1 <= 1.0f) & (dv2 <= 1.0f))) continue;
    const float id = __ldg(r4 + 4).x;         // lane 16
    if (lex_less(t, id, lt, lid)) {
      lt = t;
      lid = id;
      lj = j;
    }
  }
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    const float ot = __shfl_xor_sync(gm, lt, m);
    const float oid = __shfl_xor_sync(gm, lid, m);
    const int oj = __shfl_xor_sync(gm, lj, m);
    if (lex_less(ot, oid, lt, lid) |
        ((ot == lt) & (oid == lid) & (oj < lj))) {
      lt = ot;
      lid = oid;
      lj = oj;
    }
  }
  if (lj == NO_KEY) return false;
  wt = lt;
  wid = lid;
  wj = lj;
  return true;
}

// One bank for the group's ray: its BANK_BOXES group boxes slab-tested,
// then the page boxes of the groups that pass, PPL a lane, then the pages
// in (entry, page) order while the nearest is entered no later than wt.
// wpage: the winner's page over all banks.
template <int G, bool COUNT>
__device__ __forceinline__ void group_bank(
    const float4* __restrict__ box, const float4* __restrict__ gbox,
    const float4* __restrict__ rec, int P, int page_base, int gl, int grp,
    unsigned gm, const float o[3], const float d[3], const float inv[3],
    float& wt, float& wid, int& wpage, int& wj, Count& c) {
  constexpr int PPL = GROUP / G;
  uint32_t pass = 0u;               // bit k: group box k passes
#pragma unroll
  for (int k0 = 0; k0 < BANK_BOXES; k0 += G) {
    float tlo;
    const bool in = k0 + gl < BANK_BOXES &&
                    box_entered(gbox + (k0 + gl) * PAB4, o, inv, wt, tlo);
    const uint32_t bal = __ballot_sync(gm, in);
    pass |= ((bal >> (grp * G)) & low_bits(G)) << k0;
  }
  if (COUNT) {
    c.group_tests += BANK_BOXES;
    c.page_tests += BOX_PAGES * __popc(pass);
  }
  float ptl[PPL];
#pragma unroll
  for (int q = 0; q < PPL; ++q) {
    const int p = gl + G * q;
    float tlo;
    ptl[q] = ((pass >> (p / BOX_PAGES)) & 1u) &&
                     box_entered(box + p * PAB4, o, inv, wt, tlo)
        ? tlo : rt::inf_f();
  }
  while (true) {
    float kt = rt::inf_f();
    int kp = NO_KEY;
#pragma unroll
    for (int q = 0; q < PPL; ++q)
      if (ptl[q] < kt) {
        kt = ptl[q];
        kp = gl + G * q;
      }
    group_min<G>(gm, kt, kp);
    if ((kp == NO_KEY) | (kt > wt)) return;
#pragma unroll
    for (int q = 0; q < PPL; ++q)
      if (gl + G * q == kp) ptl[q] = rt::inf_f();
    if (COUNT) {
      c.pages += 1;
      c.tris += P;
    }
    if (group_page<G, COUNT>(rec + (long long)kp * P * REC4, P, gl, gm, o,
                             d, wt, wid, wj, c))
      wpage = page_base + kp;
  }
}

// One ray r of the list for the group: the bank worklist, then (the
// group's first lane) the payload, the shade and the state's store.
template <int G, bool COUNT>
__device__ __forceinline__ void group_ray(
    long long r, const float* __restrict__ st, float* __restrict__ out,
    long long R, const float4* __restrict__ rec,
    const float4* __restrict__ pab, const float4* __restrict__ gab,
    const float4* s_bank, int P, int NB, int ray_chunk, uint32_t s0,
    uint32_t s1, bool fixed_rng, float weight_cutoff,
    const uint32_t* __restrict__ rsq, int gl, int grp, unsigned gm,
    int* __restrict__ cnt) {
  float o[3], d[3], inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = st[k * R + r];
    d[k] = st[(3 + k) * R + r];
    inv[k] = rt::slab_inv(d[k]);
  }
  float wt = rt::inf_f(), wid = 0.0f;
  int wpage = -1, wj = 0;
  Count c = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  // lane gl owns banks gl, gl + G, ...: bit j of word i is bank gl + G *
  // (32 * i + j), MW words for every bank the wrapper takes
  constexpr int MW = MAX_BANKS / (32 * G);
  uint32_t bm[MW];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
    uint32_t bits = 0u;
    for (int j = 0; j < 32; ++j) {
      const int b = gl + G * (32 * i + j);
      if (b >= NB) break;
      float tlo;
      if (bank_entered(s_bank, b, o, inv, wt, tlo)) bits |= 1u << j;
    }
    bm[i] = bits;
  }
  if (COUNT) c.bank_tests += NB;
  while (true) {
    if (COUNT) c.bank_steps += 1;
    float kt = rt::inf_f();
    int kb = NO_KEY;
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      uint32_t m = bm[i];
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int b = gl + G * (32 * i + j);
        float tlo;
        if (!bank_entered(s_bank, b, o, inv, wt, tlo))
          bm[i] &= ~(1u << j);              // entered beyond the best hit
        else if (tlo < kt) {                // a lane's banks rise with i, j
          kt = tlo;
          kb = b;
        }
      }
    }
    group_min<G>(gm, kt, kb);
    if (kb == NO_KEY) break;
    if (kb % G == gl) {
      const int k = kb / G;
#pragma unroll
      for (int i = 0; i < MW; ++i)
        if (i == (k >> 5)) bm[i] &= ~(1u << (k & 31));
    }
    if (COUNT) c.bank_visits += 1;
    group_bank<G, COUNT>(
        pab + (long long)kb * GROUP * PAB4,
        gab + (long long)kb * BANK_BOXES * PAB4,
        rec + (long long)kb * GROUP * P * REC4, P, kb * GROUP, gl, grp, gm,
        o, d, inv, wt, wid, wpage, wj, c);
  }
  if (COUNT) {
    c.led = group_sum<G>(gm, c.led);
    c.lane_iters = group_sum<G>(gm, c.lane_iters);
  }
  if (gl != 0) return;
  if (COUNT) {
    const int v[N_COUNT] = {c.bank_steps, c.bank_tests, c.bank_visits,
                            c.group_tests, c.page_tests, c.pages, c.tris,
                            c.led, c.lane_iters};
#pragma unroll
    for (int i = 0; i < N_COUNT; ++i) cnt[i * R + r] = v[i];
  }
  float s[rt::STATE_ROWS];
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
  rt::Winner w = rt::winner_init(true);
  w.t = wt;
  w.id = wid;
  if (wpage >= 0) {
    // the winner re-tested: the hit terms of its win, and its payload as
    // rt::bank_walk stores it
    const float4* r4 = rec + ((long long)wpage * P + wj) * REC4;
    float f[4 * REC4];
#pragma unroll
    for (int q = 0; q < REC4; ++q) {
      const float4 v = __ldg(r4 + q);
      f[4 * q] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
    auto col = [&f](int lane_f) { return f[lane_f]; };
    const rt::HitTerms h = rt::hit_predicate<false>(col, o, d);
    w.n0 = f[rt::LANE_N];
    w.n1 = f[rt::LANE_N + 1];
    w.n2 = f[rt::LANE_N + 2];
    w.enc = rt::encode_face(h, f[rt::LANE_ET], f[rt::LANE_KIND]);
    w.c0 = f[rt::LANE_COLOR];
    w.c1 = f[rt::LANE_COLOR + 1];
    w.c2 = f[rt::LANE_COLOR + 2];
    w.alpha = f[rt::LANE_ALPHA];
    w.scat = f[rt::LANE_SCAT];
  }
  const long long chunk = r / ray_chunk;
  float v[3], vinv;
  rt::scatter_rv(s0, s1, (uint32_t)chunk, (uint32_t)(r - chunk * ray_chunk),
                 ray_chunk, fixed_rng, rsq, v, vinv);
  rt::shade_ray(s, w, v, vinv, fixed_rng, weight_cutoff, false, rsq);
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
}

// The trace grid: persistent; a warp claims CLAIM * (32 / G) entries of
// the list at a time from count[1] and its groups take them in turn.  Of
// the two instances launched, the one of the other width returns at once:
// G = LANES_OUTSIDE runs where more than half the listed rays start
// outside every bank box they enter (count[2]).  Dynamic shared memory:
// NB * BOX floats.
template <int G, bool COUNT>
__global__ void __launch_bounds__(TRACE_THREADS)
stream_trace_kernel(const float* __restrict__ st, float* __restrict__ out,
                    long long R, const float4* __restrict__ rec,
                    const float4* __restrict__ pab,
                    const float4* __restrict__ gab,
                    const float* __restrict__ bank_ab, int P, int NB,
                    int ray_chunk, uint32_t s0, uint32_t s1, bool fixed_rng,
                    float weight_cutoff, const uint32_t* __restrict__ rsq,
                    const int* __restrict__ list, int* count,
                    int* __restrict__ cnt) {
  const int n = count[0];
  if ((2LL * count[2] > n) != (G == LANES_OUTSIDE)) return;
  extern __shared__ float4 s_bank[];
  stage_banks(reinterpret_cast<float*>(s_bank), bank_ab, NB);
  __syncthreads();
  constexpr int GPW = 32 / G;
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;
  const int grp = lane / G;
  const unsigned gm = low_bits(G) << (grp * G);
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(count + 1, CLAIM * GPW);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n) return;
    for (int k = 0; k < CLAIM; ++k) {
      const int e = base + k * GPW + grp;
      if (e < n)
        group_ray<G, COUNT>(list[e], st, out, R, rec, pab, gab,
                            s_bank, P, NB, ray_chunk, s0, s1, fixed_rng,
                            weight_cutoff, rsq, gl, grp, gm, cnt);
    }
    __syncwarp();
  }
}

// Occupancy-sized persistent launch of one trace grid instance.
template <int G, bool COUNT>
cudaError_t launch_trace(const float* st, float* out, long long R,
                         const float* rec, const float* pab,
                         const float* gab, const float* bank_ab, int P,
                         int NB, int ray_chunk, unsigned s0, unsigned s1,
                         int fixed_rng, float weight_cutoff,
                         const unsigned* rsq, const int* list, int* count,
                         int* cnt, size_t smem, cudaStream_t stream) {
  auto trace = stream_trace_kernel<G, COUNT>;
  cudaError_t e = cudaSuccess;
  if (smem > 40 * 1024)
    e = cudaFuncSetAttribute(
        trace, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace,
                                                      TRACE_THREADS, smem);
  if (e != cudaSuccess) return e;
  trace<<<sms * per_sm, TRACE_THREADS, smem, stream>>>(
      st, out, R, reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(pab),
      reinterpret_cast<const float4*>(gab), bank_ab, P, NB, ray_chunk, s0,
      s1, fixed_rng != 0, weight_cutoff, rsq, list, count, cnt);
  return cudaGetLastError();
}

// B9: the list grid, then the trace grid at LANES_OUTSIDE or LANES lanes a
// ray, as the list says.  list: [R] int32 scratch; count: three int32
// zeros; cnt: the counting instance's [N_COUNT, R] int32 zeros, or null.
template <bool COUNT>
int launch_b9(const float* st, float* out, long long R, const float* rec,
              const float* pab, const float* gab, const float* bank_ab,
              int P, int NB, int ray_chunk, const int* chunk_live,
              unsigned s0, unsigned s1, int fixed_rng, float weight_cutoff,
              const unsigned* rsq, int* list, int* count, int* cnt,
              cudaStream_t stream) {
  const size_t smem = (size_t)NB * BOX * sizeof(float);
  if (smem > 40 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_list_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (R + LIST_BLOCK - 1) / LIST_BLOCK;
  stream_list_kernel<<<(unsigned)blocks, LIST_BLOCK, smem, stream>>>(
      st, out, R, bank_ab, NB, ray_chunk, chunk_live, s0, s1,
      fixed_rng != 0, weight_cutoff, rsq, list, count);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess)
    e = launch_trace<LANES_OUTSIDE, COUNT>(
        st, out, R, rec, pab, gab, bank_ab, P, NB, ray_chunk, s0, s1,
        fixed_rng, weight_cutoff, rsq, list, count, cnt, smem, stream);
  if (e == cudaSuccess)
    e = launch_trace<LANES, COUNT>(
        st, out, R, rec, pab, gab, bank_ab, P, NB, ray_chunk, s0, s1,
        fixed_rng, weight_cutoff, rsq, list, count, cnt, smem, stream);
  return (int)e;
}

}  // namespace

extern "C" int rt_trace_shade_streamed(
    const float* st, float* out, long long R, const float* rec,
    const float* pab, const float* gab, const float* bank_ab, int P, int NB,
    int ray_chunk, const int* chunk_live, unsigned s0, unsigned s1,
    int fixed_rng, float weight_cutoff, const unsigned* rsq, int* list,
    int* count, void* stream) {
  return launch_b9<false>(st, out, R, rec, pab, gab, bank_ab, P, NB,
                          ray_chunk, chunk_live, s0, s1, fixed_rng,
                          weight_cutoff, rsq, list, count, nullptr,
                          (cudaStream_t)stream);
}

// B9's counting instance (never on a render path): the same result, and
// cnt [N_COUNT, R] (zeros at launch) filled as Count says.
extern "C" int rt_trace_shade_streamed_counts(
    const float* st, float* out, long long R, const float* rec,
    const float* pab, const float* gab, const float* bank_ab, int P, int NB,
    int ray_chunk, const int* chunk_live, unsigned s0, unsigned s1,
    int fixed_rng, float weight_cutoff, const unsigned* rsq, int* list,
    int* count, int* cnt, void* stream) {
  return launch_b9<true>(st, out, R, rec, pab, gab, bank_ab, P, NB,
                         ray_chunk, chunk_live, s0, s1, fixed_rng,
                         weight_cutoff, rsq, list, count, cnt,
                         (cudaStream_t)stream);
}

extern "C" int rt_trace_streamed(const float* ot, const float* dt,
                                 long long row_stride, const float* alive,
                                 long long R, const float* excl, int any_hit,
                                 const float* rec, const float* pab,
                                 const float* bank_ab, int P, int NB,
                                 int ray_chunk, const int* chunk_live,
                                 float* out, void* stream) {
  auto fn = any_hit ? (excl ? launch_b10<true, true>
                            : launch_b10<true, false>)
                    : (excl ? launch_b10<false, true>
                            : launch_b10<false, false>);
  return fn(ot, dt, alive, row_stride, R, excl, rec, pab, bank_ab, P, NB,
            ray_chunk, chunk_live, out, (cudaStream_t)stream);
}
