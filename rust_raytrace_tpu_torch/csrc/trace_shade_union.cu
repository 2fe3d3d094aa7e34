// B2 and B6: the union trace over culled page lists, fused with the shade
// (B2, wave 0 without lights) or writing the winner rows (B6).
//
// Replaces: rust_raytrace_tpu/ops/intersect_pallas.py:trace_shade_chunks_pallas
// (inner _kernel_trace_shade and _trace_pages) and trace_chunks_pallas (inner
// _kernel_trace) — each ray chunk walks its culled pages
// plist[chunk, :counts[chunk]] front to back, keeps the lexicographic (t, id)
// winner of every ray with its payload (normal, enc, color, alpha,
// scattering), stops once every ray of the chunk has a hit nearer than the
// next page's entry bound ptmin, and then shades the wave (B0b) into the new
// ray state (B2) or writes the winner as [16, R] rows (B6).  B6 takes an
// optional per-ray excluded triangle id (a shadow ray's own triangle); a ray
// that meets no other triangle keeps best t = +inf, so the early exit never
// drops an occluder.
//
// Bound on this card: bytes (PERF.md): the rays in (only d on folded
// pages) and the rows or the state out, with the visited pages'
// predicate lanes and the winners' payload read once, 0.084 ms a
// 2560x1440 camera wave, 0.101 its shadow rays and 0.141 B2, against the
// ~3-5 GFLOP the exact function needs on the pages the exit visits
// (~0.05-0.08 ms).  What
// holds the kernel back is instruction issue on the pair tests: ~27 issued
// instructions a pair up to the lexicographic test, ten of them the IEEE
// division, at ~1.4 visited pages a chunk.
//
// Design: one block per chunk; a thread owns RPT rays of it (lane s *
// blockDim + threadIdx.x for slot s, so loads stay coalesced): 2 on folded
// pages (camera rays: 512 threads at ray_chunk 1024), 1 with ray origins
// (1024 threads), more above ray_chunk 1024 (at most 1024 threads), under a
// 64-register cap.  Each visited page's first 20 lanes (the predicate's 17
// and 3 more, five float4 a triangle: 8,960 B at P = 56 for two buffers)
// are staged in shared memory by cp.async, page 0's while the rays load and
// page k + 1's while page k is tested; every thread reads a triangle at one
// address (a broadcast).  Per pair, stage by stage over a thread's rays (so
// their chains interleave): the plane's t first (the predicate's own n.d
// and, with the ray origin, n.o, and its IEEE division); t >= 0, the
// exclusion and the lexicographic test against the running (t, id) winner;
// only then the plane distances, one at a time while a ray could still
// win.  Every pair that could change the winner thus takes the whole
// predicate in the predicate's own arithmetic, and a NaN or infinite t (the
// pages' zero-normal padding slots) fails as before.  A thread keeps only
// each ray's (t, id) and the winning slot; the payload is read from the
// slot's record after the loop, its hit terms recomputed by
// rt::hit_predicate with the same bits.  The early exit stays chunk-wide as
// on the TPU: one __syncthreads_and a page over every ray's "best <
// ptmin[k + 1]" (which also publishes the next page's staged copy), so
// every ray of a chunk tests the same pages and the winners equal the TPU
// kernel's at any ray_chunk.  The scatter hash keys on the ray's lane
// within the chunk and on ray_chunk, not on the block.  B2 and B6 are one
// template over SHADE and EXCL, so they share the page loop.
#include "common.cuh"

namespace {

constexpr int TRI4 = 5;       // staged float4 a triangle: lanes 0..19

__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying lanes 0..19 of page `page`'s P records into dst [P][TRI4].
__device__ __forceinline__ void stage_page(float4* dst,
                                           const float* __restrict__ pk,
                                           int page, int P) {
  const float* src = pk + (long long)page * P * rt::PACK_LANES;
  for (int i = threadIdx.x; i < P * TRI4; i += blockDim.x) {
    const int j = i / TRI4;
    cp_async16(dst + i, src + j * rt::PACK_LANES + (i - j * TRI4) * 4);
  }
}

// XLA's contraction of a*x + b*y + c*z (rt::dot3) with the lanes given.
__device__ __forceinline__ float dot3(float a, float b, float c,
                                      const float r[3]) {
  return fmaf(c, r[2], fmaf(a, r[0], b * r[1]));
}

// Plane distance dv = t (s.d) + s.o - sc (ZERO_ORIGIN: t (s.d) - sc) of
// rt::hit_predicate.
template <bool ZERO_ORIGIN>
__device__ __forceinline__ float plane_dist(float a, float b, float c,
                                            float sc, float t,
                                            const float o[3],
                                            const float d[3]) {
  return ZERO_ORIGIN ? fmaf(t, dot3(a, b, c, d), -sc)
                     : fmaf(t, dot3(a, b, c, d), dot3(a, b, c, o)) - sc;
}

// o_rows/d_rows: three rows each, row_stride floats apart.  SHADE: st is the
// [16, R] state (its rows 0..5 are o_rows/d_rows) and out the new state;
// otherwise out gets the [16, R] winner rows.  EXCL: excl[r] may not win.
// RPT: the rays of the chunk each thread owns.
template <int RPT, bool ZERO_ORIGIN, bool SHADE, bool EXCL>
__global__ void __launch_bounds__(1024)
trace_union_kernel(const float* __restrict__ o_rows,
                   const float* __restrict__ d_rows, long long row_stride,
                   long long R, const float* __restrict__ excl,
                   const float* __restrict__ pk, int P, int NP,
                   const int* __restrict__ counts,
                   const int* __restrict__ plist,
                   const float* __restrict__ ptmin,
                   const float* __restrict__ st, float* __restrict__ out,
                   uint32_t s0, uint32_t s1, bool fixed_rng,
                   float weight_cutoff, int ray_chunk,
                   const uint32_t* __restrict__ rsq) {
  extern __shared__ float4 s_page[];           // [2][P][TRI4]
  const int chunk = blockIdx.x;
  const int bd = blockDim.x;
  const int n = counts[chunk];
  const int* pl = plist + (long long)chunk * NP;
  const float* ptm = ptmin + (long long)chunk * NP;
  if (n > 0) stage_page(s_page, pk, pl[0], P);   // in flight with the rays

  // slot s: lane s * bd + threadIdx.x of the chunk; a slot past ray_chunk
  // or with d = 0 keeps t = -inf, below every ptmin, and never wins
  float o[RPT][3], d[RPT][3], ex[RPT], bt[RPT], bid[RPT];
  int slot[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * bd + threadIdx.x;
    const bool in = l < ray_chunk;
    const long long r = (long long)chunk * ray_chunk + (in ? l : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[s][k] = ZERO_ORIGIN ? 0.0f : o_rows[k * row_stride + r];
      d[s][k] = d_rows[k * row_stride + r];
    }
    const bool valid = in &&
        ((d[s][0] != 0.0f) | (d[s][1] != 0.0f) | (d[s][2] != 0.0f));
    ex[s] = EXCL ? excl[r] : 0.0f;
    bt[s] = valid ? rt::inf_f() : -rt::inf_f();
    bid[s] = 0.0f;
    slot[s] = -1;
  }

  if (n > 0) {
    cp_async_wait_all();
    __syncthreads();
  }
  for (int k = 0; k < n; ++k) {
    const float4* page = s_page + (k & 1) * P * TRI4;
    if (k + 1 < n)       // into the buffer every thread left before the vote
      stage_page(s_page + ((k + 1) & 1) * P * TRI4, pk, pl[k + 1], P);
    const int base = pl[k] * P;
    for (int j = 0; j < P; ++j) {
      const float4* f = page + j * TRI4;
      const float4 q0 = f[0];                  // n, s0.x
      const float4 q3 = f[3];                  // nc, s0c, s1c, s2c
      const float id = f[4].x;
      // stage by stage over the thread's rays (independent chains): the
      // plane's t with rt::hit_predicate's t >= 0, the exclusion and
      // rt::lex_better; then each plane distance while a ray could still
      // win (bit s of go)
      float t[RPT];
      unsigned go = 0u;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const float md_n = dot3(q0.x, q0.y, q0.z, d[s]);
        t[s] = ZERO_ORIGIN ? q3.x / md_n
                           : (q3.x - dot3(q0.x, q0.y, q0.z, o[s])) / md_n;
        const bool win = (t[s] >= 0.0f) & (!EXCL | (id != ex[s])) &
            ((t[s] < bt[s]) | ((t[s] == bt[s]) & !isinf(t[s]) &
                               (id < bid[s])));
        go |= win ? 1u << s : 0u;
      }
      if (go == 0u) continue;
      const float4 q1 = f[1];                  // s0.yz, s1.xy
#pragma unroll
      for (int s = 0; s < RPT; ++s)
        if (!(plane_dist<ZERO_ORIGIN>(q0.w, q1.x, q1.y, q3.y, t[s], o[s],
                                      d[s]) <= 1.0f))
          go &= ~(1u << s);
      if (go == 0u) continue;
      const float4 q2 = f[2];                  // s1.z, s2
#pragma unroll
      for (int s = 0; s < RPT; ++s)
        if (!(plane_dist<ZERO_ORIGIN>(q1.z, q1.w, q2.x, q3.z, t[s], o[s],
                                      d[s]) <= 1.0f))
          go &= ~(1u << s);
      if (go == 0u) continue;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        if (!(plane_dist<ZERO_ORIGIN>(q2.y, q2.z, q2.w, q3.w, t[s], o[s],
                                      d[s]) <= 1.0f))
          go &= ~(1u << s);
        if ((go >> s) & 1u) {
          bt[s] = t[s];
          bid[s] = id;
          slot[s] = base + j;
        }
      }
    }
    if (k + 1 < n) {
      bool done = true;
#pragma unroll
      for (int s = 0; s < RPT; ++s) done &= bt[s] < ptm[k + 1];
      cp_async_wait_all();                     // this thread's part of k + 1
      if (__syncthreads_and(done)) break;
    }
  }

#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * bd + threadIdx.x;
    if (l >= ray_chunk) continue;
    const long long r = (long long)chunk * ray_chunk + l;
    rt::Winner w = rt::winner_init(true);
    w.t = bt[s];
    w.id = bid[s];
    if (slot[s] >= 0) {
      const float* g = pk + (long long)slot[s] * rt::PACK_LANES;
      auto col = [g](int lane_f) { return __ldg(g + lane_f); };
      const rt::HitTerms h = rt::hit_predicate<ZERO_ORIGIN>(col, o[s], d[s]);
      w.n0 = col(rt::LANE_N);
      w.n1 = col(rt::LANE_N + 1);
      w.n2 = col(rt::LANE_N + 2);
      w.enc = rt::encode_face(h, col(rt::LANE_ET), col(rt::LANE_KIND));
      w.c0 = col(rt::LANE_COLOR);
      w.c1 = col(rt::LANE_COLOR + 1);
      w.c2 = col(rt::LANE_COLOR + 2);
      w.alpha = col(rt::LANE_ALPHA);
      w.scat = col(rt::LANE_SCAT);
    }
    if constexpr (SHADE) {
      float st_r[rt::STATE_ROWS];
#pragma unroll
      for (int i = 0; i < rt::STATE_ROWS; ++i) st_r[i] = st[i * R + r];
      float v[3], inv;
      rt::scatter_rv(s0, s1, chunk, l, ray_chunk, fixed_rng, rsq, v, inv);
      rt::shade_ray(st_r, w, v, inv, fixed_rng, weight_cutoff, false, rsq);
#pragma unroll
      for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = st_r[i];
    } else {
      rt::store_winner(w, out, R, r);
    }
  }
}

template <int RPT, bool ZERO_ORIGIN, bool SHADE, bool EXCL>
int launch_rpt(const float* o_rows, const float* d_rows, long long row_stride,
               long long R, const float* excl, const float* pk, int P, int NP,
               const int* counts, const int* plist, const float* ptmin,
               const float* st, float* out, uint32_t s0, uint32_t s1,
               int fixed_rng, float weight_cutoff, int ray_chunk,
               const uint32_t* rsq, cudaStream_t stream) {
  const size_t smem = (size_t)2 * P * TRI4 * sizeof(float4);
  auto kernel = trace_union_kernel<RPT, ZERO_ORIGIN, SHADE, EXCL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nc = (int)(R / ray_chunk);
  const int threads = rt::chunk_block_fixed(ray_chunk, RPT).threads;
  kernel<<<nc, threads, smem, stream>>>(
      o_rows, d_rows, row_stride, R, excl, pk, P, NP, counts, plist, ptmin,
      st, out, s0, s1, fixed_rng != 0, weight_cutoff, ray_chunk, rsq);
  return (int)cudaGetLastError();
}

// Rays a thread: 2 on folded pages (camera rays, coherent: the pairs'
// chains of two rays interleave), 1 with ray origins (scattered rays keep
// more warps in flight), more where 1024 threads would not hold the chunk.
template <bool ZERO_ORIGIN, bool SHADE, bool EXCL>
int launch(const float* o_rows, const float* d_rows, long long row_stride,
           long long R, const float* excl, const float* pk, int P, int NP,
           const int* counts, const int* plist, const float* ptmin,
           const float* st, float* out, uint32_t s0, uint32_t s1,
           int fixed_rng, float weight_cutoff, int ray_chunk,
           const uint32_t* rsq, cudaStream_t stream) {
  const int base = ZERO_ORIGIN ? 2 : 1;
  const int need = (ray_chunk + 1023) / 1024;
  const int rpt = need > base ? need : base;
  auto fn = rpt == 1 ? launch_rpt<1, ZERO_ORIGIN, SHADE, EXCL>
                     : (rpt == 2 ? launch_rpt<2, ZERO_ORIGIN, SHADE, EXCL>
                                 : launch_rpt<4, ZERO_ORIGIN, SHADE, EXCL>);
  return fn(o_rows, d_rows, row_stride, R, excl, pk, P, NP, counts, plist,
            ptmin, st, out, s0, s1, fixed_rng, weight_cutoff, ray_chunk, rsq,
            stream);
}

}  // namespace

extern "C" int rt_trace_shade_union(const float* st, float* out, long long R,
                                    const float* pk, int P, int NP,
                                    const int* counts, const int* plist,
                                    const float* ptmin, unsigned s0,
                                    unsigned s1, int fixed_rng,
                                    float weight_cutoff, int zero_origin,
                                    int ray_chunk, const unsigned* rsq,
                                    void* stream) {
  auto fn = zero_origin ? launch<true, true, false>
                        : launch<false, true, false>;
  return fn(st, st + 3 * R, R, R, nullptr, pk, P, NP, counts, plist, ptmin,
            st, out, s0, s1, fixed_rng, weight_cutoff, ray_chunk, rsq,
            (cudaStream_t)stream);
}

extern "C" int rt_trace_union_rows(const float* ot, const float* dt,
                                   long long row_stride, long long R,
                                   const float* excl, const float* pk, int P,
                                   int NP, const int* counts,
                                   const int* plist, const float* ptmin,
                                   int zero_origin, int ray_chunk, float* out,
                                   void* stream) {
  auto fn = zero_origin ? (excl ? launch<true, false, true>
                                : launch<true, false, false>)
                        : (excl ? launch<false, false, true>
                                : launch<false, false, false>);
  return fn(ot, dt, row_stride, R, excl, pk, P, NP, counts, plist, ptmin,
            nullptr, out, 0u, 0u, 0, 0.0f, ray_chunk, nullptr,
            (cudaStream_t)stream);
}
