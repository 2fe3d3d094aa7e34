// B11: the dense brute-force nearest hit, every live ray against every
// triangle.
//
// Replaces: rust_raytrace_tpu/ops/intersect_pallas.py:nearest_hit_pallas
// (inner _kernel and _predicate_update) — the "pallas" backend of
// render.WavefrontRenderer.  The TPU kernel runs a (ray chunk x page) grid;
// each step evaluates the hit predicate (B0a, with the ray origin) of a
// page's P triangles against RB rays, takes the page's least t and, on a
// tie, its least id, and replaces a ray's running best on a smaller t or on
// an equal finite t with a smaller id.  That is a lexicographic (t, id)
// minimum over all triangles, so the order of the visits does not matter.
//
// Bound on this card: instruction issue.  Every live (ray, triangle) pair
// costs the two dot products of the plane, an IEEE division and the
// lexicographic test (~25 issued instructions; the staged triangle's first
// float4 is shared by a thread's RPT rays), and each plane distance the
// pair reaches ~10 more; a warp pays for a step if any of its lanes takes
// it.  The rays are read once (24 B), the winners written once (8 B), and
// the pages are shared by every ray.
//
// Design: two grids a call.  With an `alive` mask, the first lists the
// wave's live rays and writes (+inf, 0) for the dead ones, which cost
// nothing more: a block of 1,024 slots orders its live rays by direction
// octant, in slot order within an octant (warp ballots), and claims room
// in the list with one atomic add, so that a warp's bounce rays leave
// nearby points in like directions and their tests agree more often.  The
// trace grid then gives each block SPAN consecutive entries of the list
// (or of the rays, with no mask), RPT rays a thread, so that its warps are
// full whatever share of the wave is alive; blocks past the list's end
// exit at once.  The block stages STAGE triangle slots at a time in shared
// memory, reordered to five float4: (n, nc), (s0, s0c), (s1, s1c), (s2,
// s2c), (id); a slot whose normal is zero (the pages' padding rows) is
// left out, since its md_n is +-0 or NaN for every ray, so its t is +-inf
// or NaN and never wins.  For every staged triangle a thread computes, for
// each of its rays, the predicate's t = (nc - n.o) / (n.d) with the
// predicate's own roundings; only a t >= 0 that would win the
// lexicographic update goes on to the three plane distances, each with
// its two dot products, stopping at the first one past 1 (the update needs
// all three <= 1, so the order of the tests changes nothing).  Every pair
// that could change the winner thus takes the whole predicate, in the
// predicate's arithmetic, and the winner's bits are those of
// nearest_hit_plain; the lexicographic minimum depends neither on the
// order of the rays nor on that of the staged slots.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
// blocks an SM the trace's registers allow: 12 caps it at 40 registers
// (some spilled), which ran ~3% faster on the H100 than 48 or 56 although
// shared memory holds it to 10 blocks an SM either way (PERF.md)
constexpr int MIN_BLOCKS = 12;
constexpr int RPT = 2;                   // rays a thread
constexpr int SPAN = THREADS * RPT;      // rays a block
constexpr int STAGE = 256;               // triangle slots a stage
constexpr int TRI4 = 5;                  // float4 a staged triangle
constexpr int LIST_BLOCK = 1024;         // slots a block of the live list

// XLA's contraction of a*x + b*y + c*z (rt::dot3) of a staged float4.
__device__ __forceinline__ float dot3(const float4 q, const float r[3]) {
  return fmaf(q.z, r[2], fmaf(q.x, r[0], q.y * r[1]));
}

struct Ray {
  float o[3], d[3];
  float t, id;
};

// The live list: the indices of the rays with alive != 0, a block's by
// direction octant and in slot order within one, at positions claimed from
// *count; dead rays get (+inf, 0).
__global__ void __launch_bounds__(LIST_BLOCK)
live_list_kernel(const unsigned char* __restrict__ alive,
                 const float* __restrict__ D, long long R,
                 int* __restrict__ list, int* __restrict__ count,
                 float* __restrict__ best_t, int* __restrict__ best_id) {
  __shared__ int s_warp[8][LIST_BLOCK / 32];
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r = (long long)blockIdx.x * LIST_BLOCK + tid;
  const bool in = r < R;
  const bool lv = in && alive[r] != 0;
  if (in && !lv) {
    best_t[r] = rt::inf_f();
    best_id[r] = 0;
  }
  int oct = 0;
  if (lv)
    oct = (D[r * 3] < 0.0f) * 4 + (D[r * 3 + 1] < 0.0f) * 2
        + (D[r * 3 + 2] < 0.0f);
  uint32_t mine = 0u;
  for (int o = 0; o < 8; ++o) {
    const uint32_t m = __ballot_sync(0xffffffffu, lv && oct == o);
    if (lane == 0) s_warp[o][warp] = __popc(m);
    if (lv && oct == o) mine = m;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int o = 0; o < 8; ++o)
      for (int w = 0; w < LIST_BLOCK / 32; ++w) {
        const int c = s_warp[o][w];
        s_warp[o][w] = total;
        total += c;
      }
    s_base = total ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (lv)
    list[s_base + s_warp[oct][warp] + __popc(mine & ((1u << lane) - 1u))] =
        (int)r;
}

// list == nullptr: every ray is live, and entry i is ray i; else the first
// *count entries of list are the live rays.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
nearest_hit_kernel(const float* __restrict__ O, const float* __restrict__ D,
                   const int* __restrict__ list,
                   const int* __restrict__ count, long long R,
                   const float* __restrict__ pk, int NS,
                   float* __restrict__ best_t, int* __restrict__ best_id) {
  __shared__ float4 s_tri[STAGE * TRI4];
  __shared__ int s_staged;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * SPAN;
  const long long total = list == nullptr ? R : (long long)*count;
  if (base >= total) return;                    // the whole block
  const int n_live = (int)min((long long)SPAN, total - base);

  // this thread's rays: entries base + tid*RPT + k; a missing ray has
  // d = 0, so its t is +-inf or NaN and never wins
  Ray ray[RPT];
  long long idx[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int c = tid * RPT + k;
    const bool has = c < n_live;
    idx[k] = !has ? -1 : (list == nullptr ? base + c : list[base + c]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      ray[k].o[q] = has ? O[idx[k] * 3 + q] : 0.0f;
      ray[k].d[q] = has ? D[idx[k] * 3 + q] : 0.0f;
    }
    ray[k].t = rt::inf_f();
    ray[k].id = 0.0f;
  }
  const bool warp_has_rays = warp * 32 * RPT < n_live;

  for (int s0 = 0; s0 < NS; s0 += STAGE) {
    __syncthreads();                            // previous stage fully read
    if (tid == 0) s_staged = 0;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < STAGE / THREADS; ++q) {
      const int i = s0 + q * THREADS + tid;
      const float4* src = reinterpret_cast<const float4*>(
          pk + (long long)i * rt::PACK_LANES);
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < NS) a = __ldg(src);
      const bool keep = (a.x != 0.0f) | (a.y != 0.0f) | (a.z != 0.0f);
      const uint32_t m = __ballot_sync(0xffffffffu, keep);
      int at = 0;
      if (lane == 0 && m != 0u) at = atomicAdd(&s_staged, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (keep) {
        const float4 b = __ldg(src + 1), c = __ldg(src + 2),
                     e = __ldg(src + 3), g = __ldg(src + 4);
        float4* dst = s_tri + at * TRI4;
        dst[0] = make_float4(a.x, a.y, a.z, e.x);     // n, nc
        dst[1] = make_float4(a.w, b.x, b.y, e.y);     // s0, s0c
        dst[2] = make_float4(b.z, b.w, c.x, e.z);     // s1, s1c
        dst[3] = make_float4(c.y, c.z, c.w, e.w);     // s2, s2c
        dst[4] = make_float4(g.x, 0.0f, 0.0f, 0.0f);  // id
      }
    }
    __syncthreads();
    const int n = s_staged;
    if (!warp_has_rays) continue;
    for (int j = 0; j < n; ++j) {
      const float4* tri = s_tri + j * TRI4;
      const float4 q0 = tri[0];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        Ray& y = ray[k];
        const float t = (q0.w - dot3(q0, y.o)) / dot3(q0, y.d);
        const float id = tri[4].x;
        if (!((t >= 0.0f) &&
              ((t < y.t) | ((t == y.t) & !isinf(t) & (id < y.id)))))
          continue;
        // ok = dv0 <= 1 & dv1 <= 1 & dv2 <= 1: stop at the first false
        const float4 q1 = tri[1];
        if (!(fmaf(t, dot3(q1, y.d), dot3(q1, y.o)) - q1.w <= 1.0f)) continue;
        const float4 q2 = tri[2];
        if (!(fmaf(t, dot3(q2, y.d), dot3(q2, y.o)) - q2.w <= 1.0f)) continue;
        const float4 q3 = tri[3];
        if (!(fmaf(t, dot3(q3, y.d), dot3(q3, y.o)) - q3.w <= 1.0f)) continue;
        y.t = t;
        y.id = id;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (idx[k] >= 0) {
      best_t[idx[k]] = ray[k].t;
      best_id[idx[k]] = (int)ray[k].id;
    }
  }
}

}  // namespace

// alive: [R] bool or null (every ray live); list [R] int32 and count [1]
// int32: scratch for the live list (unused when alive is null).
extern "C" int rt_nearest_hit(const float* O, const float* D,
                              const unsigned char* alive, long long R,
                              const float* pk, int P, int NP, float* best_t,
                              int* best_id, int* list, int* count,
                              void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (alive != nullptr) {
    cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    live_list_kernel<<<(unsigned)((R + LIST_BLOCK - 1) / LIST_BLOCK),
                       LIST_BLOCK, 0, st>>>(alive, D, R, list, count,
                                            best_t, best_id);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  nearest_hit_kernel<<<(unsigned)((R + SPAN - 1) / SPAN), THREADS, 0, st>>>(
      O, D, alive == nullptr ? nullptr : list, count, R, pk, P * NP, best_t,
      best_id);
  return (int)cudaGetLastError();
}
