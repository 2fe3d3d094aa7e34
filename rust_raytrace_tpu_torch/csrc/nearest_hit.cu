// B11: the dense brute-force nearest hit, every ray against every triangle.
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
// Bound on this card: arithmetic.  Every (ray, triangle) pair costs the
// hit predicate (eight 3-term dot products, an IEEE division, three plane
// distances and the compares, ~34 float32 operations besides the
// division's own sequence); the rays are read once (24 B) and the winners
// written once (8 B), and the pages are shared by every ray.
//
// Design: one thread per ray, blocks of BLOCK rays.  A block stages one
// page at a time in shared memory, only the 17 lanes the predicate reads
// (normal, the three scaled edge normals, the four offsets, the id), padded
// to 20 floats a triangle so that each thread reads a triangle with five
// float4 loads at one address for the whole warp (a broadcast).  Each
// thread folds the page's triangles one by one into its (t, id) winner in
// registers with the lexicographic order of rt::lex_better.  Threads past
// R load no ray but still help stage the pages.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int PRED_LANES = 17;        // lanes 0..16: predicate and id
constexpr int STRIDE = 20;            // floats per staged triangle

__global__ void __launch_bounds__(BLOCK)
nearest_hit_kernel(const float* __restrict__ O, const float* __restrict__ D,
                   long long R, const float* __restrict__ pk, int P, int NP,
                   float* __restrict__ best_t, int* __restrict__ best_id) {
  extern __shared__ float4 s_page4[];           // [P][STRIDE / 4]
  float* s_page = reinterpret_cast<float*>(s_page4);
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const bool live = r < R;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = O[r * 3 + k];
      d[k] = D[r * 3 + k];
    }
  }
  rt::Winner w = rt::winner_init(true);
  const int page_floats = P * PRED_LANES;
  for (int p = 0; p < NP; ++p) {
    const float* page = pk + (long long)p * P * rt::PACK_LANES;
    __syncthreads();                            // previous page fully read
    for (int i = threadIdx.x; i < page_floats; i += BLOCK) {
      const int j = i / PRED_LANES, f = i % PRED_LANES;
      s_page[j * STRIDE + f] = page[j * rt::PACK_LANES + f];
    }
    __syncthreads();
    for (int j = 0; j < P; ++j) {
      float f[STRIDE];
#pragma unroll
      for (int q = 0; q < STRIDE / 4; ++q) {
        const float4 v = s_page4[j * (STRIDE / 4) + q];
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      auto col = [&f](int lane_f) { return f[lane_f]; };
      const rt::HitTerms h = rt::hit_predicate<false>(col, o, d);
      const float id = f[rt::LANE_ID];
      if (h.ok && rt::lex_better(h.t, id, w)) {
        w.t = h.t;
        w.id = id;
      }
    }
  }
  if (live) {
    best_t[r] = w.t;
    best_id[r] = (int)w.id;
  }
}

}  // namespace

extern "C" int rt_nearest_hit(const float* O, const float* D, long long R,
                              const float* pk, int P, int NP, float* best_t,
                              int* best_id, void* stream) {
  const size_t smem = (size_t)P * STRIDE * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nearest_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nblocks = (R + BLOCK - 1) / BLOCK;
  nearest_hit_kernel<<<(unsigned)nblocks, BLOCK, smem,
                       (cudaStream_t)stream>>>(O, D, R, pk, P, NP, best_t,
                                               best_id);
  return (int)cudaGetLastError();
}
