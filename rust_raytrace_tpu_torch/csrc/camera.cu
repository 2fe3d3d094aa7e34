// The camera: a render's primary rays in tile-major order, a lane a thread.
//
// Replaces no TPU kernel.  The JAX package computes the camera in XLA
// (rust_raytrace_tpu/engine.py:_camera_rays_tiled, :159-198).  Its plain
// torch copy (ops/camera.py:camera_rays_tiled_plain) runs as ~640
// elementwise launches a frame over [3, R] int64 and float64 tensors (the
// threefry emulated in int64, each fma in float64 with TwoSum); at 2560x1440
// spp 4 that held the H100 57 ms of a ~75 ms frame.  This kernel computes the
// same bits in registers, and the host passes every constant as a scalar, so
// nothing is copied to the card.
//
// Lane i is stream position q = q_base + i: pixel q / spp of the tile-major
// order (tile (q / spp) / T^2 of the row-major tile grid, then the tile's
// pixels row-major).  spp 1 shoots through the pixel centre; spp > 1
// jitters the sample by two threefry draws at the counter (q, 0) under the
// keys fold_in(key, 1_000_001) across and fold_in(key, 1_000_002) down
// (rt::pos_uniform, csrc/rng.cuh), which the host computes.  The
// image-plane point is XLA-CPU's contraction (ROADMAP C2),
// fma(vv, row + v_off, fma(vu, col + u_off, orig)), with vu and vv the
// host's float32 per-pixel steps; d is p - cam scaled by XLA's rsqrt (C1,
// rt::rsqrt_xla) of its sum of squares in `sum3`'s order, fma(a2, a2,
// fma(a1, a1, a0 * a0 + 0)).  The library builds with -fmad=false, so no
// other multiply-add is fused.  Lanes with q >= R0 get o = d = 0; with
// `pinhole` o is cam on every lane, padding included (Engine's pinhole
// fold).  alive[i] = i < n_live.
//
// Bound on this card: 25 B written a lane (o and d, and the live byte),
// 368.6 MB at 2560x1440 spp 4, 0.110 ms at 3.35 TB/s; nothing is read but
// the 8 KiB rsqrt table.  Against it, two 20-round threefry draws, about 150
// int32 operations a lane with spp > 1.  Each thread keeps its lane in
// registers and writes each output row once, consecutive threads on
// consecutive words.  The divisions are by constants (spp 1, 2, 4 are
// template instances; the tile is a power of two) but for the tile grid's
// row, one a lane, and the generic spp's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "rng.cuh"

namespace {

constexpr int THREADS = 256;

struct View {
  float orig[3], cam[3], vu[3], vv[3];   // vu, vv: the per-pixel steps
};

// SPP 0: the generic path (spp a runtime value)
template <int SPP>
__global__ void __launch_bounds__(THREADS)
camera_kernel(float* __restrict__ o, float* __restrict__ d,
              uint8_t* __restrict__ alive, uint32_t n, uint32_t q_base,
              uint32_t R0, long long n_live, int spp, int tpr, int lt,
              View v, uint32_t ku0, uint32_t ku1, uint32_t kv0,
              uint32_t kv1, const uint32_t* __restrict__ rsq, int pinhole) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t q = q_base + i;
  alive[i] = (long long)i < n_live;
  float p[3] = {0.0f, 0.0f, 0.0f};
  float dd[3] = {0.0f, 0.0f, 0.0f};
  if (q < R0) {
    const uint32_t pix = SPP == 1 ? q : q / (SPP ? SPP : (uint32_t)spp);
    const uint32_t tile = pix >> (2 * lt);
    const uint32_t within = pix & ((1u << (2 * lt)) - 1u);
    const uint32_t trow = tile / (uint32_t)tpr;
    const uint32_t row = (trow << lt) + (within >> lt);
    const uint32_t col = ((tile - trow * (uint32_t)tpr) << lt)
                         + (within & ((1u << lt) - 1u));
    float u_off = 0.5f, v_off = 0.5f;
    if (SPP != 1) {
      u_off = rt::pos_uniform(ku0, ku1, q);
      v_off = rt::pos_uniform(kv0, kv1, q);
    }
    const float fr = (float)row + v_off;
    const float fc = (float)col + u_off;
    float a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = __fmaf_rn(v.vv[c], fr, __fmaf_rn(v.vu[c], fc, v.orig[c]));
      a[c] = p[c] - v.cam[c];
    }
    const float s = __fmaf_rn(a[2], a[2],
                              __fmaf_rn(a[1], a[1], a[0] * a[0] + 0.0f));
    const float inv = rt::rsqrt_xla(s, rsq);
#pragma unroll
    for (int c = 0; c < 3; ++c) dd[c] = a[c] * inv;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[(size_t)c * n + i] = pinhole ? v.cam[c] : p[c];
    d[(size_t)c * n + i] = dd[c];
  }
}

}  // namespace

// o, d: float32 [3, n]; alive: bool [n]; view: host float32 [12] (orig, cam,
// vu step, vv step); T a power of two dividing W; q_base + n < 2^31.
extern "C" int rt_camera(float* o, float* d, unsigned char* alive,
                         long long n, long long q_base, long long R0,
                         long long n_live, int spp, int W, int T,
                         const float* view, unsigned ku0, unsigned ku1,
                         unsigned kv0, unsigned kv1, const unsigned* rsq,
                         int pinhole, void* stream) {
  int lt = 0;
  while ((1 << lt) < T) ++lt;
  if (n < 0 || q_base < 0 || q_base + n > 0x7FFFFFFFLL || R0 < 0
      || R0 > 0x7FFFFFFFLL || spp < 1 || T < 1 || (1 << lt) != T
      || W < T || W % T != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  View v;
  for (int c = 0; c < 3; ++c) {
    v.orig[c] = view[c];
    v.cam[c] = view[3 + c];
    v.vu[c] = view[6 + c];
    v.vv[c] = view[9 + c];
  }
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
#define RT_CAMERA(S)                                                        \
  camera_kernel<S><<<blocks, THREADS, 0, s>>>(                              \
      o, d, alive, (uint32_t)n, (uint32_t)q_base, (uint32_t)R0, n_live,     \
      spp, W / T, lt, v, ku0, ku1, kv0, kv1, rsq, pinhole)
  switch (spp) {
    case 1: RT_CAMERA(1); break;
    case 2: RT_CAMERA(2); break;
    case 4: RT_CAMERA(4); break;
    default: RT_CAMERA(0);
  }
#undef RT_CAMERA
  return (int)cudaGetLastError();
}
