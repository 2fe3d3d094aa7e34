// The fp32 FMA-rate probe of utils/roofline.py:measure_fp32_peak.
//
// Replaces: rust_raytrace_tpu/utils/roofline.py:measure_vpu_peak, which
// measures the TPU's rate with an XLA loop of elementwise multiply-adds over
// NCHAINS arrays.  No render path launches this kernel; it is a measurement
// of the card, not a port of a Pallas kernel, and is not in native.KERNELS.
//
// Bound on this card: operations, by construction.  Each thread keeps
// NCHAINS independent chains x = fmaf(x, a, b) in registers for
// iters * UNROLL steps and writes its chains once at the end, so it reads
// nothing and writes 4 * NCHAINS bytes.  FLOPs: 2 * threads * NCHAINS *
// UNROLL * iters.
//
// Design against the two ways such a probe reads low or high: the library
// builds with -fmad=false, so `x * a + b` would compile to FMUL + FADD
// (two issue slots for one FMA's two FLOPs); the chains call fmaf, one
// FFMA each.  a and b are runtime arguments, so nvcc cannot fold a chain.
// An FFMA's result is ready some cycles after issue, so one chain a warp
// leaves a scheduler idle between its steps: the chains a thread and the
// blocks an SM are the caller's, and chip_smoke.py sweeps them.
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 32;

template <int NCHAINS>
__global__ void fma_peak_kernel(float* out, float a, float b, int iters) {
  float x[NCHAINS];
#pragma unroll
  for (int k = 0; k < NCHAINS; ++k) x[k] = 0.5f + 0.01f * (float)k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int k = 0; k < NCHAINS; ++k) x[k] = fmaf(x[k], a, b);
    }
  }
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < NCHAINS; ++k) out[t * NCHAINS + k] = x[k];
}

template <int NCHAINS>
int launch(float* out, float a, float b, int iters, int blocks, int threads,
           cudaStream_t stream) {
  fma_peak_kernel<NCHAINS><<<blocks, threads, 0, stream>>>(out, a, b, iters);
  return (int)cudaGetLastError();
}

}  // namespace

// out: blocks * threads * nchains floats.  nchains: 1, 2, 4, 8 or 16.
extern "C" int rt_fma_peak(float* out, float a, float b, int iters,
                           int nchains, int blocks, int threads,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (nchains) {
    case 1: return launch<1>(out, a, b, iters, blocks, threads, s);
    case 2: return launch<2>(out, a, b, iters, blocks, threads, s);
    case 4: return launch<4>(out, a, b, iters, blocks, threads, s);
    case 8: return launch<8>(out, a, b, iters, blocks, threads, s);
    case 16: return launch<16>(out, a, b, iters, blocks, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
