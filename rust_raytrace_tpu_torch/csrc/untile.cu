// The quantized image's un-tiling: tile-major u8 pixels to the [H, W, 3]
// image.
//
// Replaces no TPU kernel.  The JAX package un-permutes the device's image on
// the host (rust_raytrace_tpu/engine.py:_assemble_host_image, a numpy
// scatter through a cached permutation); at 2560x1440 that scatter held the
// host for ~90 ms a frame with the card idle.  This kernel does the same
// reshape on the card before the copy to the host, so the host receives the
// finished image.  It moves bits only, so it equals its plain torch version
// (ops/untile.py:untile_u8_plain) byte for byte.
//
// Layout: src is u8 [3, Pp] (channel-major rows of stride Pp; the first H*W
// entries of a row are the pixels in tile-major order, the rest padding);
// pixel (r, c) of tile size T is src[ch * Pp + ((r / T) * (W / T) + c / T) *
// T * T + (r % T) * T + c % T].  out is u8 [H, W, 3], contiguous.  The index
// is arithmetic: no permutation array is read.
//
// Bound on this card: bytes.  3 * H * W bytes in, as many out (22.1 MB at
// 2560x1440, ~6.6 us at 3.35 TB/s).  At a byte a thread the index
// arithmetic still counts: a division by a runtime value for each byte
// made the kernel slower than a permuted torch copy, so a full block's
// tile count is a constant and every division is by a constant.
//
// Design: one block stages 1024 pixels of one tile row (1, 4, 16 or 1024
// tiles for T = 32, 16, 8, 1), which are three contiguous runs of 1024 bytes
// in src, in 3 KiB of shared memory, then writes the T output row segments
// those tiles cover (3 * 1024 / T contiguous bytes each) from shared memory.
// Both sides go a byte a thread, consecutive threads on consecutive bytes,
// so every load and store of a warp is one coalesced 32-byte run.  Wider
// accesses were left out: against a ~80 ms frame on the H100 the whole
// kernel takes a few hundredths of a millisecond either way.
// T = 1 is the plain channel interleave of each row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PIXELS = 1024;   // pixels a block stages
constexpr int THREADS = 256;

// byte b of the segment of tile-row line i: pixel j = b / 3 of the segment,
// channel b % 3, staged at tile j / T, line i, column j % T
template <int T>
__device__ __forceinline__ uint8_t staged(uint8_t (*sm)[PIXELS], int i,
                                          int b) {
  const int j = b / 3;
  return sm[b - 3 * j][(j / T) * (T * T) + i * T + (j % T)];
}

// the block of tile row tr from tile t0 on, n tiles: inlined with n the
// constant NTB for every full block, so its divisions are by constants
template <int T>
__device__ __forceinline__ void untile_block(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
    uint8_t (*sm)[PIXELS], int W, long long Pp, int tr, int t0, int n) {
  const int npx = n * T * T;
  const long long base = ((long long)tr * (W / T) + t0) * (T * T);
  for (int ch = 0; ch < 3; ++ch) {
    for (int p = threadIdx.x; p < npx; p += THREADS) {
      sm[ch][p] = src[ch * Pp + base + p];
    }
  }
  __syncthreads();

  const int L = 3 * n * T;                   // bytes of one segment
  const long long row = 3LL * W;
  const long long o0 = ((long long)tr * T * W + (long long)t0 * T) * 3;
  for (int u = threadIdx.x; u < T * L; u += THREADS) {
    const int i = u / L;
    const int b = u - i * L;
    out[o0 + i * row + b] = staged<T>(sm, i, b);
  }
}

template <int T>
__global__ void __launch_bounds__(THREADS)
untile_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
              int W, long long Pp) {
  constexpr int NTB = PIXELS / (T * T);      // tiles a block stages
  __shared__ uint8_t sm[3][PIXELS];
  const int t0 = blockIdx.x * NTB;
  const int n = min(NTB, W / T - t0);
  if (n == NTB) {
    untile_block<T>(src, out, sm, W, Pp, blockIdx.y, t0, NTB);
  } else {
    untile_block<T>(src, out, sm, W, Pp, blockIdx.y, t0, n);
  }
}

}  // namespace

extern "C" int rt_untile_u8(const unsigned char* src, unsigned char* out,
                            int H, int W, int T, long long Pp, void* stream) {
  if (T != 32 && T != 16 && T != 8 && T != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntb = PIXELS / (T * T);
  const dim3 grid((W / T + ntb - 1) / ntb, H / T);
  cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 32: untile_kernel<32><<<grid, THREADS, 0, s>>>(src, out, W, Pp);
      break;
    case 16: untile_kernel<16><<<grid, THREADS, 0, s>>>(src, out, W, Pp);
      break;
    case 8: untile_kernel<8><<<grid, THREADS, 0, s>>>(src, out, W, Pp);
      break;
    default: untile_kernel<1><<<grid, THREADS, 0, s>>>(src, out, W, Pp);
  }
  return (int)cudaGetLastError();
}
