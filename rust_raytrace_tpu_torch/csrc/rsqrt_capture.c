/* Capture this x86-64 host's rsqrtps estimate: the first step of XLA-CPU's
 * rsqrt.
 *
 * XLA on the CPU lowers jax.lax.rsqrt (float32) to the hardware estimate
 * y = rsqrtps(x) followed by two Newton steps
 * y = fma(-0.5 * y, fma(x * y, y, -1), y), and returns the bare estimate for
 * every input that is not a positive normal number (the llvm.is.fpclass
 * mask of its emitter).  The estimate comes from a table in the CPU, which
 * differs between vendors, so the port reads it here, on the host that runs
 * the process, instead of shipping one.
 *
 * Model checked here:
 *   - on a positive normal x = y * 4^k with y in [1, 4), the estimate is
 *     TABLE[key(y)] * 2^-k, key = (exponent parity << 10) | top 10 mantissa
 *     bits, so 2,048 entries;
 *   - every other class (+-0, +-subnormal, +-inf, negative normal) maps to
 *     one estimate per class.
 * The capture takes one input per key and per class, then holds every float
 * in [1, 4) (2^24 inputs), every positive normal exponent at four mantissas
 * per key, every subnormal and a stride of the negative normals to the
 * model.  If one input disagrees it prints it and exits 2: the model does
 * not describe this CPU.
 *
 * Output on stdout, little-endian uint32: the 2,048 table entries (bits of
 * the estimate for y in [1, 4)), then the seven class estimates in the order
 * +0, -0, +inf, -inf, +subnormal, -subnormal, -normal.
 *
 *   cc -O2 -o rsqrt_capture rsqrt_capture.c && ./rsqrt_capture > table.bin
 */
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#if !defined(__x86_64__) && !defined(__i386__)
#error "rsqrt_capture: XLA-CPU's rsqrt estimate is an x86 instruction"
#endif
#include <xmmintrin.h>

static uint32_t est_bits(uint32_t xb) {
  float x, y;
  memcpy(&x, &xb, 4);
  __m128 v = _mm_rsqrt_ps(_mm_set1_ps(x));
  y = _mm_cvtss_f32(v);
  uint32_t yb;
  memcpy(&yb, &y, 4);
  return yb;
}

static uint32_t key_of(uint32_t xb) {
  int32_t e = (int32_t)((xb >> 23) & 0xFF) - 127;
  return ((uint32_t)(e & 1) << 10) | ((xb >> 13) & 0x3FF);
}

/* the model's estimate for a positive normal input */
static uint32_t model(const uint32_t* table, uint32_t xb) {
  int32_t e = (int32_t)((xb >> 23) & 0xFF) - 127;
  int32_t k = (e - (e & 1)) / 2;
  return table[key_of(xb)] - (uint32_t)(k * (1 << 23));
}

static int fail(const char* what, uint32_t xb, uint32_t got, uint32_t want) {
  fprintf(stderr,
          "rsqrt_capture: %s: rsqrtps(0x%08x) = 0x%08x, model 0x%08x\n",
          what, xb, got, want);
  return 2;
}

int main(void) {
  uint32_t table[2048];
  uint32_t cls[7];
  /* one input per key: y = 1.m (parity 0) or 2.m (parity 1) */
  for (uint32_t key = 0; key < 2048; ++key) {
    uint32_t xb = ((127u + (key >> 10)) << 23) | ((key & 0x3FF) << 13);
    table[key] = est_bits(xb);
  }
  const uint32_t cls_in[7] = {0x00000000u, 0x80000000u, 0x7F800000u,
                              0xFF800000u, 0x00000001u, 0x80000001u,
                              0xBF800000u};
  for (int c = 0; c < 7; ++c) cls[c] = est_bits(cls_in[c]);

  /* every float in [1, 4) */
  for (uint32_t xb = 0x3F800000u; xb < 0x40800000u; ++xb) {
    uint32_t got = est_bits(xb);
    if (got != table[key_of(xb)]) return fail("[1, 4)", xb, got,
                                              table[key_of(xb)]);
  }
  /* every positive normal exponent, four mantissas per key */
  const uint32_t low[4] = {0x0000u, 0x1FFFu, 0x0AAAu, 0x1555u};
  for (uint32_t e = 1; e < 255; ++e)
    for (uint32_t m10 = 0; m10 < 1024; ++m10)
      for (int l = 0; l < 4; ++l) {
        uint32_t xb = (e << 23) | (m10 << 13) | low[l];
        uint32_t got = est_bits(xb);
        if (got != model(table, xb)) return fail("normal", xb, got,
                                                 model(table, xb));
      }
  /* every subnormal of either sign */
  for (uint32_t m = 1; m < (1u << 23); ++m) {
    uint32_t got = est_bits(m);
    if (got != cls[4]) return fail("+subnormal", m, got, cls[4]);
    got = est_bits(0x80000000u | m);
    if (got != cls[5]) return fail("-subnormal", 0x80000000u | m, got, cls[5]);
  }
  /* negative normals, a stride through all of them */
  for (uint32_t xb = 0x80800000u; xb < 0xFF800000u; xb += 127u) {
    uint32_t got = est_bits(xb);
    if (got != cls[6]) return fail("-normal", xb, got, cls[6]);
  }

  if (fwrite(table, 4, 2048, stdout) != 2048 || fwrite(cls, 4, 7, stdout) != 7)
    return 1;
  return 0;
}
