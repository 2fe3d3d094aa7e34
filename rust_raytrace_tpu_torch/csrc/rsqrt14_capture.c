/* Capture this x86-64 host's AVX-512 rsqrt14 estimate: the first step of
 * XLA-CPU's rsqrt where it vectorizes a fusion 16 floats wide.
 *
 * XLA on the CPU emits jax.lax.rsqrt as a hardware estimate refined by two
 * Newton steps (see rsqrt_capture.c).  The estimate instruction follows the
 * width of the fusion's vectors: 4 or 8 floats take rsqrtps, 16 floats
 * vrsqrt14ps, an interpolated estimate whose result depends on every input
 * bit.  So this table covers all of [1, 4).
 *
 * Model checked here:
 *   - on a positive normal x = y * 4^k with y in [1, 4), the estimate is
 *     TABLE[(exponent parity << 23) | mantissa] * 2^-k (2^24 entries);
 *   - on a positive subnormal x, it is the estimate of x * 2^64 times 2^32;
 *   - every other class (+-0, +-inf, negative subnormal, negative normal)
 *     maps to one estimate per class.
 * The capture reads one input per table entry and per class, then holds
 * every positive normal exponent at a stride of mantissas, every subnormal
 * and a stride of the negative normals to the model.  If one input disagrees
 * it prints it and exits 2: the model does not describe this CPU.
 *
 * Output on stdout, little-endian uint32: the 2^24 table entries, then the
 * six class estimates in the order +0, -0, +inf, -inf, -subnormal, -normal.
 *
 *   cc -O2 -mavx512f -o rsqrt14_capture rsqrt14_capture.c
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#if !defined(__x86_64__)
#error "rsqrt14_capture: vrsqrt14ps is an x86-64 AVX-512 instruction"
#endif
#include <immintrin.h>

#define ENTRIES (1u << 24)

static uint32_t est_bits(uint32_t xb) {
  float x, y;
  memcpy(&x, &xb, 4);
  y = _mm512_cvtss_f32(_mm512_rsqrt14_ps(_mm512_set1_ps(x)));
  uint32_t yb;
  memcpy(&yb, &y, 4);
  return yb;
}

/* the model's estimate for a positive normal input */
static uint32_t model(const uint32_t* table, uint32_t xb) {
  int32_t e = (int32_t)((xb >> 23) & 0xFF) - 127;
  int32_t k = (e - (e & 1)) / 2;
  uint32_t idx = ((uint32_t)(e & 1) << 23) | (xb & 0x7FFFFFu);
  return table[idx] - (uint32_t)(k * (1 << 23));
}

static int fail(const char* what, uint32_t xb, uint32_t got, uint32_t want) {
  fprintf(stderr,
          "rsqrt14_capture: %s: rsqrt14(0x%08x) = 0x%08x, model 0x%08x\n",
          what, xb, got, want);
  return 2;
}

int main(void) {
  uint32_t* table = malloc(ENTRIES * sizeof(uint32_t));
  uint32_t cls[6];
  if (!table) return 1;
  /* y = 1.m (parity 0) or 2.m (parity 1) */
  for (uint32_t i = 0; i < ENTRIES; ++i)
    table[i] = est_bits(((127u + (i >> 23)) << 23) | (i & 0x7FFFFFu));
  const uint32_t cls_in[6] = {0x00000000u, 0x80000000u, 0x7F800000u,
                              0xFF800000u, 0x80000001u, 0xBF800000u};
  for (int c = 0; c < 6; ++c) cls[c] = est_bits(cls_in[c]);

  /* every positive normal exponent, a stride of mantissas */
  for (uint32_t e = 1; e < 255; ++e)
    for (uint32_t m = e % 13; m < (1u << 23); m += 13) {
      uint32_t xb = (e << 23) | m;
      uint32_t got = est_bits(xb), want = model(table, xb);
      if (got != want) return fail("normal", xb, got, want);
    }
  /* every positive subnormal: scaled by 2^64 into the normals */
  for (uint32_t m = 1; m < (1u << 23); ++m) {
    float x;
    memcpy(&x, &m, 4);
    x *= 18446744073709551616.0f;
    uint32_t xs;
    memcpy(&xs, &x, 4);
    uint32_t got = est_bits(m), want = model(table, xs) + (32u << 23);
    if (got != want) return fail("+subnormal", m, got, want);
    got = est_bits(0x80000000u | m);
    if (got != cls[4]) return fail("-subnormal", 0x80000000u | m, got, cls[4]);
  }
  /* negative normals, a stride through all of them */
  for (uint32_t xb = 0x80800000u; xb < 0xFF800000u; xb += 127u) {
    uint32_t got = est_bits(xb);
    if (got != cls[5]) return fail("-normal", xb, got, cls[5]);
  }
  /* a NaN comes back quieted, as rsqrtps returns it */
  const uint32_t nans[4] = {0x7F800001u, 0x7FC00000u, 0xFFA00005u,
                            0x7FFFFFFFu};
  for (int i = 0; i < 4; ++i) {
    uint32_t got = est_bits(nans[i]);
    if (got != (nans[i] | 0x00400000u))
      return fail("NaN", nans[i], got, nans[i] | 0x00400000u);
  }

  if (fwrite(table, 4, ENTRIES, stdout) != ENTRIES ||
      fwrite(cls, 4, 6, stdout) != 6)
    return 1;
  free(table);
  return 0;
}
