// B12: the bank-major streamed sweep — one wave of the streamed regime as
// three kernels: prep (winner init and per-(bank, chunk) group demand),
// sweep (one bank at a time over every chunk that demands it) and finish
// (payload extraction, shade, state update).
//
// Replaces: rust_raytrace_tpu/ops/intersect_streamed.py:
// trace_shade_bankmajor_pallas, inner _kernel_bm_prep (B12a),
// _kernel_bm_sweep with _bank_group_pass (B12b) and _kernel_bm_finish
// (B12c).  The TPU kernel DMAs each bank's tables into VMEM once per wave
// and streams the chunks that demand the bank past them; its glue between
// prep and sweep lists each bank's demanding chunks.  Same contract as B9
// (trace_streamed.cu), bit for bit: the winner is the lexicographic
// (t, id) minimum with exact pruning, which no visit order changes.
//
// Bound on this card: the scattered reads of the bank tables.  At 1M
// triangles (P = 224, 35 banks) plt_i alone is 68 MB, past the 50 MB L2;
// one bank's tables are 17*224*128*4 B = 1.95 MB of plt_i and 0.80 MB of
// plt_s, which L2 holds many times over.  B9 lets every ray read its banks
// where they lie, so a wave's incoherent bounce rays (waves >= 2, inside
// the closed synthetic_1m sphere) spread their reads over all 98 MB of
// tables at once; a sweep that visits every demanding chunk while one bank
// is hot reads each bank from device memory about once a wave, the Hopper
// meaning of the TPU's one table DMA per bank per wave.
//
// Design.
//   prep: one block per chunk, at most 1024 threads, each owning
//     ceil(ray_chunk / 1024) rays.  Each thread writes its lanes' winner
//     init (t = +inf on valid lanes, -inf on invalid ones; id and slot 0)
//     and slab-tests its rays against the bank AABBs, staged
//     in shared memory 128 banks at a time; warp ballots and a shared
//     atomicOr set bit g of gm[bank, chunk] when some ray of the chunk's
//     128-lane group g enters the bank.  The TPU's lane sort by primary
//     bank (_primary_bank_sort) and its inverse map are dropped: they only
//     made the TPU's 128-lane groups bank-homogeneous and round-trip
//     bit-exactly.
//   glue (torch, [NB, NC] only): each bank's demanding chunks first, in
//     chunk order, and their count (ops/intersect_streamed.py).
//   sweep: one launch per bank, in index order on the stream, so bank b+1
//     sees bank b's winners.  The grid covers every (chunk, group) pair of
//     the bank's demand list by position; blocks past the device-side
//     count, or whose group bit is clear, exit at once (no host sync).  A
//     block stages the bank's 128 page AABBs in shared memory; each live
//     ray re-tests the bank AABB against its winner so far (the cross-bank
//     cut: a page's entry is never nearer than its bank's, so a skipped
//     bank holds no better hit), then runs rt::bank_pass (perlane.cuh),
//     recording the winner's slot instead of its payload: the winner
//     stream is 3 words a ray, t, id and slot (int32 bits).  The TPU kernel
//     re-extracts the payload at every visit; only the last extraction's
//     bits count.
//   finish: one thread per ray.  The winner's triangle is re-tested once
//     (the same hit terms, hence the same enc bits) and its payload read,
//     exactly as bank_pass stores it for B9; then B9's shade (B0b) with the
//     scatter hash keyed on (chunk, lane) at ray_chunk.  Chunks flagged
//     dead in chunk_live pass their state through.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::GROUP;
using rt::N_INT;
using rt::N_SHD;

// winner stream rows ([3, R] float32): t, id, slot = the winner's page *
// P + triangle as int32 bits
constexpr int WIN_T = 0;
constexpr int WIN_ID = 1;
constexpr int WIN_SLOT = 2;
// bank AABBs a prep block stages at once; floats per staged AABB row
constexpr int BANK_TILE = 128;
constexpr int BOX = 8;

__device__ __forceinline__ void load_ray(const float* __restrict__ st,
                                         long long R, long long r, float o[3],
                                         float d[3], float inv[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = st[k * R + r];
    d[k] = st[(3 + k) * R + r];
    inv[k] = rt::slab_inv(d[k]);
  }
}

// Whether the ray enters the box (lanes 0..2 lo, 3..5 hi) no later than
// t_max.
__device__ __forceinline__ bool enters(const float* __restrict__ box,
                                       const float o[3], const float inv[3],
                                       float t_max) {
  const float lo[3] = {box[0], box[1], box[2]};
  const float hi[3] = {box[3], box[4], box[5]};
  float tlo, thi;
  rt::slab(lo, hi, o, inv, tlo, thi);
  return (tlo <= thi) & (thi >= 0.0f) & (tlo <= t_max);
}

// B12a.  Block c = chunk c, at most 1024 threads (rt::chunk_block): a
// thread owns RPT lanes of the chunk, slot s at lane s * blockDim + tid.
// blockDim is a multiple of 32 and lanes run in whole warps, so the 32
// lanes of a warp's slot lie in one 128-lane group: one ballot per warp
// and slot decides its group's bit, for 8 to 32 groups at ray_chunk 1024
// to 4096 (bit 31 of the int32 mask included).
template <int RPT>
__global__ void __launch_bounds__(1024)
bm_prep_kernel(const float* __restrict__ st, long long R,
               const float* __restrict__ bank_ab, int NB, int NC,
               int ray_chunk, const int* __restrict__ chunk_live,
               float* __restrict__ win, int* __restrict__ gm) {
  __shared__ float s_box[BANK_TILE * BOX];
  __shared__ int s_gm[BANK_TILE];
  const int tid = threadIdx.x;
  const int c = blockIdx.x;
  const bool live = chunk_live == nullptr || chunk_live[c] != 0;
  bool valid[RPT];
  float o[RPT][3], d[RPT][3], inv[RPT][3];
  unsigned gbit[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * blockDim.x + tid;
    const bool in = l < ray_chunk;
    const long long r = (long long)c * ray_chunk + (in ? l : 0);
    valid[s] = in && live && st[rt::ROW_ALIVE * R + r] != 0.0f;
    if (in) {
      win[WIN_T * R + r] = valid[s] ? rt::inf_f() : -rt::inf_f();
      win[WIN_ID * R + r] = 0.0f;
      win[WIN_SLOT * R + r] = 0.0f;
    }
    load_ray(st, R, r, o[s], d[s], inv[s]);
    gbit[s] = 1u << ((in ? l : 0) / GROUP);
  }
  for (int b0 = 0; b0 < NB; b0 += BANK_TILE) {
    const int n = min(BANK_TILE, NB - b0);
    for (int i = tid; i < n * 7; i += blockDim.x)
      s_box[(i / 7) * BOX + i % 7] =
          bank_ab[(long long)(b0 + i / 7) * AB_LANES + i % 7];
    for (int i = tid; i < n; i += blockDim.x) s_gm[i] = 0;
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float* box = s_box + b * BOX;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const bool hit = valid[s] && box[6] != 0.0f &&
                         enters(box, o[s], inv[s], rt::inf_f());
        if (__ballot_sync(0xffffffffu, hit) != 0u && (tid & 31) == 0)
          atomicOr(&s_gm[b], (int)gbit[s]);
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x)
      gm[(long long)(b0 + i) * NC + c] = s_gm[i];
    __syncthreads();
  }
}

// B12b, one bank.  Block x = position i in the bank's demand list times
// the groups of a chunk, plus the group g; 128 threads, one per lane of
// the group.  abb/ti/ts/box: the bank's page AABB rows, tables and AABB;
// slot_base = bank * 128 * P.
__global__ void __launch_bounds__(128)
bm_sweep_kernel(const float* __restrict__ st, long long R,
                float* __restrict__ win, const int* __restrict__ gm_b,
                const int* __restrict__ count_b,
                const int* __restrict__ order_b,
                const float* __restrict__ abb, const float* __restrict__ ti,
                const float* __restrict__ ts, const float* __restrict__ box,
                int P, int ray_chunk, int slot_base) {
  __shared__ float s_ab[GROUP * BOX];
  const int groups = ray_chunk / GROUP;
  const int i = blockIdx.x / groups;
  const int g = blockIdx.x - i * groups;
  if (i >= *count_b) return;
  const int c = order_b[i];
  if (((gm_b[c] >> g) & 1) == 0) return;
  for (int k = threadIdx.x; k < GROUP * 7; k += GROUP)
    s_ab[(k / 7) * BOX + k % 7] = abb[(k / 7) * AB_LANES + k % 7];
  __syncthreads();
  const long long r = (long long)c * ray_chunk + g * GROUP + threadIdx.x;
  if (st[rt::ROW_ALIVE * R + r] == 0.0f) return;
  float o[3], d[3], inv[3];
  load_ray(st, R, r, o, d, inv);
  rt::Winner w = rt::winner_init(true);
  w.t = win[WIN_T * R + r];
  w.id = win[WIN_ID * R + r];
  if (!enters(box, o, inv, w.t)) return;
  int slot = __float_as_int(win[WIN_SLOT * R + r]);
  const float id0 = w.id;
  rt::bank_pass<false, false, true, BOX>(s_ab, ti, ts, P, o, d, inv, 0.0f, w,
                                         slot_base, &slot);
  // ids are unique and this bank is visited once a wave: the winner moved
  // here exactly when its id changed
  if (w.id != id0) {
    win[WIN_T * R + r] = w.t;
    win[WIN_ID * R + r] = w.id;
    win[WIN_SLOT * R + r] = __int_as_float(slot);
  }
}

// B12c.  One thread per ray, blocks of 128.
__global__ void __launch_bounds__(128)
bm_finish_kernel(const float* __restrict__ st, float* __restrict__ out,
                 long long R, const float* __restrict__ win,
                 const float* __restrict__ plt_i,
                 const float* __restrict__ plt_s, int P, int ray_chunk,
                 const int* __restrict__ chunk_live, uint32_t s0, uint32_t s1,
                 bool fixed_rng, float weight_cutoff,
                 const uint32_t* __restrict__ rsq) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long chunk = r / ray_chunk;
  float s[rt::STATE_ROWS];
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) s[i] = st[i * R + r];
  if (chunk_live[chunk] != 0) {
    rt::Winner w = rt::winner_init(s[rt::ROW_ALIVE] != 0.0f);
    w.t = win[WIN_T * R + r];
    w.id = win[WIN_ID * R + r];
    if (w.id != 0.0f) {
      const int slot = __float_as_int(win[WIN_SLOT * R + r]);
      const int page = slot / P;
      const int j = slot - page * P;
      const int b = page / GROUP;
      const int p = page - b * GROUP;
      const float* f = plt_i + (long long)b * N_INT * P * GROUP +
                       (long long)j * GROUP + p;
      const float* g = plt_s + (long long)b * N_SHD * P * GROUP +
                       (long long)j * GROUP + p;
      auto col = [f, P](int lane_f) {
        return f[(long long)lane_f * P * GROUP];
      };
      const float o[3] = {s[0], s[1], s[2]};
      const float d[3] = {s[3], s[4], s[5]};
      rt::winner_payload(f, g, P, rt::hit_predicate<false>(col, o, d), w);
    }
    float v[3], inv;
    rt::scatter_rv(s0, s1, (uint32_t)chunk,
                   (uint32_t)(r - chunk * ray_chunk), ray_chunk, fixed_rng,
                   rsq, v, inv);
    rt::shade_ray(s, w, v, inv, fixed_rng, weight_cutoff, false, rsq);
  }
#pragma unroll
  for (int i = 0; i < rt::STATE_ROWS; ++i) out[i * R + r] = s[i];
}

}  // namespace

extern "C" int rt_bm_prep(const float* st, long long R, const float* bank_ab,
                          int NB, int ray_chunk, const int* chunk_live,
                          float* win, int* gm, void* stream) {
  const int NC = (int)(R / ray_chunk);
  const rt::ChunkBlock b = rt::chunk_block(ray_chunk);
  auto kernel = b.rpt == 1 ? bm_prep_kernel<1>
                           : (b.rpt == 2 ? bm_prep_kernel<2>
                                         : bm_prep_kernel<4>);
  kernel<<<NC, b.threads, 0, (cudaStream_t)stream>>>(
      st, R, bank_ab, NB, NC, ray_chunk, chunk_live, win, gm);
  return (int)cudaGetLastError();
}

// One launch per bank, in index order on the stream.
extern "C" int rt_bm_sweep(const float* st, long long R, float* win,
                           const int* gm, const int* count, const int* order,
                           const float* ab, const float* plt_i,
                           const float* plt_s, const float* bank_ab, int P,
                           int NB, int ray_chunk, void* stream) {
  const long long NC = R / ray_chunk;
  const unsigned blocks = (unsigned)(NC * (ray_chunk / GROUP));
  for (int b = 0; b < NB; ++b) {
    bm_sweep_kernel<<<blocks, GROUP, 0, (cudaStream_t)stream>>>(
        st, R, win, gm + b * NC, count + b, order + b * NC,
        ab + (long long)b * GROUP * AB_LANES,
        plt_i + (long long)b * N_INT * P * GROUP,
        plt_s + (long long)b * N_SHD * P * GROUP,
        bank_ab + (long long)b * AB_LANES, P, ray_chunk, b * GROUP * P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int rt_bm_finish(const float* st, float* out, long long R,
                            const float* win, const float* plt_i,
                            const float* plt_s, int P, int ray_chunk,
                            const int* chunk_live, unsigned s0, unsigned s1,
                            int fixed_rng, float weight_cutoff,
                            const unsigned* rsq, void* stream) {
  const int threads = 128;
  const long long blocks = (R + threads - 1) / threads;
  bm_finish_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      st, out, R, win, plt_i, plt_s, P, ray_chunk, chunk_live, s0, s1,
      fixed_rng != 0, weight_cutoff, rsq);
  return (int)cudaGetLastError();
}
