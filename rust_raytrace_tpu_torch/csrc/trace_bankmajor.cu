// B12: the bank-major streamed sweep — one wave of the streamed regime as
// three kernels: prep (winner init and per-(bank, chunk) group demand),
// sweep (every bank over the chunk groups that demand it, bank-major, in
// one launch) and finish (payload extraction, shade, state update).
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
// Bound on this card: the hit predicate's arithmetic on the pages each ray
// visits, as B9 (trace_streamed.cu), and the serial chain of each 128-ray
// group's banks: group g's bank b+1 starts only once its bank b is done.
// A bank's records (128 * 224 * 96 B = 2.75 MB at P = 224) stay in the 50
// MB L2 while the groups that demand it pass; the 96 MB of all banks do
// not.  B9 lets every ray read its banks where they lie, so a wave's
// incoherent bounce rays (waves >= 2, inside the closed synthetic_1m
// sphere) spread their reads over every bank at once; the sweep's items
// run in bank-major order, the Hopper meaning of the TPU's one table DMA
// per bank per wave.
//
// Design.
//   prep: one block per chunk, at most 1024 threads, each owning
//     ceil(ray_chunk / 1024) rays.  A chunk flagged dead writes only its
//     lanes' winner init (t = -inf, id and slot 0) and zero gm words: it
//     reads no state row and tests no slab.  In a live chunk each thread
//     writes its lanes' winner init (t = +inf on valid lanes, -inf on
//     invalid ones) and slab-tests its valid rays against the bank AABBs,
//     staged in shared memory BANK_TILE banks at a time, 32 banks a mask
//     word in registers; a warp ORs each word over its 32 lanes
//     (__reduce_or_sync, the lanes of one 128-lane group) and writes it to
//     shared memory once; then thread b of the block sets bit g of gm[b, c]
//     from the words of group g's warps.  So a bank costs a warp no ballot
//     and no atomic.  The TPU's lane sort by primary bank
//     (_primary_bank_sort) and its inverse map are dropped: they only made
//     the TPU's 128-lane groups bank-homogeneous and round-trip
//     bit-exactly.
//   glue (torch, [NB, NC] only): each bank's demanding chunks first, in
//     chunk order, and their count (ops/intersect_streamed.py).
//   sweep: one persistent launch (the resident blocks of the card, 128
//     threads each, one per lane of a group) for every bank.  An item is
//     (bank b, position i in b's demand list, group g), numbered bank-major
//     (b, then i, then g); blocks claim items in that order from a device
//     counter (sync[0]).  An item whose group bit of gm is clear does
//     nothing.  Otherwise the block waits, by an acquire load, until the
//     group's previous demanded bank (the highest b' < b with the group's
//     bit of gm[b', c] set) has released the group's flag (sync[1 + c * G +
//     g] = b' + 1), stages bank b's 128 page boxes in shared memory, and
//     runs each live ray: the cross-bank cut (the bank AABB against its
//     winner so far: a page's entry is never nearer than its bank's, so a
//     skipped bank holds no better hit), then rt::bank_walk (perlane.cuh)
//     over the bank's page-major records, recording the winner's slot
//     instead of its payload; then it releases the flag (a release store)
//     to b + 1.  So each group sees its banks in index order, as one launch
//     per bank did, and no bank waits for the whole grid.  An item's
//     predecessor has a lower number, so it was claimed before, by a block
//     that is running: the grid cannot deadlock.  Only an item's block
//     writes its group's winner stream (3 words a ray: t, id and slot as
//     int32 bits), read past L1 (ld.cg).  An empty wave claims no item: one
//     launch whose blocks exit at once.  The TPU kernel re-extracts the
//     payload at every visit; only the last extraction's bits count.
//   finish: one thread per ray.  The winner's triangle is re-tested once
//     (the same hit terms, hence the same enc bits) and its payload read,
//     exactly as rt::bank_walk stores it for B9; then B9's shade (B0b) with the
//     scatter hash keyed on (chunk, lane) at ray_chunk.  Chunks flagged
//     dead in chunk_live pass their state through.
#include "perlane.cuh"

namespace {

using rt::AB_LANES;
using rt::GROUP;
using rt::N_INT;
using rt::N_SHD;
using rt::PAB4;
using rt::REC4;

// winner stream rows ([3, R] float32): t, id, slot = the winner's page *
// P + triangle as int32 bits
constexpr int WIN_T = 0;
constexpr int WIN_ID = 1;
constexpr int WIN_SLOT = 2;
// bank AABBs a prep block stages at once (a multiple of 32: whole mask
// words); floats per staged AABB row; a chunk's lane-warps at the largest
// ray_chunk (utils/native.py MAX_RAY_CHUNK = 4096)
constexpr int BANK_TILE = 256;
constexpr int BOX = 8;
constexpr int LANE_WARPS = 4096 / 32;

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
// lanes of a warp's slot lie in one 128-lane group: its lane-warp (lane /
// 32) w belongs to group w / 4, for 8 to 32 groups at ray_chunk 1024 to
// 4096 (bit 31 of the int32 mask included).  The bank AABBs are staged
// two float4 each.
template <int RPT>
__global__ void __launch_bounds__(1024, RPT == 1 ? 2 : 1)
bm_prep_kernel(const float* __restrict__ st, long long R,
               const float* __restrict__ bank_ab, int NB, int NC,
               int ray_chunk, const int* __restrict__ chunk_live,
               float* __restrict__ win, int* __restrict__ gm) {
  __shared__ float4 s_box[BANK_TILE * 2];
  __shared__ uint32_t s_or[LANE_WARPS][BANK_TILE / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = blockIdx.x;
  const long long r0 = (long long)c * ray_chunk;
  if (chunk_live != nullptr && chunk_live[c] == 0) {
    for (int l = tid; l < ray_chunk; l += blockDim.x) {
      win[WIN_T * R + r0 + l] = -rt::inf_f();
      win[WIN_ID * R + r0 + l] = 0.0f;
      win[WIN_SLOT * R + r0 + l] = 0.0f;
    }
    for (int b = tid; b < NB; b += blockDim.x) gm[(long long)b * NC + c] = 0;
    return;
  }
  bool valid[RPT];
  float o[RPT][3], inv[RPT][3];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int l = s * blockDim.x + tid;
    const long long r = r0 + l;
    valid[s] = l < ray_chunk && st[rt::ROW_ALIVE * R + r] != 0.0f;
    if (l < ray_chunk) {
      win[WIN_T * R + r] = valid[s] ? rt::inf_f() : -rt::inf_f();
      win[WIN_ID * R + r] = 0.0f;
      win[WIN_SLOT * R + r] = 0.0f;
    }
    if (valid[s]) {
      float d[3];
      load_ray(st, R, r, o[s], d, inv[s]);
    }
  }
  const int G = ray_chunk / GROUP;
  float* sb = reinterpret_cast<float*>(s_box);
  for (int b0 = 0; b0 < NB; b0 += BANK_TILE) {
    const int n = min(BANK_TILE, NB - b0);
    for (int i = tid; i < n * BOX; i += blockDim.x)
      sb[i] = i % BOX == 7
          ? 0.0f : bank_ab[(long long)(b0 + i / BOX) * AB_LANES + i % BOX];
    __syncthreads();
    for (int w = 0; w < (n + 31) / 32; ++w) {
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        uint32_t bits = 0u;
        if (valid[s]) {
          const int m = min(32, n - w * 32);
          for (int j = 0; j < m; ++j) {
            const float4 a = s_box[2 * (w * 32 + j)];
            const float4 e = s_box[2 * (w * 32 + j) + 1];
            const float lo[3] = {a.x, a.y, a.z};
            const float hi[3] = {a.w, e.x, e.y};
            float tlo, thi;
            rt::slab(lo, hi, o[s], inv[s], tlo, thi);
            if ((e.z != 0.0f) & (tlo <= thi) & (thi >= 0.0f))
              bits |= 1u << j;
          }
        }
        bits = __reduce_or_sync(0xffffffffu, bits);
        const int lw = (s * blockDim.x + tid) / 32;
        if (lane == 0 && lw * 32 < ray_chunk) s_or[lw][w] = bits;
      }
    }
    __syncthreads();
    for (int b = tid; b < n; b += blockDim.x) {
      int m = 0;
      for (int g = 0; g < G; ++g) {
        const uint32_t* q = &s_or[4 * g][b >> 5];
        const uint32_t any = q[0] | q[BANK_TILE / 32] |
                             q[2 * (BANK_TILE / 32)] |
                             q[3 * (BANK_TILE / 32)];
        m |= (int)((any >> (b & 31)) & 1u) << g;
      }
      gm[(long long)(b0 + b) * NC + c] = m;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// B12b: the persistent sweep.  GROUP threads a block; dynamic shared
// memory: NB + 1 ints.  sync: [1 + NC * G] int32, zero at launch.
__global__ void __launch_bounds__(GROUP)
bm_sweep_kernel(const float* __restrict__ st, long long R, float* win,
                const int* __restrict__ gm, const int* __restrict__ count,
                const int* __restrict__ order,
                const float4* __restrict__ rec,
                const float4* __restrict__ pab,
                const float* __restrict__ bank_ab, int P, int NB, int NC,
                int ray_chunk, int* sync) {
  extern __shared__ int s_first[];        // [NB + 1]: bank b's first item
  __shared__ float4 s_ab[GROUP * PAB4];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int G = ray_chunk / GROUP;
  if (tid == 0) {
    int n = 0;
    for (int b = 0; b < NB; ++b) {
      s_first[b] = n;
      n += count[b] * G;
    }
    s_first[NB] = n;
  }
  __syncthreads();
  const int items = s_first[NB];
  int b = 0;
  while (true) {
    if (tid == 0) s_item = atomicAdd(sync, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= items) return;
    while (item >= s_first[b + 1]) ++b;    // a block's items only grow
    const int k = item - s_first[b];
    const int i = k / G;
    const int g = k - i * G;
    const int c = order[(long long)b * NC + i];
    if ((gm[(long long)b * NC + c] >> g) & 1) {
      int* flag = sync + 1 + (long long)c * G + g;
      if (tid == 0) {
        int prev = b - 1;
        while (prev >= 0 && ((gm[(long long)prev * NC + c] >> g) & 1) == 0)
          --prev;
        // a predecessor that never releases is a bug: trap (the launch
        // fails) rather than hang the card
        for (long long spins = 0; prev >= 0 && ld_acquire(flag) <= prev;
             ++spins) {
          if (spins > (1LL << 27)) __trap();
          __nanosleep(64);
        }
      }
      for (int q = tid; q < GROUP * PAB4; q += GROUP)
        s_ab[q] = pab[(long long)b * GROUP * PAB4 + q];
      __syncthreads();
      const long long r = (long long)c * ray_chunk + g * GROUP + tid;
      if (st[rt::ROW_ALIVE * R + r] != 0.0f) {
        float o[3], d[3], inv[3];
        load_ray(st, R, r, o, d, inv);
        rt::Winner w = rt::winner_init(true);
        w.t = __ldcg(win + WIN_T * R + r);
        w.id = __ldcg(win + WIN_ID * R + r);
        if (enters(bank_ab + (long long)b * AB_LANES, o, inv, w.t)) {
          int slot = __float_as_int(__ldcg(win + WIN_SLOT * R + r));
          const float id0 = w.id;
          rt::bank_walk<false, false, true>(
              s_ab, rec + (long long)b * GROUP * P * REC4, P, o, d, inv,
              0.0f, w, b * GROUP * P, &slot);
          // ids are unique and this bank is visited once a wave: the
          // winner moved here exactly when its id changed
          if (w.id != id0) {
            __stcg(win + WIN_T * R + r, w.t);
            __stcg(win + WIN_ID * R + r, w.id);
            __stcg(win + WIN_SLOT * R + r, __int_as_float(slot));
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(flag, b + 1);
      }
    }
    __syncthreads();                       // s_item and s_ab are free
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

// One persistent launch: the card's resident blocks claim every bank's
// items.  sync: [1 + NC * ray_chunk / 128] int32 zeros.
extern "C" int rt_bm_sweep(const float* st, long long R, float* win,
                           const int* gm, const int* count, const int* order,
                           const float* rec, const float* pab,
                           const float* bank_ab, int P, int NB, int ray_chunk,
                           int* sync, void* stream) {
  const int NC = (int)(R / ray_chunk);
  const size_t smem = (size_t)(NB + 1) * sizeof(int);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bm_sweep_kernel, GROUP, smem);
  if (e != cudaSuccess) return (int)e;
  bm_sweep_kernel<<<sms * per_sm, GROUP, smem, (cudaStream_t)stream>>>(
      st, R, win, gm, count, order, reinterpret_cast<const float4*>(rec),
      reinterpret_cast<const float4*>(pab), bank_ab, P, NB, NC, ray_chunk,
      sync);
  return (int)cudaGetLastError();
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
