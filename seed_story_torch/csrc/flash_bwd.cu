// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate: two
// kernels, dq (which also computes delta) and dk/dv, launched in that order
// on one stream.
//
// Replaces the TPU kernels seed_story_tpu/ops/attention.py::_flash_bwd_dq_kernel
// and ::_flash_bwd_dkv_kernel (both launched by _flash_bwd). Same contract as
// the forward (flash_fwd.cu):
//
//   visible(b, i, j) = i < Sq && j < min(kv_len[b], Skv) && (!causal || j <= q_start[b] + i)
//   P  = exp(scale * Q K^T - LSE)  on visible entries, 0 elsewhere
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// The scale multiplies the f32 scores; scores, P, dP, delta and the
// accumulators are f32; P is rounded to bf16 before P^T dO and dS before dS K
// and dS^T Q, as the TPU kernels round them. Masked entries are selected to 0,
// never multiplied, so rows with LSE = -inf (no visible key) give exactly zero
// gradient. Inputs are (B, H, S, D) views with a unit-stride head dim (other
// strides free); LSE (B, Hq, Sq) f32 from the forward; outputs dQ (B, Hq, Sq,
// D), dK and dV (B, Hkv, Skv, D) bf16 contiguous, and delta (B, Hq, Sq) f32,
// which the dq kernel writes and the dk/dv kernel reads. Every dQ row is
// written by one dq block and every dK / dV row by one dk/dv block, with no
// atomics: the gradients are bitwise repeatable.
//
// What bounds it on an H100: per visible (query, key) pair the backward does
// five products of depth d (S and dP in both kernels, dS K in dq, P^T dO and
// dS^T Q in dk/dv) against the forward's two, and P is recomputed in both
// kernels. At the LLaMA's S = 1280, d = 128 and the UNet's S = 4096, d = 64
// that is far above the card's 295 FLOP/byte ridge: the tensor cores and the
// exponentials between the products bound it. The resamplers' short blocks
// (Sq or Skv = 64..256) are bound by reading Q, K, V, O and dO once each.
//
// Design, shared by both kernels (the forward's shape):
// - Warp specialisation. A producer keeps a 3-stage ring of 64-row tiles full
//   with TMA, each stage completing on an mbarrier ("full") and released by
//   the consumers on another ("empty"); consumer warpgroups of 64 rows run
//   wgmma for every product. Tensor maps are 4-D (d, and the row / head /
//   batch dims sorted by stride), built per call on the host from the
//   caller's strides, with the 128-byte swizzle and 64-column boxes; head dims
//   80 / 100 / 104 are padded to 128, and ragged Sq / Skv edges filled, by
//   TMA's out-of-bounds zero fill in shared memory.
// - S, dP, P and dS live only in registers: the two score products are
//   wgmma m64n64k16 with both operands K-major in shared memory, and the f32
//   accumulator layout of a 64 x 64 score tile is the A-fragment layout of the
//   next product, so P and dS, converted to bf16 in registers, are wgmma's A
//   operand against an MN-major B from shared memory (as P V in the forward).
//   Exponentials in base 2 (ex2.approx); the mask is applied only on tiles
//   that cross kv_len, Skv or the diagonal.
// - Block size. Blocks hold 128 rows (query rows for dq, keys for dk/dv) in
//   two consumer warpgroups of 64, or 64 rows in one where the rows fit it or
//   where a grid of 128-row blocks would leave multiprocessors idle.
// - dq: one block per (128 query rows, q-head, batch row): two consumer
//   warpgroups and a producer warp, 288 threads. The producer loads Q, dO and
//   O once and streams K / V tiles of 64 keys up to the last key any row of
//   the block sees. Each consumer first sums
//   dO * O over its rows (delta, f32) and writes it out, then per tile:
//   S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K (K as MN-major B).
//   dQ * scale is staged in the warpgroup's own Q rows for 16-byte stores.
//   Shared memory at d = 128: Q, dO, O 3 x 32 KB + 3 x (K 16 KB + V 16 KB).
// - dk/dv: one block per (128 keys, KV head, batch row): K and V stay
//   resident; the producer walks the GQA group's q-heads and, for each, the
//   Q / dO tiles of 64 rows from the first row that sees the block's first key,
//   each stage with its 64 rows' LSE and delta (rows past Sq get LSE = +inf,
//   so P = 0 there). Consumers compute the transposes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out as A fragments for dV += P^T dO
//   and dK += dS^T Q (Q and dO as MN-major B): the group sum happens in the
//   f32 accumulators, with no temporaries. Each consumer thread holds dK and
//   dV (64 + 64 f32 at d = 128) beside S^T and dP^T (32 + 32), more than the
//   224 registers a 288-thread block allows, so the producer is a whole
//   warpgroup that gives its registers up (setmaxnreg 40) to two consumer
//   warpgroups (232 each): 384 threads. A block whose keys all lie past
//   kv_len loads nothing and writes zeros.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int TILE = 64;                    // rows of a streamed tile: keys (dq), query rows (dk/dv)
constexpr int TILE_BOX = TILE * ROW_BYTES;  // one 64-column box of a streamed tile
constexpr int STAGES = 3;                   // depth of the ring
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // dk/dv with two consumers: 65,536 in all

struct Params {
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* delta;
  const float* lse;
  const int* q_start;
  const int* kv_len;
  int hq, hkv, sq, skv, d;
  float scale;
  float scale_log2;  // scale * log2(e): P = exp2(S scale_log2 - LSE log2(e))
  int causal;
  // which of (row, head, batch) each tensor-map dim 1..3 holds
  int perm_q[3], perm_k[3], perm_v[3], perm_o[3], perm_do[3];
};

// Shared memory of a dq block, in bytes from a 1024-byte aligned base: Q, dO
// and O of the block's rows, each DP / 64 boxes of (BLOCK_M rows x 64
// columns); the K / V ring; delta of the block's rows; the mbarriers.
template <int DP, int NWG>
struct DqSmem {
  static constexpr int BLOCK_M = 64 * NWG;
  static constexpr int KBOX = DP / BOX_COLS;
  static constexpr int ROWS_BOX = BLOCK_M * ROW_BYTES;
  static constexpr int Q = 0;
  static constexpr int DO = Q + KBOX * ROWS_BOX;
  static constexpr int O = DO + KBOX * ROWS_BOX;
  static constexpr int RING = O + KBOX * ROWS_BOX;  // stage: K then V
  static constexpr int V_OFF = KBOX * TILE_BOX;
  static constexpr int STAGE = 2 * KBOX * TILE_BOX;
  static constexpr int DELTA = RING + STAGES * STAGE;
  static constexpr int BAR = DELTA + BLOCK_M * 4;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + room to align the base
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

// Shared memory of a dk/dv block: K and V of the block's keys, the Q / dO
// ring, each stage's LSE * log2(e) and delta (64 + 64 f32), the mbarriers.
template <int DP, int NWG>
struct DkvSmem {
  static constexpr int BLOCK_N = 64 * NWG;
  static constexpr int KBOX = DP / BOX_COLS;
  static constexpr int KV_BOX = BLOCK_N * ROW_BYTES;
  static constexpr int K = 0;
  static constexpr int V = K + KBOX * KV_BOX;
  static constexpr int RING = V + KBOX * KV_BOX;  // stage: Q then dO
  static constexpr int DO_OFF = KBOX * TILE_BOX;
  static constexpr int STAGE = 2 * KBOX * TILE_BOX;
  static constexpr int STATS = RING + STAGES * STAGE;
  static constexpr int BAR = STATS + STAGES * 2 * TILE * 4;  // kv_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ void init_ring(uint32_t bar0, uint32_t full_count,
                                          uint32_t empty_count) {
  mbar_init(bar0, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(bar0 + 8 * (1 + s), full_count);
    mbar_init(bar0 + 8 * (1 + STAGES + s), empty_count);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The producer waits, before it exits, until the consumers released the last
// stages, so no copy is in flight then.
__device__ __forceinline__ void drain_ring(uint32_t bar_empty, int n) {
  for (int t = max(n - STAGES, 0); t < n; ++t) {
    mbar_wait(bar_empty + 8 * (t % STAGES), (t / STAGES) & 1);
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o,
                        const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = DqSmem<DP, NWG>;
  constexpr int BLOCK_M = L::BLOCK_M;
  constexpr int NT = DP / 8;  // 8-column blocks of the dQ accumulator, 16-byte chunks of a row

  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                  // + 8 * stage
  const uint32_t bar_empty = bar_q + 8 * (1 + STAGES);  // + 8 * stage

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q_start = p.q_start[b];
  const int kv_lim = min(p.kv_len[b], p.skv);

  // One past the last key any row of this block can see.
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, q_start + min(q0 + BLOCK_M, p.sq));
  const int n_tiles = (max(kv_end, 0) + TILE - 1) / TILE;

  if (tid == 0) init_ring(bar_q, 1, 128 * NWG);
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one lane keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(bar_q, 3 * L::KBOX * L::ROWS_BOX);
      tma_load_tile(base + L::Q, &tm_q, bar_q, p.perm_q, L::KBOX, L::ROWS_BOX, q0, h, b);
      tma_load_tile(base + L::DO, &tm_do, bar_q, p.perm_do, L::KBOX, L::ROWS_BOX, q0, h, b);
      tma_load_tile(base + L::O, &tm_o, bar_q, p.perm_o, L::KBOX, L::ROWS_BOX, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t dst = base + L::RING + s * L::STAGE;
        mbar_expect_tx(bar_full + 8 * s, L::STAGE);
        tma_load_tile(dst, &tm_k, bar_full + 8 * s, p.perm_k, L::KBOX, TILE_BOX, t * TILE, hk, b);
        tma_load_tile(dst + L::V_OFF, &tm_v, bar_full + 8 * s, p.perm_v, L::KBOX, TILE_BOX,
                      t * TILE, hk, b);
      }
      drain_ring(bar_empty, n_tiles);
    }
  } else {
    // This thread's two rows (within the block): r and r + 8 of its warp's 16.
    const int row_in_block = wg * 64 + warp * 16 + lane / 4;
    const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
    float lse2[2];
    int limit[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row_in_block + 8 * r;
      lse2[r] = i < p.sq ? p.lse[row0 + row_in_block + 8 * r] * LOG2E : 0.f;
      limit[r] = p.causal ? min(kv_lim, q_start + i + 1) : kv_lim;
    }
    // The least limit over this warpgroup's rows: tiles below it need no mask.
    const int wg_limit = p.causal ? min(kv_lim, q_start + q0 + wg * 64 + 1) : kv_lim;

    // delta = rowsum(dO * O) over this warpgroup's 64 rows, two threads a row,
    // written out for the dk/dv kernel and handed to the rows' owners.
    float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
    mbar_wait(bar_q, 0);
    {
      const int t = tid % 128;
      const int row = wg * 64 + t / 2;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        const int off = swizzled(row, (t % 2) * (NT / 2) + c, L::ROWS_BOX);
        const uint4 x = *reinterpret_cast<const uint4*>(smem + L::DO + off);
        const uint4 y = *reinterpret_cast<const uint4*>(smem + L::O + off);
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xs[e]);
          const float2 fy = __bfloat1622float2(ys[e]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (t % 2 == 0) {
        delta_s[row] = acc;
        if (q0 + row < p.sq) p.delta[row0 + row] = acc;
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
    const float dl[2] = {delta_s[row_in_block], delta_s[row_in_block + 8]};

    float dq[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) dq[i] = 0.f;
    const uint32_t q_smem = base + L::Q + wg * 64 * ROW_BYTES;
    const uint32_t do_smem = base + L::DO + wg * 64 * ROW_BYTES;

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t k_smem = base + L::RING + s * L::STAGE;
      const uint32_t v_smem = k_smem + L::V_OFF;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      __syncwarp();

      // S = Q K^T and dP = dO V^T over the head dim, 16 columns a step.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row of box kk / 4
        wgmma_ss(sc, make_desc(q_smem + (kk / 4) * L::ROWS_BOX + col, 16, 1024),
                 make_desc(k_smem + (kk / 4) * TILE_BOX + col, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(dp, make_desc(do_smem + (kk / 4) * L::ROWS_BOX + col, 16, 1024),
                 make_desc(v_smem + (kk / 4) * TILE_BOX + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta); sc[n * 4 + r * 2 + j] is row r, key k0 + 8 n + 2 (lane % 4) + j.
      const int k0 = t * TILE;
      const bool masked = k0 + TILE > wg_limit;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = n * 4 + r * 2 + j;
            float pv = fast_exp2(fmaf(sc[i], p.scale_log2, -lse2[r]));
            if (masked && k0 + n * 8 + 2 * (lane % 4) + j >= limit[r]) pv = 0.f;
            dp[i] = pv * (dp[i] - dl[r]);
          }
        }
      }
      uint32_t ds[16];
      pack_a(dp, ds);

      // dQ += dS K, 16 keys a step: K rows are 128 bytes, 8-row groups 1024
      // apart, the second 64 head-dim columns one box further.
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        wgmma_rs(dq, &ds[kb * 4], make_desc(k_smem + kb * 16 * ROW_BYTES, TILE_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(ds);
      mbar_arrive(bar_empty + 8 * s);
    }

    // dQ * scale staged in this warpgroup's own Q rows, then 16-byte stores.
    const float mul[2] = {p.scale, p.scale};
    stage_rows<NT>(smem + L::Q, L::ROWS_BOX, dq, mul, row_in_block, lane);
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
    store_rows<NT>(smem + L::Q, L::ROWS_BOX, wg * 64, p.dq + row0 * p.d, p.sq - q0, p.d,
                   tid % 128);
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using L = DkvSmem<DP, NWG>;
  constexpr int NT = DP / 8;

  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  const uint32_t bar_kv = base + L::BAR;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_kv + 8 * (1 + STAGES);
  float* stats = reinterpret_cast<float*>(smem + L::STATS);  // + 2 * TILE * stage

  const int k0 = blockIdx.x * L::BLOCK_N;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q_start = p.q_start[b];
  const int kv_lim = min(p.kv_len[b], p.skv);

  // Work items: for each q-head of the group, the query tiles from the one
  // holding the first row that sees key k0 to the last; none when every key
  // of the block lies past kv_len.
  const int n_q_tiles = (p.sq + TILE - 1) / TILE;
  const int t_first = p.causal ? max(0, k0 - q_start) / TILE : 0;
  const int per_head = max(n_q_tiles - t_first, 0);
  const int n_items = k0 < kv_lim ? group * per_head : 0;

  if (tid == 0) init_ring(bar_kv, 32, 128 * NWG);
  __syncthreads();

  if (wg == NWG) {
    // The producer warpgroup: warp 0 keeps the ring full; its lanes write the
    // stage's LSE and delta, lane 0 issues the copies.
    if constexpr (NWG == 2) regs_dealloc<PRODUCER_REGS>();
    if (warp == 0 && n_items > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::KBOX * L::KV_BOX);
        tma_load_tile(base + L::K, &tm_k, bar_kv, p.perm_k, L::KBOX, L::KV_BOX, k0, hk, b);
        tma_load_tile(base + L::V, &tm_v, bar_kv, p.perm_v, L::KBOX, L::KV_BOX, k0, hk, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int h = hk * group + it / per_head;
        const int q0 = (t_first + it % per_head) * TILE;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
        float* st = stats + s * 2 * TILE;
        const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
        for (int c = lane; c < TILE; c += 32) {
          const bool in = q0 + c < p.sq;  // rows past Sq: P = exp2(-inf) = 0
          st[c] = in ? p.lse[row0 + c] * LOG2E : INFINITY;
          st[TILE + c] = in ? p.delta[row0 + c] : 0.f;
        }
        if (lane == 0) {
          const uint32_t dst = base + L::RING + s * L::STAGE;
          mbar_expect_tx(bar_full + 8 * s, L::STAGE);
          tma_load_tile(dst, &tm_q, bar_full + 8 * s, p.perm_q, L::KBOX, TILE_BOX, q0, h, b);
          tma_load_tile(dst + L::DO_OFF, &tm_do, bar_full + 8 * s, p.perm_do, L::KBOX, TILE_BOX,
                        q0, h, b);
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
      drain_ring(bar_empty, n_items);
    }
  } else {
    if constexpr (NWG == 2) regs_alloc<CONSUMER_REGS>();
    // This thread's two keys (within the block): r and r + 8 of its warp's 16.
    const int key_in_block = wg * 64 + warp * 16 + lane / 4;
    const int key[2] = {k0 + key_in_block, k0 + key_in_block + 8};
    const int wk0 = k0 + wg * 64;  // this warpgroup's first key
    const uint32_t k_smem = base + L::K + wg * 64 * ROW_BYTES;
    const uint32_t v_smem = base + L::V + wg * 64 * ROW_BYTES;

    float dk[NT * 4], dv[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) dk[i] = dv[i] = 0.f;

    if (n_items > 0) mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_items; ++it) {
      const int q0 = (t_first + it % per_head) * TILE;
      const int s = it % STAGES;
      const uint32_t q_smem = base + L::RING + s * L::STAGE;
      const uint32_t do_smem = q_smem + L::DO_OFF;
      const float* st = stats + s * 2 * TILE;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      __syncwarp();

      // S^T = K Q^T and dP^T = V dO^T over the head dim, 16 columns a step.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(sc, make_desc(k_smem + (kk / 4) * L::KV_BOX + col, 16, 1024),
                 make_desc(q_smem + (kk / 4) * TILE_BOX + col, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(dp, make_desc(v_smem + (kk / 4) * L::KV_BOX + col, 16, 1024),
                 make_desc(do_smem + (kk / 4) * TILE_BOX + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - delta); sc[n * 4 + r * 2 + j] is key r,
      // query row q0 + 8 n + 2 (lane % 4) + j.
      const bool masked = wk0 + 64 > kv_lim || (p.causal && wk0 + 63 > q_start + q0);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n * 8 + 2 * (lane % 4) + j;
          const float lse2 = st[col];
          const float dl = st[TILE + col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = n * 4 + r * 2 + j;
            float pv = fast_exp2(fmaf(sc[i], p.scale_log2, -lse2));
            if (masked && (key[r] >= kv_lim || (p.causal && key[r] > q_start + q0 + col))) {
              pv = 0.f;
            }
            sc[i] = pv;
            dp[i] = pv * (dp[i] - dl);
          }
        }
      }
      uint32_t pa[16], ds[16];
      pack_a(sc, pa);
      pack_a(dp, ds);

      // dV += P^T dO and dK += dS^T Q, 16 query rows a step (dO, Q MN-major).
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        wgmma_rs(dv, &pa[kb * 4], make_desc(do_smem + kb * 16 * ROW_BYTES, TILE_BOX, 1024));
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        wgmma_rs(dk, &ds[kb * 4], make_desc(q_smem + kb * 16 * ROW_BYTES, TILE_BOX, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(ds);
      mbar_arrive(bar_empty + 8 * s);
    }

    // dK * scale and dV staged in this warpgroup's own K and V rows, then
    // 16-byte stores (zeros for keys past kv_len: their P is 0).
    const float mul_k[2] = {p.scale, p.scale};
    const float mul_v[2] = {1.f, 1.f};
    stage_rows<NT>(smem + L::K, L::KV_BOX, dk, mul_k, key_in_block, lane);
    stage_rows<NT>(smem + L::V, L::KV_BOX, dv, mul_v, key_in_block, lane);
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
    const long long out0 = (static_cast<long long>(b) * p.hkv + hk) * p.skv + k0;
    store_rows<NT>(smem + L::K, L::KV_BOX, wg * 64, p.dk + out0 * p.d, p.skv - k0, p.d, tid % 128);
    store_rows<NT>(smem + L::V, L::KV_BOX, wg * 64, p.dv + out0 * p.d, p.skv - k0, p.d, tid % 128);
  }
}

// Tensor maps of q, k, v, o, dO, in that order.
struct Maps {
  CUtensorMap m[5];
};

template <int DP, int NWG>
cudaError_t launch_dq(const Maps& t, const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = DqSmem<DP, NWG>::BYTES;
  static unsigned long long configured = 0;
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<DP, NWG>, bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + 64 * NWG - 1) / (64 * NWG), p.hq, batch);
  flash_bwd_dq_kernel<DP, NWG>
      <<<grid, 128 * NWG + 32, bytes, stream>>>(t.m[0], t.m[1], t.m[2], t.m[3], t.m[4], p);
  return cudaGetLastError();
}

template <int DP, int NWG>
cudaError_t launch_dkv(const Maps& t, const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = DkvSmem<DP, NWG>::BYTES;
  static unsigned long long configured = 0;
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DP, NWG>, bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.skv + 64 * NWG - 1) / (64 * NWG), p.hkv, batch);
  flash_bwd_dkv_kernel<DP, NWG>
      <<<grid, 128 * (NWG + 1), bytes, stream>>>(t.m[0], t.m[1], t.m[2], t.m[4], p);
  return cudaGetLastError();
}

int run(bool dq, const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* delta, void* dq_out, void* dk_out, void* dv_out,
        const void* q_start, const void* kv_len, int batch, int hq, int hkv, int sq, int skv,
        int d, int d_in, const long long* strides, float scale, int causal, void* stream) {
  if (d <= 0 || d_in < d || d_in > 128 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // dq blocks hold 64 * nwg query rows, dk/dv blocks 64 * nwg keys; the
  // streamed tiles are 64 rows. One warpgroup where the rows fit it, or
  // where blocks of 128 rows would leave multiprocessors idle (small
  // grids: twice the blocks, each half the work).
  const int block_rows = dq ? sq : skv;
  const long long blocks_of_128 =
      static_cast<long long>((block_rows + 127) / 128) * (dq ? hq : hkv) * batch;
  const int nwg = block_rows <= 64 || blocks_of_128 < sm_count() ? 1 : 2;
  Params p;
  p.dq = static_cast<__nv_bfloat16*>(dq_out);
  p.dk = static_cast<__nv_bfloat16*>(dk_out);
  p.dv = static_cast<__nv_bfloat16*>(dv_out);
  p.delta = static_cast<float*>(delta);
  p.lse = static_cast<const float*>(lse);
  p.q_start = static_cast<const int*>(q_start);
  p.kv_len = static_cast<const int*>(kv_len);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  const void* ptrs[5] = {q, k, v, o, dout};
  const int seq[5] = {sq, skv, skv, sq, sq};
  const int heads[5] = {hq, hkv, hkv, hq, hq};
  const int q_rows = dq ? 64 * nwg : TILE;
  const int kv_rows = dq ? TILE : 64 * nwg;
  const int rows[5] = {q_rows, kv_rows, kv_rows, q_rows, q_rows};
  int* perms[5] = {p.perm_q, p.perm_k, p.perm_v, p.perm_o, p.perm_do};
  Maps maps;
  for (int i = 0; i < 5; ++i) {
    if (!dq && i == 3) continue;  // dk/dv does not read O
    const long long* st = strides + 3 * i;  // (batch, head, seq)
    const CUresult r = encode_map(&maps.m[i], ptrs[i], d_in, seq[i], heads[i], batch, st[2],
                                  st[1], st[0], rows[i], perms[i]);
    if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dq) {
    if (d_in <= 64) {
      err = nwg == 1 ? launch_dq<64, 1>(maps, p, batch, s) : launch_dq<64, 2>(maps, p, batch, s);
    } else {
      err = nwg == 1 ? launch_dq<128, 1>(maps, p, batch, s) : launch_dq<128, 2>(maps, p, batch, s);
    }
  } else {
    if (d_in <= 64) {
      err = nwg == 1 ? launch_dkv<64, 1>(maps, p, batch, s) : launch_dkv<64, 2>(maps, p, batch, s);
    } else {
      err = nwg == 1 ? launch_dkv<128, 1>(maps, p, batch, s)
                     : launch_dkv<128, 2>(maps, p, batch, s);
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes; both take the same arguments (dq
// reads O and writes dq and delta; dk/dv reads delta and writes dk, dv). Each
// returns 0, a CUDA error code, or 1000 + cuTensorMapEncodeTiled's CUresult
// when a tensor map cannot describe an input. d is the head dim of the
// outputs; d_in the column count of the input views (d, or d rounded up to 8
// for the wrapper's aligned copies). Strides are (batch, head, seq) in
// elements for q, k, v, o, dO in turn; every base must be 16-byte aligned and
// every stride a multiple of 8 elements.
#define FLASH_BWD_ARGS                                                                           \
  const void *q, const void *k, const void *v, const void *o, const void *dout, const void *lse, \
      void *delta, void *dq, void *dk, void *dv, const void *q_start, const void *kv_len,        \
      int batch, int hq, int hkv, int sq, int skv, int d, int d_in, long long q_sb,              \
      long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,            \
      long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,            \
      long long o_ss, long long do_sb, long long do_sh, long long do_ss, float scale,            \
      int causal, void *stream
#define FLASH_BWD_RUN(is_dq)                                                                     \
  const long long strides[15] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,                 \
                                 v_ss, o_sb, o_sh, o_ss, do_sb, do_sh, do_ss};                   \
  return run(is_dq, q, k, v, o, dout, lse, delta, dq, dk, dv, q_start, kv_len, batch, hq, hkv, \
             sq, skv, d, d_in, strides, scale, causal, stream)

extern "C" int flash_bwd_dq_bf16(FLASH_BWD_ARGS) { FLASH_BWD_RUN(true); }

extern "C" int flash_bwd_dkv_bf16(FLASH_BWD_ARGS) { FLASH_BWD_RUN(false); }
