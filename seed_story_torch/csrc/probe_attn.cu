// The attention probes' kernels for Hopper (sm_90a): the counterparts of
// the six Pallas kernels of benchmarks/probe_attn_variants.py,
// probe_attn_overhead.py and probe_attn_dma.py. They split an attention
// kernel's time into its parts: the exponentials, one program per head, the
// traffic of attention's I/O. Plain versions:
// seed_story_torch/benchmarks/probe_kernels.py; launch plans: attn_plan,
// single_pass_plan and copy_plan there.
//
// Inputs are contiguous bf16 (B, H, S, 64) q, k, v (the packed layout:
// (B, H/2, S, 128), head i of a pair at columns 64 i); outputs bf16 in the
// same layout. Scores and sums are f32; P is rounded to bf16 before PV.
//
// Three templates:
// - online::probe_attn_online_kernel<Variant, NWG, BKV> replaces `attn`
//   (probe_attn_variants.py:77, body make_kernel :23): full-mask online
//   softmax over key tiles of BKV (64 or 128), in three variants: base =
//   scale, then __expf (a multiply by log2 e and ex2.approx); exp2 = the
//   scale and log2 e folded into one FFMA before ex2.approx; noexp = P =
//   scale * S with no max, no MUFU and alpha = 1. The TPU's 256-1024-row
//   blocks do not fit a block's registers; a block owns BQ = 64 NWG query
//   rows of one head (grid (S / BQ, H, B)): NWG consumer warpgroups of 64
//   rows and one producer warp, which loads Q once by TMA and K / V tiles
//   into a ring of mbarrier stages (128-byte swizzle; 128 KB of ring at BQ =
//   128, one block an SM; 96 KB at BQ = 64, so that two blocks share an
//   SM). The consumers need at most 168 registers a thread (ptxas), so
//   two 160-thread blocks fit an SM's 65,536 and no setmaxnreg is needed.
//   S = Q K^T is wgmma m64nBKVk16 from shared memory; P, rounded to bf16 in
//   registers, is the A operand of O += P V (wgmma m64n64k16, V the MN-major
//   B). S, P, O, the running max and the row sums (f32, a zero sum read as 1)
//   stay in registers. Every instance pipelines: tile t + 1's Q K^T is issued
//   with tile t's P V, and tile t + 1's softmax runs while that P V does.
//   At BQ = 128 the two warpgroups also issue their products in turn (named
//   barriers), so one's exponentials run under the other's products; at BQ
//   = 64 the two blocks of an SM overlap the same way, unordered. O / l is
//   staged through the warpgroup's own Q rows and stored 16 bytes a thread.
// - sp::probe_single_pass_kernel<HEADS, PACKED> replaces `single_pass`
//   (probe_attn_overhead.py:48), `single_pass_fused_bh` (:76) and
//   `attn_packed2` (probe_attn_dma.py:51): softmax(scale Q K^T) V with one
//   max per row over the whole sequence, as the TPU kernel keeps it (no
//   online rescaling). A head's f32 scores (4 MiB at S = 1024) do not fit on
//   chip, so every query row makes two passes over the keys: pass 1
//   computes Q K^T and its row max; pass 2 computes Q K^T again, p = exp(s -
//   m) with the final m, l += p in f32 and O += bf16(p) V. The TPU's one
//   program per head becomes a cluster of blocks per head (or head pair):
//   each block takes 128 query rows (two consumer warpgroups of 64 and one
//   producer warp, the shape of flash_fwd.cu), a cluster has up to 8 blocks
//   and a head ceil(S / 128) blocks in one or more clusters, so the grid
//   has 160-320 blocks at the probe shapes where one block a head gave
//   10-40. Q comes once by TMA and serves both passes. K (pass 1) and K and
//   V (pass 2) tiles of 128 keys cross L2 once a cluster: each block's
//   producer issues its share of a tile's 8-row boxes by TMA multicast into
//   every block of the cluster, into a ring of 4 stages with "full" and
//   "empty" mbarriers. A stage is refilled only once every block of the
//   cluster has released it: each consumer warp arrives on the empty
//   barrier of every block (mapa + remote mbarrier.arrive). S = Q K^T is
//   wgmma m64n128k16 from shared memory; pass 1 keeps the row max in
//   registers with no exponential; pass 2 takes ex2.approx with the scale
//   and log2 e folded into one FFMA, packs P to bf16 as wgmma's A operand
//   and adds P V with V as the MN-major B (wgmma_rs). S, P and O stay in
//   registers. A row's sums run over the keys in one fixed order, so the
//   bits do not depend on the plan. The two-head program keeps both heads'
//   Q in shared memory and carries the ring on from one head to the next;
//   the packed layout reads head j of a pair as the box at column 64 j.
// - probe_copy_only_kernel replaces `copy_only` (probe_attn_overhead.py:32,
//   probe_attn_dma.py:32): blocks of (head, span) where the TPU grid has one
//   program a head, 4 or more blocks an SM at the probe shapes. A block
//   brings its span of K (8-32 KB) into shared memory with one bulk copy
//   (left unread: the TPU pipeline brings K's block on chip unused), loads
//   its spans of Q and V with 16-byte loads, all issued before the first
//   sum, and stores O = bf16(f32(Q) + f32(V)), equal to torch's q + v bit
//   for bit, 16 bytes a thread. It moves attention's whole I/O, 3 tensors
//   in and one out.
//
// What bounds them on an H100: attention at d = 64 is 4 S^2 d operations
// a head against 8 S d bytes, so above S ~ 600 the tensor cores bound it
// (989 TFLOP/s); the exponentials (S^2 a head) need as long on the SFU (16
// a clock an SM): the exp floor equals the operations' bound at d = 64, so a
// kernel reaches either only where every exponential runs under a product.
// That is what the online kernel's pipeline and its warpgroups' turns are
// for, and its noexp variant shows what is left without them. The single
// pass does 6 S^2 d operations a head (Q K^T twice), so its best is 1.5 x
// the bound. The copy is bound by bytes (3.35 TB/s): enough blocks and
// bytes in flight on every SM is what its design is for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;  // head dim
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kBase = 0, kExp2 = 1, kNoExp = 2 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the online kernel: a TMA ring, wgmma, warpgroups in turn ----

namespace online {

using flash::ROW_BYTES;

// Shared memory of one block from a 1024-byte aligned base: Q (64 NWG rows),
// the ring (a stage is a K tile then a V tile of BKV rows, 128-byte swizzle),
// the barriers. 64-row blocks (NWG = 1) are sized so that two share an SM.
template <int kNWG, int kBKV>
struct Smem {
  static constexpr int BLOCKS_PER_SM = kNWG == 1 ? 2 : 1;
  static constexpr int Q_BYTES = kNWG * 64 * ROW_BYTES;
  static constexpr int TILE = kBKV * ROW_BYTES;  // one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAGES = (kNWG == 1 ? 96 * 1024 : 128 * 1024) / STAGE;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int BAR = K + STAGES * STAGE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + room to align the base
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
  // an SM has 228 KB, and each block's share of it takes 1 KB more
  static_assert(BLOCKS_PER_SM * (BYTES + 1024) <= 233472, "the planned blocks do not fit an SM");
};

struct Params {
  __nv_bfloat16* o;
  int s;             // query rows and keys a head
  int heads;         // H
  float scale;       // 1 / sqrt(d)
  float scale_log2;  // scale * log2(e)
  int perm_q[3], perm_kv[3];  // which of (row, head, batch) each map dim 1..3 holds
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// S = Q K^T of a warpgroup's 64 rows against a tile of N / 2 keys, both K-major
// and swizzled: four k-steps of 16 over d = 64, committed as one group.
template <int N>
__device__ __forceinline__ void issue_scores(float (&sc)[N], uint32_t q_smem, uint32_t k_smem) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    flash::wgmma_ss(sc, flash::make_desc(q_smem + kk * 32, 16, 1024),
                    flash::make_desc(k_smem + kk * 32, 16, 1024), kk > 0);
  }
  flash::wgmma_commit();
}

// O += P V: P's bf16 A fragments (16 keys a step, 4 N keys in all), V the
// MN-major B from shared memory; committed as one group.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[N], uint32_t v_smem) {
#pragma unroll
  for (int kb = 0; kb < N / 4; ++kb) {
    flash::wgmma_rs(o, &pa[kb * 4],
                    flash::make_desc(v_smem + kb * 16 * ROW_BYTES, 4 * N * ROW_BYTES, 1024));
  }
  flash::wgmma_commit();
}

// One tile's softmax on S in place (sc[n * 4 + r * 2 + j]: row r * 8 + lane /
// 4 of the warp's 16, key 8 n + 2 (lane % 4) + j): the running max m, the
// factor alpha for O and l, P in f32 and this thread's part of the tile's
// row sums ps. base: scale, then __expf (a multiply by log2 e and
// ex2.approx); exp2: the scale and log2 e folded into one FFMA before
// ex2.approx; noexp: P = scale * S, no max, no MUFU, alpha = 1.
template <int kVariant, int N>
__device__ __forceinline__ void softmax_step(float (&sc)[N], float (&m)[2], float (&alpha)[2],
                                             float (&ps)[2], float scale, float scale_log2) {
  ps[0] = ps[1] = 0.f;
  if constexpr (kVariant == kNoExp) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sc[i] *= scale;
      ps[(i / 2) % 2] += sc[i];
    }
    alpha[0] = alpha[1] = 1.f;
  } else {
    if constexpr (kVariant == kBase) {
#pragma unroll
      for (int i = 0; i < N; ++i) sc[i] *= scale;
    }
    // base: the max of scale * S; exp2: of raw S, in log2 units after the fold
    const float f = kVariant == kExp2 ? scale_log2 : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
        mx = fmaxf(mx, fmaxf(sc[n * 4 + r * 2], sc[n * 4 + r * 2 + 1]));
      }
      const float mn = fmaxf(m[r], quad_max(mx) * f);
      alpha[r] = kVariant == kBase ? __expf(m[r] - mn) : ex2(m[r] - mn);
      m[r] = mn;
#pragma unroll
      for (int n = 0; n < N / 4; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = sc[n * 4 + r * 2 + j];
          x = kVariant == kBase ? __expf(x - mn) : ex2(fmaf(x, scale_log2, -mn));
          ps[r] += x;
        }
      }
    }
  }
}

// Grid (S / 64 NWG, H, B): a block owns 64 NWG query rows of one head, NWG
// consumer warpgroups of 64 rows and one producer warp. Every consumer walks
// all S / BKV key tiles with tile t + 1's Q K^T in flight beside tile t's
// P V, and tile t + 1's softmax under that P V.
template <int kVariant, int kNWG, int kBKV>
__global__ void __launch_bounds__(128 * kNWG + 32, Smem<kNWG, kBKV>::BLOCKS_PER_SM)
    probe_attn_online_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<kNWG, kBKV>;
  constexpr int N = kBKV / 2;  // S accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = flash::aligned_smem(smem_raw, base);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                       // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::STAGES;       // + 8 * stage
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q0 = blockIdx.x * 64 * kNWG, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = p.s / kBKV;

  if (tid == 0) {
    flash::mbar_init(bar_q, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      flash::mbar_init(bar_full + 8 * st, 1);
      flash::mbar_init(bar_empty + 8 * st, 4 * kNWG);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kNWG) {
    // The producer warp: one lane loads Q, then keeps the ring full,
    // refilling a stage once every consumer warp has released it. Every
    // copy lands before the consumers finish, since they wait for each.
    if (lane == 0) {
      flash::mbar_expect_tx(bar_q, L::Q_BYTES);
      flash::tma_load_tile(base + L::Q, &tm_q, bar_q, p.perm_q, 1, L::Q_BYTES, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % L::STAGES;
        if (t >= L::STAGES) flash::mbar_wait(bar_empty + 8 * st, (t / L::STAGES - 1) & 1);
        const uint32_t dst = base + L::K + st * L::STAGE;
        flash::mbar_expect_tx(bar_full + 8 * st, L::STAGE);
        flash::tma_load_tile(dst, &tm_k, bar_full + 8 * st, p.perm_kv, 1, L::TILE, t * kBKV, h, b);
        flash::tma_load_tile(dst + L::TILE, &tm_v, bar_full + 8 * st, p.perm_kv, 1, L::TILE,
                             t * kBKV, h, b);
      }
    }
  } else {
    const int row_in_block = wg * 64 + warp * 16 + lane / 4;
    const uint32_t q_smem = base + L::Q + wg * 64 * ROW_BYTES;
    auto k_smem = [&](int t) { return base + L::K + (t % L::STAGES) * L::STAGE; };
    auto wait_full = [&](int t) {
      flash::mbar_wait(bar_full + 8 * (t % L::STAGES), (t / L::STAGES) & 1);
    };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) flash::mbar_arrive(bar_empty + 8 * (t % L::STAGES));
    };
    // Two warpgroups issue their products in turn: warpgroup w waits on
    // named barrier 1 + w until the other has issued, so one's softmax runs
    // while the other's products hold the tensor cores. Each issues S / BKV
    // + 1 times; warpgroup 1 opens with an arrive and skips its last, so the
    // counts on both barriers match.
    auto my_turn = [&]() {
      if constexpr (kNWG == 2) bar_sync(1 + wg, 256);
    };
    auto your_turn = [&]() {
      if constexpr (kNWG == 2) bar_arrive(2 - wg, 256);
    };

    float o[32], m[2] = {-INFINITY, -INFINITY}, l[2], alpha[2], ps[2];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sc[N];
    uint32_t pa[N / 2];  // P in bf16 as wgmma A fragments
    flash::mbar_wait(bar_q, 0);
    if constexpr (kNWG == 2) {
      if (wg == 1) bar_arrive(1, 256);  // warpgroup 0 issues first
    }

    wait_full(0);
    my_turn();
    flash::wgmma_fence();
    issue_scores(sc, q_smem, k_smem(0));
    your_turn();
    wgmma_wait<0>();
    flash::fence_regs(sc);
    softmax_step<kVariant>(sc, m, alpha, ps, p.scale, p.scale_log2);
    l[0] = ps[0];
    l[1] = ps[1];
    flash::pack_a(sc, pa);
    for (int t = 1; t < n_tiles; ++t) {
      wait_full(t);
      my_turn();
      flash::wgmma_fence();
      issue_scores(sc, q_smem, k_smem(t));
      issue_pv(o, pa, k_smem(t - 1) + L::TILE);
      your_turn();
      wgmma_wait<1>();  // S of tile t; P V of tile t - 1 still runs
      flash::fence_regs(sc);
      softmax_step<kVariant>(sc, m, alpha, ps, p.scale, p.scale_log2);
      wgmma_wait<0>();
      flash::fence_regs(o);
      flash::fence_regs(pa);
      release(t - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
      if constexpr (kVariant != kNoExp) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            o[n * 4 + r * 2] *= alpha[r];
            o[n * 4 + r * 2 + 1] *= alpha[r];
          }
        }
      }
      flash::pack_a(sc, pa);
    }
    my_turn();
    flash::wgmma_fence();
    issue_pv(o, pa, k_smem(n_tiles - 1) + L::TILE);
    if (wg == 0) your_turn();
    wgmma_wait<0>();
    flash::fence_regs(o);
    flash::fence_regs(pa);
    // (the last stage needs no release: the producer has issued every tile)

    // O / l (a zero sum read as 1) staged in this warpgroup's own Q rows,
    // then 16-byte stores.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      inv[r] = 1.f / (sum == 0.f ? 1.f : sum);
    }
    flash::stage_rows<8>(smem + L::Q, L::Q_BYTES, o, inv, row_in_block, lane);
    bar_sync(3 + wg, 128);
    const long long row0 = (static_cast<long long>(b) * p.heads + h) * p.s + q0;
    flash::store_rows<8>(smem + L::Q, L::Q_BYTES, wg * 64, p.o + row0 * kD, 64 * kNWG, kD,
                         tid % 128);
  }
}

// Raises the instance's dynamic shared-memory limit and asks for the largest
// shared-memory carveout (two 64-row blocks an SM need 2 x 106 KB), once a
// device.
template <int kVariant, int kNWG, int kBKV>
cudaError_t configure() {
  auto kernel = probe_attn_online_kernel<kVariant, kNWG, kBKV>;
  static unsigned long long configured = 0;  // a bit per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && (configured >> device & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<kNWG, kBKV>::BYTES);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && device < 64) configured |= 1ull << device;
  return err;
}

template <int kVariant, int kNWG, int kBKV>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err = configure<kVariant, kNWG, kBKV>();
  if (err != cudaSuccess) return err;
  probe_attn_online_kernel<kVariant, kNWG, kBKV>
      <<<dim3(p.s / (64 * kNWG), p.heads, batch), 128 * kNWG + 32, Smem<kNWG, kBKV>::BYTES,
         stream>>>(q, k, v, p);
  return cudaGetLastError();
}

// What the instance is: its dynamic shared memory, ring stages, threads, the
// blocks an SM holds by the runtime's occupancy count, and its registers.
template <int kVariant, int kNWG, int kBKV>
cudaError_t info(int* out) {
  cudaError_t err = configure<kVariant, kNWG, kBKV>();
  if (err != cudaSuccess) return err;
  auto kernel = probe_attn_online_kernel<kVariant, kNWG, kBKV>;
  constexpr int threads = 128 * kNWG + 32;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      Smem<kNWG, kBKV>::BYTES);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = Smem<kNWG, kBKV>::BYTES;
  out[1] = Smem<kNWG, kBKV>::STAGES;
  out[2] = threads;
  out[3] = blocks;
  out[4] = attr.numRegs;
  return cudaSuccess;
}

// Calls fn(variant, warpgroups, keys a tile) with the three as integral
// constants for one of the 12 instances; cudaErrorInvalidValue for none.
template <typename Fn>
cudaError_t dispatch(int variant, int block_q, int block_kv, Fn&& fn) {
  auto tiles = [&](auto v) -> cudaError_t {
    using I2 = std::integral_constant<int, 2>;
    using I1 = std::integral_constant<int, 1>;
    using K128 = std::integral_constant<int, 128>;
    using K64 = std::integral_constant<int, 64>;
    if (block_q == 128 && block_kv == 128) return fn(v, I2{}, K128{});
    if (block_q == 128 && block_kv == 64) return fn(v, I2{}, K64{});
    if (block_q == 64 && block_kv == 128) return fn(v, I1{}, K128{});
    if (block_q == 64 && block_kv == 64) return fn(v, I1{}, K64{});
    return cudaErrorInvalidValue;
  };
  switch (variant) {
    case kBase: return tiles(std::integral_constant<int, kBase>{});
    case kExp2: return tiles(std::integral_constant<int, kExp2>{});
    case kNoExp: return tiles(std::integral_constant<int, kNoExp>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace online

// ---- the single pass: a cluster of blocks a head, K / V multicast by TMA ----

namespace sp {

using flash::BOX_COLS;
using flash::ROW_BYTES;

constexpr int kRows = 128;       // query rows a block: two consumer warpgroups of 64
constexpr int kKeys = 128;       // keys a K / V tile
constexpr int kStages = 4;       // depth of the K / V ring
constexpr int kShareRows = 8;    // rows of a K / V box: 1 KB, one swizzle period
constexpr int kShares = kKeys / kShareRows;  // boxes a tile, cut among the cluster's blocks
constexpr int kMaxCluster = 8;   // Hopper's portable limit
constexpr int kThreads = 2 * 128 + 32;
constexpr int kTileBytes = kKeys * ROW_BYTES;  // one K or V tile (d = 64): 16 KB
constexpr int kQBytes = kRows * ROW_BYTES;     // a head's 128 Q rows: 16 KB

struct Params {
  __nv_bfloat16* o;
  int s;                 // sequence length, a multiple of 64
  int cols;              // elements of a row of the layout: 64, or 128 for packed pairs
  int blocks_per_group;  // blocks a head (or pair): cluster x clusters_per_group
  int cluster;           // blocks a cluster
  float scale_log2;      // scale * log2(e): the exponentials run in base 2
  int perm_q[3], perm_kv[3];  // which of (row, head, batch) each map dim 1..3 holds
};

// Shared memory from a 1024-byte aligned base: Q of each head (kHeads x 16 KB),
// the ring (a stage is K then V, 16 KB each), the barriers.
template <int kHeads>
struct Smem {
  static constexpr int Q = 0;
  static constexpr int K = Q + kHeads * kQBytes;
  static constexpr int STAGE = 2 * kTileBytes;
  static constexpr int BAR = K + kStages * STAGE;  // q_full[kHeads], full[kStages], empty[kStages]
  static constexpr int BYTES = BAR + 8 * (kHeads + 2 * kStages) + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The 64-column box at (column col, row, head) of a map from encode_map.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         const int (&perm)[3], int col, int row, int head) {
  flash::tma_load(dst, map, bar, col, flash::pick(perm[0], row, head, 0),
                  flash::pick(perm[1], row, head, 0), flash::pick(perm[2], row, head, 0));
}

__device__ __forceinline__ void load_box_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, uint16_t mask,
                                                   const int (&perm)[3], int col, int row,
                                                   int head) {
  flash::tma_load_multicast(dst, map, bar, mask, col, flash::pick(perm[0], row, head, 0),
                            flash::pick(perm[1], row, head, 0),
                            flash::pick(perm[2], row, head, 0));
}

// S = Q K^T of a warpgroup's 64 rows against a 128-key tile, both K-major
// and swizzled in shared memory: four k-steps of 16 over d = 64.
__device__ __forceinline__ void scores(float (&sc)[64], uint32_t q_smem, uint32_t k_smem) {
  flash::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    flash::wgmma_ss(sc, flash::make_desc(q_smem + kk * 32, 16, 1024),
                    flash::make_desc(k_smem + kk * 32, 16, 1024), kk > 0);
  }
  flash::wgmma_commit();
  flash::wgmma_wait_all();
  flash::fence_regs(sc);
}

// sc[n * 4 + r * 2 + j] is key k0 + 8 n + 2 (lane % 4) + j: keys from s on
// (the last tile when s is not a multiple of 128) read as zero; they get -inf.
__device__ __forceinline__ void mask_tail(float (&sc)[64], int k0, int s, int lane) {
  if (k0 + kKeys <= s) return;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (k0 + 8 * n + 2 * (lane % 4) + j >= s) sc[n * 4 + j] = sc[n * 4 + 2 + j] = -INFINITY;
    }
  }
}

// Grid: head groups x blocks_per_group, in clusters of `cluster` blocks along
// x. Block i of a group owns query rows 128 i .. 128 i + 127 of each of the
// group's heads (rows from s on read as zero and are not stored). A group is
// one head (kHeads 1), two consecutive heads of the flat layout (kHeads 2), or
// the two halves of a packed row (kPacked).
template <int kHeads, bool kPacked>
__global__ void __launch_bounds__(kThreads, 1)
    probe_single_pass_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<kHeads>;
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  flash::aligned_smem(smem_raw, base);  // the same offset in every block of the cluster
  const uint32_t bar_q = base + L::BAR;                // + 8 * head
  const uint32_t bar_full = bar_q + 8 * kHeads;        // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int group = blockIdx.x / p.blocks_per_group;
  const int q0 = (blockIdx.x % p.blocks_per_group) * kRows;
  const int n_tiles = (p.s + kKeys - 1) / kKeys;
  // the map's head index and first column of the group's head hi
  auto head_of = [&](int hi) { return kPacked ? group : group * kHeads + hi; };
  auto col_of = [&](int hi) { return kPacked ? hi * BOX_COLS : 0; };

  if (tid == 0) {
    for (int hi = 0; hi < kHeads; ++hi) flash::mbar_init(bar_q + 8 * hi, 1);
    for (int st = 0; st < kStages; ++st) {
      flash::mbar_init(bar_full + 8 * st, 1);
      // one arrive from each consumer warp of each block of the cluster
      flash::mbar_init(bar_empty + 8 * st, 8 * p.cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // no multicast or remote arrive reaches a block before its barriers exist
  cg::this_cluster().sync();

  if (wg == 2) {
    // The producer: one lane loads this block's Q rows of each head, then
    // walks the ring through every tile of both passes of every head (pass 1
    // K, pass 2 K and V), issuing this block's share of each tile (boxes
    // rank, rank + cluster, ...) to every block of the cluster. A stage is
    // refilled once all the cluster's consumers have released it.
    if (lane == 0) {
      const uint32_t rank = cluster_rank();
      const uint16_t mask = static_cast<uint16_t>((1u << p.cluster) - 1);
      for (int hi = 0; hi < kHeads; ++hi) {
        flash::mbar_expect_tx(bar_q + 8 * hi, kQBytes);
        load_box(base + L::Q + hi * kQBytes, &tm_q, bar_q + 8 * hi, p.perm_q, col_of(hi), q0,
                 head_of(hi));
      }
      int g = 0;  // tiles through the ring so far
      for (int hi = 0; hi < kHeads; ++hi) {
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = 0; t < n_tiles; ++t, ++g) {
            const int st = g % kStages;
            if (g >= kStages) flash::mbar_wait(bar_empty + 8 * st, (g / kStages - 1) & 1);
            const uint32_t dst = base + L::K + st * L::STAGE;
            flash::mbar_expect_tx(bar_full + 8 * st, pass ? 2 * kTileBytes : kTileBytes);
            for (int sh = rank; sh < kShares; sh += p.cluster) {
              const int row = t * kKeys + sh * kShareRows;
              const uint32_t off = sh * kShareRows * ROW_BYTES;
              load_box_multicast(dst + off, &tm_k, bar_full + 8 * st, mask, p.perm_kv,
                                 col_of(hi), row, head_of(hi));
              if (pass) {
                load_box_multicast(dst + kTileBytes + off, &tm_v, bar_full + 8 * st, mask,
                                   p.perm_kv, col_of(hi), row, head_of(hi));
              }
            }
          }
        }
      }
      // Every block has released the last stages, so no remote arrive is
      // still on its way to this block when it exits.
      for (int t = max(g - kStages, 0); t < g; ++t) {
        flash::mbar_wait(bar_empty + 8 * (t % kStages), (t / kStages) & 1);
      }
    }
    return;
  }

  // A consumer warp releases a stage to every block of the cluster: lane r
  // arrives on block r's empty barrier.
  auto release = [&](int st) {
    __syncwarp();
    if (lane < p.cluster) flash::mbar_arrive_remote(bar_empty + 8 * st, lane);
  };
  // This thread's two rows of the block: r and r + 8 of its warp's 16.
  const int row_in_block = wg * 64 + warp * 16 + lane / 4;
  int g = 0;
  for (int hi = 0; hi < kHeads; ++hi) {
    const uint32_t q_smem = base + L::Q + hi * kQBytes + wg * 64 * ROW_BYTES;
    flash::mbar_wait(bar_q + 8 * hi, 0);

    // Pass 1: the row max of S over every key, kept per thread and reduced
    // over the quad once.
    float mx[2] = {-INFINITY, -INFINITY};
    for (int t = 0; t < n_tiles; ++t, ++g) {
      const int st = g % kStages;
      flash::mbar_wait(bar_full + 8 * st, (g / kStages) & 1);
      __syncwarp();
      float sc[64];
      scores(sc, q_smem, base + L::K + st * L::STAGE);
      release(st);
      mask_tail(sc, t * kKeys, p.s, lane);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], fmaxf(sc[n * 4 + r * 2], sc[n * 4 + r * 2 + 1]));
        }
      }
    }
    float m[2];  // the row max of scale * S, in log2 units
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(mx[r]) * p.scale_log2;

    // Pass 2: p = exp(scale S - max) with the final max, so O is never
    // rescaled; l sums p in f32 per thread; O += bf16(p) V.
    float o[32], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int t = 0; t < n_tiles; ++t, ++g) {
      const int st = g % kStages;
      const uint32_t k_smem = base + L::K + st * L::STAGE;
      flash::mbar_wait(bar_full + 8 * st, (g / kStages) & 1);
      __syncwarp();
      float sc[64];
      scores(sc, q_smem, k_smem);
      mask_tail(sc, t * kKeys, p.s, lane);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float e = flash::fast_exp2(fmaf(sc[n * 4 + r * 2 + j], p.scale_log2, -m[r]));
            sc[n * 4 + r * 2 + j] = e;
            l[r] += e;
          }
        }
      }
      uint32_t pa[32];  // P in bf16 as wgmma A fragments, 16 keys a step
      flash::pack_a(sc, pa);
      flash::wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 8; ++kb) {
        flash::wgmma_rs(o, &pa[kb * 4],
                        flash::make_desc(k_smem + kTileBytes + kb * 16 * ROW_BYTES, kTileBytes,
                                         1024));
      }
      flash::wgmma_commit();
      flash::wgmma_wait_all();
      flash::fence_regs(o);
      flash::fence_regs(pa);
      release(st);
    }

    // O / l in bf16, 4 bytes a store: rows from s on are not stored.
    const size_t head_row0 = kPacked ? static_cast<size_t>(group) * p.s
                                     : static_cast<size_t>(group * kHeads + hi) * p.s;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float inv = 1.f / sum;
      const int row = q0 + row_in_block + 8 * r;
      if (row >= p.s) continue;
      __nv_bfloat16* out = p.o + (head_row0 + row) * p.cols + col_of(hi) + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(out + 8 * n) =
            flash::pack_bf16(o[n * 4 + r * 2] * inv, o[n * 4 + r * 2 + 1] * inv);
      }
    }
  }
}

template <int kHeads, bool kPacked>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const Params& p, int blocks, cudaStream_t stream) {
  constexpr int bytes = Smem<kHeads>::BYTES;
  auto kernel = probe_single_pass_kernel<kHeads, kPacked>;
  static unsigned long long configured = 0;
  cudaError_t err = flash::allow_smem(kernel, bytes, configured);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, p);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

}  // namespace sp

// ---- the copy: blocks of (head, span) ----

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 8;  // 16-byte units a thread: spans of up to 32 KB
constexpr int kCopyMaxSpan = kCopyThreads * kCopyUnroll;

// Grid: heads x spans_per_head. A block owns span_units 16-byte units of its
// head (fewer in the head's last span): K's into shared memory by one bulk
// copy, left unread; Q's and V's into registers, every load issued before
// the first sum; O = bf16(f32(Q) + f32(V)) stored 16 bytes a thread.
__global__ void __launch_bounds__(kCopyThreads) probe_copy_only_kernel(
    const uint4* __restrict__ q, const uint4* __restrict__ k, const uint4* __restrict__ v,
    uint4* __restrict__ o, long long head_units, int span_units, int spans_per_head) {
  extern __shared__ __align__(128) uint4 k_span[];
  __shared__ __align__(8) uint64_t k_bar;
  const long long head = blockIdx.x / spans_per_head;
  const long long start = static_cast<long long>(blockIdx.x % spans_per_head) * span_units;
  const int n = static_cast<int>(min(static_cast<long long>(span_units), head_units - start));
  const long long first = head * head_units + start;
  const uint32_t bar = flash::smem_u32(&k_bar);
  if (threadIdx.x == 0) {
    flash::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    flash::mbar_expect_tx(bar, n * 16);
    flash::bulk_load(flash::smem_u32(k_span), k + first, n * 16, bar);
  }
  uint4 a[kCopyUnroll], b[kCopyUnroll];
#pragma unroll
  for (int j = 0; j < kCopyUnroll; ++j) {
    const int i = threadIdx.x + j * kCopyThreads;
    if (i < n) {
      a[j] = __ldg(q + first + i);
      b[j] = __ldg(v + first + i);
    }
  }
#pragma unroll
  for (int j = 0; j < kCopyUnroll; ++j) {
    const int i = threadIdx.x + j * kCopyThreads;
    if (i >= n) break;
    const uint32_t aw[4] = {a[j].x, a[j].y, a[j].z, a[j].w};
    const uint32_t bw[4] = {b[j].x, b[j].y, b[j].z, b[j].w};
    uint32_t ow[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      ow[w] = pack_bf16(fa.x + fb.x, fa.y + fb.y);
    }
    o[first + i] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
  // K has landed: no copy into shared memory outlives the block
  if (threadIdx.x == 0) flash::mbar_wait(bar, 0);
}

}  // namespace

extern "C" {

// Full-mask attention of contiguous bf16 (b, h, s, 64) q, k, v into o, one of
// the three variants (0 base, 1 exp2, 2 noexp), tiles (block_q, block_kv) in
// {64, 128}^2, s a multiple of both. Returns 0, a cudaError_t code, or 1000 +
// the CUresult of a tensor map that could not be encoded.
int probe_attn(const void* q, const void* k, const void* v, void* o, int b, int h, int s,
               int variant, int block_q, int block_kv, float scale, void* stream) {
  if (!((block_q == 64 || block_q == 128) && (block_kv == 64 || block_kv == 128)) || b < 1 ||
      h < 1 || s < 1 || s % block_q || s % block_kv || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (flash::encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the encoder needs the device's context current on this thread
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  online::Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.s = s;
  p.heads = h;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const long long ss = kD, sh = static_cast<long long>(s) * kD, sb = sh * h;
  CUtensorMap tq, tk, tv;
  CUresult r = flash::encode_map(&tq, q, kD, s, h, b, ss, sh, sb, block_q, p.perm_q);
  if (r == CUDA_SUCCESS) {
    r = flash::encode_map(&tk, k, kD, s, h, b, ss, sh, sb, block_kv, p.perm_kv);
  }
  if (r == CUDA_SUCCESS) {
    r = flash::encode_map(&tv, v, kD, s, h, b, ss, sh, sb, block_kv, p.perm_kv);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  auto st = static_cast<cudaStream_t>(stream);
  err = online::dispatch(variant, block_q, block_kv, [&](auto vr, auto nwg, auto bkv) {
    return online::launch<decltype(vr)::value, decltype(nwg)::value, decltype(bkv)::value>(
        tq, tk, tv, p, b, st);
  });
  return static_cast<int>(err);
}

// The online kernel's instance for (variant, block_q, block_kv): out[0] its
// dynamic shared memory in bytes, out[1] its ring's stages, out[2] its
// threads, out[3] the blocks an SM holds (the runtime's occupancy count),
// out[4] its registers a thread at launch. Returns 0 or a cudaError_t code.
int probe_attn_info(int variant, int block_q, int block_kv, int* out) {
  const cudaError_t err =
      online::dispatch(variant, block_q, block_kv, [&](auto vr, auto nwg, auto bkv) {
        return online::info<decltype(vr)::value, decltype(nwg)::value, decltype(bkv)::value>(
            out);
      });
  return static_cast<int>(err);
}

// The single pass over `groups` head groups of `heads_per_block` heads (1 or
// 2) in the flat (B x H, S, 64) layout, or (packed = 1, two heads a group)
// the (B x H/2, S, 128) one; s a multiple of 64. Each group runs on
// clusters_per_group clusters of `cluster` blocks of 128 query rows
// (cluster x clusters_per_group x 128 >= s, cluster <= 8). Returns 0, a
// cudaError_t code, or 1000 + the CUresult of a tensor map that could not be
// encoded.
int probe_single_pass(const void* q, const void* k, const void* v, void* o, int groups,
                      int heads_per_block, int packed, int s, int cluster,
                      int clusters_per_group, float scale, void* stream) {
  const int blocks_per_group = cluster * clusters_per_group;
  if (groups < 1 || s < 64 || s % 64 || cluster < 1 || cluster > sp::kMaxCluster ||
      clusters_per_group < 1 || static_cast<long long>(blocks_per_group) * sp::kRows < s ||
      static_cast<long long>(blocks_per_group - cluster) * sp::kRows >= s ||
      static_cast<long long>(groups) * blocks_per_group > 0x7fffffff ||
      !(heads_per_block == 1 || heads_per_block == 2) || (packed && heads_per_block != 2) ||
      !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (flash::encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the encoder needs the device's context current on this thread
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  sp::Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.s = s;
  p.cols = packed ? 2 * kD : kD;
  p.blocks_per_group = blocks_per_group;
  p.cluster = cluster;
  p.scale_log2 = scale * kLog2e;
  // (1, heads of the layout, s, cols) views: rows of cols elements
  const int heads = packed ? groups : groups * heads_per_block;
  const long long ss = p.cols, sh = static_cast<long long>(s) * p.cols;
  CUtensorMap tq, tk, tv;
  CUresult r = flash::encode_map(&tq, q, p.cols, s, heads, 1, ss, sh, 0, sp::kRows, p.perm_q);
  if (r == CUDA_SUCCESS) {
    r = flash::encode_map(&tk, k, p.cols, s, heads, 1, ss, sh, 0, sp::kShareRows, p.perm_kv);
  }
  if (r == CUDA_SUCCESS) {
    r = flash::encode_map(&tv, v, p.cols, s, heads, 1, ss, sh, 0, sp::kShareRows, p.perm_kv);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const int blocks = groups * blocks_per_group;
  auto st = static_cast<cudaStream_t>(stream);
  if (packed) err = sp::launch<2, true>(tq, tk, tv, p, blocks, st);
  else if (heads_per_block == 2) err = sp::launch<2, false>(tq, tk, tv, p, blocks, st);
  else err = sp::launch<1, false>(tq, tk, tv, p, blocks, st);
  return static_cast<int>(err);
}

// O = Q + V over `heads` heads of head_units 16-byte units each, in blocks
// of (head, span): spans of span_units (at most 2048: 32 KB), spans_per_head
// of them covering the head. K's span goes to shared memory.
int probe_copy_only(const void* q, const void* k, const void* v, void* o, int heads,
                    long long head_units, int span_units, int spans_per_head, void* stream) {
  if (heads < 1 || head_units < 1 || span_units < 1 || span_units > kCopyMaxSpan ||
      spans_per_head < 1 ||
      static_cast<long long>(span_units) * spans_per_head < head_units ||
      static_cast<long long>(span_units) * (spans_per_head - 1) >= head_units ||
      static_cast<long long>(heads) * spans_per_head > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_copy_only_kernel<<<heads * spans_per_head, kCopyThreads, span_units * 16,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k), static_cast<const uint4*>(v),
      static_cast<uint4*>(o), head_units, span_units, spans_per_head);
  return cudaGetLastError();
}

}  // extern "C"
