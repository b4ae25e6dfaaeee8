// The attention probes' kernels for Hopper (sm_90a): the counterparts of
// the six Pallas kernels of benchmarks/probe_attn_variants.py,
// probe_attn_overhead.py and probe_attn_dma.py. They split an attention
// kernel's time into its parts: the exponentials, one program per head, the
// traffic of attention's I/O. Plain versions:
// seed_story_torch/benchmarks/probe_kernels.py; launch plans of the single
// pass and the copy: single_pass_plan and copy_plan there.
//
// Inputs are contiguous bf16 (B, H, S, 64) q, k, v (the packed layout:
// (B, H/2, S, 128), head i of a pair at columns 64 i); outputs bf16 in the
// same layout. Scores and sums are f32; P is rounded to bf16 before PV.
//
// Three templates:
// - probe_attn_online_kernel<Variant, BQ, BKV> replaces `attn`
//   (probe_attn_variants.py:77, body make_kernel :23): full-mask online
//   softmax. Grid (S / BQ, H, B); BQ / 16 warps, each owning 16 query rows
//   whose Q stays in registers as mma A fragments. K and V tiles of BKV
//   keys come through a two-stage cp.async double buffer in shared memory
//   (rows padded to 72 bf16, so fragment reads are free of bank
//   conflicts). S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> f32;
//   S, the running max and sum and O stay in registers, and the S
//   accumulators are P's A fragments. V's B fragments come from
//   ldmatrix.trans. Variants: base = __expf (a multiply by log2 e and
//   ex2.approx), exp2 = the scale times log2 e folded into one FFMA before
//   ex2.approx, noexp = P = scale * S with no max, no MUFU and alpha = 1.
//   The TPU's 256-1024-row blocks do not fit a block's registers; BQ and
//   BKV are 64 or 128. Simple and correct first; not yet redesigned.
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
// a clock an SM): the exp floor equals the operations' bound at d = 64, so
// the two warpgroups of a block take turns, one's exponentials beside the
// other's products. The single pass does 6 S^2 d operations a head (Q K^T
// twice), so its best is 1.5 x the bound. The copy is bound by bytes (3.35
// TB/s): enough blocks and bytes in flight on every SM is what its design
// is for.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;         // head dim
constexpr int kRow = kD + 8;   // a K / V row in shared memory, padded (144 bytes)
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kBase = 0, kExp2 = 1, kNoExp = 2 };

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i; lane (g, t) = (lane / 4, lane % 4) receives
// elements (2 t, g) and (2 t + 1, g) of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of 16 query rows (row0 .. row0 + 15, row stride `stride`),
// all four 16-wide steps of d = 64: a0..a3 = (g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8) of each step.
__device__ __forceinline__ void load_q(uint32_t (&qa)[4][4], const __nv_bfloat16* q, int stride,
                                       int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = 16 * ks + 2 * t;
    qa[ks][0] = ld32(q + g * stride + c);
    qa[ks][1] = ld32(q + (g + 8) * stride + c);
    qa[ks][2] = ld32(q + g * stride + c + 8);
    qa[ks][3] = ld32(q + (g + 8) * stride + c + 8);
  }
}

// `rows` rows of 64 bf16 (global row stride `stride`) into shared memory
// at `dst` (row stride kRow), 16 bytes a thread and step.
template <int kThreads>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int stride,
                                          int rows) {
  for (int c = threadIdx.x; c < rows * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    cp_async16(dst + (r * kRow + col) * 2, src + static_cast<size_t>(r) * stride + col);
  }
}

// S = Q K^T for the 16 query rows of a warp against kKeys keys of a K
// tile in shared memory: n-tile n covers keys 8 n .. 8 n + 7; accumulator
// c0, c1 = (row g, keys 8 n + 2t, + 1), c2, c3 = row g + 8.
template <int kKeys>
__device__ __forceinline__ void scores(float (&sc)[kKeys / 8][4], const uint32_t (&qa)[4][4],
                                       const __nv_bfloat16* ks, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const __nv_bfloat16* krow = ks + (8 * n + g) * kRow + 2 * t;
#pragma unroll
    for (int kstep = 0; kstep < 4; ++kstep) {
      mma_bf16(sc[n], qa[kstep], ld32(krow + 16 * kstep), ld32(krow + 16 * kstep + 8));
    }
  }
}

// O += P V: P's A fragments are the score accumulators of n-tiles 2 kk and
// 2 kk + 1, V's B fragments come by ldmatrix.trans from the V tile.
template <int kKeys>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4], const float (&p)[kKeys / 8][4],
                                   uint32_t vs, int lane) {
  const int mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int key = 16 * kk + (mat & 1) * 8 + r;
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (key * kRow + 16 * np + (mat >> 1) * 8) * 2);
      mma_bf16(o[2 * np], pa, b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// O / l of a warp's 16 rows to bf16 at `out` (row stride `stride`); l is
// each thread's partial sum of its row (g or g + 8), summed over the quad.
__device__ __forceinline__ void store_o(__nv_bfloat16* out, int stride, const float (&o)[kD / 8][4],
                                        float l_g, float l_g8, int lane) {
  const int g = lane / 4, t = lane % 4;
  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  const float inv_g = 1.f / (l_g == 0.f ? 1.f : l_g);
  const float inv_g8 = 1.f / (l_g8 == 0.f ? 1.f : l_g8);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(out + g * stride + c) =
        pack_bf16(o[n][0] * inv_g, o[n][1] * inv_g);
    *reinterpret_cast<uint32_t*>(out + (g + 8) * stride + c) =
        pack_bf16(o[n][2] * inv_g8, o[n][3] * inv_g8);
  }
}

template <int kVariant, int kBQ, int kBKV>
__global__ void __launch_bounds__(kBQ * 2) probe_attn_online_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int s, float scale) {
  constexpr int kThreads = kBQ * 2;  // a warp per 16 query rows
  constexpr int kTile = kBKV * kRow;  // bf16 elements of one K or V tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [stage][K, V][kBKV][kRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kh = k + head * s * kD;
  const __nv_bfloat16* vh = v + head * s * kD;
  const int row0 = blockIdx.x * kBQ + warp * 16;
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  auto load_tile = [&](int j) {  // K and V of key tile j into stage j % 2
    const uint32_t st = smem_s + (j & 1) * 2 * kTile * 2;
    copy_rows<kThreads>(st, kh + static_cast<size_t>(j) * kBKV * kD, kD, kBKV);
    copy_rows<kThreads>(st + kTile * 2, vh + static_cast<size_t>(j) * kBKV * kD, kD, kBKV);
  };

  const int n_tiles = s / kBKV;
  load_tile(0);
  cp_async_commit();
  uint32_t qa[4][4];
  load_q(qa, q + (head * s + row0) * kD, kD, lane);

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_g = -INFINITY, m_g8 = -INFINITY, l_g = 0.f, l_g8 = 0.f;
  const float sc2 = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = smem + (j & 1) * 2 * kTile;
    float sc[kBKV / 8][4];
    scores<kBKV>(sc, qa, ks, lane);

    if constexpr (kVariant == kNoExp) {  // P = scale * S: no max, no exponential
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] *= scale;
        l_g += sc[n][0] + sc[n][1];
        l_g8 += sc[n][2] + sc[n][3];
      }
    } else {
      float mx_g = -INFINITY, mx_g8 = -INFINITY;
      if constexpr (kVariant == kBase) {
#pragma unroll
        for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] *= scale;
        }
      }
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
        mx_g = fmaxf(mx_g, fmaxf(sc[n][0], sc[n][1]));
        mx_g8 = fmaxf(mx_g8, fmaxf(sc[n][2], sc[n][3]));
      }
      // base: the max of scale * S; exp2: of raw S, in log2 units after the fold
      const float f = kVariant == kExp2 ? sc2 : 1.f;
      const float mn_g = fmaxf(m_g, quad_max(mx_g) * f);
      const float mn_g8 = fmaxf(m_g8, quad_max(mx_g8) * f);
      float al_g, al_g8;
      if constexpr (kVariant == kBase) {
        al_g = __expf(m_g - mn_g);
        al_g8 = __expf(m_g8 - mn_g8);
      } else {
        al_g = ex2(m_g - mn_g);
        al_g8 = ex2(m_g8 - mn_g8);
      }
      m_g = mn_g;
      m_g8 = mn_g8;
      float ps_g = 0.f, ps_g8 = 0.f;
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kVariant == kBase) {
            sc[n][e] = __expf(sc[n][e] - mn_g);
            sc[n][2 + e] = __expf(sc[n][2 + e] - mn_g8);
          } else {
            sc[n][e] = ex2(fmaf(sc[n][e], sc2, -mn_g));
            sc[n][2 + e] = ex2(fmaf(sc[n][2 + e], sc2, -mn_g8));
          }
          ps_g += sc[n][e];
          ps_g8 += sc[n][2 + e];
        }
      }
      l_g = l_g * al_g + ps_g;
      l_g8 = l_g8 * al_g8 + ps_g8;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc[n][0] *= al_g;
        acc[n][1] *= al_g;
        acc[n][2] *= al_g8;
        acc[n][3] *= al_g8;
      }
    }
    pv<kBKV>(acc, sc, smem_s + ((j & 1) * 2 * kTile + kTile) * 2, lane);
    __syncthreads();  // the next iteration refills this stage
  }
  store_o(o + (head * s + row0) * kD, kD, acc, l_g, l_g8, lane);
}

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

template <int kVariant, int kBQ, int kBKV>
cudaError_t launch_online(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                          __nv_bfloat16* o, int b, int h, int s, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * 2 * kBKV * kRow * 2;
  auto kernel = probe_attn_online_kernel<kVariant, kBQ, kBKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s / kBQ, h, b), kBQ * 2, smem, stream>>>(q, k, v, o, s, scale);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch_variant(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                           __nv_bfloat16* o, int b, int h, int s, int block_q, int block_kv,
                           float scale, cudaStream_t stream) {
  if (block_q == 128 && block_kv == 128)
    return launch_online<kVariant, 128, 128>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 128 && block_kv == 64)
    return launch_online<kVariant, 128, 64>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 64 && block_kv == 128)
    return launch_online<kVariant, 64, 128>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 64 && block_kv == 64)
    return launch_online<kVariant, 64, 64>(q, k, v, o, b, h, s, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Full-mask attention, one of the three variants (0 base, 1 exp2, 2 noexp),
// tiles (block_q, block_kv) in {64, 128}^2; s a multiple of both.
int probe_attn(const void* q, const void* k, const void* v, void* o, int b, int h, int s,
               int variant, int block_q, int block_kv, float scale, void* stream) {
  if (s % block_q || s % block_kv) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return launch_variant<kBase>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    case kExp2: return launch_variant<kExp2>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    case kNoExp:
      return launch_variant<kNoExp>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    default: return cudaErrorInvalidValue;
  }
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
