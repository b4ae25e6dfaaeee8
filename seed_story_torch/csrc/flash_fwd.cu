// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel seed_story_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _flash_fwd). Same contract:
//
//   visible(b, i, j) = j < kv_len[b] && j < Skv && (!causal || j <= q_start[b] + i)
//
// Masked scores never contribute (the contract's -0.7 * FLT_MAX gives them
// weight exactly 0); rows with no visible key output exactly 0 with LSE = -inf.
// The scale multiplies the f32 scores, P is rounded to bf16 before the PV
// product, and the running max / sum / output stay in f32. GQA reads KV head
// h / (Hq / Hkv) without repeating K or V. Inputs are (B, H, S, D) views with
// a unit-stride head dim; outputs O (B, Hq, Sq, D) bf16 contiguous and LSE
// (B, Hq, Sq) f32.
//
// What bounds it on an H100: at the UNet's and the ViT's self-attention
// (Sq = Skv = 1024..4096) the work is 4 * Sq * Skv * d FLOPs per head against
// 2 * (Sq + Skv) * d * 2 bytes, far above the card's 295 FLOP/byte ridge: it is
// bound by the tensor cores and by the softmax between the two products. At
// the cross-attention (Skv = 64) and the resamplers (Sq or Skv = 64..256) the
// ratio is below the ridge and it is bound by reading Q, K, V and writing O.
//
// Design:
// - One block per (128 query rows, head, batch row): two consumer warpgroups
//   of 64 rows each (one warpgroup and 64 rows when Sq <= 64) and one producer
//   warp. 288 threads, at most 224 registers a thread (ptxas: 166 at d = 128,
//   194 with one warpgroup, 159 at d = 64, no spills); one block per SM.
// - TMA: a lane of the producer warp loads Q once and K / V tiles of 128 keys
//   into a ring of three stages, each completing on an mbarrier ("full").
//   The consumers release a stage on a second mbarrier ("empty") and the
//   producer refills it then, so copies run ahead of the math and neither
//   warpgroup waits for the other. Tensor maps are 4-D (d, and the row / head
//   / batch dims sorted by stride), built per call on the host from the
//   caller's strides, with the 128-byte swizzle and 64-column boxes.
//   Out-of-bounds rows and columns read as zero: head dims 80 / 100 / 104 are
//   padded to 128, and ragged Sq / Skv edges filled, in shared memory, with
//   no padded copy in device memory. Shared memory at d = 128: Q 32 KB +
//   3 x (K 32 KB + V 32 KB) = 224 KB of the 227 KB a block may have.
// - S = Q K^T: wgmma m64n128k16, Q and K both from shared memory (K-major),
//   S in registers. The online softmax runs in registers in base 2
//   (ex2.approx): each thread owns two rows of its warp's 16, the row max
//   over the 4 threads of a quad with two shuffles, the row sum kept per
//   thread and reduced once at the end. The mask is applied only on tiles
//   that cross kv_len, Skv or the diagonal; tiles past the last key any row
//   of the block sees are never loaded.
// - O += P V: P converted to bf16 in registers is wgmma's A operand (the
//   accumulator layout of S is the A-fragment layout), V from shared memory as
//   an MN-major B. O is rescaled in registers: S, P and O never touch shared
//   memory inside the loop.
// - Epilogue: O / l staged through the warpgroup's own (swizzled) Q rows and
//   written with 16-byte stores; the LSE from the quad's first thread.
// At d = 64 (the UNet) the exponentials take about as long on the SM as both
// products; overlapping one tile's softmax with the next tile's QK^T (two S
// register sets) and persistent blocks are left for later.

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N = 128;  // keys per K / V tile
constexpr int STAGES = 3;     // depth of the K / V ring
constexpr int BOX_COLS = 64;  // head-dim columns per TMA box: 128 bytes, the swizzle's span
constexpr int ROW_BYTES = BOX_COLS * 2;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const int* q_start;
  const int* kv_len;
  int hq, hkv, sq, skv, d;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int causal;
  // which of (row, head, batch) each tensor-map dim 1..3 of Q, K and V holds
  int perm_q[3], perm_k[3], perm_v[3];
};

// Shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 8 rows of 128 bytes). Each tile is DP / 64
// boxes of (rows x 64 columns); a stage holds K then V.
template <int DP, int NWG>
struct Smem {
  static constexpr int BLOCK_M = 64 * NWG;
  static constexpr int KBOX = DP / BOX_COLS;
  static constexpr int Q_BOX = BLOCK_M * ROW_BYTES;
  static constexpr int KV_BOX = BLOCK_N * ROW_BYTES;
  static constexpr int Q = 0;
  static constexpr int K = Q + KBOX * Q_BOX;
  static constexpr int V_OFF = KBOX * KV_BOX;
  static constexpr int STAGE = 2 * KBOX * KV_BOX;
  static constexpr int BAR = K + STAGES * STAGE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + room to align the base
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int pick(int which, int row, int head, int batch) {
  return which == 0 ? row : (which == 1 ? head : batch);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties registers read or written by in-flight wgmma to the point after the
// wait, so the compiler neither reads them early nor reuses them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(a, i)                                                                          \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]), "+f"(a[i + 5]), \
      "+f"(a[i + 6]), "+f"(a[i + 7])
#define F32(a) F8(a, 0), F8(a, 8), F8(a, 16), F8(a, 24)
#define F64(a) F32(a), F8(a, 32), F8(a, 40), F8(a, 48), F8(a, 56)
#define R32                                                                                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define R64                                                                                   \
  R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D(64 x 128) (+)= A(64 x 16) B(16 x 128)^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64 "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x N) += A(64 x 16, registers) B(16 x N), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<DP, NWG>;
  constexpr int BLOCK_M = L::BLOCK_M;
  constexpr int NT = DP / 8;  // 8-column blocks of the O accumulator
  constexpr uint32_t Q_BYTES = L::KBOX * L::Q_BOX;
  constexpr uint32_t KV_BYTES = L::STAGE;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
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
  const int kv_len = p.kv_len[b];

  // One past the last key any row of this block can see.
  int kv_end = min(kv_len, p.skv);
  if (p.causal) kv_end = min(kv_end, q_start + min(q0 + BLOCK_M, p.sq));
  const int n_tiles = (max(kv_end, 0) + BLOCK_N - 1) / BLOCK_N;

  auto load_kv = [&](int t) {
    const int s = t % STAGES;
    const uint32_t dst = base + L::K + s * L::STAGE;
    const int row = t * BLOCK_N;
    mbar_expect_tx(bar_full + 8 * s, KV_BYTES);
#pragma unroll
    for (int kb = 0; kb < L::KBOX; ++kb) {
      tma_load(dst + kb * L::KV_BOX, &tm_k, bar_full + 8 * s, kb * BOX_COLS,
               pick(p.perm_k[0], row, hk, b), pick(p.perm_k[1], row, hk, b),
               pick(p.perm_k[2], row, hk, b));
      tma_load(dst + L::V_OFF + kb * L::KV_BOX, &tm_v, bar_full + 8 * s, kb * BOX_COLS,
               pick(p.perm_v[0], row, hk, b), pick(p.perm_v[1], row, hk, b),
               pick(p.perm_v[2], row, hk, b));
    }
  };

  if (tid == 0 && n_tiles > 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The producer warp: one lane keeps the ring full, refilling a stage once
  // both warpgroups have released it, so no consumer waits for the other.
  if (warp == 0 && wg == NWG) {
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int kb = 0; kb < L::KBOX; ++kb) {
        tma_load(base + L::Q + kb * L::Q_BOX, &tm_q, bar_q, kb * BOX_COLS,
                 pick(p.perm_q[0], q0, h, b), pick(p.perm_q[1], q0, h, b),
                 pick(p.perm_q[2], q0, h, b));
      }
      for (int t = 0; t < n_tiles; ++t) {
        if (t >= STAGES) mbar_wait(bar_empty + 8 * (t % STAGES), (t / STAGES - 1) & 1);
        load_kv(t);
      }
      // no copy is in flight when the warp exits: the last stages are released
      for (int t = max(n_tiles - STAGES, 0); t < n_tiles; ++t) {
        mbar_wait(bar_empty + 8 * (t % STAGES), (t / STAGES) & 1);
      }
    }
    return;
  }

  // This thread's two rows (within the block): r and r + 8 of its warp's 16.
  const int row_in_block = wg * 64 + warp * 16 + lane / 4;
  int limit[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    limit[r] = min(kv_len, p.skv);
    if (p.causal) limit[r] = min(limit[r], q_start + q0 + row_in_block + 8 * r + 1);
  }
  // The least limit over this warpgroup's rows: tiles below it need no mask.
  int wg_limit = min(kv_len, p.skv);
  if (p.causal) wg_limit = min(wg_limit, q_start + q0 + wg * 64 + 1);

  float o[NT * 4];
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const uint32_t q_smem = base + L::Q + wg * 64 * ROW_BYTES;

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const uint32_t k_smem = base + L::K + s * L::STAGE;
    const uint32_t v_smem = k_smem + L::V_OFF;
    mbar_wait(bar_full + 8 * s, parity);
    __syncwarp();

    // S = Q K^T over the head dim, 16 columns a step.
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row of box kk / 4
      wgmma_ss_n128(sc, make_desc(q_smem + (kk / 4) * L::Q_BOX + col, 16, 1024),
                    make_desc(k_smem + (kk / 4) * L::KV_BOX + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[n * 4 + r * 2 + j] is row r, key k0 + 8 n + 2 (lane % 4) + j.
    const int k0 = t * BLOCK_N;
    if (k0 + BLOCK_N > wg_limit) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (k0 + n * 8 + 2 * (lane % 4) + j >= limit[r]) sc[n * 4 + r * 2 + j] = -INFINITY;
          }
        }
      }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 16; ++n) mx = fmaxf(mx, fmaxf(sc[n * 4 + r * 2], sc[n * 4 + r * 2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * p.scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
      alpha[r] = fast_exp2(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float e = fast_exp2(fmaf(sc[n * 4 + r * 2 + j], p.scale_log2, -m_use));
          sc[n * 4 + r * 2 + j] = e;
          sum += e;
        }
      }
      l[r] = l[r] * alpha[r] + sum;
    }

    // P in bf16 as wgmma A fragments: 16 keys (two 8-key blocks) a step.
    uint32_t pa[32];
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      pa[kb * 4 + 0] = pack_bf16(sc[kb * 8 + 0], sc[kb * 8 + 1]);
      pa[kb * 4 + 1] = pack_bf16(sc[kb * 8 + 2], sc[kb * 8 + 3]);
      pa[kb * 4 + 2] = pack_bf16(sc[kb * 8 + 4], sc[kb * 8 + 5]);
      pa[kb * 4 + 3] = pack_bf16(sc[kb * 8 + 6], sc[kb * 8 + 7]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[n * 4 + r * 2] *= alpha[r];
        o[n * 4 + r * 2 + 1] *= alpha[r];
      }
    }

    // O += P V, 16 keys a step; V rows are 128 bytes, 8-row groups 1024 apart,
    // the second 64 head-dim columns one box further.
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      wgmma_rs(o, &pa[kb * 4], make_desc(v_smem + kb * 16 * ROW_BYTES, L::KV_BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);

    mbar_arrive(bar_empty + 8 * s);
  }

  // Row sums over the quad; LSE; O / l staged in this warpgroup's own Q rows
  // (the swizzled layout TMA gave them), then 16-byte stores.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  const long long out_row0 = (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_in_block + 8 * r;
      if (q0 + row < p.sq) {
        p.lse[out_row0 + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : -INFINITY;
      }
    }
  }
  unsigned char* stage_o = smem + L::Q;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_in_block + 8 * r;
      const int byte = (n / 8) * L::Q_BOX + row * ROW_BYTES + (((n % 8) ^ (row % 8)) * 16) +
                       4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(stage_o + byte) =
          pack_bf16(o[n * 4 + r * 2] * inv[r], o[n * 4 + r * 2 + 1] * inv[r]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
  for (int idx = tid % 128; idx < 64 * NT; idx += 128) {
    const int row = wg * 64 + idx / NT;
    const int chunk = idx % NT;
    const int col = chunk * 8;
    if (q0 + row >= p.sq || col >= p.d) continue;
    const unsigned char* src =
        stage_o + (chunk / 8) * L::Q_BOX + row * ROW_BYTES + (((chunk % 8) ^ (row % 8)) * 16);
    __nv_bfloat16* dst = p.o + (out_row0 + row) * p.d + col;
    if (p.d % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int c = 0; c < 8 && col + c < p.d; ++c) dst[c] = e[c];
    }
  }
}

template <int DP, int NWG>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = Smem<DP, NWG>::BYTES;
  static unsigned long long configured = 0;  // a bit per device: the attribute is set
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !(configured >> device & 1)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (device < 64) configured |= 1ull << device;
  }
  const dim3 grid((p.sq + 64 * NWG - 1) / (64 * NWG), p.hq, batch);
  flash_fwd_kernel<DP, NWG><<<grid, 128 * NWG + 32, bytes, stream>>>(q, k, v, p);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-D map of a (B, H, S, cols) bf16 view (strides in elements, unit-stride
// columns): dim 0 the columns in boxes of 64, dims 1..3 (S, H, B) sorted by
// stride, the S box `rows` long. A dim of size 1 gets a stride past the
// tensor's extent. perm[i] says which of (S, H, B) dim i + 1 is.
CUresult encode_map(CUtensorMap* map, const void* ptr, int cols, int s, int h, int b,
                    long long ss, long long sh, long long sb, int rows, int perm[3]) {
  struct Dim {
    unsigned long long size, stride;
    int which;
  } dims[3] = {{static_cast<unsigned long long>(s), static_cast<unsigned long long>(ss) * 2, 0},
               {static_cast<unsigned long long>(h), static_cast<unsigned long long>(sh) * 2, 1},
               {static_cast<unsigned long long>(b), static_cast<unsigned long long>(sb) * 2, 2}};
  unsigned long long extent = static_cast<unsigned long long>(cols) * 2;
  for (auto& dim : dims) {
    if (dim.size > 1 && dim.stride * dim.size > extent) extent = dim.stride * dim.size;
  }
  extent = (extent + 15) / 16 * 16;
  for (auto& dim : dims) {
    if (dim.size == 1) dim.stride = extent;
  }
  for (int i = 1; i < 3; ++i) {  // insertion sort by stride, stable
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim tmp = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = tmp;
    }
  }
  const cuuint64_t gdim[4] = {static_cast<cuuint64_t>(cols), dims[0].size, dims[1].size,
                              dims[2].size};
  const cuuint64_t gstride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  cuuint32_t box[4] = {BOX_COLS, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    perm[i] = dims[i].which;
    if (dims[i].which == 0) box[i + 1] = rows;
  }
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
                   gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns 0, a CUDA error code, or
// 1000 + cuTensorMapEncodeTiled's CUresult when a tensor map cannot describe
// an input.
// d is the head dim of O; d_in the column count of the q / k / v views
// (d, or d rounded up to 8 for the wrapper's aligned copies). Every base must
// be 16-byte aligned and every stride a multiple of 8 elements.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* q_start, const void* kv_len, int batch, int hq, int hkv,
                              int sq, int skv, int d, int d_in, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, float scale,
                              int causal, void* stream) {
  if (d <= 0 || d_in < d || d_in > 128 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int nwg = sq <= 64 ? 1 : 2;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_start = static_cast<const int*>(q_start);
  p.kv_len = static_cast<const int*>(kv_len);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map(&tq, q, d_in, sq, hq, batch, q_ss, q_sh, q_sb, 64 * nwg, p.perm_q);
  if (r == CUDA_SUCCESS) {
    r = encode_map(&tk, k, d_in, skv, hkv, batch, k_ss, k_sh, k_sb, BLOCK_N, p.perm_k);
  }
  if (r == CUDA_SUCCESS) {
    r = encode_map(&tv, v, d_in, skv, hkv, batch, v_ss, v_sh, v_sb, BLOCK_N, p.perm_v);
  }
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d_in <= 64) {
    err = nwg == 1 ? launch<64, 1>(tq, tk, tv, p, batch, s) : launch<64, 2>(tq, tk, tv, p, batch, s);
  } else {
    err = nwg == 1 ? launch<128, 1>(tq, tk, tv, p, batch, s)
                   : launch<128, 2>(tq, tk, tv, p, batch, s);
  }
  return static_cast<int>(err);
}
