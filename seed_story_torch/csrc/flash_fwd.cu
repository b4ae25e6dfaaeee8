// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel seed_story_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _flash_fwd). Same contract:
//
//   visible(b, i, j) = j < kv_len[b] && j < Skv && (!causal || j <= q_start[b] + i)
//                      && (!window || j > q_start[b] + i - window)
//
// (a window, under causal only, is a windowed layer of a model that mixes
// windowed and global layers: K-EXAONE's prefill at window 128).
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
//   that cross kv_len, Skv or the diagonal (or a row's window start); tiles
//   past the last key any row of the block sees, and with a window the tiles
//   wholly before the first key any row of it sees, are never loaded: the
//   producer and the consumers walk the same run of tiles, from the tile
//   that holds the block's first row's window start.
// - O += P V: P converted to bf16 in registers is wgmma's A operand (the
//   accumulator layout of S is the A-fragment layout), V from shared memory as
//   an MN-major B. O is rescaled in registers: S, P and O never touch shared
//   memory inside the loop.
// - Epilogue: O / l staged through the warpgroup's own (swizzled) Q rows and
//   written with 16-byte stores; the LSE from the quad's first thread.
// At d = 64 (the UNet) the exponentials take about as long on the SM as both
// products; overlapping one tile's softmax with the next tile's QK^T (two S
// register sets) and persistent blocks are left for later.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BLOCK_N = 128;  // keys per K / V tile
constexpr int STAGES = 3;     // depth of the K / V ring

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const int* q_start;
  const int* kv_len;
  int hq, hkv, sq, skv, d;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int causal;
  int window;  // 0: none
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
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
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
  const int t_end = (max(kv_end, 0) + BLOCK_N - 1) / BLOCK_N;
  // The first tile any row of this block sees: its first row's window start.
  const int t_first = p.window > 0 ? min(t_end, max(0, q_start + q0 + 1 - p.window) / BLOCK_N) : 0;
  const int n_tiles = t_end - t_first;  // the ring's stages count from t_first

  auto load_kv = [&](int t) {  // the n-th tile of the run into stage n % STAGES
    const int s = t % STAGES;
    const uint32_t dst = base + L::K + s * L::STAGE;
    mbar_expect_tx(bar_full + 8 * s, KV_BYTES);
    tma_load_tile(dst, &tm_k, bar_full + 8 * s, p.perm_k, L::KBOX, L::KV_BOX,
                  (t_first + t) * BLOCK_N, hk, b);
    tma_load_tile(dst + L::V_OFF, &tm_v, bar_full + 8 * s, p.perm_v, L::KBOX, L::KV_BOX,
                  (t_first + t) * BLOCK_N, hk, b);
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
      tma_load_tile(base + L::Q, &tm_q, bar_q, p.perm_q, L::KBOX, L::Q_BOX, q0, h, b);
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
  int limit[2], lower[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    limit[r] = min(kv_len, p.skv);
    if (p.causal) limit[r] = min(limit[r], q_start + q0 + row_in_block + 8 * r + 1);
    lower[r] = p.window > 0 ? q_start + q0 + row_in_block + 8 * r + 1 - p.window : 0;
  }
  // The least limit over this warpgroup's rows: tiles below it need no mask;
  // with a window, nor do tiles from its rows' last window start on.
  int wg_limit = min(kv_len, p.skv);
  if (p.causal) wg_limit = min(wg_limit, q_start + q0 + wg * 64 + 1);
  const int wg_lower = p.window > 0 ? q_start + q0 + wg * 64 + 64 - p.window : 0;

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
      wgmma_ss(sc, make_desc(q_smem + (kk / 4) * L::Q_BOX + col, 16, 1024),
               make_desc(k_smem + (kk / 4) * L::KV_BOX + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[n * 4 + r * 2 + j] is row r, key k0 + 8 n + 2 (lane % 4) + j.
    const int k0 = (t_first + t) * BLOCK_N;
    if (k0 + BLOCK_N > wg_limit || k0 < wg_lower) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int key = k0 + n * 8 + 2 * (lane % 4) + j;
            if (key >= limit[r] || key < lower[r]) sc[n * 4 + r * 2 + j] = -INFINITY;
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
    pack_a(sc, pa);
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
  stage_rows<NT>(stage_o, L::Q_BOX, o, inv, row_in_block, lane);
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
  store_rows<NT>(stage_o, L::Q_BOX, wg * 64, p.o + out_row0 * p.d, p.sq - q0, p.d, tid % 128);
}

template <int DP, int NWG>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = Smem<DP, NWG>::BYTES;
  static unsigned long long configured = 0;
  const cudaError_t err = allow_smem(flash_fwd_kernel<DP, NWG>, bytes, configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + 64 * NWG - 1) / (64 * NWG), p.hq, batch);
  flash_fwd_kernel<DP, NWG><<<grid, 128 * NWG + 32, bytes, stream>>>(q, k, v, p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns 0, a CUDA error code, or
// 1000 + cuTensorMapEncodeTiled's CUresult when a tensor map cannot describe
// an input. window: 0 for none, else (under causal) the keys a query sees
// ending at its own position.
// d is the head dim of O; d_in the column count of the q / k / v views
// (d, or d rounded up to 8 for the wrapper's aligned copies). Every base must
// be 16-byte aligned and every stride a multiple of 8 elements.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* q_start, const void* kv_len, int batch, int hq, int hkv,
                              int sq, int skv, int d, int d_in, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, float scale,
                              int causal, int window, void* stream) {
  if (d <= 0 || d_in < d || d_in > 128 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      !(scale > 0.f) || window < 0 || (window > 0 && !causal)) {
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
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  p.window = window;
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
