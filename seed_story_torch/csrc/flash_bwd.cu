// Flash-attention backward for Hopper (sm_90a), bf16 in, f32 accumulate: two
// kernels, dq and dk/dv.
//
// Replaces the TPU kernels seed_story_tpu/ops/attention.py::_flash_bwd_dq_kernel
// and ::_flash_bwd_dkv_kernel (both launched by _flash_bwd). Same contract as
// the forward (flash_fwd.cu):
//
//   visible(b, i, j) = i < Sq && j < min(kv_len[b], Skv) && (!causal || j <= q_start[b] + i)
//   P  = exp(scale * Q K^T - LSE)  on visible entries, 0 elsewhere
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)  (f32, from the caller)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// The scale multiplies the f32 scores; scores, P, dP and the accumulators are
// f32; P is rounded to bf16 before P^T dO and dS before dS K and dS^T Q, as the
// TPU kernels round them. Masked entries are selected to 0 before any product,
// so rows with LSE = -inf (no visible key) give exactly zero gradient and no
// inf * 0. Outputs dQ (B, Hq, Sq, D), dK and dV (B, Hkv, Skv, D) are bf16
// contiguous; inputs take (batch, head, seq) strides with a unit-stride head
// dim. LSE and delta are (B, Hq, Sq) f32 contiguous.
//
// What bounds it on an H100: the backward does 2.5x the forward's matrix work
// (five products per tile against two) and recomputes P, so at the LLaMA's
// S=1280, d=128 and the UNet's S=4096, d=64 it is bound by the tensor cores and
// by the elementwise pass between the products, not by bytes. The resamplers'
// short blocks (64 or 256 rows against 64..256 keys) are bound by loading each
// tile once per block.
//
// Design (simple wmma first; wgmma, TMA and pipelining come later):
// - dq: one block of 4 warps per (64-row query tile, q-head, batch row). Q and
//   dO stay in shared memory; K and V tiles of 64 keys are staged one after
//   the other, only up to kv_len and the causal diagonal. Each warp owns 16
//   query rows and keeps their dQ accumulators in registers.
// - dk/dv: one block per (64-key tile, kv-head, batch row). K and V stay in
//   shared memory; the block loops over the GQA group's q-heads and over the
//   query tiles from the first row that can see the tile's first key, so the
//   group sum happens in the f32 accumulators: no (B, Hq, Skv, D) temporaries
//   and no atomics. Each warp owns 16 keys and keeps their dK and dV
//   accumulators in registers. A tile past kv_len writes zeros.
// Head dims up to 128 pad to 64 or 128 with zeros in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BLOCK = 64;  // query rows and keys per tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int WARP_ROWS = BLOCK / NUM_WARPS;  // 16 rows per warp

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* q_start;
  const int* kv_len;
  int hq, hkv, sq, skv, d;
  long long q_sb, q_sh, q_ss;  // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  float scale;
  int causal;
  int vec;  // 1 when every pointer is 16-byte aligned and every stride a multiple of 8
};

// Shared memory for head dims padded to DP: four bf16 tiles (two resident,
// two streamed), two f32 64x64 score tiles, two bf16 64x64 probability tiles
// and the 64 rows' LSE and delta. The f32 output staging at the end reuses
// the two score tiles. Every region starts on a 128-byte boundary and every
// 16-row fragment on a 32-byte one, as wmma::load_matrix_sync requires.
template <int DP>
struct Layout {
  static constexpr int LD_T = DP + 8;     // bf16 tiles
  static constexpr int LD_S = BLOCK + 4;  // f32 scores
  static constexpr int LD_P = BLOCK + 8;  // bf16 probabilities
  static constexpr int LD_O = DP + 4;     // f32 output staging
  static constexpr int T0 = 0;
  static constexpr int T1 = T0 + BLOCK * LD_T * 2;
  static constexpr int T2 = T1 + BLOCK * LD_T * 2;
  static constexpr int T3 = T2 + BLOCK * LD_T * 2;
  static constexpr int S = T3 + BLOCK * LD_T * 2;
  static constexpr int DPS = S + BLOCK * LD_S * 4;
  static constexpr int P = DPS + BLOCK * LD_S * 4;
  static constexpr int DS = P + BLOCK * LD_P * 2;
  static constexpr int STATS = DS + BLOCK * LD_P * 2;
  static constexpr int BYTES = STATS + 2 * BLOCK * 4;
  static_assert(BLOCK * LD_O * 4 <= 2 * BLOCK * LD_S * 4, "staging must fit the score tiles");
};

template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int rows_valid, int d, int vec) {
  flash::load_tile<DP, BLOCK, NUM_THREADS>(dst, src, stride, rows_valid, d, vec);
}

// Loads LSE and delta of query rows q0 .. q0 + 63 of head h (0 past Sq).
__device__ __forceinline__ void load_row_stats(const Params& p, int b, int h, int q0,
                                               float* lse_s, float* delta_s) {
  if (threadIdx.x < BLOCK) {
    const int i = q0 + threadIdx.x;
    const long long row = ((long long)b * p.hq + h) * p.sq + i;
    lse_s[threadIdx.x] = i < p.sq ? p.lse[row] : 0.f;
    delta_s[threadIdx.x] = i < p.sq ? p.delta[row] : 0.f;
  }
}

// acc (16 rows x DP, this warp's) * scale -> bf16 rows of `out` (row pitch d),
// staged through shared memory; rows at or past n_rows are not written.
template <int DP>
__device__ __forceinline__ void write_rows(FragC (&acc)[DP / 16], float* stage, bf16* out,
                                           int n_rows, int d, float scale) {
  using L = Layout<DP>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int db = 0; db < DP / 16; ++db) {
    wmma::store_matrix_sync(stage + db * 16, acc[db], L::LD_O, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < WARP_ROWS && r < n_rows; ++r) {
    for (int c = lane; c < d; c += 32) {
      out[(long long)r * d + c] = __float2bfloat16(stage[r * L::LD_O + c] * scale);
    }
  }
  __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const Params p) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::T3);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  float* dp_s = reinterpret_cast<float*>(smem + L::DPS);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::STATS);
  float* delta_s = lse_s + BLOCK;

  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * WARP_ROWS;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = p.q_start[b];
  const int kv_lim = min(p.kv_len[b], p.skv);

  const int q_rows = min(BLOCK, p.sq - q0);
  load_tile<DP>(q_s, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss, q_rows, p.d, p.vec);
  load_tile<DP>(do_s, p.dout + b * p.do_sb + h * p.do_sh + q0 * p.do_ss, p.do_ss, q_rows, p.d,
                p.vec);
  load_row_stats(p, b, h, q0, lse_s, delta_s);
  const bf16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  // One past the last key any row of this block can see.
  int kv_end = kv_lim;
  if (p.causal) kv_end = min(kv_end, q_start + q0 + q_rows);
  kv_end = max(kv_end, 0);
  const int n_tiles = (kv_end + BLOCK - 1) / BLOCK;

  FragC dq_frag[DP / 16];
#pragma unroll
  for (int db = 0; db < DP / 16; ++db) wmma::fill_fragment(dq_frag[db], 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK;
    __syncthreads();  // the previous tile is consumed; Q, dO and the stats are visible
    load_tile<DP>(k_s, kg + k0 * p.k_ss, p.k_ss, min(BLOCK, p.skv - k0), p.d, p.vec);
    load_tile<DP>(v_s, vg + k0 * p.v_ss, p.v_ss, min(BLOCK, p.skv - k0), p.d, p.vec);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows.
#pragma unroll
    for (int nb = 0; nb < BLOCK / 16; ++nb) {
      FragC s_frag, dp_frag;
      wmma::fill_fragment(s_frag, 0.f);
      wmma::fill_fragment(dp_frag, 0.f);
#pragma unroll
      for (int kb = 0; kb < DP / 16; ++kb) {
        FragA a;
        FragBc bt;
        wmma::load_matrix_sync(a, q_s + row0 * L::LD_T + kb * 16, L::LD_T);
        wmma::load_matrix_sync(bt, k_s + nb * 16 * L::LD_T + kb * 16, L::LD_T);
        wmma::mma_sync(s_frag, a, bt, s_frag);
        wmma::load_matrix_sync(a, do_s + row0 * L::LD_T + kb * 16, L::LD_T);
        wmma::load_matrix_sync(bt, v_s + nb * 16 * L::LD_T + kb * 16, L::LD_T);
        wmma::mma_sync(dp_frag, a, bt, dp_frag);
      }
      wmma::store_matrix_sync(s_s + row0 * L::LD_S + nb * 16, s_frag, L::LD_S, wmma::mem_row_major);
      wmma::store_matrix_sync(dp_s + row0 * L::LD_S + nb * 16, dp_frag, L::LD_S, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P * (dP - delta) in f32, rounded to bf16; two keys per lane.
    for (int r = 0; r < WARP_ROWS; ++r) {
      const int row = row0 + r;
      const int i = q0 + row;
      int limit = i < p.sq ? kv_lim : 0;
      if (p.causal) limit = min(limit, q_start + i + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float pv =
            k0 + c < limit ? expf(s_s[row * L::LD_S + c] * p.scale - lse_s[row]) : 0.f;
        ds_s[row * L::LD_P + c] = __float2bfloat16(pv * (dp_s[row * L::LD_S + c] - delta_s[row]));
      }
    }
    __syncwarp();

    // dQ += dS K.
#pragma unroll
    for (int db = 0; db < DP / 16; ++db) {
#pragma unroll
      for (int kb = 0; kb < BLOCK / 16; ++kb) {
        FragA a;
        FragBr bk;
        wmma::load_matrix_sync(a, ds_s + row0 * L::LD_P + kb * 16, L::LD_P);
        wmma::load_matrix_sync(bk, k_s + kb * 16 * L::LD_T + db * 16, L::LD_T);
        wmma::mma_sync(dq_frag[db], a, bk, dq_frag[db]);
      }
    }
  }
  __syncthreads();  // every warp is done with the score tiles the staging reuses

  const long long out_row = ((long long)b * p.hq + h) * p.sq + q0 + row0;
  write_rows<DP>(dq_frag, s_s + row0 * L::LD_O, p.dq + out_row * p.d, q_rows - row0, p.d, p.scale);
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const Params p) {
  using L = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::T0);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::T1);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::T2);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::T3);
  float* s_s = reinterpret_cast<float*>(smem + L::S);  // S^T: keys x queries
  float* dp_s = reinterpret_cast<float*>(smem + L::DPS);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L::P);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::STATS);
  float* delta_s = lse_s + BLOCK;

  const int k0 = blockIdx.x * BLOCK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * WARP_ROWS;
  const int group = p.hq / p.hkv;
  const int q_start = p.q_start[b];
  const int kv_lim = min(p.kv_len[b], p.skv);

  const int k_rows = min(BLOCK, p.skv - k0);
  load_tile<DP>(k_s, p.k + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss, p.k_ss, k_rows, p.d, p.vec);
  load_tile<DP>(v_s, p.v + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss, p.v_ss, k_rows, p.d, p.vec);

  // Query rows before q_start + i >= k0 see none of this tile's keys: start at
  // the tile holding the first row that sees key k0. A tile past kv_len has no
  // visible key at all.
  const int n_q_tiles = (p.sq + BLOCK - 1) / BLOCK;
  int t_first = p.causal ? max(0, k0 - q_start) / BLOCK : 0;
  if (k0 >= kv_lim) t_first = n_q_tiles;

  FragC dk_frag[DP / 16], dv_frag[DP / 16];
#pragma unroll
  for (int db = 0; db < DP / 16; ++db) {
    wmma::fill_fragment(dk_frag[db], 0.f);
    wmma::fill_fragment(dv_frag[db], 0.f);
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int t = t_first; t < n_q_tiles; ++t) {
      const int q0 = t * BLOCK;
      const int q_rows = min(BLOCK, p.sq - q0);
      __syncthreads();  // the previous query tile is consumed; K and V are visible
      load_tile<DP>(q_s, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss, q_rows, p.d, p.vec);
      load_tile<DP>(do_s, p.dout + b * p.do_sb + h * p.do_sh + q0 * p.do_ss, p.do_ss, q_rows,
                    p.d, p.vec);
      load_row_stats(p, b, h, q0, lse_s, delta_s);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys.
#pragma unroll
      for (int nb = 0; nb < BLOCK / 16; ++nb) {
        FragC s_frag, dp_frag;
        wmma::fill_fragment(s_frag, 0.f);
        wmma::fill_fragment(dp_frag, 0.f);
#pragma unroll
        for (int kb = 0; kb < DP / 16; ++kb) {
          FragA a;
          FragBc bt;
          wmma::load_matrix_sync(a, k_s + row0 * L::LD_T + kb * 16, L::LD_T);
          wmma::load_matrix_sync(bt, q_s + nb * 16 * L::LD_T + kb * 16, L::LD_T);
          wmma::mma_sync(s_frag, a, bt, s_frag);
          wmma::load_matrix_sync(a, v_s + row0 * L::LD_T + kb * 16, L::LD_T);
          wmma::load_matrix_sync(bt, do_s + nb * 16 * L::LD_T + kb * 16, L::LD_T);
          wmma::mma_sync(dp_frag, a, bt, dp_frag);
        }
        wmma::store_matrix_sync(s_s + row0 * L::LD_S + nb * 16, s_frag, L::LD_S, wmma::mem_row_major);
        wmma::store_matrix_sync(dp_s + row0 * L::LD_S + nb * 16, dp_frag, L::LD_S,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // P^T and dS^T = P^T * (dP^T - delta), both rounded to bf16; two queries per lane.
      for (int r = 0; r < WARP_ROWS; ++r) {
        const int row = row0 + r;
        const int j = k0 + row;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int i = q0 + c;
          const bool vis = j < kv_lim && i < p.sq && (!p.causal || j <= q_start + i);
          const float pv = vis ? expf(s_s[row * L::LD_S + c] * p.scale - lse_s[c]) : 0.f;
          p_s[row * L::LD_P + c] = __float2bfloat16(pv);
          ds_s[row * L::LD_P + c] = __float2bfloat16(pv * (dp_s[row * L::LD_S + c] - delta_s[c]));
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q.
#pragma unroll
      for (int db = 0; db < DP / 16; ++db) {
#pragma unroll
        for (int kb = 0; kb < BLOCK / 16; ++kb) {
          FragA a;
          FragBr bm;
          wmma::load_matrix_sync(a, p_s + row0 * L::LD_P + kb * 16, L::LD_P);
          wmma::load_matrix_sync(bm, do_s + kb * 16 * L::LD_T + db * 16, L::LD_T);
          wmma::mma_sync(dv_frag[db], a, bm, dv_frag[db]);
          wmma::load_matrix_sync(a, ds_s + row0 * L::LD_P + kb * 16, L::LD_P);
          wmma::load_matrix_sync(bm, q_s + kb * 16 * L::LD_T + db * 16, L::LD_T);
          wmma::mma_sync(dk_frag[db], a, bm, dk_frag[db]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the score tiles the staging reuses

  const long long out_row = ((long long)b * p.hkv + hk) * p.skv + k0 + row0;
  float* stage = s_s + row0 * L::LD_O;
  write_rows<DP>(dk_frag, stage, p.dk + out_row * p.d, k_rows - row0, p.d, p.scale);
  write_rows<DP>(dv_frag, stage, p.dv + out_row * p.d, k_rows - row0, p.d, 1.f);
}

template <int DP>
cudaError_t launch(const Params& p, int batch, bool dq, cudaStream_t stream) {
  constexpr int bytes = Layout<DP>::BYTES;
  auto kernel = dq ? flash_bwd_dq_kernel<DP> : flash_bwd_dkv_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int rows = dq ? p.sq : p.skv;
  const dim3 grid((rows + BLOCK - 1) / BLOCK, dq ? p.hq : p.hkv, batch);
  kernel<<<grid, NUM_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dq_out, void* dk_out, void* dv_out, const void* q_start,
        const void* kv_len, int batch, int hq, int hkv, int sq, int skv, int d, long long q_sb,
        long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
        long long v_sb, long long v_sh, long long v_ss, long long do_sb, long long do_sh,
        long long do_ss, float scale, int causal, int vec, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq_out);
  p.dk = static_cast<bf16*>(dk_out);
  p.dv = static_cast<bf16*>(dv_out);
  p.q_start = static_cast<const int*>(q_start);
  p.kv_len = static_cast<const int*>(kv_len);
  p.hq = hq;
  p.hkv = hkv;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.do_sb = do_sb;
  p.do_sh = do_sh;
  p.do_ss = do_ss;
  p.scale = scale;
  p.causal = causal;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return static_cast<int>(launch<64>(p, batch, dq, s));
  if (d <= 128) return static_cast<int>(launch<128>(p, batch, dq, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points, bound with ctypes; both take the same arguments (dq
// ignores dk/dv, dkv ignores dq). Each returns the CUDA error code (0 = ok).
#define FLASH_BWD_ARGS                                                                          \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,               \
      const void *delta, void *dq, void *dk, void *dv, const void *q_start, const void *kv_len, \
      int batch, int hq, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,       \
      long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,           \
      long long v_sh, long long v_ss, long long do_sb, long long do_sh, long long do_ss,        \
      float scale, int causal, int vec, void *stream
#define FLASH_BWD_PASS                                                                        \
  q, k, v, dout, lse, delta, dq, dk, dv, q_start, kv_len, batch, hq, hkv, sq, skv, d, q_sb,   \
      q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, scale, causal, vec, \
      stream

extern "C" int flash_bwd_dq_bf16(FLASH_BWD_ARGS) { return run(true, FLASH_BWD_PASS); }

extern "C" int flash_bwd_dkv_bf16(FLASH_BWD_ARGS) { return run(false, FLASH_BWD_PASS); }
