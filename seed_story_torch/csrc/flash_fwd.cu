// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces the TPU kernel seed_story_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _flash_fwd). Same contract:
//
//   visible(b, i, j) = j < kv_len[b] && j < Skv && (!causal || j <= q_start[b] + i)
//
// Masked scores take -0.7 * FLT_MAX; rows with no visible key output exactly 0
// with LSE = -inf. The scale multiplies the f32 scores, P is rounded to bf16
// before the PV product, and the running max / sum / output stay in f32. GQA
// reads KV head h / (Hq / Hkv) without repeating K or V. Outputs: O
// (B, Hq, Sq, D) bf16 contiguous and LSE (B, Hq, Sq) f32.
//
// What bounds it on an H100: at the UNet's S=4096, d=64 self-attention the
// work is 4*S*S*d FLOPs per head against 4*S*d bytes, so it is bound by the
// tensor cores and by the softmax between the two products. For short query
// blocks (the resamplers, Sq=64..256 against Skv<=1024) it is bound by reading
// K and V once per 64-row query tile.
//
// Design: one block of 4 warps per (64-row query tile, head, batch row). The
// query tile stays in shared memory; 64-key K and V tiles are staged in shared
// memory one after the other. QK^T and PV run on the tensor cores through
// nvcuda::wmma bf16 16x16x16 fragments with f32 accumulators; each warp owns
// 16 query rows, keeps its output accumulators in registers, and does the
// online softmax for its rows with warp shuffles. Tiles past the last key any
// row of the block can see (kv_len, or the causal diagonal) are never loaded.
// Head dims up to 128 are padded to 64 or 128 with zeros in shared memory;
// ragged Sq / Skv edges are masked here, so the caller pads nothing.
// wgmma, TMA, cp.async pipelining and persistence are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BLOCK_M = 64;  // query rows per block
constexpr int BLOCK_N = 64;  // keys per KV tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int WARP_ROWS = BLOCK_M / NUM_WARPS;  // 16 query rows per warp
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  const int* q_start;
  const int* kv_len;
  int hq, hkv, sq, skv, d;
  long long q_sb, q_sh, q_ss;  // strides in elements; the head dim is unit-stride
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
  int causal;
  int vec;  // 1 when every pointer is 16-byte aligned and every stride a multiple of 8
};

// Shared-memory layout for head dims padded to DP. Row pitches carry padding
// against bank conflicts; every region starts on a 128-byte boundary and every
// 16-row fragment on a 32-byte one, as wmma::load_matrix_sync requires.
template <int DP>
struct Layout {
  static constexpr int LD_T = DP + 8;       // bf16 Q, K, V tiles
  static constexpr int LD_S = BLOCK_N + 4;  // f32 scores
  static constexpr int LD_P = BLOCK_N + 8;  // bf16 probabilities
  static constexpr int LD_O = DP + 4;       // f32 output rows
  static constexpr int Q = 0;
  static constexpr int K = Q + BLOCK_M * LD_T * 2;
  static constexpr int V = K + BLOCK_N * LD_T * 2;
  static constexpr int S = V + BLOCK_N * LD_T * 2;
  static constexpr int P = S + BLOCK_M * LD_S * 4;
  static constexpr int O = P + BLOCK_M * LD_P * 2;
  static constexpr int STATS = O + BLOCK_M * LD_O * 4;
  static constexpr int BYTES = STATS + 3 * BLOCK_M * 4;
};

template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int rows_valid, int d, int vec) {
  flash::load_tile<DP, ROWS, NUM_THREADS>(dst, src, stride, rows_valid, d, vec);
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const Params p) {
  using L = Layout<DP>;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* o_s = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::STATS);
  float* l_s = m_s + BLOCK_M;
  float* a_s = l_s + BLOCK_M;

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * WARP_ROWS;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = p.q_start[b];
  const int kv_len = p.kv_len[b];

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + hk * p.v_sh;

  load_tile<DP, BLOCK_M>(q_s, qg, p.q_ss, min(BLOCK_M, p.sq - q0), p.d, p.vec);
  if (threadIdx.x < BLOCK_M) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  // One past the last key any row of this block can see.
  int kv_end = min(kv_len, p.skv);
  if (p.causal) kv_end = min(kv_end, q_start + min(q0 + BLOCK_M, p.sq));
  kv_end = max(kv_end, 0);
  const int n_tiles = (kv_end + BLOCK_N - 1) / BLOCK_N;

  FragC o_frag[DP / 16];
#pragma unroll
  for (int db = 0; db < DP / 16; ++db) wmma::fill_fragment(o_frag[db], 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();  // the previous tile is consumed; Q and the stats are visible
    load_tile<DP, BLOCK_N>(k_s, kg + k0 * p.k_ss, p.k_ss, min(BLOCK_N, p.skv - k0), p.d, p.vec);
    load_tile<DP, BLOCK_N>(v_s, vg + k0 * p.v_ss, p.v_ss, min(BLOCK_N, p.skv - k0), p.d, p.vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
#pragma unroll
    for (int nb = 0; nb < BLOCK_N / 16; ++nb) {
      FragC s_frag;
      wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
      for (int kb = 0; kb < DP / 16; ++kb) {
        FragA a;
        FragBc bk;
        wmma::load_matrix_sync(a, q_s + row0 * L::LD_T + kb * 16, L::LD_T);
        wmma::load_matrix_sync(bk, k_s + nb * 16 * L::LD_T + kb * 16, L::LD_T);
        wmma::mma_sync(s_frag, a, bk, s_frag);
      }
      wmma::store_matrix_sync(s_s + row0 * L::LD_S + nb * 16, s_frag, L::LD_S, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time, two keys per lane.
    for (int r = 0; r < WARP_ROWS; ++r) {
      const int row = row0 + r;
      int limit = min(kv_len, p.skv);
      if (p.causal) limit = min(limit, q_start + q0 + row + 1);
      const bool vis0 = k0 + lane < limit;
      const bool vis1 = k0 + lane + 32 < limit;
      const float s0 = vis0 ? s_s[row * L::LD_S + lane] * p.scale : MASK_VALUE;
      const float s1 = vis1 ? s_s[row * L::LD_S + lane + 32] * p.scale : MASK_VALUE;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = vis0 ? expf(s0 - m_new) : 0.f;
      const float p1 = vis1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[row * L::LD_P + lane] = __float2bfloat16(p0);
      p_s[row * L::LD_P + lane + 32] = __float2bfloat16(p1);
      __syncwarp();  // every lane has read m_s[row] before lane 0 replaces it
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
        a_s[row] = alpha;
      }
    }
    __syncwarp();

    // Rescale the running output rows by alpha, then O += P V.
#pragma unroll
    for (int db = 0; db < DP / 16; ++db) {
      wmma::store_matrix_sync(o_s + row0 * L::LD_O + db * 16, o_frag[db], L::LD_O, wmma::mem_row_major);
    }
    __syncwarp();
    for (int idx = lane; idx < WARP_ROWS * DP; idx += 32) {
      const int row = row0 + idx / DP;
      o_s[row * L::LD_O + idx % DP] *= a_s[row];
    }
    __syncwarp();
#pragma unroll
    for (int db = 0; db < DP / 16; ++db) {
      wmma::load_matrix_sync(o_frag[db], o_s + row0 * L::LD_O + db * 16, L::LD_O, wmma::mem_row_major);
#pragma unroll
      for (int kb = 0; kb < BLOCK_N / 16; ++kb) {
        FragA a;
        FragBr bv;
        wmma::load_matrix_sync(a, p_s + row0 * L::LD_P + kb * 16, L::LD_P);
        wmma::load_matrix_sync(bv, v_s + kb * 16 * L::LD_T + db * 16, L::LD_T);
        wmma::mma_sync(o_frag[db], a, bv, o_frag[db]);
      }
    }
  }
  __syncthreads();  // the stats are visible even when no tile ran

#pragma unroll
  for (int db = 0; db < DP / 16; ++db) {
    wmma::store_matrix_sync(o_s + row0 * L::LD_O + db * 16, o_frag[db], L::LD_O, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < WARP_ROWS; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= p.sq) break;
    const float l = l_s[row];
    const float denom = l == 0.f ? 1.f : l;
    const long long out_row = ((long long)b * p.hq + h) * p.sq + qi;
    __nv_bfloat16* og = p.o + out_row * p.d;
    for (int c = lane; c < p.d; c += 32) og[c] = __float2bfloat16(o_s[row * L::LD_O + c] / denom);
    if (lane == 0) p.lse[out_row] = l > 0.f ? m_s[row] + logf(l) : -INFINITY;
  }
}

template <int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = Layout<DP>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BLOCK_M - 1) / BLOCK_M, p.hq, batch);
  flash_fwd_kernel<DP><<<grid, NUM_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns the CUDA error code (0 = ok).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* q_start, const void* kv_len, int batch, int hq, int hkv,
                              int sq, int skv, int d, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, float scale,
                              int causal, int vec, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.scale = scale;
  p.causal = causal;
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return static_cast<int>(launch<64>(p, batch, s));
  if (d <= 128) return static_cast<int>(launch<128>(p, batch, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
