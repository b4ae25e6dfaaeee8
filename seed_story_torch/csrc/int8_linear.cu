// Weight-only int8 GEMV / skinny GEMM for Hopper (sm_90a): the base product
// of an int8 LoRADense on the decode and speculative-verify passes.
//
//   y (M, N) = bf16( bf16( sum_k x[m, k] * W[n, k] ) * bf16(scale[n]) )
//
// x (M, K) bf16 row-major with M <= 8, W (N, K) int8 row-major (PyTorch's
// Linear layout), scale (N,) f32, y (M, N) bf16; sums in f32. The two bf16
// roundings are those of the plain version, F.linear(x, W.to(bf16)) *
// scale.to(bf16).
//
// Replaces: no Pallas kernel. The JAX package computes this product in plain
// XLA (seed_story_tpu/models/llama.py:294, LoRADense with quantize=True),
// where the int8 -> bf16 convert fuses into the dot's operand load, so the
// device reads each int8 weight byte once. Eager PyTorch has no such fusion:
// the plain version writes and reads a bf16 copy of W on every call.
//
// What bounds it on an H100: with M <= 8 rows the product does 2 * M FLOPs
// per weight byte, far below the card's ridge; it is bound by streaming W
// (N * K bytes) from device memory. At the 7B agent's shapes that is 16.8 MB
// (q/k/v/o, 4096 x 4096) and 45.1 MB (gate/up 11008 x 4096, down
// 4096 x 11008), 5.0 and 13.5 us at 3.35 TB/s.
//
// Design:
// - Each block owns 16 output channels (8 warps x 2 rows) and walks K in
//   tiles of 2048 columns. Every lane reads its weights as 16-byte vectors
//   (16 int8 values), consecutive lanes on consecutive 16 bytes, so each
//   warp streams whole 512-byte stretches of a row; a tile's weight loads
//   are issued into registers before the block stages the matching x tile.
// - The x tile (M x 2048 bf16, at most 32 KB) is staged in shared memory
//   once per block and read back as 16-byte vectors; all lanes of a warp
//   read different columns, so x never leaves the SM more than once a tile.
// - int8 -> f32 by shifts in registers, products and sums in f32, one warp
//   shuffle reduction per (row, m) at the end, and the two bf16 roundings in
//   the epilogue. One launch per product; nothing is written but y.
// - K must be a multiple of 16 (every projection of the agent is); a tile
//   shorter than 2048 (K = 11008) leaves the lanes past its end idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = (kThreads / 32) * kRowsPerWarp;
constexpr int kTileK = 2048;
constexpr int kVec = 16;                            // int8 weights per 16-byte load
constexpr int kChunksPerLane = kTileK / kVec / 32;  // 4

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The 4 signed bytes of w, as floats (byte 0 first).
__device__ __forceinline__ void int8x4_to_float(uint32_t w, float* f) {
  f[0] = static_cast<float>(static_cast<int32_t>(w << 24) >> 24);
  f[1] = static_cast<float>(static_cast<int32_t>(w << 16) >> 24);
  f[2] = static_cast<float>(static_cast<int32_t>(w << 8) >> 24);
  f[3] = static_cast<float>(static_cast<int32_t>(w) >> 24);
}

// The 2 bf16 values of w, as floats (the low half first).
__device__ __forceinline__ void bf16x2_to_float(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

template <int M>
__global__ void __launch_bounds__(kThreads) int8_linear_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 xs[M][kTileK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  float acc[kRowsPerWarp][M];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < M; ++m) acc[r][m] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    const int kt = min(kTileK, k - k0);  // a multiple of 16
    // this warp's weights of the tile, in flight while x is staged
    uint4 wr[kRowsPerWarp][kChunksPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int c = 0; c < kChunksPerLane; ++c) {
        const int col = (c * 32 + lane) * kVec;
        if (row < n && col < kt) {
          wr[r][c] = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(row) * k + k0 + col));
        } else {
          wr[r][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    __syncthreads();  // the previous tile's reads of xs are done
    const int vecs_per_row = kt / 8;  // 16-byte vectors of 8 bf16
    for (int i = threadIdx.x; i < M * vecs_per_row; i += kThreads) {
      const int m = i / vecs_per_row, c = i % vecs_per_row;
      reinterpret_cast<uint4*>(xs[m])[c] =
          __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * k + k0) + c);
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kChunksPerLane; ++c) {
      const int col = (c * 32 + lane) * kVec;
      if (col >= kt) continue;
      float wf[kRowsPerWarp][kVec];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        int8x4_to_float(wr[r][c].x, &wf[r][0]);
        int8x4_to_float(wr[r][c].y, &wf[r][4]);
        int8x4_to_float(wr[r][c].z, &wf[r][8]);
        int8x4_to_float(wr[r][c].w, &wf[r][12]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint4 xa = *reinterpret_cast<const uint4*>(&xs[m][col]);
        const uint4 xb = *reinterpret_cast<const uint4*>(&xs[m][col + 8]);
        float xf[kVec];
        bf16x2_to_float(xa.x, &xf[0]);
        bf16x2_to_float(xa.y, &xf[2]);
        bf16x2_to_float(xa.z, &xf[4]);
        bf16x2_to_float(xa.w, &xf[6]);
        bf16x2_to_float(xb.x, &xf[8]);
        bf16x2_to_float(xb.y, &xf[10]);
        bf16x2_to_float(xb.z, &xf[12]);
        bf16x2_to_float(xb.w, &xf[14]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float s = acc[r][m];
#pragma unroll
          for (int e = 0; e < kVec; ++e) s = fmaf(xf[e], wf[r][e], s);
          acc[r][m] = s;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s = acc[r][m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[r][m] = s;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row >= n) continue;
      const float sc = bf16_round(scale[row]);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        y[static_cast<size_t>(m) * n + row] = __float2bfloat16_rn(bf16_round(acc[r][m]) * sc);
      }
    }
  }
}

template <int M>
cudaError_t launch(const void* x, const void* w, const void* scale, void* y, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  int8_linear_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), n, k);
  return cudaGetLastError();
}

}  // namespace

// x (m, k) bf16, w (n, k) int8, scale (n,) f32, y (m, n) bf16: all contiguous
// with 16-byte aligned bases; 1 <= m <= 8, k a positive multiple of 16.
// Returns a cudaError_t code (0 on success).
extern "C" int int8_linear_bf16(const void* x, const void* w, const void* scale, void* y, int m,
                                int n, int k, void* stream) {
  if (m < 1 || m > 8 || n < 1 || k < 16 || k % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch<1>(x, w, scale, y, n, k, s));
    case 2: return static_cast<int>(launch<2>(x, w, scale, y, n, k, s));
    case 3: return static_cast<int>(launch<3>(x, w, scale, y, n, k, s));
    case 4: return static_cast<int>(launch<4>(x, w, scale, y, n, k, s));
    case 5: return static_cast<int>(launch<5>(x, w, scale, y, n, k, s));
    case 6: return static_cast<int>(launch<6>(x, w, scale, y, n, k, s));
    case 7: return static_cast<int>(launch<7>(x, w, scale, y, n, k, s));
    default: return static_cast<int>(launch<8>(x, w, scale, y, n, k, s));
  }
}
