// Pieces of the wmma flash-attention kernels (flash_bwd.cu); the Hopper
// forward (flash_fwd.cu) loads its tiles with TMA instead.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

// Copies a ROWS x d bf16 tile (row pitch `stride` elements) into shared memory
// with pitch DP + 8, zero-filling rows >= rows_valid and columns >= d. With
// `vec`, every source row start is 16-byte aligned and full 8-column chunks
// move as one 16-byte load; otherwise element by element.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int rows_valid, int d, int vec) {
  constexpr int LD = DP + 8;
  constexpr int CHUNKS = DP / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    __nv_bfloat16* out = dst + r * LD + c;
    if (vec && r < rows_valid && c + 8 <= d) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src + r * stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[e] = (r < rows_valid && c + e < d) ? src[r * stride + c + e] : zero;
      }
    }
  }
}

}  // namespace flash
