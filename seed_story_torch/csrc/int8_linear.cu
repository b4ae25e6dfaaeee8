// Weight-only int8 GEMV / skinny GEMM for Hopper (sm_90a): the base product
// of an int8 LoRADense on the decode and speculative-verify passes.
//
//   y (M, N) = bf16( bf16( sum_k x[m, k] * W[n, k] ) * bf16(scale[n]) )
//
// x (M, K) bf16 row-major with M <= 32, W (N, K) int8 row-major (PyTorch's
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
// What bounds it on an H100: with M <= 32 rows the product does 2 * M FLOPs
// per weight byte, far below the card's ridge; it is bound by streaming W
// (N * K bytes) from device memory. At the 7B agent's shapes that is 16.8 MB
// (q/k/v/o, 4096 x 4096) and 45.1 MB (gate/up 11008 x 4096, down
// 4096 x 11008), 5.0 and 13.5 us at 3.35 TB/s. What keeps a kernel from that
// bound is instructions per weight byte (the convert and the products) and
// too few bytes in flight.
//
// Design:
// - Tensor cores: mma.sync m16n8k16 bf16 -> f32 with 16 channels of W as
//   the A operand and x^T as the B operand, in NT = ceil(M / 8) n-tiles of 8
//   columns (NT of 1, 2 or 4; lanes of columns >= M feed zeros): a
//   speculative verify block of B stories in lockstep is B (K + 1) rows.
//   Each W fragment is converted once and feeds every n-tile's mma, so W is
//   still read and converted once a call. int8 -> bf16 is exact for
//   |w| <= 127 and bf16 x bf16 products are exact in f32, so the result
//   differs from the plain version only in the order of the f32 sums. That
//   order depends on N and K only (the K split below), never on M: a row
//   gets the same bits in a call of 2..32 rows.
// - A permuted k: the sum over k does not care about order, so within each
//   64-column slab the mma's k index i (lane t = (i % 8) / 2 of the
//   fragment) is bound to column 16 t + 4 j + 2 (i / 8) + i % 2 in step
//   j = 0..3. A lane then needs 16 consecutive int8 bytes of each of its
//   two channels (one 16-byte vector) and 16 consecutive bf16 values of its
//   x row (two 16-byte vectors) per slab: W and x keep their layouts.
// - Convert with byte permutes: each int8 byte, offset by 128, is placed in
//   the mantissa of 2^23 (prmt), one f32 subtraction gives the exact value,
//   and the high halves of two f32 values pack into one bf16x2 (prmt).
// - The weight stream stays in flight: a block (4 warps, 64 channels, one
//   16-channel mma tile a warp) keeps a ring of 3 stages in shared memory,
//   each 256 columns of its 64 channels and of x (16 KB + 4 KB a n-tile;
//   96 KB for NT = 4, so two blocks still fit an SM),
//   filled by cp.async from every thread (each warp instruction copies two
//   whole 256-byte row stretches; zero-filled past N and K) while the stage
//   before is converted and multiplied; one block barrier a stage. x is
//   read once per 64 channels. Chunks are XOR-swizzled so the fragment
//   reads are free of bank conflicts.
// - Split K across the blocks of a thread block cluster (at most 8 slices)
//   so that a call has about 2 blocks per SM (N = 4096, K = 4096: 64
//   channel groups x 4 slices of 1024 columns). The slices' f32 sums meet in
//   distributed shared memory: after a cluster barrier each block adds, for
//   its share of the group's outputs, every slice's sum in slice order
//   (bitwise repeatable) and rounds twice in the epilogue.
// - One row (the decode pass) takes a CUDA-core kernel,
//   int8_linear_kernel_gemv: at M = 1 the bytes are the whole cost and its
//   single pass over K, 2 channels a warp with 16-byte register loads,
//   streams W faster than the mma kernel's split K and cluster merge.
// - K must be a multiple of 16 (every projection of the agent is).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // channels per block
constexpr int kStageK = 256;        // columns per stage: four 64-column slabs
constexpr int kStages = 3;
constexpr int kWBytes = kRows * kStageK;              // 16 KB
constexpr int kMaxRows = 32;                          // x rows: 4 n-tiles of 8

// The ring of a kernel with NT n-tiles: x rows of a stage 4 KB a n-tile.
template <int NT>
struct Ring {
  static constexpr int kXBytes = 8 * NT * kStageK * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;  // 60, 72 or 96 KB
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The 4 signed bytes of w as two bf16x2 (bytes 0-1 in lo, bytes 2-3 in hi;
// the lower byte in the lower half), exactly.
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // biased: byte + 128 in 0..255
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23: a byte in the low mantissa is exact
  constexpr float kBias = 8388736.0f;       // 2^23 + 128
  const float f0 = __uint_as_float(prmt(u, kMagic, 0x7650)) - kBias;
  const float f1 = __uint_as_float(prmt(u, kMagic, 0x7651)) - kBias;
  const float f2 = __uint_as_float(prmt(u, kMagic, 0x7652)) - kBias;
  const float f3 = __uint_as_float(prmt(u, kMagic, 0x7653)) - kBias;
  // small integers are exact in bf16: the high half of the f32 is the value
  lo = prmt(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = prmt(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Grid (channel groups of 64, K slices of k_range columns), launched with
// clusters of (1, slices, 1); NT n-tiles of 8 rows of x (m <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads) int8_linear_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int m, int n, int k,
    int k_range) {
  constexpr int kXBytes = Ring<NT>::kXBytes;
  constexpr int kStageBytes = Ring<NT>::kStageBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sums[kRows][8 * NT];  // this slice's sums: (channel, row of x)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragment's row group and lane in it
  const int row0 = blockIdx.x * kRows;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int k0 = slice * k_range, k1 = min(k, k0 + k_range);
  const int n_stages = (k1 - k0 + kStageK - 1) / kStageK;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  auto issue = [&](int i) {  // stage i into slot i % kStages
    if (i < n_stages) {
      const int col0 = k0 + i * kStageK;
      const uint32_t slot = ring + (i % kStages) * kStageBytes;
#pragma unroll
      for (int c = 0; c < kWBytes / 16 / kThreads; ++c) {  // whole row stretches a warp instruction
        const int lin = c * kThreads + tid;
        const int r = lin / (kStageK / 16), chunk = lin % (kStageK / 16);
        const int row = row0 + r, col = col0 + 16 * chunk;
        const bool ok = row < n && col < k1;
        cp_async16(slot + r * kStageK + 16 * (chunk ^ ((r & 1) << 2)),
                   ok ? w + static_cast<size_t>(row) * k + col : w, ok);
      }
#pragma unroll
      for (int c = 0; c < kXBytes / 16 / kThreads; ++c) {  // x rows of kStageK / 8 chunks
        const int lin = c * kThreads + tid;
        const int r = lin / (kStageK / 8), chunk = lin % (kStageK / 8);
        const int col = col0 + 8 * chunk;
        if (r < m) {
          const bool ok = col < k1;
          cp_async16(slot + kWBytes + r * kStageK * 2 + 16 * (chunk ^ (r & 1)),
                     ok ? x + static_cast<size_t>(r) * k + col : x, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float acc[2][NT][4] = {};  // two chains of mma (even and odd slabs) a n-tile
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  const int wr = 16 * warp + g;  // this lane's rows in the block: wr, wr + 8
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i is in for every thread; every thread is done with stage i - 1
    issue(i + kStages - 1);
    const uint8_t* slot = smem + (i % kStages) * kStageBytes;
#pragma unroll
    for (int s = 0; s < kStageK / 64; ++s) {  // slab: columns 64 s + 16 t .. + 15 for this lane
      const uint4 wa = *reinterpret_cast<const uint4*>(
          slot + wr * kStageK + 16 * ((4 * s + t) ^ ((wr & 1) << 2)));
      const uint4 wb = *reinterpret_cast<const uint4*>(
          slot + (wr + 8) * kStageK + 16 * ((4 * s + t) ^ ((wr & 1) << 2)));
      uint32_t xb[NT][8];  // x row 8 nt + g: columns 16 t .. + 15 of the slab
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
        if (8 * nt + g < m) {
          const uint8_t* xr = slot + kWBytes + (8 * nt + g) * kStageK * 2;
          x0 = *reinterpret_cast<const uint4*>(xr + 16 * ((8 * s + 2 * t) ^ (g & 1)));
          x1 = *reinterpret_cast<const uint4*>(xr + 16 * ((8 * s + 2 * t + 1) ^ (g & 1)));
        }
        xb[nt][0] = x0.x, xb[nt][1] = x0.y, xb[nt][2] = x0.z, xb[nt][3] = x0.w;
        xb[nt][4] = x1.x, xb[nt][5] = x1.y, xb[nt][6] = x1.z, xb[nt][7] = x1.w;
      }
      const uint32_t wa4[4] = {wa.x, wa.y, wa.z, wa.w}, wb4[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // mma step: columns 16 t + 4 j .. + 3 of the slab
        uint32_t a0, a1, a2, a3;  // converted once, used by every n-tile
        int8x4_to_bf16x2(wa4[j], a0, a2);
        int8x4_to_bf16x2(wb4[j], a1, a3);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(acc[s % 2][nt], a0, a1, a2, a3, xb[nt][2 * j], xb[nt][2 * j + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[.][nt]: (row wr, x rows 8 nt + 2t, + 1), (row wr + 8, the same x rows)
  float sum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nt][e] = acc[0][nt][e] + acc[1][nt][e];
  }
  if (slices == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wr + 8 * (e / 2), mm = 8 * nt + 2 * t + e % 2;
        if (row < n && mm < m) {
          y[static_cast<size_t>(mm) * n + row] =
              __float2bfloat16_rn(bf16_round(sum[nt][e]) * bf16_round(scale[row]));
        }
      }
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sums[wr + 8 * (e / 2)][8 * nt + 2 * t + e % 2] = sum[nt][e];
  }
  // the slices' sums in distributed shared memory, added in slice order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = cluster.block_rank() * kThreads + tid; e < kRows * m; e += slices * kThreads) {
    const int r = e % kRows, mm = e / kRows, row = row0 + r;
    if (row >= n) continue;
    float part[8];  // every load issued before the first add
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) {
      part[sl] = sl < slices ? *cluster.map_shared_rank(&sums[r][mm], sl) : 0.f;
    }
    float v = 0.f;
#pragma unroll
    for (int sl = 0; sl < 8; ++sl) v += part[sl];  // slice order; the zeros past `slices` are exact
    y[static_cast<size_t>(mm) * n + row] =
        __float2bfloat16_rn(bf16_round(v) * bf16_round(scale[row]));
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// The CUDA-core kernel for one row (see the design notes): each block owns
// 16 output channels (8 warps x 2 rows) and walks K in tiles of 2048
// columns; every lane reads its weights as 16-byte vectors into registers
// before the block stages the x tile in shared memory; int8 -> f32 by
// shifts, f32 FMAs, one warp shuffle reduction per channel. Written for M
// rows of x and launched for M = 1; this form compiles to 64 registers (four
// blocks an SM), where a 4-weights-at-a-time rewrite took 76-80 and streamed
// W up to 6% slower.
constexpr int kGemvThreads = 256;
constexpr int kGemvRowsPerWarp = 2;
constexpr int kGemvRows = (kGemvThreads / 32) * kGemvRowsPerWarp;
constexpr int kGemvTileK = 2048;
constexpr int kGemvChunks = kGemvTileK / 16 / 32;  // 16-byte vectors a lane a tile

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
__global__ void __launch_bounds__(kGemvThreads) int8_linear_kernel_gemv(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 xs[M][kGemvTileK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kGemvRows + warp * kGemvRowsPerWarp;

  float acc[kGemvRowsPerWarp][M];
#pragma unroll
  for (int r = 0; r < kGemvRowsPerWarp; ++r) {
#pragma unroll
    for (int m = 0; m < M; ++m) acc[r][m] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kGemvTileK) {
    const int kt = min(kGemvTileK, k - k0);  // a multiple of 16
    // this warp's weights of the tile, in flight while x is staged
    uint4 wr[kGemvRowsPerWarp][kGemvChunks];
#pragma unroll
    for (int r = 0; r < kGemvRowsPerWarp; ++r) {
      const int row = row0 + r;
#pragma unroll
      for (int c = 0; c < kGemvChunks; ++c) {
        const int col = (c * 32 + lane) * 16;
        if (row < n && col < kt) {
          wr[r][c] = __ldg(
              reinterpret_cast<const uint4*>(w + static_cast<size_t>(row) * k + k0 + col));
        } else {
          wr[r][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    __syncthreads();  // the previous tile's reads of xs are done
    const int vecs_per_row = kt / 8;  // 16-byte vectors of 8 bf16
    for (int i = threadIdx.x; i < M * vecs_per_row; i += kGemvThreads) {
      const int m = i / vecs_per_row, c = i % vecs_per_row;
      reinterpret_cast<uint4*>(xs[m])[c] =
          __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * k + k0) + c);
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kGemvChunks; ++c) {
      const int col = (c * 32 + lane) * 16;
      if (col >= kt) continue;
      float wf[kGemvRowsPerWarp][16];
#pragma unroll
      for (int r = 0; r < kGemvRowsPerWarp; ++r) {
        int8x4_to_float(wr[r][c].x, &wf[r][0]);
        int8x4_to_float(wr[r][c].y, &wf[r][4]);
        int8x4_to_float(wr[r][c].z, &wf[r][8]);
        int8x4_to_float(wr[r][c].w, &wf[r][12]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint4 xa = *reinterpret_cast<const uint4*>(&xs[m][col]);
        const uint4 xb = *reinterpret_cast<const uint4*>(&xs[m][col + 8]);
        float xf[16];
        bf16x2_to_float(xa.x, &xf[0]);
        bf16x2_to_float(xa.y, &xf[2]);
        bf16x2_to_float(xa.z, &xf[4]);
        bf16x2_to_float(xa.w, &xf[6]);
        bf16x2_to_float(xb.x, &xf[8]);
        bf16x2_to_float(xb.y, &xf[10]);
        bf16x2_to_float(xb.z, &xf[12]);
        bf16x2_to_float(xb.w, &xf[14]);
#pragma unroll
        for (int r = 0; r < kGemvRowsPerWarp; ++r) {
          float s = acc[r][m];
#pragma unroll
          for (int e = 0; e < 16; ++e) s = fmaf(xf[e], wf[r][e], s);
          acc[r][m] = s;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kGemvRowsPerWarp; ++r) {
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
    for (int r = 0; r < kGemvRowsPerWarp; ++r) {
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

}  // namespace

namespace {

// The mma kernel with NT n-tiles, launched in clusters of the K slices.
template <int NT>
int launch_mma(const __nv_bfloat16* x, const int8_t* w, const float* scale, __nv_bfloat16* y,
               int m, int n, int k, int k_range, int slices, cudaStream_t st) {
  constexpr int kSmemBytes = Ring<NT>::kSmemBytes;
  // once per device; the same value from every caller, so a race is harmless
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(int8_linear_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kRows - 1) / kRows, slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, int8_linear_kernel<NT>, x, w, scale, y, m, n, k, k_range));
}

}  // namespace

// x (m, k) bf16, w (n, k) int8, scale (n,) f32, y (m, n) bf16: all contiguous
// with 16-byte aligned bases; 1 <= m <= 32, k a positive multiple of 16. With
// gemv (m must be 1) the CUDA-core kernel runs; else the mma kernel with
// ceil(m / 8) n-tiles (1, 2 or 4) and K cut into slices of k_range columns (a
// multiple of 256), at most 8. Returns a cudaError_t code (0 on success).
extern "C" int int8_linear_bf16(const void* x, const void* w, const void* scale, void* y, int m,
                                int n, int k, int k_range, int gemv, void* stream) {
  if (m < 1 || m > kMaxRows || n < 1 || k < 16 || k % 16 != 0 || (gemv && m != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (gemv) {
    int8_linear_kernel_gemv<1><<<(n + kGemvRows - 1) / kGemvRows, kGemvThreads, 0, st>>>(
        xb, wb, sc, yb, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  const int slices = k_range > 0 ? (k + k_range - 1) / k_range : 0;
  if (k_range < kStageK || k_range % kStageK != 0 || slices > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 8) return launch_mma<1>(xb, wb, sc, yb, m, n, k, k_range, slices, st);
  if (m <= 16) return launch_mma<2>(xb, wb, sc, yb, m, n, k, k_range, slices, st);
  return launch_mma<4>(xb, wb, sc, yb, m, n, k, k_range, slices, st);
}
