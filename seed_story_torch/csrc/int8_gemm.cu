// Kernel C: the weight-only int8 GEMM for Hopper (sm_90a), for products of
// more than 32 rows: the int8 agent's prefill, the int8 UNet's QDense layers
// and the quantize_base training forward and backward.
//
//   forward     y  (M, N) = bf16( bf16( sum_k x[m, k] W[n, k] ) * bf16(scale[n]) )
//   transposed  dx (M, K) = bf16( sum_n bf16( g[m, n] * bf16(scale[n]) ) W[n, k] )
//
// x (M, K) and g (M, N) bf16 row-major, W (N, K) int8 row-major (PyTorch's
// Linear layout), scale (N,) f32; sums in f32. The forward's roundings are
// those of the plain version, F.linear(x, W.to(bf16)) * scale.to(bf16); the
// transposed form is the gradient of that expression to x, as JAX's autodiff
// takes it: the gradient times the bf16 scale, rounded, then the product
// with W, which contracts over N.
//
// Replaces: no Pallas kernel. The JAX package computes these products in
// plain XLA (seed_story_tpu/models/llama.py:294, LoRADense with
// quantize=True; seed_story_tpu/models/sdxl/unet.py:63-77, QDense), where
// the int8 -> bf16 convert fuses into the dot's operand load and its
// autodiff, so the device reads each int8 weight byte once. Eager PyTorch
// writes a bf16 copy of W before every such product; this kernel never
// does.
//
// What bounds it on an H100: with M in the hundreds to thousands the
// product does 2 M operations per weight byte, above the card's ridge (about
// 295 bf16 operations a byte): it is bound by the tensor cores. The int8
// bytes matter only below about 150 rows.
//
// Design (a simple kernel that is right; wgmma and TMA are for a later one):
// - Block tiles of 128 x 128 outputs, 8 warps as 2 x 4 of 64 x 32 each,
//   mma.sync m16n8k16 bf16 with f32 accumulators; stages of 64 columns of
//   the contracted axis in a 3-stage cp.async ring (the bf16 x or g tile and
//   the int8 W tile; rows past M and W rows or columns past N or K are zero
//   filled, their outputs not stored).
// - Each stage's int8 W tile is converted once per block into a bf16 tile in
//   shared memory (kernel A's byte permutes: each byte + 128 in the mantissa
//   of 2^23, one f32 subtraction, exact), which ldmatrix reads as the B
//   operand: non-transposed for the forward (W rows are the output columns,
//   contiguous in the contracted K), transposed (ldmatrix.trans) for dx (W
//   rows are the contracted N). The transposed form also scales its g tile
//   in place in shared memory before the products, rounding each product to
//   bf16.
// - A block sums an output's whole contracted axis in one order, stage by
//   stage and k16 step by step, which depends on K (or N) only: no split-K.
//   A row gets the same bits whatever the number of rows beside it, so a
//   ragged batched prefill gives a prompt the bits it gets alone.
// - Shared tiles are XOR-swizzled in 16-byte chunks (chunk ^ (row & 7)) so
//   that ldmatrix and the conversion's stores are free of bank conflicts.
// - N and K must be multiples of 64 (every projection of the SDXL UNet and
//   of LLaMA-2-7B is); M is any positive count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along the output columns
constexpr int kBM = 128;       // rows of a block tile
constexpr int kBN = 128;       // output columns of a block tile
constexpr int kBK = 64;        // contracted columns of a stage
constexpr int kStages = 3;
constexpr int kABytes = kBM * kBK * 2;  // the bf16 x or g tile of a stage: 16 KB
constexpr int kWBytes = kBN * kBK;      // the int8 W tile of a stage: 8 KB
constexpr int kStageBytes = kABytes + kWBytes;
constexpr int kWbBytes = kBN * kBK * 2;  // the converted bf16 W tile: 16 KB
constexpr int kSmemBytes = kStages * kStageBytes + kWbBytes;  // 88 KB

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
// the lower byte in the lower half), exactly (kernel A's conversion).
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

// bf16(a * s) for the two bf16 values of a (s already a bf16 value as f32).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t a, float s_lo, float s_hi) {
  const float lo = __uint_as_float(a << 16) * s_lo;  // a bf16 product is exact in f32
  const float hi = __uint_as_float(a & 0xffff0000u) * s_hi;
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile of
// `chunks` chunks a row.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int chunks) {
  return static_cast<uint32_t>((row * chunks + (chunk ^ (row & 7))) * 16);
}

// Grid (output column tiles of 128, row tiles of 128). Forward (kTrans
// false): a = x (m, k), out = y (m, n), contracting k. Transposed: a = g
// (m, n), out = dx (m, k), contracting n. w is (n, k) in both.
template <bool kTrans>
__global__ void __launch_bounds__(kThreads) int8_gemm_kernel(
    const __nv_bfloat16* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the mma fragment's row group and lane in it
  const int wm = warp / 4, wn = warp % 4;  // this warp's 64 x 32 piece of the block tile
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int contracted = kTrans ? n : k;  // a multiple of kBK
  const int cols = kTrans ? k : n;        // output columns
  const int n_stages = contracted / kBK;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t wb = ring + kStages * kStageBytes;  // the converted bf16 W tile
  uint8_t* const wb_ptr = smem + kStages * kStageBytes;

  auto issue = [&](int i) {  // stage i into slot i % kStages
    if (i < n_stages) {
      const int c0 = i * kBK;  // first contracted column of the stage
      const uint32_t slot = ring + (i % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kABytes / 16 / kThreads; ++j) {  // a rows: 8 chunks of 8 bf16
        const int idx = j * kThreads + tid;
        const int r = idx / 8, c = idx % 8;
        const bool ok = row0 + r < m;
        cp_async16(slot + swz(r, c, 8),
                   ok ? a + static_cast<size_t>(row0 + r) * contracted + c0 + 8 * c : a, ok);
      }
#pragma unroll
      for (int j = 0; j < kWBytes / 16 / kThreads; ++j) {
        const int idx = j * kThreads + tid;
        if (!kTrans) {  // W rows col0.. (output columns), 4 chunks of 16 int8 along k
          const int r = idx / 4, c = idx % 4;
          const bool ok = col0 + r < n;
          cp_async16(slot + kABytes + idx * 16,
                     ok ? w + static_cast<size_t>(col0 + r) * k + c0 + 16 * c : w, ok);
        } else {  // W rows c0.. (contracted), 8 chunks of 16 int8 along the output k
          const int r = idx / 8, c = idx % 8;
          const bool ok = col0 + 16 * c < k;
          cp_async16(slot + kABytes + idx * 16,
                     ok ? w + static_cast<size_t>(c0 + r) * k + col0 + 16 * c : w, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  float acc[4][4][4] = {};  // (m16 tile, n8 tile, fragment)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i is in for every thread; every thread is done with stage i - 1
    issue(i + kStages - 1);
    const uint32_t slot = ring + (i % kStages) * kStageBytes;
    uint8_t* const slot_ptr = smem + (i % kStages) * kStageBytes;

    // W int8 -> bf16, once per block
#pragma unroll
    for (int j = 0; j < kWBytes / 16 / kThreads; ++j) {
      const int idx = j * kThreads + tid;
      const uint4 v = *reinterpret_cast<const uint4*>(slot_ptr + kABytes + idx * 16);
      uint4 lo, hi;  // bf16 of bytes 0-7 and 8-15
      int8x4_to_bf16x2(v.x, lo.x, lo.y);
      int8x4_to_bf16x2(v.y, lo.z, lo.w);
      int8x4_to_bf16x2(v.z, hi.x, hi.y);
      int8x4_to_bf16x2(v.w, hi.z, hi.w);
      // forward: row n of 64 k (8 chunks); transposed: row n of 128 output k (16 chunks)
      const int chunks = kTrans ? 16 : 8;
      const int r = kTrans ? idx / 8 : idx / 4, c = 2 * (kTrans ? idx % 8 : idx % 4);
      *reinterpret_cast<uint4*>(wb_ptr + swz(r, c, chunks)) = lo;
      *reinterpret_cast<uint4*>(wb_ptr + swz(r, c + 1, chunks)) = hi;
    }
    if (kTrans) {  // g tile times bf16(scale) of its contracted columns, rounded to bf16
      const int c = tid % 8;  // this thread's chunk: contracted columns 8 c .. 8 c + 7
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + i * kBK + 8 * c));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + i * kBK + 8 * c + 4));
      const float s[8] = {bf16_round(s0.x), bf16_round(s0.y), bf16_round(s0.z),
                          bf16_round(s0.w), bf16_round(s1.x), bf16_round(s1.y),
                          bf16_round(s1.z), bf16_round(s1.w)};
#pragma unroll
      for (int j = 0; j < kBM / (kThreads / 8); ++j) {
        uint4* p = reinterpret_cast<uint4*>(slot_ptr + swz(tid / 8 + j * (kThreads / 8), c, 8));
        uint4 v = *p;
        v.x = scale_bf16x2(v.x, s[0], s[1]);
        v.y = scale_bf16x2(v.y, s[2], s[3]);
        v.z = scale_bf16x2(v.z, s[4], s[5]);
        v.w = scale_bf16x2(v.w, s[6], s[7]);
        *p = v;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {  // rows wm*64 + 16 mi .., columns kk .. kk + 15
        const int mat = lane / 8;
        const int r = wm * 64 + mi * 16 + lane % 8 + 8 * (mat & 1);
        ldmatrix_x4(slot + swz(r, kk / 8 + (mat >> 1), 8), af[mi][0], af[mi][1], af[mi][2],
                    af[mi][3]);
      }
      uint32_t bf[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {  // output columns wn*32 + 16 nj .. + 15: two n8 tiles
        const int mat = lane / 8;
        if (!kTrans) {  // W_bf16 (n, k): rows are output columns
          const int r = wn * 32 + nj * 16 + lane % 8 + 8 * (mat >> 1);
          ldmatrix_x4(wb + swz(r, kk / 8 + (mat & 1), 8), bf[2 * nj][0], bf[2 * nj][1],
                      bf[2 * nj + 1][0], bf[2 * nj + 1][1]);
        } else {  // W_bf16 (n, k): rows are contracted, read transposed
          const int r = kk + lane % 8 + 8 * (mat & 1);
          ldmatrix_x4_trans(wb + swz(r, (wn * 32 + nj * 16) / 8 + (mat >> 1), 16),
                            bf[2 * nj][0], bf[2 * nj][1], bf[2 * nj + 1][0],
                            bf[2 * nj + 1][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  // acc[mi][ni]: (row g, columns 2t, 2t + 1), (row g + 8, the same columns)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = col0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= cols) continue;  // cols is even, so col + 1 is in too
    float s0 = 1.f, s1 = 1.f;
    if (!kTrans) {
      s0 = bf16_round(scale[col]);
      s1 = bf16_round(scale[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 64 + mi * 16 + g + 8 * h;
        if (row >= m) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (!kTrans) {
          v0 = bf16_round(v0) * s0;
          v1 = bf16_round(v1) * s1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * cols + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <bool kTrans>
int launch(const __nv_bfloat16* a, const int8_t* w, const float* scale, __nv_bfloat16* out,
           int m, int n, int k, cudaStream_t st) {
  // once per device; the same value from every caller, so a race is harmless
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(int8_gemm_kernel<kTrans>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  const int cols = kTrans ? k : n;
  const dim3 grid((cols + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int8_gemm_kernel<kTrans><<<grid, kThreads, kSmemBytes, st>>>(a, w, scale, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// transposed 0: a = x (m, k) bf16, out = y (m, n) bf16; transposed 1: a = g
// (m, n) bf16, out = dx (m, k) bf16. w (n, k) int8, scale (n,) f32. All
// contiguous with 16-byte aligned bases; m >= 1, n and k positive multiples
// of 64, m and the grid's row tiles within 65535 * 128. Returns a
// cudaError_t code (0 on success).
extern "C" int int8_gemm_bf16(const void* a, const void* w, const void* scale, void* out, int m,
                              int n, int k, int transposed, void* stream) {
  if (m < 1 || n < kBK || k < kBK || n % kBK != 0 || k % kBK != 0 ||
      (m + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ab = static_cast<const __nv_bfloat16*>(a);
  const auto* wb = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  return transposed ? launch<true>(ab, wb, sc, ob, m, n, k, st)
                    : launch<false>(ab, wb, sc, ob, m, n, k, st);
}
