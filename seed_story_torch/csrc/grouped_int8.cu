// Grouped weight-only int8 product for Hopper (sm_90a): the routed experts of
// a mixture-of-experts layer (models/moe.py) on the decode and speculative
// verify passes, every held expert's product in one launch.
//
//   y[p, n] = bf16( bf16( sum_k x[p / in_div, k] * W[e, n, k] ) * bf16(scale[e, n]) )
//
// for each (token, expert) pair p listed for held expert e: pairs are
// order[offsets[e] .. offsets[e + 1]) (device int32, sorted by expert on the
// device), x (R, K) bf16 row-major, W (E, N, K) int8 row-major, scale (E, N)
// f32, y (P, N) bf16; rows of y that no listed pair names are not written.
// in_div maps a pair to its x row: the number of experts a token takes for
// the first product (x holds the tokens, pair t * top_k + j is token t), 1
// for the second (x holds the pairs' activations). The two bf16 roundings are
// those of the plain version (ops/int8_linear.py grouped_int8_linear, a loop
// over the experts of F.linear(x, W[e].to(bf16)) * scale[e].to(bf16)).
//
// Replaces: no Pallas kernel (the JAX package runs no mixture of experts); it
// is the hand-written kernel that the port's rule for int8 weight-only
// products on the card asks for once the experts are int8.
//
// What bounds it on an H100: a verify pass of 8 stories x 5 rows routes 320
// pairs over 128 experts, so a held expert sees 2.5 rows on average and the
// product does about 5 FLOPs a weight byte, far below the ridge: it is bound
// by streaming the weights of the experts that some pair hit (N * K bytes
// each). Experts no pair hit must cost nothing, and the launch must not wait
// on the host for the counts.
//
// Design: kernel A's (csrc/int8_linear.cu int8_linear_kernel) per expert.
// - Grid (channel groups of 64, K slices, held experts). A block reads its
//   expert's pair count from offsets on the device; a block whose expert has
//   no pair returns at once, reading no weight byte (the pairs of experts
//   this device does not hold were sorted past offsets[E] and drop out
//   there). So the grid is fixed by the shapes and the launch needs no
//   host sync.
// - A block takes its expert's pairs 16 at a time (two mma n-tiles of 8
//   columns; lanes past the pass's rows feed zeros), gathering each pair's x
//   row through order and in_div: the same mma.sync m16n8k16 with 16 channels
//   of W as A and the x rows as B, the same byte-permute int8 -> bf16
//   convert, the same 3-stage cp.async ring of 256 columns, as kernel A.
//   More than 16 pairs take further passes over the weights (rare: 40 rows
//   of 8 experts each put 2.5 pairs on an expert on average).
// - The K split comes from N, K and the number of held experts only (about
//   two blocks an SM if every expert were hit, at most 8 slices, summed in
//   distributed shared memory in slice order), never from the pair counts:
//   a pair's sums run in the same order however many pairs share its
//   expert, so a row's bits do not depend on the batch.
// - K must be a multiple of 16.

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
constexpr int kWBytes = kRows * kStageK;  // 16 KB
constexpr int kNT = 2;                    // n-tiles of 8 pairs: 16 pairs a pass
constexpr int kPass = 8 * kNT;
constexpr int kXBytes = 8 * kNT * kStageK * 2;  // 8 KB
constexpr int kStageBytes = kWBytes + kXBytes;
constexpr int kSmemBytes = kStages * kStageBytes;  // 72 KB

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

// The 4 signed bytes of w as two bf16x2 (bytes 0-1 in lo, bytes 2-3 in hi), exactly.
__device__ __forceinline__ void int8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // biased: byte + 128 in 0..255
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23: a byte in the low mantissa is exact
  constexpr float kBias = 8388736.0f;       // 2^23 + 128
  const float f0 = __uint_as_float(prmt(u, kMagic, 0x7650)) - kBias;
  const float f1 = __uint_as_float(prmt(u, kMagic, 0x7651)) - kBias;
  const float f2 = __uint_as_float(prmt(u, kMagic, 0x7652)) - kBias;
  const float f3 = __uint_as_float(prmt(u, kMagic, 0x7653)) - kBias;
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

struct Params {
  const __nv_bfloat16* x;
  const int8_t* w;
  const float* scale;
  const int* order;
  const int* offsets;
  __nv_bfloat16* y;
  int n, k, k_range, in_div;
};

// Grid (channel groups of 64, K slices of k_range columns, held experts),
// launched with clusters of (1, slices, 1).
__global__ void __launch_bounds__(kThreads) grouped_int8_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float sums[kRows][kPass];  // this slice's sums: (channel, pair of the pass)
  __shared__ int xrow[kPass], yrow[kPass];
  const int e = blockIdx.z;
  const int first = p.offsets[e], count = p.offsets[e + 1] - first;
  if (count <= 0) return;  // the whole cluster (one expert) leaves together

  const int n = p.n, k = p.k;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const int slice = blockIdx.y, slices = gridDim.y;
  const int k0 = slice * p.k_range, k1 = min(k, k0 + p.k_range);
  const int n_stages = (k1 - k0 + kStageK - 1) / kStageK;
  const int8_t* w = p.w + static_cast<size_t>(e) * n * k;
  const float* scale = p.scale + static_cast<size_t>(e) * n;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  cg::cluster_group cluster = cg::this_cluster();
  const int wr = 16 * warp + g;  // this lane's rows in the block: wr, wr + 8

  for (int base = 0; base < count; base += kPass) {
    const int m = min(kPass, count - base);
    __syncthreads();  // the previous pass is done with the ring and the row indices
    if (tid < m) {
      const int pair = p.order[first + base + tid];
      xrow[tid] = pair / p.in_div;
      yrow[tid] = pair;
    }
    __syncthreads();

    auto issue = [&](int i) {  // stage i into slot i % kStages
      if (i < n_stages) {
        const int col0 = k0 + i * kStageK;
        const uint32_t slot = ring + (i % kStages) * kStageBytes;
#pragma unroll
        for (int c = 0; c < kWBytes / 16 / kThreads; ++c) {
          const int lin = c * kThreads + tid;
          const int r = lin / (kStageK / 16), chunk = lin % (kStageK / 16);
          const int row = row0 + r, col = col0 + 16 * chunk;
          const bool ok = row < n && col < k1;
          cp_async16(slot + r * kStageK + 16 * (chunk ^ ((r & 1) << 2)),
                     ok ? w + static_cast<size_t>(row) * k + col : w, ok);
        }
#pragma unroll
        for (int c = 0; c < kXBytes / 16 / kThreads; ++c) {
          const int lin = c * kThreads + tid;
          const int r = lin / (kStageK / 8), chunk = lin % (kStageK / 8);
          const int col = col0 + 8 * chunk;
          if (r < m) {
            const bool ok = col < k1;
            cp_async16(slot + kWBytes + r * kStageK * 2 + 16 * (chunk ^ (r & 1)),
                       ok ? p.x + static_cast<size_t>(xrow[r]) * k + col : p.x, ok);
          }
        }
      }
      cp_async_commit();  // an empty group keeps the count uniform
    };

    float acc[2][kNT][4] = {};  // two chains of mma (even and odd slabs) a n-tile
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < n_stages; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage i is in for every thread; every thread is done with stage i - 1
      issue(i + kStages - 1);
      const uint8_t* slot = smem + (i % kStages) * kStageBytes;
#pragma unroll
      for (int s = 0; s < kStageK / 64; ++s) {
        const uint4 wa = *reinterpret_cast<const uint4*>(
            slot + wr * kStageK + 16 * ((4 * s + t) ^ ((wr & 1) << 2)));
        const uint4 wb = *reinterpret_cast<const uint4*>(
            slot + (wr + 8) * kStageK + 16 * ((4 * s + t) ^ ((wr & 1) << 2)));
        uint32_t xb[kNT][8];  // pair 8 nt + g of the pass: columns 16 t .. + 15 of the slab
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
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
        for (int j = 0; j < 4; ++j) {
          uint32_t a0, a1, a2, a3;  // converted once, used by every n-tile
          int8x4_to_bf16x2(wa4[j], a0, a2);
          int8x4_to_bf16x2(wb4[j], a1, a3);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_bf16(acc[s % 2][nt], a0, a1, a2, a3, xb[nt][2 * j], xb[nt][2 * j + 1]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // acc[.][nt]: (channel wr, pairs 8 nt + 2t, + 1), (channel wr + 8, the same pairs)
    float sum[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[nt][q] = acc[0][nt][q] + acc[1][nt][q];
    }
    if (slices == 1) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + wr + 8 * (q / 2), mm = 8 * nt + 2 * t + q % 2;
          if (row < n && mm < m) {
            p.y[static_cast<size_t>(yrow[mm]) * n + row] =
                __float2bfloat16_rn(bf16_round(sum[nt][q]) * bf16_round(scale[row]));
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int q = 0; q < 4; ++q) sums[wr + 8 * (q / 2)][8 * nt + 2 * t + q % 2] = sum[nt][q];
    }
    // the slices' sums in distributed shared memory, added in slice order
    cluster.sync();
    for (int i = cluster.block_rank() * kThreads + tid; i < kRows * m; i += slices * kThreads) {
      const int r = i % kRows, mm = i / kRows, row = row0 + r;
      if (row >= n) continue;
      float part[8];  // every load issued before the first add
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
        part[sl] = sl < slices ? *cluster.map_shared_rank(&sums[r][mm], sl) : 0.f;
      }
      float v = 0.f;
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) v += part[sl];  // slice order; the zeros past `slices` are exact
      p.y[static_cast<size_t>(yrow[mm]) * n + row] =
          __float2bfloat16_rn(bf16_round(v) * bf16_round(scale[row]));
    }
    cluster.sync();  // no block goes on while another reads its sums
  }
}

}  // namespace

// x (R, k) bf16, w (experts, n, k) int8, scale (experts, n) f32, y (P, n)
// bf16, all contiguous with 16-byte aligned bases; order (P,) and offsets
// (experts + 1,) int32 on the device (see the head of this file); k a
// positive multiple of 16; K cut into slices of k_range columns (a multiple
// of 256), at most 8. Returns a cudaError_t code (0 on success).
extern "C" int grouped_int8_bf16(const void* x, const void* w, const void* scale,
                                 const void* order, const void* offsets, void* y, int experts,
                                 int n, int k, int k_range, int in_div, void* stream) {
  const int slices = k_range > 0 ? (k + k_range - 1) / k_range : 0;
  if (experts < 1 || n < 1 || k < 16 || k % 16 != 0 || in_div < 1 || k_range < kStageK ||
      k_range % kStageK != 0 || slices > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per device; the same value from every caller, so a race is harmless
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(grouped_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.order = static_cast<const int*>(order);
  p.offsets = static_cast<const int*>(offsets);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.n = n;
  p.k = k;
  p.k_range = k_range;
  p.in_div = in_div;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kRows - 1) / kRows, slices, experts);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = slices;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, grouped_int8_kernel, p));
}
