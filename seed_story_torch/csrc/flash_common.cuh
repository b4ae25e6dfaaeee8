// Hopper (sm_90a) pieces shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), kernel C (int8_gemm.cu) and the probes'
// single pass and copy (probe_attn.cu): mbarriers (local and across a
// cluster), TMA loads (multicast too), bulk copies and the host-side
// tensor-map encoders, wgmma descriptors and products, register fences,
// and the small conversions around them.
#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BOX_COLS = 64;  // head-dim columns per TMA box: 128 bytes, the swizzle's span
constexpr int ROW_BYTES = BOX_COLS * 2;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The dynamic shared memory from its first 1024-byte boundary (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): the pointer, and in `base` its
// shared-window address.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw, uint32_t& base) {
  const uint32_t addr = smem_u32(raw);
  base = (addr + 1023) & ~1023u;
  return raw + (base - addr);
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

// tma_load into every block of the cluster that `mask` names (bit i: the block
// of rank i): the box lands at `dst`'s offset in each block's shared memory
// and completes on the mbarrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, uint16_t mask, int c0, int c1,
                                                   int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Arrives on the mbarrier at `bar`'s offset in the shared memory of the
// cluster's block `rank` (this block too).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, with no tensor map; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 2-D box at (column c0, row c1) of a map from encode_map_2d.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ int pick(int which, int row, int head, int batch) {
  return which == 0 ? row : (which == 1 ? head : batch);
}

// Loads the box at (row, head, batch) of a tile of `kbox` 64-column boxes, each
// `box_bytes` apart from `dst`, completing on `bar`; perm from encode_map.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              const int (&perm)[3], int kbox, uint32_t box_bytes,
                                              int row, int head, int batch) {
  for (int kb = 0; kb < kbox; ++kb) {
    tma_load(dst + kb * box_bytes, map, bar, kb * BOX_COLS, pick(perm[0], row, head, batch),
             pick(perm[1], row, head, batch), pick(perm[2], row, head, batch));
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 64-column
// boxes `box_bytes` apart, as TMA's 128-byte swizzle placed it.
__device__ __forceinline__ int swizzled(int row, int chunk, int box_bytes) {
  return (chunk / 8) * box_bytes + row * ROW_BYTES + (((chunk % 8) ^ (row % 8)) * 16);
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

// Moves registers between warpgroups (sm_90a): the whole warpgroup executes
// it, and ptxas honours it only where one if / else splits the roles for good.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
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
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
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
// D(64 x 64) (+)= A(64 x 16) B(16 x 64)^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32 "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : F32(d)
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

// The accumulator of a 64 x 16k product (acc[n * 4 + r * 2 + j]: row r * 8 +
// lane / 4 of the warp's 16, column 8 n + 2 (lane % 4) + j) in bf16 as wgmma A
// fragments: a[kb * 4 .. kb * 4 + 3] cover columns 16 kb .. 16 kb + 15.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// Stages this thread's part of a warpgroup's 64 x 8 NT accumulator (layout
// as in pack_a), row r times mul[r], in bf16 into the thread's two rows
// (row_in_block, + 8) of a swizzled tile of 64-column boxes box_bytes apart.
template <int NT>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int box_bytes,
                                           const float (&acc)[NT * 4], const float (&mul)[2],
                                           int row_in_block, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_in_block + 8 * r;
      *reinterpret_cast<uint32_t*>(tile + swizzled(row, n, box_bytes) + 4 * (lane % 4)) =
          pack_bf16(acc[n * 4 + r * 2] * mul[r], acc[n * 4 + r * 2 + 1] * mul[r]);
    }
  }
}

// Copies tile rows row0 .. row0 + 63 (staged by one warpgroup, whose thread
// t % 128 this is) to out (row 0 of the tile, row pitch d), only rows below
// n_rows and columns below d, 16 bytes a thread where d allows.
template <int NT>
__device__ __forceinline__ void store_rows(const unsigned char* tile, int box_bytes, int row0,
                                           __nv_bfloat16* out, int n_rows, int d, int t) {
  for (int idx = t; idx < 64 * NT; idx += 128) {
    const int row = row0 + idx / NT;
    const int chunk = idx % NT;
    const int col = chunk * 8;
    if (row >= n_rows || col >= d) continue;
    const unsigned char* src = tile + swizzled(row, chunk, box_bytes);
    __nv_bfloat16* dst = out + static_cast<long long>(row) * d + col;
    if (d % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int c = 0; c < 8 && col + c < d; ++c) dst[c] = e[c];
    }
  }
}

// ---- host side ----

// Raises a kernel's dynamic shared-memory limit once per device; `configured`
// holds a bit per device and lives with the kernel's template instance.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, unsigned long long& configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && (configured >> device & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64) configured |= 1ull << device;
  return err;
}

// Multiprocessors of the current device (0 if the runtime cannot say).
inline int sm_count() {
  int device = 0, n = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return n;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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
// tensor's extent. perm[i] says which of (S, H, B) dim i + 1 is. Out-of-bounds
// rows and columns read as zero.
inline CUresult encode_map(CUtensorMap* map, const void* ptr, int cols, int s, int h, int b,
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

// A 2-D map of a row-major (rows, cols) matrix of `dtype` with a row pitch of
// `pitch_bytes` (a multiple of 16), read in boxes of box_cols x box_rows with
// `swizzle`. Out-of-bounds rows and columns read as zero.
inline CUresult encode_map_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
                              unsigned long long cols, unsigned long long rows,
                              unsigned long long pitch_bytes, unsigned box_cols,
                              unsigned box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t gdim[2] = {cols, rows};
  const cuuint64_t gstride[1] = {pitch_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return encoder()(map, dtype, 2, const_cast<void*>(ptr), gdim, gstride, box, estride,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace flash
