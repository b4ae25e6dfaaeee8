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
// 295 bf16 operations a byte), so the tensor cores bound it, and only wgmma
// reaches their rate. Inside the SM this design pays shared-memory traffic
// for it: a stage of a 128 x 256 block (4.2 MFLOP, about 1,024 tensor-core
// cycles) moves 32 KB in by TMA, reads the 16 KB int8 tile and writes its
// 32 KB bf16 copy, and wgmma reads 16 KB of x and the 32 KB B tile once per
// warpgroup (64 KB): 160 KB, about 1,250 cycles at 128 bytes a cycle. The
// transposed form also reads and writes its 16 KB g tile to scale it. So the
// kernel is bound by shared memory before the tensor cores, and it reaches
// well under the ceiling that traffic sets. The int8 bytes matter only below
// about 150 rows; there, few output tiles bind it, which K slices on a
// cluster repair.
//
// Design (as csrc/flash_fwd.cu, with the int8 tile as wgmma's B operand):
// - A block owns 128 rows x BN output columns (BN 256 or 128, chosen by the
//   wrapper): two consumer warpgroups of 64 rows, each accumulating its
//   64 x BN tile in f32 registers through wgmma m64nBNk16, and one producer
//   warp. 288 threads, one block per SM.
// - The producer's first lane streams stages of 64 contracted columns into a
//   ring (4 stages at BN 256, 6 at 128) with TMA, each completing on a
//   "full" mbarrier: the bf16 x (or g) tile, 128 rows x 128 bytes with the
//   128-byte swizzle, and the int8 W tile, unswizzled (forward: BN rows of W
//   x 64 bytes; dx: 64 rows of W x BN bytes). Rows past M and W rows or
//   columns past N or K read as zero; their outputs are not stored. The
//   consumers release a stage on its "empty" mbarrier. Each weight's tensor
//   map is built once and cached by (pointer, N, K, form, box): a map holds
//   addresses and shapes, no data.
// - The 256 consumer threads convert each int8 tile into one of three bf16
//   slots with kernel A's byte permutes (each byte + 128 in the mantissa of
//   2^23, one f32 subtraction, exact), writing exactly the bytes a
//   128-byte-swizzle TMA load of a bf16 copy of W would have written: for
//   the forward W rows are output columns, a K-major B (as K in flash's
//   Q K^T); for dx W rows are the contracted N, an MN-major B read through
//   the descriptor's transpose bit (as V in flash's P V), in 64-column
//   boxes. The thread-to-chunk maps keep the conversion's loads and stores
//   free of bank conflicts. dx scales its g tile in place (each warpgroup
//   its own 64 rows: times bf16(scale) of the stage's contracted columns,
//   rounded to bf16) beside the conversion, the scales loaded before it.
// - Stage t+1 is converted while the wgmma of stage t runs: a consumer
//   issues stage t's four k16 products, waits for stage t+1's TMA, converts
//   its share, fences the generic-proxy stores for the async proxy
//   (fence.proxy.async), waits for its stage t-1 products, releases that
//   stage's ring slot, and meets the other consumers at one named barrier.
//   Three converted slots make that one barrier a stage enough: the slot
//   stage t+1 overwrites was last read by stage t-2, which every consumer
//   had finished before the previous barrier. (A converter warpgroup that
//   ran two stages ahead measured no faster: the traffic above, not the
//   overlap, sets the pace.)
// - Epilogue: forward bf16(bf16(acc) * bf16(scale)), dx bf16(acc), staged in
//   swizzled shared memory and written with 16-byte stores.
// - K slices: the wrapper may cut the contracted axis into slices of whole
//   stages (at most 8), chosen from N and K alone, whose f32 sums are added
//   in slice order. A cluster of blocks, a slice each, fills the card where
//   few output tiles would leave it idle: each block writes its partial tile
//   to its shared memory and, after a cluster barrier, adds its share of the
//   tile over the slices through distributed shared memory before the
//   epilogue. A large M instead lets one 128-column block add the slices
//   itself, in a second register tile, in the same order.
// - So every output sums its contracted axis in one order, stage by stage,
//   k16 step by step and slice by slice, set by N and K only: neither the
//   block width nor the split changes it, and a row gets the same bits
//   whatever the number of rows beside it (a ragged batched prefill gives a
//   prompt the bits it gets alone).
// - N and K must be multiples of 64 (every projection of the SDXL UNet and
//   of LLaMA-2-7B is); M is any positive count.

#include <cooperative_groups.h>

#include <mutex>
#include <unordered_map>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::aligned_smem;
using flash::encode_map_2d;
using flash::fence_regs;
using flash::make_desc;
using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::pack_bf16;
using flash::swizzled;
using flash::tma_load_2d;
using flash::wgmma_commit;
using flash::wgmma_fence;

constexpr int kBM = 128;             // rows of a block: two consumer warpgroups of 64
constexpr int kBK = 64;              // contracted columns of a stage: 128 bytes of bf16
constexpr int kSlots = 3;            // converted bf16 W tiles
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxSlices = 8;        // the portable cluster size
constexpr int kRowBytes = 128;       // a swizzled row: 64 bf16
constexpr int kABox = kBM * kRowBytes;  // the x / g tile of a stage: one 128-row box, 16 KB

// Shared memory of one block, in bytes from a 1024-byte aligned base. The
// epilogue reuses the ring and the slots: the staged bf16 tile (BN / 64
// boxes of 128 rows) or, with slices, the f32 partial tile.
template <int BN>
struct Smem {
  static constexpr int STAGES = BN == 256 ? 4 : 6;  // depth of the TMA ring
  static constexpr int W_RAW = BN * kBK;  // the int8 W tile of a stage
  static constexpr int STAGE = kABox + W_RAW;
  static constexpr int SLOT = BN * kBK * 2;  // a converted bf16 W tile
  static constexpr int SLOTS = STAGES * STAGE;
  static constexpr int BAR = SLOTS + kSlots * SLOT;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + room to align the base
  static constexpr int PART_LD = BN + 8;  // f32 partial row pitch: fewer bank conflicts
  static_assert(kBM * PART_LD * 4 <= BAR, "the partial tile must fit the ring and slots");
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};

struct Params {
  const float* scale;
  __nv_bfloat16* out;
  int m;           // rows
  int cols;        // output columns: N forward, K transposed
  int n_stages;    // contracted / 64
  int per_slice;   // stages of a K slice
  int slices;      // blocks a slice each (a cluster), or 1: one block adds the slices itself
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// 16 int8 as 16 bf16: bytes 0-7 in lo, 8-15 in hi.
__device__ __forceinline__ void int8x16_to_bf16(const uint4 v, uint4& lo, uint4& hi) {
  int8x4_to_bf16x2(v.x, lo.x, lo.y);
  int8x4_to_bf16x2(v.y, lo.z, lo.w);
  int8x4_to_bf16x2(v.z, hi.x, hi.y);
  int8x4_to_bf16x2(v.w, hi.z, hi.w);
}

// bf16(a * s) for the two bf16 values of a (s already a bf16 value as f32).
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t a, float s_lo, float s_hi) {
  const float lo = __uint_as_float(a << 16) * s_lo;  // a bf16 product is exact in f32
  const float hi = __uint_as_float(a & 0xffff0000u) * s_hi;
  return pack_bf16(lo, hi);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define KC_F128(a)                                                                          \
  F64(a), F8(a, 64), F8(a, 72), F8(a, 80), F8(a, 88), F8(a, 96), F8(a, 104), F8(a, 112), \
      F8(a, 120)
#define KC_R128                                                                             \
  R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, " \
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "    \
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
      "%125, %126, %127"

// D(64 x BN) (+)= A(64 x 16) B(16 x BN), both from shared memory with the
// 128-byte swizzle: A K-major; B K-major (TB 0) or MN-major (TB 1).
template <int BN, int TB>
struct Mma;
#define KC_MMA(BN, TB, REGS, FREGS, NA, NB, NACC)                                            \
  template <>                                                                               \
  struct Mma<BN, TB> {                                                                      \
    static __device__ __forceinline__ void run(float (&d)[BN / 2], uint64_t da, uint64_t db, \
                                               int accumulate) {                            \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #NACC ", 0;\n"                      \
                   "wgmma.mma_async.sync.aligned.m64n" #BN "k16.f32.bf16.bf16 {" REGS       \
                   "}, %" #NA ", %" #NB ", p, 1, 1, 0, " #TB ";\n}\n"                        \
                   : FREGS(d)                                                               \
                   : "l"(da), "l"(db), "r"(accumulate));                                    \
    }                                                                                       \
  };
KC_MMA(128, 0, R64, F64, 64, 65, 66)
KC_MMA(128, 1, R64, F64, 64, 65, 66)
KC_MMA(256, 0, KC_R128, KC_F128, 128, 129, 130)
KC_MMA(256, 1, KC_R128, KC_F128, 128, 129, 130)

// Converts the int8 W tile `raw` of a stage into the bf16 slot `dst`, as
// TMA's 128-byte swizzle would have placed a bf16 copy. tid: 0..255.
template <int BN, bool kTrans>
__device__ __forceinline__ void convert_w(const unsigned char* raw, unsigned char* dst, int tid) {
  if (!kTrans) {
    // raw: BN rows (output columns) x 64 bytes; dst: BN rows x 128 bytes. A
    // thread takes 16 int8 (row u / 4, columns 16 (u % 4) ..): eight lanes
    // read 128 contiguous bytes and write two rows' disjoint chunks.
#pragma unroll
    for (int it = 0; it < BN / 64; ++it) {
      const int u = it * kConsumers + tid;
      const int row = u / 4, c = u % 4;
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + u * 16), lo, hi);
      *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * c, 0)) = lo;
      *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * c + 1, 0)) = hi;
    }
  } else {
    // raw: 64 rows (contracted) x BN bytes (output columns); dst: BN / 64
    // boxes of 64 rows x 128 bytes, 8 KB apart. A warp's job is 8 rows x 4
    // chunks of 16 int8: in each eight lanes, four take chunks 8 co + 4 p ..
    // of an even row and four chunks 8 co + 4 (1 - p) .. of the next row, so
    // their loads and their stores fall in disjoint banks.
    constexpr int kOctets = BN / 128;  // 8-chunk groups of a raw row
    constexpr int kJobs = 8 * kOctets * 2;
    const int warp = tid / 32, lane = tid % 32, q = lane % 8, h = q / 4;
#pragma unroll
    for (int i = 0; i < kJobs / (kConsumers / 32); ++i) {
      const int j = i * (kConsumers / 32) + warp;
      const int rg = j % 8, co = (j / 8) % kOctets, pass = j / (8 * kOctets);
      const int row = 8 * rg + 2 * (lane / 8) + h;
      const int c = 8 * co + 4 * (h ^ pass) + q % 4;  // raw chunk: output columns 16 c ..
      uint4 lo, hi;
      int8x16_to_bf16(*reinterpret_cast<const uint4*>(raw + row * BN + c * 16), lo, hi);
      *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * c, kBK * kRowBytes)) = lo;
      *reinterpret_cast<uint4*>(dst + swizzled(row, 2 * c + 1, kBK * kRowBytes)) = hi;
    }
  }
}

// dx only: this warpgroup's 64 rows of the g tile (one swizzled box) times
// bf16(scale) of the stage's contracted columns kc .., rounded to bf16, in
// place. t: the thread within its warpgroup; s0, s1: scale[kc + 8 (t % 8) ..
// + 7], loaded before the stage's conversion so that their latency hides
// behind it.
__device__ __forceinline__ void scale_g(unsigned char* a_tile, const float4 s0, const float4 s1,
                                        int wg, int t) {
  const int c = t % 8;  // contracted columns kc + 8 c .. kc + 8 c + 7
  const float s[8] = {bf16_round(s0.x), bf16_round(s0.y), bf16_round(s0.z), bf16_round(s0.w),
                      bf16_round(s1.x), bf16_round(s1.y), bf16_round(s1.z), bf16_round(s1.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint4* p = reinterpret_cast<uint4*>(a_tile + swizzled(wg * 64 + t / 8 + 16 * j, c, 0));
    uint4 v = *p;
    v.x = scale_bf16x2(v.x, s[0], s[1]);
    v.y = scale_bf16x2(v.y, s[2], s[3]);
    v.z = scale_bf16x2(v.z, s[4], s[5]);
    v.w = scale_bf16x2(v.w, s[6], s[7]);
    *p = v;
  }
}

// Grid (output column tiles of BN, row tiles of 128, K slices), clusters of
// (1, 1, slices) when slices > 1. Forward (kTrans false): a = x (m, k), out =
// y (m, n), contracting k. Transposed: a = g (m, n), out = dx (m, k),
// contracting n. W is (n, k) in both.
template <int BN, bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using L = Smem<BN>;
  constexpr bool kSliced = BN == 128;  // K slices: a second f32 tile in registers
  extern __shared__ unsigned char smem_raw[];
  uint32_t base;
  unsigned char* smem = aligned_smem(smem_raw, base);
  const uint32_t bar_full = base + L::BAR;            // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::STAGES;  // + 8 * stage
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * kBM;
  // this block's stages t0 .. t0 + nk - 1: one slice, or all of them
  const int t0 = blockIdx.z * p.per_slice;
  const int nk = p.slices > 1 ? min(p.n_stages - t0, p.per_slice) : p.n_stages;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // acc[n * 4 + r * 2 + j]: row r * 8 + lane / 4 of the warp's 16, column 8 n + 2 (lane % 4) + j;
  // total: the sum of the finished slices, in slice order
  float acc[BN / 2], total[BN / 2];
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row_in_block = wg * 64 + warp * 16 + lane / 4;

  if (tid >= kConsumers) {
    // The producer warp: one lane keeps the ring full.
    if (tid == kConsumers) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % L::STAGES;
        if (t >= L::STAGES) mbar_wait(bar_empty + 8 * s, (t / L::STAGES - 1) & 1);
        const uint32_t dst = base + s * L::STAGE;
        const int kc = (t0 + t) * kBK;
        mbar_expect_tx(bar_full + 8 * s, L::STAGE);
        tma_load_2d(dst, &tm_a, bar_full + 8 * s, kc, row0);
        if (kTrans) {
          tma_load_2d(dst + kABox, &tm_w, bar_full + 8 * s, col0, kc);
        } else {
          tma_load_2d(dst + kABox, &tm_w, bar_full + 8 * s, kc, col0);
        }
      }
    }
    __syncwarp();
  } else {
    auto prepare = [&](int t) {  // stage t's W into slot t % kSlots; dx: g scaled
      const int s = t % L::STAGES;
      float4 s0, s1;
      if (kTrans) {
        const float* sc = p.scale + (t0 + t) * kBK + 8 * (tid % 8);
        s0 = __ldg(reinterpret_cast<const float4*>(sc));
        s1 = __ldg(reinterpret_cast<const float4*>(sc + 4));
      }
      mbar_wait(bar_full + 8 * s, (t / L::STAGES) & 1);
      convert_w<BN, kTrans>(smem + s * L::STAGE + kABox, smem + L::SLOTS + (t % kSlots) * L::SLOT,
                            tid);
      if (kTrans) scale_g(smem + s * L::STAGE, s0, s1, wg, tid % 128);
      fence_proxy_async();  // the generic stores, visible to wgmma
    };

    prepare(0);
    consumers_sync();
    for (int t = 0; t < nk; ++t) {
      const uint32_t a = base + (t % L::STAGES) * L::STAGE + wg * 64 * kRowBytes;
      const uint32_t b = base + L::SLOTS + (t % kSlots) * L::SLOT;
      const bool first = t % p.per_slice == 0;  // a slice's first stage starts the sum anew
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // B: forward rows of 128 bytes, 16 columns = 32 bytes a step; dx 16
        // rows a step, the 64-column boxes 8 KB apart
        const uint64_t db = kTrans ? make_desc(b + kk * 16 * kRowBytes, kBK * kRowBytes, 1024)
                                   : make_desc(b + kk * 32, 16, 1024);
        Mma<BN, kTrans ? 1 : 0>::run(acc, make_desc(a + kk * 32, 16, 1024), db,
                                     kk > 0 || !first);
      }
      wgmma_commit();
      if (t + 1 < nk) prepare(t + 1);
      if (kSliced && ((t + 1) % p.per_slice == 0 || t + 1 == nk)) {  // a slice ends
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] = t < p.per_slice ? acc[i] : total[i] + acc[i];
      } else {
        wgmma_wait<1>();
        fence_regs(acc);
      }
      if (t > 0) mbar_arrive(bar_empty + 8 * ((t - 1) % L::STAGES));
      consumers_sync();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (kSliced) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = total[i];
    }
    consumers_sync();  // every product is done: the ring and the slots are free

    if (p.slices == 1) {
      // bf16 outputs staged in BN / 64 swizzled boxes of 128 rows, then
      // 16-byte stores of this warpgroup's 64 rows.
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        float s0 = 1.f, s1 = 1.f;
        if (!kTrans && col0 + col < p.cols) {  // cols is a multiple of 64
          s0 = bf16_round(p.scale[col0 + col]);
          s1 = bf16_round(p.scale[col0 + col + 1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v0 = acc[n * 4 + r * 2], v1 = acc[n * 4 + r * 2 + 1];
          if (!kTrans) {
            v0 = bf16_round(v0) * s0;
            v1 = bf16_round(v1) * s1;
          }
          *reinterpret_cast<uint32_t*>(smem + swizzled(row_in_block + 8 * r, n, kABox) +
                                       4 * (lane % 4)) = pack_bf16(v0, v1);
        }
      }
      asm volatile("bar.sync %0, 128;" ::"r"(wg + 2) : "memory");
      for (int idx = tid % 128; idx < 64 * (BN / 8); idx += 128) {
        const int row = wg * 64 + idx / (BN / 8), chunk = idx % (BN / 8);
        if (row0 + row >= p.m || col0 + 8 * chunk >= p.cols) continue;
        *reinterpret_cast<uint4*>(p.out + static_cast<size_t>(row0 + row) * p.cols + col0 +
                                  8 * chunk) =
            *reinterpret_cast<const uint4*>(smem + swizzled(row, chunk, kABox));
      }
      return;
    }
    // The slice's f32 partial tile, row-major with a padded pitch.
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(part + (row_in_block + 8 * r) * L::PART_LD + 8 * n +
                                   2 * (lane % 4)) =
            make_float2(acc[n * 4 + r * 2], acc[n * 4 + r * 2 + 1]);
      }
    }
  }
  if (p.slices == 1) return;  // the producer warp of an unsplit block

  // The slices' partial tiles in distributed shared memory, added in slice
  // order; each block of the cluster finishes every slices-th group of 4
  // columns.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* part = reinterpret_cast<const float*>(smem);
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = rank * kThreads + tid; e < kBM * (BN / 4); e += p.slices * kThreads) {
    const int row = e / (BN / 4), col = 4 * (e % (BN / 4));
    if (row0 + row >= p.m || col0 + col >= p.cols) continue;
    float4 v = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part + row * L::PART_LD + col, 0));
    for (int sl = 1; sl < p.slices; ++sl) {
      const float4 q = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part + row * L::PART_LD + col, sl));
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    if (!kTrans) {
      v.x = bf16_round(v.x) * bf16_round(p.scale[col0 + col]);
      v.y = bf16_round(v.y) * bf16_round(p.scale[col0 + col + 1]);
      v.z = bf16_round(v.z) * bf16_round(p.scale[col0 + col + 2]);
      v.w = bf16_round(v.w) * bf16_round(p.scale[col0 + col + 3]);
    }
    *reinterpret_cast<uint2*>(p.out + static_cast<size_t>(row0 + row) * p.cols + col0 + col) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

// Tensor maps of the int8 weights, built once per (pointer, N, K, form, box).
struct MapKey {
  uintptr_t ptr;
  int n, k, transposed, bn;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && n == o.n && k == o.k && transposed == o.transposed && bn == o.bn;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& key) const {
    size_t h = std::hash<uintptr_t>()(key.ptr);
    h = h * 1000003u ^ static_cast<size_t>(key.n);
    h = h * 1000003u ^ static_cast<size_t>(key.k);
    return (h * 2u + static_cast<size_t>(key.transposed)) * 2u + (key.bn == 256);
  }
};
std::mutex g_maps_mutex;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;
constexpr size_t kMaxCachedMaps = 1 << 16;

CUresult weight_map(CUtensorMap* map, const void* w, int n, int k, int transposed, int bn) {
  const MapKey key{reinterpret_cast<uintptr_t>(w), n, k, transposed, bn};
  std::lock_guard<std::mutex> lock(g_maps_mutex);
  const auto found = g_maps.find(key);
  if (found != g_maps.end()) {
    *map = found->second;
    return CUDA_SUCCESS;
  }
  // forward: boxes of BN rows x 64 columns; dx: 64 rows x BN columns
  const CUresult r = encode_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k, n, k,
                                   transposed ? bn : kBK, transposed ? kBK : bn,
                                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r == CUDA_SUCCESS) {
    if (g_maps.size() >= kMaxCachedMaps) g_maps.clear();
    g_maps.emplace(key, *map);
  }
  return r;
}

template <int BN, bool kTrans>
int launch(const CUtensorMap& ta, const CUtensorMap& tw, const Params& p, cudaStream_t st) {
  constexpr int bytes = Smem<BN>::BYTES;
  static unsigned long long configured = 0;
  cudaError_t err = flash::allow_smem(int8_gemm_kernel<BN, kTrans>, bytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.cols + BN - 1) / BN, (p.m + kBM - 1) / kBM, p.slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.slices;
  cfg.attrs = attr;
  cfg.numAttrs = p.slices > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_kernel<BN, kTrans>, ta, tw, p);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // namespace

// transposed 0: a = x (m, k) bf16, out = y (m, n) bf16; transposed 1: a = g
// (m, n) bf16, out = dx (m, k) bf16. w (n, k) int8, scale (n,) f32. All
// contiguous with 16-byte aligned bases; m >= 1, n and k positive multiples
// of 64, at most 65535 row tiles of 128. bn (128 or 256) is the block's
// output width; the contracted axis is summed in slices of per_slice stages
// of 64 (at most 8), added in slice order, either by one block (split 0; bn
// 128 only, unless there is one slice) or by the blocks of a cluster, a
// slice each (split 1).
// Returns 0, a cudaError_t code, or 1000 + the CUresult of a tensor map that
// could not be encoded.
extern "C" int int8_gemm_bf16(const void* a, const void* w, const void* scale, void* out, int m,
                              int n, int k, int transposed, int bn, int per_slice, int split,
                              void* stream) {
  const int inner = transposed ? n : k;  // a's columns: the contracted axis
  const int n_stages = inner / kBK;
  const int slices = per_slice > 0 ? (n_stages + per_slice - 1) / per_slice : 0;
  if (m < 1 || n < kBK || k < kBK || n % kBK != 0 || k % kBK != 0 ||
      (m + kBM - 1) / kBM > 65535 || (bn != 128 && bn != 256) || slices < 1 ||
      slices > kMaxSlices || (bn == 256 && slices > 1 && !split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (flash::encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread, which an autograd worker thread may not have yet.
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ta, tw;
  CUresult r = encode_map_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, inner, m, inner * 2ull,
                             kBK, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS) r = weight_map(&tw, w, n, k, transposed, bn);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.cols = transposed ? k : n;
  p.n_stages = n_stages;
  p.per_slice = per_slice;
  p.slices = split ? slices : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256) {
    return transposed ? launch<256, true>(ta, tw, p, st) : launch<256, false>(ta, tw, p, st);
  }
  return transposed ? launch<128, true>(ta, tw, p, st) : launch<128, false>(ta, tw, p, st);
}
