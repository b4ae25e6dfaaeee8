// The attention probes' kernels for Hopper (sm_90a): the counterparts of
// the six Pallas kernels of benchmarks/probe_attn_variants.py,
// probe_attn_overhead.py and probe_attn_dma.py. They split an attention
// kernel's time into its parts: the exponentials, one program per head, the
// traffic of attention's I/O. Plain versions:
// seed_story_torch/benchmarks/probe_kernels.py.
//
// Inputs are contiguous bf16 (B, H, S, 64) q, k, v (the packed layout:
// (B, H/2, S, 128), head i of a pair at columns 64 i); outputs bf16 in the
// same layout. Scores and sums are f32; P is rounded to bf16 before PV.
//
// Three templates:
// - probe_attn_online_kernel<Variant, BQ, BKV> replaces `attn`
//   (probe_attn_variants.py:77, body make_kernel :23): full-mask online
//   softmax. Grid (S / BQ, H, B); BQ / 16 warps, each owning 16 query rows
//   whose Q stays in registers as mma A fragments. K and V tiles of BKV
//   keys come through a two-stage cp.async double buffer in shared memory
//   (rows padded to 72 bf16, so fragment reads are free of bank
//   conflicts). S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> f32;
//   S, the running max and sum and O stay in registers, and the S
//   accumulators are P's A fragments. V's B fragments come from
//   ldmatrix.trans. Variants: base = __expf (a multiply by log2 e and
//   ex2.approx), exp2 = the scale times log2 e folded into one FFMA before
//   ex2.approx, noexp = P = scale * S with no max, no MUFU and alpha = 1.
//   The TPU's 256-1024-row blocks do not fit a block's registers; BQ and
//   BKV are 64 or 128.
// - probe_single_pass_kernel<HEADS, PACKED> replaces `single_pass`
//   (probe_attn_overhead.py:48), `single_pass_fused_bh` (:76) and
//   `attn_packed2` (probe_attn_dma.py:51): one block per (b, h), or per
//   head pair (flattened b * h, or the packed layout), as the TPU grid has
//   one program per head or pair. A head's f32 scores (4 MiB at S = 1024)
//   do not fit on chip, so each group of 8 x 16 query rows makes two passes
//   over the keys: pass 1 computes Q K^T and its row max; pass 2 computes
//   Q K^T again, p = exp(s - m), l += sum p in f32 and O += bf16(p) V. That
//   keeps the TPU kernel's one max per row (not an online recurrence).
// - probe_copy_only_kernel replaces `copy_only` (probe_attn_overhead.py:32,
//   probe_attn_dma.py:32): grid of one block per (b, h) head; each thread
//   streams Q and V with 16-byte loads and K into shared memory with
//   16-byte cp.async (the TPU pipeline brings K's block on chip unused),
//   and writes O = bf16(f32(Q) + f32(V)), equal to torch's q + v bit for
//   bit. It moves attention's whole I/O, 3 tensors in and one out.
//
// What bounds them on an H100: attention at d = 64 is 4 S^2 d operations
// a head against 8 S d bytes, so above S ~ 600 the tensor cores bound it
// (989 TFLOP/s); the exponentials (S^2 a head) need ~0.086 ms at
// (2, 10, 4096, 64) on the SFU, about the operations' bound. The copy is
// bound by bytes (3.35 TB/s). The single pass runs on B x H (or half as
// many) blocks of the card's 132 multiprocessors, which is what it probes.
// These kernels are simple and correct first; none is tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kRow = kD + 8;   // a K / V row in shared memory, padded (144 bytes)
constexpr float kLog2e = 1.4426950408889634f;

enum Variant { kBase = 0, kExp2 = 1, kNoExp = 2 };

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lanes 8 i .. 8 i + 7 give the row
// addresses of matrix i; lane (g, t) = (lane / 4, lane % 4) receives
// elements (2 t, g) and (2 t + 1, g) of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of 16 query rows (row0 .. row0 + 15, row stride `stride`),
// all four 16-wide steps of d = 64: a0..a3 = (g, 2t), (g + 8, 2t),
// (g, 2t + 8), (g + 8, 2t + 8) of each step.
__device__ __forceinline__ void load_q(uint32_t (&qa)[4][4], const __nv_bfloat16* q, int stride,
                                       int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = 16 * ks + 2 * t;
    qa[ks][0] = ld32(q + g * stride + c);
    qa[ks][1] = ld32(q + (g + 8) * stride + c);
    qa[ks][2] = ld32(q + g * stride + c + 8);
    qa[ks][3] = ld32(q + (g + 8) * stride + c + 8);
  }
}

// `rows` rows of 64 bf16 (global row stride `stride`) into shared memory
// at `dst` (row stride kRow), 16 bytes a thread and step.
template <int kThreads>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int stride,
                                          int rows) {
  for (int c = threadIdx.x; c < rows * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), col = (c % (kD / 8)) * 8;
    cp_async16(dst + (r * kRow + col) * 2, src + static_cast<size_t>(r) * stride + col);
  }
}

// S = Q K^T for the 16 query rows of a warp against kKeys keys of a K
// tile in shared memory: n-tile n covers keys 8 n .. 8 n + 7; accumulator
// c0, c1 = (row g, keys 8 n + 2t, + 1), c2, c3 = row g + 8.
template <int kKeys>
__device__ __forceinline__ void scores(float (&sc)[kKeys / 8][4], const uint32_t (&qa)[4][4],
                                       const __nv_bfloat16* ks, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const __nv_bfloat16* krow = ks + (8 * n + g) * kRow + 2 * t;
#pragma unroll
    for (int kstep = 0; kstep < 4; ++kstep) {
      mma_bf16(sc[n], qa[kstep], ld32(krow + 16 * kstep), ld32(krow + 16 * kstep + 8));
    }
  }
}

// O += P V: P's A fragments are the score accumulators of n-tiles 2 kk and
// 2 kk + 1, V's B fragments come by ldmatrix.trans from the V tile.
template <int kKeys>
__device__ __forceinline__ void pv(float (&o)[kD / 8][4], const float (&p)[kKeys / 8][4],
                                   uint32_t vs, int lane) {
  const int mat = lane / 8, r = lane % 8;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const int key = 16 * kk + (mat & 1) * 8 + r;
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (key * kRow + 16 * np + (mat >> 1) * 8) * 2);
      mma_bf16(o[2 * np], pa, b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// O / l of a warp's 16 rows to bf16 at `out` (row stride `stride`); l is
// each thread's partial sum of its row (g or g + 8), summed over the quad.
__device__ __forceinline__ void store_o(__nv_bfloat16* out, int stride, const float (&o)[kD / 8][4],
                                        float l_g, float l_g8, int lane) {
  const int g = lane / 4, t = lane % 4;
  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  const float inv_g = 1.f / (l_g == 0.f ? 1.f : l_g);
  const float inv_g8 = 1.f / (l_g8 == 0.f ? 1.f : l_g8);
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(out + g * stride + c) =
        pack_bf16(o[n][0] * inv_g, o[n][1] * inv_g);
    *reinterpret_cast<uint32_t*>(out + (g + 8) * stride + c) =
        pack_bf16(o[n][2] * inv_g8, o[n][3] * inv_g8);
  }
}

template <int kVariant, int kBQ, int kBKV>
__global__ void __launch_bounds__(kBQ * 2) probe_attn_online_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int s, float scale) {
  constexpr int kThreads = kBQ * 2;  // a warp per 16 query rows
  constexpr int kTile = kBKV * kRow;  // bf16 elements of one K or V tile
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [stage][K, V][kBKV][kRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const __nv_bfloat16* kh = k + head * s * kD;
  const __nv_bfloat16* vh = v + head * s * kD;
  const int row0 = blockIdx.x * kBQ + warp * 16;
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  auto load_tile = [&](int j) {  // K and V of key tile j into stage j % 2
    const uint32_t st = smem_s + (j & 1) * 2 * kTile * 2;
    copy_rows<kThreads>(st, kh + static_cast<size_t>(j) * kBKV * kD, kD, kBKV);
    copy_rows<kThreads>(st + kTile * 2, vh + static_cast<size_t>(j) * kBKV * kD, kD, kBKV);
  };

  const int n_tiles = s / kBKV;
  load_tile(0);
  cp_async_commit();
  uint32_t qa[4][4];
  load_q(qa, q + (head * s + row0) * kD, kD, lane);

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_g = -INFINITY, m_g8 = -INFINITY, l_g = 0.f, l_g8 = 0.f;
  const float sc2 = scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();  // an empty group keeps the count uniform
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = smem + (j & 1) * 2 * kTile;
    float sc[kBKV / 8][4];
    scores<kBKV>(sc, qa, ks, lane);

    if constexpr (kVariant == kNoExp) {  // P = scale * S: no max, no exponential
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] *= scale;
        l_g += sc[n][0] + sc[n][1];
        l_g8 += sc[n][2] + sc[n][3];
      }
    } else {
      float mx_g = -INFINITY, mx_g8 = -INFINITY;
      if constexpr (kVariant == kBase) {
#pragma unroll
        for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] *= scale;
        }
      }
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
        mx_g = fmaxf(mx_g, fmaxf(sc[n][0], sc[n][1]));
        mx_g8 = fmaxf(mx_g8, fmaxf(sc[n][2], sc[n][3]));
      }
      // base: the max of scale * S; exp2: of raw S, in log2 units after the fold
      const float f = kVariant == kExp2 ? sc2 : 1.f;
      const float mn_g = fmaxf(m_g, quad_max(mx_g) * f);
      const float mn_g8 = fmaxf(m_g8, quad_max(mx_g8) * f);
      float al_g, al_g8;
      if constexpr (kVariant == kBase) {
        al_g = __expf(m_g - mn_g);
        al_g8 = __expf(m_g8 - mn_g8);
      } else {
        al_g = ex2(m_g - mn_g);
        al_g8 = ex2(m_g8 - mn_g8);
      }
      m_g = mn_g;
      m_g8 = mn_g8;
      float ps_g = 0.f, ps_g8 = 0.f;
#pragma unroll
      for (int n = 0; n < kBKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kVariant == kBase) {
            sc[n][e] = __expf(sc[n][e] - mn_g);
            sc[n][2 + e] = __expf(sc[n][2 + e] - mn_g8);
          } else {
            sc[n][e] = ex2(fmaf(sc[n][e], sc2, -mn_g));
            sc[n][2 + e] = ex2(fmaf(sc[n][2 + e], sc2, -mn_g8));
          }
          ps_g += sc[n][e];
          ps_g8 += sc[n][2 + e];
        }
      }
      l_g = l_g * al_g + ps_g;
      l_g8 = l_g8 * al_g8 + ps_g8;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        acc[n][0] *= al_g;
        acc[n][1] *= al_g;
        acc[n][2] *= al_g8;
        acc[n][3] *= al_g8;
      }
    }
    pv<kBKV>(acc, sc, smem_s + ((j & 1) * 2 * kTile + kTile) * 2, lane);
    __syncthreads();  // the next iteration refills this stage
  }
  store_o(o + (head * s + row0) * kD, kD, acc, l_g, l_g8, lane);
}

constexpr int kSpWarps = 8;    // single pass: 8 x 16 query rows a group
constexpr int kSpKeys = 64;    // keys a tile
constexpr int kSpThreads = 32 * kSpWarps;
constexpr int kSpTile = kSpKeys * kRow;

template <int kHeads, bool kPacked>
__global__ void __launch_bounds__(kSpThreads) probe_single_pass_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int s, float scale) {
  constexpr int kStride = kPacked ? 2 * kD : kD;  // a row of the layout
  __shared__ __align__(16) __nv_bfloat16 smem[2 * 2 * kSpTile];  // [stage][K, V][key][kRow]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n_tiles = s / kSpKeys;

  for (int hi = 0; hi < kHeads; ++hi) {
    // the head's first element: head blockIdx.x * kHeads + hi of the flat
    // (B x H) layout, or half hi of the packed pair blockIdx.x
    const size_t base = kPacked ? static_cast<size_t>(blockIdx.x) * s * kStride + hi * kD
                                : (static_cast<size_t>(blockIdx.x) * kHeads + hi) * s * kD;
    const __nv_bfloat16* kh = k + base;
    const __nv_bfloat16* vh = v + base;

    for (int row0 = warp * 16; row0 - warp * 16 < s; row0 += kSpWarps * 16) {
      const bool active = row0 < s;
      uint32_t qa[4][4];
      if (active) load_q(qa, q + base + static_cast<size_t>(row0) * kStride, kStride, lane);

      // pass 1: the row max of scale * Q K^T over every key tile
      float mx_g = -INFINITY, mx_g8 = -INFINITY;
      copy_rows<kSpThreads>(smem_s, kh, kStride, kSpKeys);
      cp_async_commit();
      for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
          copy_rows<kSpThreads>(smem_s + ((j + 1) & 1) * 2 * kSpTile * 2,
                                kh + static_cast<size_t>(j + 1) * kSpKeys * kStride, kStride,
                                kSpKeys);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (active) {
          float sc[kSpKeys / 8][4];
          scores<kSpKeys>(sc, qa, smem + (j & 1) * 2 * kSpTile, lane);
#pragma unroll
          for (int n = 0; n < kSpKeys / 8; ++n) {
            mx_g = fmaxf(mx_g, fmaxf(sc[n][0], sc[n][1]) * scale);
            mx_g8 = fmaxf(mx_g8, fmaxf(sc[n][2], sc[n][3]) * scale);
          }
        }
        __syncthreads();
      }
      const float m_g = quad_max(mx_g), m_g8 = quad_max(mx_g8);

      // pass 2: p = exp(scale * S - m), l = sum p, O = bf16(p) V
      float acc[kD / 8][4];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      float l_g = 0.f, l_g8 = 0.f;
      copy_rows<kSpThreads>(smem_s, kh, kStride, kSpKeys);
      copy_rows<kSpThreads>(smem_s + kSpTile * 2, vh, kStride, kSpKeys);
      cp_async_commit();
      for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
          const uint32_t st = smem_s + ((j + 1) & 1) * 2 * kSpTile * 2;
          const size_t off = static_cast<size_t>(j + 1) * kSpKeys * kStride;
          copy_rows<kSpThreads>(st, kh + off, kStride, kSpKeys);
          copy_rows<kSpThreads>(st + kSpTile * 2, vh + off, kStride, kSpKeys);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        if (active) {
          float sc[kSpKeys / 8][4];
          scores<kSpKeys>(sc, qa, smem + (j & 1) * 2 * kSpTile, lane);
#pragma unroll
          for (int n = 0; n < kSpKeys / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[n][e] = __expf(sc[n][e] * scale - m_g);
              sc[n][2 + e] = __expf(sc[n][2 + e] * scale - m_g8);
              l_g += sc[n][e];
              l_g8 += sc[n][2 + e];
            }
          }
          pv<kSpKeys>(acc, sc, smem_s + ((j & 1) * 2 * kSpTile + kSpTile) * 2, lane);
        }
        __syncthreads();
      }
      if (active) {
        store_o(o + base + static_cast<size_t>(row0) * kStride, kStride, acc, l_g, l_g8, lane);
      }
    }
  }
}

constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads) probe_copy_only_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, long long head_elems) {
  __shared__ __align__(16) uint4 k_stage[2][kCopyThreads];  // K lands here, unread
  const size_t base = static_cast<size_t>(blockIdx.x) * head_elems;
  const uint4* qh = reinterpret_cast<const uint4*>(q + base);
  const uint4* kh = reinterpret_cast<const uint4*>(k + base);
  const uint4* vh = reinterpret_cast<const uint4*>(v + base);
  uint4* oh = reinterpret_cast<uint4*>(o + base);
  const long long n = head_elems / 8;  // 16-byte units of the head
  int stage = 0;
  for (long long i = threadIdx.x; i < n; i += kCopyThreads, stage ^= 1) {
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(&k_stage[stage][threadIdx.x])),
               kh + i);
    cp_async_commit();
    const uint4 a = qh[i], b = vh[i];
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
    uint32_t ow[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      ow[w] = pack_bf16(fa.x + fb.x, fa.y + fb.y);
    }
    oh[i] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    cp_async_wait<1>();  // the slot written two steps on is free again
  }
  cp_async_wait<0>();
}

template <int kVariant, int kBQ, int kBKV>
cudaError_t launch_online(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                          __nv_bfloat16* o, int b, int h, int s, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * 2 * kBKV * kRow * 2;
  auto kernel = probe_attn_online_kernel<kVariant, kBQ, kBKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(s / kBQ, h, b), kBQ * 2, smem, stream>>>(q, k, v, o, s, scale);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t launch_variant(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                           __nv_bfloat16* o, int b, int h, int s, int block_q, int block_kv,
                           float scale, cudaStream_t stream) {
  if (block_q == 128 && block_kv == 128)
    return launch_online<kVariant, 128, 128>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 128 && block_kv == 64)
    return launch_online<kVariant, 128, 64>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 64 && block_kv == 128)
    return launch_online<kVariant, 64, 128>(q, k, v, o, b, h, s, scale, stream);
  if (block_q == 64 && block_kv == 64)
    return launch_online<kVariant, 64, 64>(q, k, v, o, b, h, s, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Full-mask attention, one of the three variants (0 base, 1 exp2, 2 noexp),
// tiles (block_q, block_kv) in {64, 128}^2; s a multiple of both.
int probe_attn(const void* q, const void* k, const void* v, void* o, int b, int h, int s,
               int variant, int block_q, int block_kv, float scale, void* stream) {
  if (s % block_q || s % block_kv) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kBase: return launch_variant<kBase>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    case kExp2: return launch_variant<kExp2>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    case kNoExp:
      return launch_variant<kNoExp>(qb, kb, vb, ob, b, h, s, block_q, block_kv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The single pass on `blocks` blocks of `heads_per_block` heads (1 or 2),
// in the flat (B x H, S, 64) layout or (packed = 1, two heads a block) the
// (B x H/2, S, 128) one; s a multiple of 64.
int probe_single_pass(const void* q, const void* k, const void* v, void* o, int blocks,
                      int heads_per_block, int packed, int s, float scale, void* stream) {
  if (s % kSpKeys) return cudaErrorInvalidValue;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (packed && heads_per_block == 2) {
    probe_single_pass_kernel<2, true><<<blocks, kSpThreads, 0, st>>>(qb, kb, vb, ob, s, scale);
  } else if (!packed && heads_per_block == 2) {
    probe_single_pass_kernel<2, false><<<blocks, kSpThreads, 0, st>>>(qb, kb, vb, ob, s, scale);
  } else if (!packed && heads_per_block == 1) {
    probe_single_pass_kernel<1, false><<<blocks, kSpThreads, 0, st>>>(qb, kb, vb, ob, s, scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// O = Q + V over `heads` heads of `head_elems` bf16 each (a multiple of 8),
// one block a head; K streamed into shared memory.
int probe_copy_only(const void* q, const void* k, const void* v, void* o, int heads,
                    long long head_elems, void* stream) {
  if (head_elems % 8) return cudaErrorInvalidValue;
  probe_copy_only_kernel<<<heads, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), head_elems);
  return cudaGetLastError();
}

}  // extern "C"
