// Small-query attention over the KV cache for Hopper (sm_90a): the decode
// (one query) and speculative-verify (K + 1 <= 8 queries) passes of the
// LLaMA agent, over a bf16 cache or an int8 cache with per-token scales.
//
// Contract (the plain version, seed_story_torch/ops/attention.py
// decode_attention): q (B, Hq, S, 128) bf16; K / V (B, Hkv, C, 128), int8
// with f32 (B, Hkv, C) scales or bf16 without; kv_len, q_start (B,) int32.
// GQA folds the group into the query rows: row r = g * S + s of KV head h is
// query s of head h * group + g. Query s sees keys j < min(q_start + s + 1,
// kv_len) (for S = 1: j < kv_len); a row that sees no key outputs 0. Scores
// are f32 dots times the softmax scale times k_scale[j]; the softmax is f32;
// probabilities are multiplied by v_scale[j], rounded to bf16, and go
// through PV with f32 sums. Output (B, Hq, S, 128) bf16.
//
// Replaces: no Pallas kernel. The JAX package computes this in plain XLA
// (seed_story_tpu/ops/attention.py:105-172, decode_attention), which reads
// the cache in its stored dtype and applies the int8 scales to the (C,)
// score and probability vectors after the dots, so no dequantized or f32
// copy of the cache exists. Eager PyTorch would materialize one.
//
// What bounds it on an H100: each KV head's cache is read once for at most
// 8 * group query rows, 4 FLOPs per element and row against 1 or 2 bytes: it
// is bound by reading K and V (and the scales) from device memory. What
// keeps a kernel from that bound is the instructions spent per cache byte
// and too few bytes in flight.
//
// Design (split-KV, flash-decoding on mma.sync):
// - Grid: (chunk of keys, KV head, batch row x tile of 16 query rows). A
//   block is 4 warps; warp w takes the chunk's 16-key tiles w, w + 4, ...,
//   each with its own online softmax, so no block barrier runs in the loop.
// - Tensor cores: S = Q K^T and O += P V with mma.sync m16n8k16 bf16 -> f32.
//   The 16 query rows are the A operand of the scores (rows past the tile's
//   own are zero), held in registers for the whole chunk; each 16 keys give
//   two n8 score fragments whose f32 accumulators are, after the
//   softmax, the A operand of PV (P stays in registers). int8 -> bf16 is
//   exact, so K and V enter the products unscaled and the scales apply to
//   the score and probability vectors, as in the plain version.
// - Permuted sums: within each 64-wide slab of the head dim the score mma's
//   k index is bound to dim 16 t + 4 j + (0..3) of step j, so a lane reads
//   16 consecutive int8 bytes (or 16 bf16 values) of its key row, and the
//   PV mma's column n of output tile (q, e) is bound to dim 32 q + 4 n + e,
//   so a lane reads 4 consecutive V bytes of each of its 4 key rows and
//   interleaves them with byte permutes; its output then covers 8
//   consecutive dims per q. int8 -> bf16 by byte permutes into the mantissa
//   of 2^23 and one f32 subtraction.
// - The cache stream stays in flight: each warp keeps a ring of 4 (int8) or
//   3 (bf16) stages (a tile of K, V and both scales) in shared memory,
//   filled by cp.async from every lane, whole rows at a time, and
//   zero-filled past the last visible key; the 16-byte chunks are
//   XOR-swizzled by key so the fragment reads are free of bank conflicts.
//   The loop is bound by latency more than by issue: the score products of
//   a tile run as four independent mma chains (two slabs x two n8
//   fragments). (Computing the next tile's scores between a tile's softmax
//   and its PV measured no faster.)
// - Merges in a fixed order, so the result is bitwise repeatable: the 4
//   warps of a block through shared memory; the (at most 16) chunks of a
//   (batch row, head, row tile) form a thread block cluster and meet in
//   distributed shared memory: after a cluster barrier each block reads
//   every chunk's f32 (max, sum, unnormalized output) in chunk order for
//   its share of the outputs. One launch, no scratch in device memory.
// - Every call takes this kernel, one query row too, so a row's sums do not
//   depend on how many rows share its call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 128;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTile = 16;  // query rows of a block (the mma's M)
constexpr int kMaxChunks = 16;  // a cluster's blocks (Hopper's non-portable limit)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* q_start;
  const int* kv_len;
  __nv_bfloat16* out;
  int hq, hkv, s, c, chunk, n_chunks, rows, row_tiles;
  long long q_sb, q_sh, q_ss;
  long long kv_sb, kv_sh, kv_sc;  // K and V share strides (elements)
  long long sc_sb, sc_sh, sc_sc;  // k_scale and v_scale share strides
  float scale;
};

// Shared-memory stage of one warp: K and V (16 key rows each, swizzled),
// the tile's 16 k scales then 16 v scales.
template <typename T>
struct Stage {
  static constexpr int kKeys = 16;  // keys a stage (32-key int8 stages measured slower)
  static constexpr int kRowBytes = kD * sizeof(T);                     // 128 or 256
  static constexpr int kChunks = kKeys * kRowBytes / 16 / 32;          // K (or V) copies a lane
  static constexpr int kKBytes = kKeys * kRowBytes;
  static constexpr int kVBytes = kKeys * kRowBytes;
  static constexpr int kBytes = kKBytes + kVBytes + 2 * kKeys * 4;    // K, V, k and v scales
  static constexpr int kStages = sizeof(T) == 1 ? 4 : 3;               // 66 or 98 KB a block
};

template <typename T>
constexpr int smem_bytes() {
  return kWarps * Stage<T>::kStages * Stage<T>::kBytes;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The XOR on a K row's 16-byte chunk index: a fragment load pairs keys g
// and g + 1 (int8: chunks 4 sl + t; bf16: 8 sl + 2 t + p), which then sit in
// different banks.
template <typename T>
__device__ __forceinline__ int k_swizzle(int key) {
  return sizeof(T) == 1 ? (key & 1) << 2 : key & 1;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The 4 signed bytes of w as two bf16x2 (bytes 0-1 in lo, 2-3 in hi), exactly.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys query row `row` of batch row b may see (clamped to [0, C]).
__device__ __forceinline__ int row_limit(const Params& p, int row, int kv_len, int q_start) {
  if (row >= p.rows) return 0;
  const int lim = p.s == 1 ? kv_len : min(q_start + row % p.s + 1, kv_len);
  return max(0, min(lim, p.c));
}

__device__ __forceinline__ size_t out_index(const Params& p, int b, int h, int row, int d) {
  const int group = p.hq / p.hkv;
  const int head = h * group + row / p.s;
  return ((static_cast<size_t>(b) * p.hq + head) * p.s + row % p.s) * kD + d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attn_chunk_kernel(Params p) {
  using St = Stage<T>;
  constexpr int kStages = St::kStages;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint16_t qs[kRowTile][kD];  // the tile's query rows (bf16 bits)

  const int chunk_id = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p.row_tiles, rt = blockIdx.z % p.row_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kv_len = p.kv_len[b], q_start = p.q_start[b];
  const int row0 = rt * kRowTile;
  const int lim_g = row_limit(p, row0 + g, kv_len, q_start);
  const int lim_g8 = row_limit(p, row0 + g + 8, kv_len, q_start);
  int jmax = 0;
  for (int r = 0; r < kRowTile; ++r) jmax = max(jmax, row_limit(p, row0 + r, kv_len, q_start));
  const int j0 = chunk_id * p.chunk;
  const int jend = min(j0 + p.chunk, jmax);
  const int n_tiles = jend > j0 ? (jend - j0 + St::kKeys - 1) / St::kKeys : 0;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  const T* kbase = static_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const float* ksbase = kInt8 ? p.k_scale + b * p.sc_sb + h * p.sc_sh : nullptr;
  const float* vsbase = kInt8 ? p.v_scale + b * p.sc_sb + h * p.sc_sh : nullptr;
  uint8_t* ring = smem + warp * kStages * St::kBytes;
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  auto issue = [&](int i) {  // this warp's i-th tile into slot i % kStages
    if (i < mine) {
      const int tile0 = j0 + (warp + i * kWarps) * St::kKeys;
      const uint32_t slot = ring_s + (i % kStages) * St::kBytes;
      // K and V: whole rows, 16-byte chunks swizzled by key (K: to split the
      // two keys a fragment load pairs; V: the four keys a PV fragment reads)
#pragma unroll
      for (int c = 0; c < St::kChunks; ++c) {
        const int lin = c * 32 + lane;
        const int row = lin / (St::kRowBytes / 16), chunk = lin % (St::kRowBytes / 16);
        const int key = tile0 + row;
        const bool ok = key < jend;
        const size_t off = ok ? key * p.kv_sc * sizeof(T) + chunk * 16 : 0;
        cp_async16(slot + row * St::kRowBytes + (chunk ^ k_swizzle<T>(row)) * 16,
                   reinterpret_cast<const uint8_t*>(kbase) + off, ok);
        cp_async16(slot + St::kKBytes + row * St::kRowBytes +
                       (chunk ^ (2 * ((row >> 1) & 3))) * 16,
                   reinterpret_cast<const uint8_t*>(vbase) + off, ok);
      }
      if constexpr (kInt8) {  // the k and v scales of keys lane (and lane + 32 ...)
#pragma unroll
        for (int r = lane; r < St::kKeys; r += 32) {
          const int key = tile0 + r;
          const bool ok = key < jend;
          const uint32_t dst = slot + St::kKBytes + St::kVBytes + r * 4;
          cp_async4(dst, ok ? ksbase + key * p.sc_sc : ksbase, ok);
          cp_async4(dst + St::kKeys * 4, ok ? vsbase + key * p.sc_sc : vsbase, ok);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  // the query rows: loads issued before the cache stream, stored after it
  uint16_t qv[kRowTile * kD / kThreads];
#pragma unroll
  for (int i = 0; i < kRowTile * kD / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x, r = row0 + e / kD;
    qv[i] = 0;
    if (r < p.rows) {
      const int head = h * (p.hq / p.hkv) + r / p.s;
      qv[i] = reinterpret_cast<const uint16_t*>(
          p.q + b * p.q_sb + head * p.q_sh + (r % p.s) * p.q_ss)[e % kD];
    }
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
#pragma unroll
  for (int i = 0; i < kRowTile * kD / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    qs[e / kD][e % kD] = qv[i];
  }
  __syncthreads();
  // A fragments [slab][step]: pairs 2 j, 2 j + 1 of q[row][64 sl + 16 t ..], rows g, g + 8
  uint32_t qa[2][4][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // a0..a3: (row g, pair 2j), (g + 8, 2j), (g, 2j+1), (g + 8, 2j+1)
        const int row = g + 8 * (e % 2), d = 64 * sl + 16 * t + 4 * j + 2 * (e / 2);
        qa[sl][j][e] = *reinterpret_cast<const uint32_t*>(&qs[row][d]);
      }
    }
  }
  const float sc2 = p.scale * kLog2e;  // scores in log2 units: exp2 below

  float acc_o[16][4];  // output tile (q, e) = 4 q + e: rows g / g + 8, dims 32 q + 8 t + e (+ 4)
#pragma unroll
  for (int i = 0; i < 16; ++i) acc_o[i][0] = acc_o[i][1] = acc_o[i][2] = acc_o[i][3] = 0.f;
  float m_g = -INFINITY, m_g8 = -INFINITY, l_g = 0.f, l_g8 = 0.f;

  // scores of tile i: two n8 fragments, keys 8 hf + 2 t + (0, 1) of rows g,
  // g + 8, each summed in two chains (slabs)
  auto scores = [&](int i, float (&sc)[2][4]) {
    const uint8_t* slot = ring + (i % kStages) * St::kBytes;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float part[2][4] = {};
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        // key 8 hf + g, dims 64 sl + 16 t .. + 15: one (int8) or two (bf16) chunks
        const int key = 8 * hf + g;
        const uint8_t* krow = slot + key * St::kRowBytes;
        uint4 kc[2];
        if constexpr (kInt8) {
          kc[0] = *reinterpret_cast<const uint4*>(krow + ((4 * sl + t) ^ k_swizzle<T>(key)) * 16);
        } else {
          kc[0] = *reinterpret_cast<const uint4*>(krow + ((8 * sl + 2 * t) ^ k_swizzle<T>(key)) * 16);
          kc[1] = *reinterpret_cast<const uint4*>(
              krow + ((8 * sl + 2 * t + 1) ^ k_swizzle<T>(key)) * 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0, b1;
          if constexpr (kInt8) {
            const uint32_t wv[4] = {kc[0].x, kc[0].y, kc[0].z, kc[0].w};
            int8x4_to_bf16x2(wv[j], b0, b1);
          } else {
            const uint4 cw = kc[j / 2];
            b0 = (j % 2) ? cw.z : cw.x;
            b1 = (j % 2) ? cw.w : cw.y;
          }
          mma_bf16(part[sl], qa[sl][j], b0, b1);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[hf][e] = part[0][e] + part[1][e];
    }
  };

  // online softmax over tile i (scores in log2 units): its PV A fragment
  // (rows g / g + 8 x keys 2 t (+1) / 8 + 2 t (+1)), the running max and sum
  // updated and the output rescaled
  auto softmax = [&](int i, float (&sc)[2][4], uint32_t (&pa)[4]) {
    const uint8_t* slot = ring + (i % kStages) * St::kBytes;
    const int tile0 = j0 + (warp + i * kWarps) * St::kKeys;
    const float* scl = reinterpret_cast<const float*>(slot + St::kKBytes + St::kVBytes);
    float vs[2][2];
    float mx_g = -INFINITY, mx_g8 = -INFINITY;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 8 * hf + 2 * t + e;
        const int j = tile0 + kk;
        const float f = kInt8 ? sc2 * scl[kk] : sc2;
        vs[hf][e] = kInt8 ? scl[St::kKeys + kk] : 1.f;
        sc[hf][e] = j < lim_g ? sc[hf][e] * f : -INFINITY;
        sc[hf][2 + e] = j < lim_g8 ? sc[hf][2 + e] * f : -INFINITY;
        mx_g = fmaxf(mx_g, sc[hf][e]);
        mx_g8 = fmaxf(mx_g8, sc[hf][2 + e]);
      }
    }
    const float mn_g = fmaxf(m_g, quad_max(mx_g)), mn_g8 = fmaxf(m_g8, quad_max(mx_g8));
    const float al_g = mn_g == -INFINITY ? 1.f : exp2f(m_g - mn_g);
    const float al_g8 = mn_g8 == -INFINITY ? 1.f : exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;
    float ps_g = 0.f, ps_g8 = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float pg[2], pg8[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pg[e] = sc[hf][e] == -INFINITY ? 0.f : exp2f(sc[hf][e] - mn_g);
        pg8[e] = sc[hf][2 + e] == -INFINITY ? 0.f : exp2f(sc[hf][2 + e] - mn_g8);
        ps_g += pg[e];
        ps_g8 += pg8[e];
      }
      pa[2 * hf] = pack_bf16(pg[0] * vs[hf][0], pg[1] * vs[hf][1]);
      pa[2 * hf + 1] = pack_bf16(pg8[0] * vs[hf][0], pg8[1] * vs[hf][1]);
    }
    l_g = l_g * al_g + ps_g;
    l_g8 = l_g8 * al_g8 + ps_g8;
#pragma unroll
    for (int i2 = 0; i2 < 16; ++i2) {
      acc_o[i2][0] *= al_g;
      acc_o[i2][1] *= al_g;
      acc_o[i2][2] *= al_g8;
      acc_o[i2][3] *= al_g8;
    }
  };

  // PV of tile i: V rows 2 t, 2 t + 1 (b0) and 2 t + 8, 2 t + 9 (b1), dims 32 q + 4 g + e
  auto pv = [&](int i, const uint32_t (&pa)[4]) {
    const uint8_t* vt = ring + (i % kStages) * St::kBytes + St::kKBytes;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b0[4], b1[4];
      if constexpr (kInt8) {
        const int off = (((2 * q + g / 4) ^ (2 * t)) * 16) + 4 * (g % 4);
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vt + (2 * t) * 128 + off);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vt + (2 * t + 1) * 128 + off);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(vt + (2 * t + 8) * 128 + off);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(vt + (2 * t + 9) * 128 + off);
        int8x4_to_bf16x2(prmt(w0, w1, 0x5140), b0[0], b0[1]);
        int8x4_to_bf16x2(prmt(w0, w1, 0x7362), b0[2], b0[3]);
        int8x4_to_bf16x2(prmt(w8, w9, 0x5140), b1[0], b1[1]);
        int8x4_to_bf16x2(prmt(w8, w9, 0x7362), b1[2], b1[3]);
      } else {
        const int off = (((4 * q + g / 2) ^ (2 * t)) * 16) + 8 * (g % 2);
        const uint2 w0 = *reinterpret_cast<const uint2*>(vt + (2 * t) * 256 + off);
        const uint2 w1 = *reinterpret_cast<const uint2*>(vt + (2 * t + 1) * 256 + off);
        const uint2 w8 = *reinterpret_cast<const uint2*>(vt + (2 * t + 8) * 256 + off);
        const uint2 w9 = *reinterpret_cast<const uint2*>(vt + (2 * t + 9) * 256 + off);
        b0[0] = prmt(w0.x, w1.x, 0x5410);
        b0[1] = prmt(w0.x, w1.x, 0x7632);
        b0[2] = prmt(w0.y, w1.y, 0x5410);
        b0[3] = prmt(w0.y, w1.y, 0x7632);
        b1[0] = prmt(w8.x, w9.x, 0x5410);
        b1[1] = prmt(w8.x, w9.x, 0x7632);
        b1[2] = prmt(w8.y, w9.y, 0x5410);
        b1[3] = prmt(w8.y, w9.y, 0x7632);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mma_bf16(acc_o[4 * q + e], pa, b0[e], b1[e]);
    }
  };

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // every lane's copies of tile i are in; every lane is done with tile i - 1
    issue(i + kStages - 1);
    float sc[2][4];
    uint32_t pa[4];
    scores(i, sc);
    softmax(i, sc, pa);
    pv(i, pa);
  }
  cp_async_wait<0>();
  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);

  // the 4 warps' (max, sum, output) in shared memory, merged in warp order
  __syncthreads();  // every warp is done with its ring
  constexpr int kOStride = kD + 1;  // a padded row: the fragment stores are free of conflicts
  float* ow = reinterpret_cast<float*>(smem);          // [warp][16 rows][kOStride]
  float* ml = ow + kWarps * kRowTile * kOStride;       // [warp][16 rows][2]
  float* bo = ml + kWarps * kRowTile * 2;              // the block's: [16 rows][kOStride]
  float* bml = bo + kRowTile * kOStride;               // and [16 rows][2]
  {
    float* mine_o = ow + warp * kRowTile * kOStride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 32 * q + 8 * t + e;
        mine_o[g * kOStride + d] = acc_o[4 * q + e][0];
        mine_o[g * kOStride + d + 4] = acc_o[4 * q + e][1];
        mine_o[(g + 8) * kOStride + d] = acc_o[4 * q + e][2];
        mine_o[(g + 8) * kOStride + d + 4] = acc_o[4 * q + e][3];
      }
    }
    if (t == 0) {
      float* mine_ml = ml + warp * kRowTile * 2;
      mine_ml[g * 2] = m_g;
      mine_ml[g * 2 + 1] = l_g;
      mine_ml[(g + 8) * 2] = m_g8;
      mine_ml[(g + 8) * 2 + 1] = l_g8;
    }
  }
  __syncthreads();
  const int n_rows = min(kRowTile, p.rows - row0);
  for (int idx = threadIdx.x; idx < n_rows * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    float m = -INFINITY;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) m = fmaxf(m, ml[(wp * kRowTile + r) * 2]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float mw = ml[(wp * kRowTile + r) * 2];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m);
      l += f * ml[(wp * kRowTile + r) * 2 + 1];
      o += f * ow[(wp * kRowTile + r) * kOStride + d];
    }
    bo[r * kOStride + d] = o;
    if (d == 0) {
      bml[2 * r] = m;
      bml[2 * r + 1] = l;
    }
  }

  // the chunks of the cluster in distributed shared memory, merged in chunk
  // order; each block finishes its share of the outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n_chunks = static_cast<int>(cluster.num_blocks());
  for (int idx = cluster.block_rank() * kThreads + threadIdx.x; idx < n_rows * kD;
       idx += n_chunks * kThreads) {
    const int r = idx / kD, d = idx % kD;
    float mc[kMaxChunks], lc[kMaxChunks], oc[kMaxChunks];  // every load before the first use
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      mc[c] = -INFINITY;
      lc[c] = oc[c] = 0.f;
      if (c < n_chunks) {
        const float* rml = cluster.map_shared_rank(bml, c);
        mc[c] = rml[2 * r];
        lc[c] = rml[2 * r + 1];
        oc[c] = cluster.map_shared_rank(bo, c)[r * kOStride + d];
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) m = fmaxf(m, mc[c]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const float f = mc[c] == -INFINITY ? 0.f : exp2f(mc[c] - m);
      l += f * lc[c];
      o += f * oc[c];
    }
    p.out[out_index(p, b, h, row0 + r, d)] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  static bool smem_set[64] = {};  // once per device; a race sets the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(decode_attn_chunk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
    if (err == cudaSuccess) {  // clusters of more than 8 blocks
      err = cudaFuncSetAttribute(decode_attn_chunk_kernel<T>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    if (dev < 64) smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_chunks, p.hkv, batch * p.row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_chunks;  // the chunks of one (head, row tile) form a cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_attn_chunk_kernel<T>, p);
}

}  // namespace

// q (B, Hq, S, 128) bf16 with strides q_s*; k, v (B, Hkv, C, 128) with the
// same strides kv_s* (int8 when kv_int8, else bf16), unit stride on d and
// 16-byte aligned rows; k_scale, v_scale (B, Hkv, C) f32 with strides sc_s*
// (null unless kv_int8); q_start, kv_len (B,) int32; out (B, Hq, S, 128)
// bf16 contiguous. Keys are cut into n_chunks chunks of `chunk` (a multiple
// of 64), n_chunks <= 16; query rows (group * S) go in tiles of 16.
// Returns a cudaError_t code.
extern "C" int decode_attn(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* q_start, const void* kv_len, void* out,
                           int batch, int hq, int hkv, int s, int c, int chunk, int n_chunks,
                           int kv_int8, long long q_sb, long long q_sh, long long q_ss,
                           long long kv_sb, long long kv_sh, long long kv_sc, long long sc_sb,
                           long long sc_sh, long long sc_sc, float scale, void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || s > 8 || c < 1 || chunk < 1 ||
      chunk % 64 != 0 || n_chunks < 1 || static_cast<long long>(chunk) * n_chunks < c ||
      n_chunks > kMaxChunks || (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.k_scale = kv_int8 ? static_cast<const float*>(k_scale) : nullptr;
  p.v_scale = kv_int8 ? static_cast<const float*>(v_scale) : nullptr;
  p.q_start = static_cast<const int*>(q_start);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hq = hq;
  p.hkv = hkv;
  p.s = s;
  p.c = c;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.rows = (hq / hkv) * s;
  p.row_tiles = (p.rows + kRowTile - 1) / kRowTile;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.kv_sb = kv_sb;
  p.kv_sh = kv_sh;
  p.kv_sc = kv_sc;
  p.sc_sb = sc_sb;
  p.sc_sh = sc_sh;
  p.sc_sc = sc_sc;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kv_int8 ? launch<int8_t>(p, batch, st) : launch<__nv_bfloat16>(p, batch, st);
  return static_cast<int>(err);
}
