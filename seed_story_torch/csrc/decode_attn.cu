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
// is bound by reading K and V (and the scales) from device memory.
//
// Design (split-KV):
// - Kernel 1, one block of 256 threads per (chunk of keys, KV head, batch
//   row). It loops over tiles of RT query rows (RT = 1, 2, 4 or 8, the
//   smallest power of two that holds the rows, at most 8). Per tile:
//   the rows' queries go to shared memory in f32; each thread computes whole
//   key rows' scores, reading K as 16-byte vectors while every lane of a
//   warp reads the same query element (a shared-memory broadcast); one warp
//   per row takes the chunk's max, exponentials and sum, and writes the
//   bf16-rounded probability times v_scale back; for PV each warp owns one
//   row (and a share of the keys when RT < 8), its lanes read V as 16-byte
//   vectors of 16 (int8) or 8 (bf16) dims, and the key shares are summed
//   with shuffles and through shared memory.
// - A chunk's rows write their partial (max, sum, unnormalized output) in
//   f32; kernel 2, one block per (row, KV head, batch row), merges the
//   chunks. With one chunk kernel 1 writes the output itself. The host picks
//   the chunk so that a call has about two blocks per multiprocessor.
// - Both kernels are one launch of the wrapper: the count and the time of a
//   call include the merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 512;

struct Params {
  const __nv_bfloat16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* q_start;
  const int* kv_len;
  __nv_bfloat16* out;
  float* part_o;   // (B * Hkv, n_chunks, R, 128)
  float* part_ml;  // (B * Hkv, n_chunks, R, 2)
  int hq, hkv, s, c, chunk, n_chunks, rows;
  long long q_sb, q_sh, q_ss;
  long long kv_sb, kv_sh, kv_sc;  // K and V share strides (elements)
  long long sc_sb, sc_sh, sc_sc;  // k_scale and v_scale share strides
  float scale;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of T at p as floats: 16 int8 values or 8 bf16 values.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f);

template <>
__device__ __forceinline__ void load_vec<int8_t>(const int8_t* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[4 * i + 0] = static_cast<float>(static_cast<int32_t>(w[i] << 24) >> 24);
    f[4 * i + 1] = static_cast<float>(static_cast<int32_t>(w[i] << 16) >> 24);
    f[4 * i + 2] = static_cast<float>(static_cast<int32_t>(w[i] << 8) >> 24);
    f[4 * i + 3] = static_cast<float>(static_cast<int32_t>(w[i]) >> 24);
  }
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i + 0] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Keys query row `row` of batch row b may see (clamped to [0, C]).
__device__ __forceinline__ int row_limit(const Params& p, int row, int kv_len, int q_start) {
  if (row >= p.rows) return 0;
  int lim = p.s == 1 ? kv_len : min(q_start + row % p.s + 1, kv_len);
  return max(0, min(lim, p.c));
}

__device__ __forceinline__ size_t out_index(const Params& p, int b, int h, int row, int d) {
  const int group = p.hq / p.hkv;
  const int head = h * group + row / p.s;
  return ((static_cast<size_t>(b) * p.hq + head) * p.s + row % p.s) * kD + d;
}

template <typename T, int RT>
__global__ void __launch_bounds__(kThreads) decode_attn_chunk_kernel(Params p) {
  constexpr int kVecT = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int kSplits = kWarps / RT;   // warps sharing one row's keys in PV
  constexpr int kGroups = kD / kVecT;    // lanes covering one V row
  constexpr int kKeysPerWarp = 32 / kGroups;
  __shared__ __align__(16) float qs[RT][kD];
  __shared__ float sc[RT][kMaxChunk];
  __shared__ __align__(16) float red[kWarps][kD];
  __shared__ float row_m[RT], row_l[RT];

  const int chunk_id = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = p.hq / p.hkv;
  const int kv_len = p.kv_len[b];
  const int q_start = p.q_start[b];
  const int j0 = chunk_id * p.chunk;
  const T* kbase = static_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const float* ksbase = p.k_scale ? p.k_scale + b * p.sc_sb + h * p.sc_sh : nullptr;
  const float* vsbase = p.v_scale ? p.v_scale + b * p.sc_sb + h * p.sc_sh : nullptr;
  const size_t bh = static_cast<size_t>(b) * p.hkv + h;

  for (int rt0 = 0; rt0 < p.rows; rt0 += RT) {
    int lim[RT];
    int jmax = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      lim[r] = row_limit(p, rt0 + r, kv_len, q_start);
      jmax = max(jmax, lim[r]);
    }
    const int nkeys = max(0, min(j0 + p.chunk, jmax) - j0);

    __syncthreads();  // the previous tile is done with shared memory
    for (int i = tid; i < RT * kD; i += kThreads) {
      const int r = i / kD, d = i % kD, row = rt0 + r;
      float val = 0.f;
      if (row < p.rows) {
        const int head = h * group + row / p.s;
        val = __bfloat162float(p.q[b * p.q_sb + head * p.q_sh + (row % p.s) * p.q_ss + d]);
      }
      qs[r][d] = val;
    }
    __syncthreads();

    // scores: one key row per thread
    for (int jj = tid; jj < nkeys; jj += kThreads) {
      const int j = j0 + jj;
      const T* krow = kbase + j * p.kv_sc;
      float dot[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) dot[r] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < kD; d0 += kVecT) {
        float kf[kVecT];
        load_vec<T>(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float s = dot[r];
#pragma unroll
          for (int e = 0; e < kVecT; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(&qs[r][d0 + e]);
            s = fmaf(qv.x, kf[e], s);
            s = fmaf(qv.y, kf[e + 1], s);
            s = fmaf(qv.z, kf[e + 2], s);
            s = fmaf(qv.w, kf[e + 3], s);
          }
          dot[r] = s;
        }
      }
      const float ks = ksbase ? ksbase[j * p.sc_sc] : 1.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) sc[r][jj] = j < lim[r] ? dot[r] * p.scale * ks : -INFINITY;
    }
    __syncthreads();

    // softmax of the chunk: one warp per row
    if (warp < RT) {
      const int r = warp;
      float m = -INFINITY;
      for (int jj = lane; jj < nkeys; jj += 32) m = fmaxf(m, sc[r][jj]);
      m = warp_max(m);
      float l = 0.f;
      for (int jj = lane; jj < nkeys; jj += 32) {
        const float e = m == -INFINITY ? 0.f : expf(sc[r][jj] - m);
        l += e;
        const float vs = vsbase ? vsbase[(j0 + jj) * p.sc_sc] : 1.f;
        sc[r][jj] = bf16_round(e * vs);
      }
      l = warp_sum(l);
      if (lane == 0) {
        row_m[r] = m;
        row_l[r] = l;
      }
    }
    __syncthreads();

    // PV: warp -> (row, key share); lanes -> (key, 16-byte slice of V's row)
    {
      const int r = warp / kSplits, split = warp % kSplits;
      const int g = lane % kGroups, kw = lane / kGroups;
      float acc[kVecT];
#pragma unroll
      for (int e = 0; e < kVecT; ++e) acc[e] = 0.f;
      for (int jj = split * kKeysPerWarp + kw; jj < nkeys; jj += kSplits * kKeysPerWarp) {
        const float pr = sc[r][jj];
        float vf[kVecT];
        load_vec<T>(vbase + (j0 + jj) * p.kv_sc + g * kVecT, vf);
#pragma unroll
        for (int e = 0; e < kVecT; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < kVecT; ++e) {
#pragma unroll
        for (int off = kGroups; off < 32; off <<= 1) {
          acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
        }
      }
      if (kw == 0) {
#pragma unroll
        for (int e = 0; e < kVecT; ++e) red[warp][g * kVecT + e] = acc[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < RT * kD; i += kThreads) {
      const int r = i / kD, d = i % kD, row = rt0 + r;
      if (row >= p.rows) continue;
      float o = 0.f;
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp) o += red[r * kSplits + sp][d];
      if (p.n_chunks == 1) {
        const float l = row_l[r];
        p.out[out_index(p, b, h, row, d)] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
      } else {
        const size_t slot = (bh * p.n_chunks + chunk_id) * p.rows + row;
        p.part_o[slot * kD + d] = o;
        if (d == 0) {
          p.part_ml[slot * 2] = row_m[r];
          p.part_ml[slot * 2 + 1] = row_l[r];
        }
      }
    }
  }
}

// One block per (row, KV head, batch row), one thread per dim: merges the
// chunks' partial max, sum and output.
__global__ void __launch_bounds__(kD) decode_attn_combine_kernel(Params p) {
  const int row = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const size_t base = (static_cast<size_t>(b) * p.hkv + h) * p.n_chunks;
  float m = -INFINITY;
  for (int c = 0; c < p.n_chunks; ++c) m = fmaxf(m, p.part_ml[((base + c) * p.rows + row) * 2]);
  float l = 0.f, o = 0.f;
  if (m != -INFINITY) {
    for (int c = 0; c < p.n_chunks; ++c) {
      const size_t slot = (base + c) * p.rows + row;
      const float mc = p.part_ml[slot * 2];
      if (mc == -INFINITY) continue;
      const float w = expf(mc - m);
      l += w * p.part_ml[slot * 2 + 1];
      o += w * p.part_o[slot * kD + d];
    }
  }
  p.out[out_index(p, b, h, row, d)] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
}

template <typename T, int RT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  decode_attn_chunk_kernel<T, RT><<<dim3(p.n_chunks, p.hkv, batch), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_chunks == 1) return err;
  decode_attn_combine_kernel<<<dim3(p.rows, p.hkv, batch), kD, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const Params& p, int batch, cudaStream_t stream) {
  if (p.rows == 1) return launch<T, 1>(p, batch, stream);
  if (p.rows == 2) return launch<T, 2>(p, batch, stream);
  if (p.rows <= 4) return launch<T, 4>(p, batch, stream);
  return launch<T, 8>(p, batch, stream);
}

}  // namespace

// q (B, Hq, S, 128) bf16 with strides q_s*; k, v (B, Hkv, C, 128) with the
// same strides kv_s* (int8 when kv_int8, else bf16), unit stride on d and
// 16-byte aligned rows; k_scale, v_scale (B, Hkv, C) f32 with strides sc_s*
// (null unless kv_int8); q_start, kv_len (B,) int32; out (B, Hq, S, 128)
// bf16 contiguous; part_o / part_ml f32 scratch of (B * Hkv * n_chunks *
// group * S) x 128 and x 2 (unused when n_chunks == 1). Keys are cut into
// n_chunks chunks of `chunk` (<= 512). Returns a cudaError_t code.
extern "C" int decode_attn(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* q_start, const void* kv_len, void* out,
                           void* part_o, void* part_ml, int batch, int hq, int hkv, int s, int c,
                           int chunk, int n_chunks, int kv_int8, long long q_sb, long long q_sh,
                           long long q_ss, long long kv_sb, long long kv_sh, long long kv_sc,
                           long long sc_sb, long long sc_sh, long long sc_sc, float scale,
                           void* stream) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || s > 8 || c < 1 || chunk < 1 ||
      chunk > kMaxChunk || n_chunks < 1 || static_cast<long long>(chunk) * n_chunks < c ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr))) {
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
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.hq = hq;
  p.hkv = hkv;
  p.s = s;
  p.c = c;
  p.chunk = chunk;
  p.n_chunks = n_chunks;
  p.rows = (hq / hkv) * s;
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
  const cudaError_t err = kv_int8 ? launch_rows<int8_t>(p, batch, st)
                                  : launch_rows<__nv_bfloat16>(p, batch, st);
  return static_cast<int>(err);
}
