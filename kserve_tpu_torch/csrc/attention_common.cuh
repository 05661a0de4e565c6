// Shared pieces of the paged-attention kernels: 16-byte row loads from
// the page-major cache into f32 shared memory, and one online-softmax step
// over a tile of KT keys for R query rows.
//
// Cache layout (the JAX package's, unchanged): pages [P, 2, nkv, ps, d],
// K at index 0 and V at index 1 of the second axis, page 0 the null page.
// Pages are f32 or bf16 (the q dtype) or, with int8 KV, int8 with one f32
// scale per row in scales [P, 2, nkv, ps]: a staged int8 row is
// dequantized to q * scale in f32 (the Pallas kernels' `k * s[..., None]`),
// so the tile in shared memory is f32 whatever the page type.
// Every CTA owns the R query rows of ONE kv head, so the K/V rows it
// stages are shared by the whole GQA group.
//
// Shared-memory state of a CTA (all f32):
//   q_s   [R][D]       queries, pre-multiplied by the softmax scale
//   k_s   [KT][D+4]    key tile (rows padded: conflict-free float4 reads)
//   v_s   [KT][D+4]    value tile
//   p_s   [R][KT]      scores, then probabilities
//   acc_s [R][D]       running sum of p * V
//   m_s, l_s, a_s [R]  running max, running denominator, rescale factor
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kt {

// a masked score; exp(MASKED - m) is never taken, masked keys weigh 0
constexpr float MASKED = -1e30f;

// element-type codes of the C entry points: q/out take 0 or 1, pages any
template <typename T> struct DtypeCode;
template <> struct DtypeCode<float> { static constexpr int value = 0; };
template <> struct DtypeCode<__nv_bfloat16> { static constexpr int value = 1; };
template <> struct DtypeCode<int8_t> { static constexpr int value = 2; };

// whether the (q dtype, page dtype, scales) triple names an instance
template <typename T, typename P>
inline bool is_instance(int dtype, int kv_dtype, const void* scales) {
  return dtype == DtypeCode<T>::value && kv_dtype == DtypeCode<P>::value &&
         (scales != nullptr) == std::is_same<P, int8_t>::value;
}

__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// 16 int8 values, each times the row's f32 scale
__device__ __forceinline__ void load_vec_scaled(const int8_t* src, float* dst,
                                                float s) {
  const int4 u = *reinterpret_cast<const int4*>(src);
  const char4* c = reinterpret_cast<const char4*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dst[4 * j] = static_cast<float>(c[j].x) * s;
    dst[4 * j + 1] = static_cast<float>(c[j].y) * s;
    dst[4 * j + 2] = static_cast<float>(c[j].z) * s;
    dst[4 * j + 3] = static_cast<float>(c[j].w) * s;
  }
}

__device__ __forceinline__ void store_out(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_out(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

template <typename T>
struct VecOf { static constexpr int n = 16 / sizeof(T); };

// Stage keys/values [lo, lo+KT) of kv head `h` for the sequence whose page
// table row is `pt` (W entries).  Positions at or past `hi`, or past the
// table, are zero-filled: the mask drops them, zeros keep NaN out, and
// their scales are never read.  `scales` is used for int8 pages only (one
// scalar load per 16-value vector: 4 B per row need no vector alignment).
template <typename P, int D, int KT, int NT>
__device__ __forceinline__ void load_kv_tile(
    const P* __restrict__ pages, const float* __restrict__ scales,
    const int* __restrict__ pt, int W, int nkv, int ps, int h, int lo,
    int hi, float* k_s, float* v_s) {
  constexpr int V = VecOf<P>::n;
  constexpr int DP = D + 4;
  constexpr int PER_ROW = D / V;
  for (int idx = threadIdx.x; idx < 2 * KT * PER_ROW; idx += NT) {
    const int kv = idx / (KT * PER_ROW);
    const int rem = idx % (KT * PER_ROW);
    const int t = rem / PER_ROW;
    const int c = (rem % PER_ROW) * V;
    float* dst = (kv == 0 ? k_s : v_s) + t * DP + c;
    const int pos = lo + t;
    const int slot_page = pos / ps;
    if (pos < hi && slot_page < W) {
      const int64_t page = pt[slot_page];
      const int64_t row = ((page * 2 + kv) * nkv + h) * (int64_t)ps + (pos % ps);
      if constexpr (std::is_same<P, int8_t>::value) {
        load_vec_scaled(pages + row * D + c, dst, scales[row]);
      } else {
        load_vec(pages + row * D + c, dst);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = 0.f;
    }
  }
}

// One online-softmax step over the staged tile for R rows.  `key_ok(r,
// kpos)` is the caller's mask (causal/length, validity, window); kpos is
// the absolute key position lo + t.  Ends with the tile folded into
// acc_s/l_s/m_s; callers __syncthreads() before restaging the tile.
template <int D, int KT, int NT, typename Mask>
__device__ __forceinline__ void attend_tile(
    int R, int lo, float softcap, const float* q_s, const float* k_s,
    const float* v_s, float* p_s, float* acc_s, float* m_s, float* l_s,
    float* a_s, Mask key_ok) {
  constexpr int DP = D + 4;
  // scores: one (row, key) pair per thread, float4 over d
  for (int pair = threadIdx.x; pair < R * KT; pair += NT) {
    const int r = pair / KT;
    const int t = pair % KT;
    const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
    const float4* kr = reinterpret_cast<const float4*>(k_s + t * DP);
    float s = 0.f;
#pragma unroll 8
    for (int i = 0; i < D / 4; ++i) {
      const float4 a = qr[i];
      const float4 b = kr[i];
      s += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    p_s[pair] = key_ok(r, lo + t) ? s : MASKED;
  }
  __syncthreads();
  // online softmax: one thread per row
  for (int r = threadIdx.x; r < R; r += NT) {
    float* pr = p_s + r * KT;
    const float m_old = m_s[r];
    float m_new = m_old;
    for (int t = 0; t < KT; ++t) m_new = fmaxf(m_new, pr[t]);
    float sum = 0.f;
    for (int t = 0; t < KT; ++t) {
      const float s = pr[t];
      const float p = (s == MASKED) ? 0.f : expf(s - m_new);
      pr[t] = p;
      sum += p;
    }
    const float alpha = expf(m_old - m_new);
    a_s[r] = alpha;
    l_s[r] = l_s[r] * alpha + sum;
    m_s[r] = m_new;
  }
  __syncthreads();
  // acc = acc * alpha + P @ V
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D;
    const int i = idx % D;
    const float* pr = p_s + r * KT;
    float a = acc_s[idx] * a_s[r];
#pragma unroll
    for (int t = 0; t < KT; ++t) a += pr[t] * v_s[t * DP + i];
    acc_s[idx] = a;
  }
  __syncthreads();
}

// Dynamic shared memory (floats) of one CTA.
template <int D, int KT>
constexpr int smem_floats(int R) {
  return R * D + 2 * KT * (D + 4) + R * KT + R * D + 3 * R;
}

// Allow more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace kt
