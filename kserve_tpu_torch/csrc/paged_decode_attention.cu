// Paged decode attention: one query token per sequence over its KV pages.
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_decode_kernel and, at
// HEAD_DIM=64, :_packed_decode_kernel (the TPU packed two tokens into one
// 128-lane row; Hopper needs no such layout, d=64 is one more instance).
// Its int8-page instance stands for no Pallas kernel: the JAX package runs
// int8 decode through the XLA gather (kserve_tpu/ops/attention.py:
// paged_attention_xla), and this instance computes that function with the
// Pallas kernels' f32 dequant (each staged int8 row times its f32 scale),
// reading half the bytes of a bf16 cache plus 4 B of scale per row.
//
// What bounds it on the H100: bytes.  A decode step reads each live
// sequence's K and V once, sum_b seq_len_b * nkv * d * 2 * 2 B for bf16, at
// 3.35 TB/s, and does ~4 flops per byte read, far below the ~295 flop/byte
// ridge.  So the design reads every KV row exactly once: a CTA owns one
// (sequence, kv head) pair and computes all `group` query heads of that kv
// head from the same staged tile, so GQA costs no extra reads.  Keys stream
// through shared memory in tiles of KT positions with an online softmax in
// f32; a sequence with seq_len 0 (an inactive lane) reads no page and
// writes zeros.  CTAs carry nothing between them and run in any order.
// Not done yet (later work): split-KV across CTAs for long contexts and
// few sequences, cp.async/TMA double buffering of the tiles.
#include "attention_common.cuh"

namespace {

constexpr int DEC_KT = 32;   // keys per staged tile
constexpr int DEC_NT = 128;  // threads per CTA

template <typename T, typename P, int D>
__global__ void __launch_bounds__(DEC_NT) paged_decode_kernel(
    const T* __restrict__ q,            // [B, nq, D]
    const P* __restrict__ pages,        // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,   // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table, // [B, W]
    const int* __restrict__ seq_lens,   // [B]
    T* __restrict__ out,                // [B, nq, D]
    int nq, int nkv, int ps, int W, float scale, float softcap, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nq / nkv;
  const int R = group;
  constexpr int DP = D + 4;
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + DEC_KT * DP;
  float* p_s = v_s + DEC_KT * DP;
  float* acc_s = p_s + R * DEC_KT;
  float* m_s = acc_s + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int seq_len = seq_lens[b];
  const T* qb = q + ((int64_t)b * nq + (int64_t)h * group) * D;
  for (int idx = threadIdx.x; idx < R * D; idx += DEC_NT) {
    float x;
    if constexpr (sizeof(T) == 4) x = qb[idx];
    else x = __bfloat162float(qb[idx]);
    q_s[idx] = x * scale;
    acc_s[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += DEC_NT) {
    m_s[r] = kt::MASKED;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int qpos = seq_len - 1;
  int lo = 0;
  if (window > 0 && seq_len - window > 0) lo = seq_len - window;
  lo = (lo / DEC_KT) * DEC_KT;
  const int* pt = page_table + (int64_t)b * W;
  auto key_ok = [=](int, int kpos) {
    return kpos < seq_len && (window <= 0 || qpos - kpos < window);
  };
  for (int t0 = lo; t0 < seq_len; t0 += DEC_KT) {
    kt::load_kv_tile<P, D, DEC_KT, DEC_NT>(pages, scales, pt, W, nkv, ps, h,
                                           t0, seq_len, k_s, v_s);
    __syncthreads();
    kt::attend_tile<D, DEC_KT, DEC_NT>(R, t0, softcap, q_s, k_s, v_s, p_s,
                                       acc_s, m_s, l_s, a_s, key_ok);
  }

  T* ob = out + ((int64_t)b * nq + (int64_t)h * group) * D;
  for (int idx = threadIdx.x; idx < R * D; idx += DEC_NT) {
    const float l = l_s[idx / D];
    kt::store_out(seq_len > 0 ? acc_s[idx] / fmaxf(l, 1e-30f) : 0.f,
                  ob + idx);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pages, const float* scales,
                   const int* page_table, const int* seq_lens, void* out,
                   int B, int nq, int nkv, int ps, int W, float scale,
                   float softcap, int window, cudaStream_t stream) {
  const int R = nq / nkv;
  const size_t bytes = sizeof(float) * kt::smem_floats<D, DEC_KT>(R);
  auto kernel = paged_decode_kernel<T, P, D>;
  cudaError_t err = kt::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, nkv);
  kernel<<<grid, DEC_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages), scales,
      page_table, seq_lens, static_cast<T*>(out), nq, nkv, ps, W, scale,
      softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  Returns a cudaError_t (0 = launched).
extern "C" int kt_paged_decode_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* seq_lens, void* out, int B, int nq,
    int nkv, int head_dim, int page_size, int W, float scale, float softcap,
    int window, int dtype, int kv_dtype, void* stream) {
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KT_DEC(T, P, D)                                                     \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)     \
  return (int)launch<T, P, D>(q, pages, sc, pt, sl, out, B, nq, nkv,        \
                              page_size, W, scale, softcap, window, s)
  KT_DEC(__nv_bfloat16, __nv_bfloat16, 128);
  KT_DEC(__nv_bfloat16, __nv_bfloat16, 64);
  KT_DEC(float, float, 128);
  KT_DEC(float, float, 64);
  KT_DEC(__nv_bfloat16, int8_t, 128);
  KT_DEC(__nv_bfloat16, int8_t, 64);
  KT_DEC(float, int8_t, 128);
  KT_DEC(float, int8_t, 64);
#undef KT_DEC
  return (int)cudaErrorInvalidValue;
}
