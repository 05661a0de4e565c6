// Ragged paged attention over one packed buffer of prompt chunks and decode
// tokens (the step-0 attention of every `mixed` engine step).
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_ragged_kernel, both its
// bf16/f32-page form and its int8-page form (`quantized=True`, :450-516):
// the int8 instance stages int8 rows and dequantizes each by its f32 scale
// into the same f32 tile, so the softmax and P @ V do not change.  An int8
// row reads half the bytes of a bf16 one plus a 4-byte scale.
//
// Contract (docs/kernels.md of the JAX package): the packed query buffer
// [T, nq, d] holds each lane's slice at an offset that is a multiple of
// BQ=8, so every BQ-token block belongs to ONE lane; block_seq/block_qoff
// name that lane and the block's first offset in its slice (-1 = padding).
// The slice's own K/V are already written to the pages, so attention reads
// only pages: query j of lane s sits at kv_start[s]+j and sees keys
// 0..kv_start[s]+j (causal), within `window` when window > 0.  Rows past
// q_len are exactly 0.
//
// What bounds it on the H100: for a prefill chunk, operations
// (sum over queries of 4 * keys * d * nq flops at 989 TF/s bf16); for a
// pure-decode packing, bytes (each lane's live KV read once at 3.35 TB/s).
// This first design runs the math on CUDA cores in f32, not on the tensor
// cores, so a long prefill chunk sits far from its bound: a CTA owns one
// (block, kv head), stages KT keys of that head at a time in shared memory
// and updates an online softmax for its BQ*group rows (32 for Llama-3-8B),
// so each KV row is read once per block and shared by the GQA group.
// wgmma tiles and split-KV come later.
#include "attention_common.cuh"

namespace {

constexpr int RAG_BQ = 8;    // query tokens per block (the packing unit)
constexpr int RAG_KT = 16;   // keys per staged tile
constexpr int RAG_NT = 128;  // threads per CTA

template <typename T, typename P, int D>
__global__ void __launch_bounds__(RAG_NT) ragged_kernel(
    const T* __restrict__ q,             // [T, nq, D]
    const P* __restrict__ pages,         // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,    // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,  // [B, W]
    const int* __restrict__ block_seq,   // [G]
    const int* __restrict__ block_qoff,  // [G]
    const int* __restrict__ kv_start,    // [B]
    const int* __restrict__ q_len,       // [B]
    T* __restrict__ out,                 // [T, nq, D]
    int nq, int nkv, int ps, int W, float scale, float softcap, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nq / nkv;
  const int R = RAG_BQ * group;  // row r: token r / group, head h*group + r % group
  constexpr int DP = D + 4;
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + RAG_KT * DP;
  float* p_s = v_s + RAG_KT * DP;
  float* acc_s = p_s + R * RAG_KT;
  float* m_s = acc_s + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int s_raw = block_seq[g];
  const int s = s_raw < 0 ? 0 : s_raw;
  const int qoff = block_qoff[g];
  const int kv0 = kv_start[s];
  const int qn = q_len[s];

  for (int idx = threadIdx.x; idx < R * D; idx += RAG_NT) {
    const int r = idx / D;
    const int i = idx % D;
    const int64_t src =
        ((int64_t)(g * RAG_BQ + r / group) * nq + h * group + r % group) * D + i;
    float x;
    if constexpr (sizeof(T) == 4) x = q[src];
    else x = __bfloat162float(q[src]);
    q_s[idx] = x * scale;
    acc_s[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += RAG_NT) {
    m_s[r] = kt::MASKED;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // keys this block needs: positions 0 .. kv0 + min(qoff+BQ, qn) - 1
  const int kv_hi = s_raw < 0 ? 0 : kv0 + min(qoff + RAG_BQ, qn);
  int lo = 0;
  if (window > 0 && kv0 + qoff - window + 1 > 0) lo = kv0 + qoff - window + 1;
  lo = (lo / RAG_KT) * RAG_KT;
  const int* pt = page_table + (int64_t)s * W;
  auto key_ok = [=](int r, int kpos) {
    const int j = qoff + r / group;  // query offset within the slice
    const int qpos = kv0 + j;
    return j < qn && kpos <= qpos && (window <= 0 || qpos - kpos < window);
  };
  for (int t0 = lo; t0 < kv_hi; t0 += RAG_KT) {
    kt::load_kv_tile<P, D, RAG_KT, RAG_NT>(pages, scales, pt, W, nkv, ps, h,
                                           t0, kv_hi, k_s, v_s);
    __syncthreads();
    kt::attend_tile<D, RAG_KT, RAG_NT>(R, t0, softcap, q_s, k_s, v_s, p_s,
                                       acc_s, m_s, l_s, a_s, key_ok);
  }

  for (int idx = threadIdx.x; idx < R * D; idx += RAG_NT) {
    const int r = idx / D;
    const int i = idx % D;
    const bool valid = s_raw >= 0 && qoff + r / group < qn;
    const float l = l_s[r];
    const int64_t dst =
        ((int64_t)(g * RAG_BQ + r / group) * nq + h * group + r % group) * D + i;
    kt::store_out(valid ? acc_s[idx] / fmaxf(l, 1e-30f) : 0.f, out + dst);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pages, const float* scales,
                   const int* page_table, const int* block_seq,
                   const int* block_qoff, const int* kv_start,
                   const int* q_len, void* out, int G, int nq, int nkv,
                   int ps, int W, float scale, float softcap, int window,
                   cudaStream_t stream) {
  const int R = RAG_BQ * (nq / nkv);
  const size_t bytes = sizeof(float) * kt::smem_floats<D, RAG_KT>(R);
  auto kernel = ragged_kernel<T, P, D>;
  cudaError_t err = kt::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(G, nkv);
  kernel<<<grid, RAG_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages), scales,
      page_table, block_seq, block_qoff, kv_start, q_len,
      static_cast<T*>(out), nq, nkv, ps, W, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  T (the buffer length) must be a multiple of 8; G = T / 8.
// Returns a cudaError_t (0 = launched).
extern "C" int kt_ragged_paged_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* block_seq, const void* block_qoff,
    const void* kv_start, const void* q_len, void* out, int G, int nq,
    int nkv, int head_dim, int page_size, int W, float scale, float softcap,
    int window, int dtype, int kv_dtype, void* stream) {
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* bs = static_cast<const int*>(block_seq);
  const int* bo = static_cast<const int*>(block_qoff);
  const int* ks = static_cast<const int*>(kv_start);
  const int* ql = static_cast<const int*>(q_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_RAG(T, P, D)                                                      \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch<T, P, D>(q, pages, sc, pt, bs, bo, ks, ql, out, G, nq,  \
                              nkv, page_size, W, scale, softcap, window, st)
  KT_RAG(__nv_bfloat16, __nv_bfloat16, 128);
  KT_RAG(__nv_bfloat16, __nv_bfloat16, 64);
  KT_RAG(float, float, 128);
  KT_RAG(float, float, 64);
  KT_RAG(__nv_bfloat16, int8_t, 128);
  KT_RAG(__nv_bfloat16, int8_t, 64);
  KT_RAG(float, int8_t, 128);
  KT_RAG(float, int8_t, 64);
#undef KT_RAG
  return (int)cudaErrorInvalidValue;
}
