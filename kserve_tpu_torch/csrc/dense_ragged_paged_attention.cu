// Dense-stride ragged paged attention: the speculative-verify packing of
// the `mixed_decode` program, where lane i's slice (its last token plus K
// drafts, padded to the stride SP) sits at packed rows i*SP .. i*SP+SP-1,
// so several lanes share one 8-token block of the solo ragged kernel.
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_dense_ragged_kernel,
// both its bf16/f32-page form and its int8-page form (`quantized=True`,
// :583-663): int8 rows are dequantized by their f32 scales as they are
// staged, into the same f32 tile.
//
// Contract: the slice's own K/V are already written to the pages; query j
// of lane i sits at kv_start[i]+j and sees keys 0..kv_start[i]+j (causal),
// within `window` when window > 0.  Rows j >= q_len[i] (stride padding, or
// every row of a lane with q_len 0) are exactly 0.  A lane with q_len 0
// reads no page, whatever its kv_start: an inactive lane, or one starved of
// page capacity mid-dispatch.
//
// What bounds it on the H100: bytes.  A verify round reads each live
// lane's whole KV once for at most SP*group query rows (16 for Llama-3-8B
// at SP 4), about 4*SP*group flops per KV element pair: far below the ~295
// flops per byte where bf16 tensor cores become the limit.  The design is
// the solo kernel's, regrouped: one CTA per (lane, kv head) owns the lane's
// SP*group rows of that head, stages KT keys at a time in shared memory
// (each key row read once and shared by the GQA group) and updates an
// online softmax in f32 on CUDA cores.  B*nkv CTAs (64 for Llama-3-8B at
// batch 8) leave most of the 132 SMs idle on short caches; split-KV and
// cp.async double buffering come later.
#include "attention_common.cuh"

namespace {

constexpr int DEN_KT = 16;   // keys per staged tile
constexpr int DEN_NT = 128;  // threads per CTA

template <typename T, typename P, int D>
__global__ void __launch_bounds__(DEN_NT) dense_ragged_kernel(
    const T* __restrict__ q,             // [B*sp, nq, D]
    const P* __restrict__ pages,         // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,    // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,  // [B, W]
    const int* __restrict__ kv_start,    // [B]
    const int* __restrict__ q_len,       // [B]
    T* __restrict__ out,                 // [B*sp, nq, D]
    int sp, int nq, int nkv, int ps, int W, float scale, float softcap,
    int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = blockIdx.x;
  const int h = blockIdx.y;
  const int group = nq / nkv;
  const int R = sp * group;  // row r: slice token r / group, head h*group + r % group
  constexpr int DP = D + 4;
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + DEN_KT * DP;
  float* p_s = v_s + DEN_KT * DP;
  float* acc_s = p_s + R * DEN_KT;
  float* m_s = acc_s + R * D;
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int kv0 = kv_start[lane];
  const int qn = q_len[lane];
  const int64_t row0 = (int64_t)lane * sp;

  for (int idx = threadIdx.x; idx < R * D; idx += DEN_NT) {
    const int r = idx / D;
    const int i = idx % D;
    const int64_t src = ((row0 + r / group) * nq + h * group + r % group) * D + i;
    float x;
    if constexpr (sizeof(T) == 4) x = q[src];
    else x = __bfloat162float(q[src]);
    q_s[idx] = x * scale;
    acc_s[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += DEN_NT) {
    m_s[r] = kt::MASKED;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // keys this lane needs: positions 0 .. kv0 + qn - 1; none when qn == 0
  // (no page and no scale is read for such a lane)
  const int kv_hi = qn > 0 ? kv0 + qn : 0;
  int lo = 0;
  if (window > 0 && kv0 - window + 1 > 0) lo = kv0 - window + 1;
  lo = (lo / DEN_KT) * DEN_KT;
  const int* pt = page_table + (int64_t)lane * W;
  auto key_ok = [=](int r, int kpos) {
    const int j = r / group;  // query offset within the slice
    const int qpos = kv0 + j;
    return j < qn && kpos <= qpos && (window <= 0 || qpos - kpos < window);
  };
  for (int t0 = lo; t0 < kv_hi; t0 += DEN_KT) {
    kt::load_kv_tile<P, D, DEN_KT, DEN_NT>(pages, scales, pt, W, nkv, ps, h,
                                           t0, kv_hi, k_s, v_s);
    __syncthreads();
    kt::attend_tile<D, DEN_KT, DEN_NT>(R, t0, softcap, q_s, k_s, v_s, p_s,
                                       acc_s, m_s, l_s, a_s, key_ok);
  }

  for (int idx = threadIdx.x; idx < R * D; idx += DEN_NT) {
    const int r = idx / D;
    const int i = idx % D;
    const bool valid = r / group < qn;
    const float l = l_s[r];
    const int64_t dst = ((row0 + r / group) * nq + h * group + r % group) * D + i;
    kt::store_out(valid ? acc_s[idx] / fmaxf(l, 1e-30f) : 0.f, out + dst);
  }
}

template <typename T, typename P, int D>
cudaError_t launch(const void* q, const void* pages, const float* scales,
                   const int* page_table, const int* kv_start,
                   const int* q_len, void* out, int B, int sp, int nq,
                   int nkv, int ps, int W, float scale, float softcap,
                   int window, cudaStream_t stream) {
  const int R = sp * (nq / nkv);
  const size_t bytes = sizeof(float) * kt::smem_floats<D, DEN_KT>(R);
  auto kernel = dense_ragged_kernel<T, P, D>;
  cudaError_t err = kt::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, nkv);
  kernel<<<grid, DEN_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages), scales,
      page_table, kv_start, q_len, static_cast<T*>(out), sp, nq, nkv, ps, W,
      scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  The packed buffer holds B*sp rows; sp divides 8.  Returns a
// cudaError_t (0 = launched).
extern "C" int kt_dense_ragged_paged_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* kv_start, const void* q_len,
    void* out, int B, int sp, int nq, int nkv, int head_dim, int page_size,
    int W, float scale, float softcap, int window, int dtype, int kv_dtype,
    void* stream) {
  if (B <= 0 || sp <= 0 || 8 % sp != 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* ks = static_cast<const int*>(kv_start);
  const int* ql = static_cast<const int*>(q_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_DENSE(T, P, D)                                                    \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch<T, P, D>(q, pages, sc, pt, ks, ql, out, B, sp, nq, nkv, \
                              page_size, W, scale, softcap, window, st)
  KT_DENSE(__nv_bfloat16, __nv_bfloat16, 128);
  KT_DENSE(__nv_bfloat16, __nv_bfloat16, 64);
  KT_DENSE(float, float, 128);
  KT_DENSE(float, float, 64);
  KT_DENSE(__nv_bfloat16, int8_t, 128);
  KT_DENSE(__nv_bfloat16, int8_t, 64);
  KT_DENSE(float, int8_t, 128);
  KT_DENSE(float, int8_t, 64);
#undef KT_DENSE
  return (int)cudaErrorInvalidValue;
}
