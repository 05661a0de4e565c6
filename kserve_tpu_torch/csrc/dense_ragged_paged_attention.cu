// Dense-stride ragged paged attention: the speculative-verify packing of
// the `mixed_decode` program, where lane i's slice (its last token plus K
// drafts, padded to the stride SP) sits at packed rows i*SP .. i*SP+SP-1,
// so several lanes share one 8-token block of the solo ragged kernel.
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_dense_ragged_kernel,
// both its bf16/f32-page form and its int8-page form (`quantized=True`,
// :583-663).
//
// Contract: the slice's own K/V are already written to the pages; query j
// of lane i sits at kv_start[i]+j and sees keys 0..kv_start[i]+j (causal),
// within `window` when window > 0.  Rows j >= q_len[i] (stride padding, or
// every row of a lane with q_len 0) are exactly 0.  A lane with q_len 0
// reads no page and no scale, whatever its kv_start: an inactive lane, or
// one starved of page capacity mid-dispatch.
//
// What bounds it on the H100: bytes.  A verify round reads each live
// lane's whole KV once for at most SP*group query rows (16 for Llama-3-8B
// at SP 4), about 4*SP*group flops per KV element pair: far below the ~295
// flops per byte where bf16 tensor cores become the limit.  So the cure is
// parallelism over the keys and loads that overlap the math, not faster
// arithmetic.
//
// bf16 q (over bf16 or int8 pages), head_dim 64 and 128:
//   - Split-KV: each (lane, kv head, 16-row slab) splits its key range
//     into chunks of `chunk` keys (128 at Llama-3-8B's 2,048-token tables:
//     ~300 CTAs of 4 warps on the timed verify round, >= 2 per SM); the
//     grid's split axis is a host-side upper bound (the table's keys over
//     the chunk) and surplus CTAs exit at once.
//   - In a CTA, K/V stream through two cp.async stages of 64 keys; each
//     warp takes 16 of them for the slab's 16 rows (one m16 slab: the 16
//     rows of a stride-4 slice at group 4) on the tensor cores, so the
//     rows' fragments are shared and the math costs next to nothing.  The
//     tensor cores are used because the 16 rows are exactly one MMA slab
//     and the P @ V product then needs no per-thread loops; the kernel is
//     held by its loads either way.  int8 stages become exact bf16 tiles,
//     their scales folded into S and P in f32 (attention_tc.cuh).
//   - The 4 warps' (m, l, o) fold in shared memory; with one split that is
//     the output.  Otherwise each split writes its (m, l, o) in f32 to
//     scratch, and the last split to arrive (an atomic ticket per (lane,
//     head, slab) after __threadfence) merges them and resets the ticket:
//     one launch, no host sync.  The ticket buffer is zeroed once by the
//     wrapper; calls that share it must run in stream order.
//   - That CTA, from split bounds to merge, is tc::split_kv_slab
//     (attention_tc.cuh); the decode kernel runs it at stride 1.
// bf16 q, head_dim 256 (Gemma-2): s256::split_kv_cta (attention_split256.cuh),
//   the decode kernel's CTA too: a persistent grid of one CTA per SM, each
//   an equal run of the 64-key tiles of every live (lane, kv head, 8-row
//   slab) (8 rows: a stride-4 slice at group 2); a producer warp lands
//   them by TMA through an mbarrier ring, four consumer warps take
//   disjoint keys of each stage on transposed mma.sync products, int8
//   rows dequantized in registers; the runs of a slab merge in-kernel.
// f32 q (f32 or int8 pages): the first, CUDA-core design in attention_common.cuh
//   (TF32 tensor cores cannot meet the 1e-4 f32 gate): one CTA per (lane,
//   kv head), 16-key tiles, f32 online softmax.
// Still left: the d 64/128 instances on the d=256 design (TMA ring,
// persistent grid) instead of the upper-bound grid.
#include "attention_common.cuh"
#include "attention_split256.cuh"
#include "attention_tc.cuh"

namespace {

constexpr int DEN_KT = 16;   // keys per staged tile (f32 design)
constexpr int DEN_NT = 128;  // threads per CTA (f32 design)

// ---------------------------------------------------------------- f32 q

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
cudaError_t launch_f32(const void* q, const void* pages, const float* scales,
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

// ---------------------------------------------------------------- bf16 q

// grid (B, nkv * slabs, splits): tc::split_kv_slab over the lane's
// q_len / kv_start.  Two CTAs per SM at d 128 (their shared memory allows
// two): the bound also keeps ptxas from trading registers for spills.
template <typename P, int D>
__global__ void __launch_bounds__(tc::NT, 2) dense_ragged_kernel_tc(
    const __nv_bfloat16* __restrict__ q,  // [B*sp, nq, D]
    const P* __restrict__ pages,          // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ kv_start,     // [B]
    const int* __restrict__ q_len,        // [B]
    __nv_bfloat16* __restrict__ out,      // [B*sp, nq, D]
    float* __restrict__ partials,         // o [slots, splits, 16, D], (m, l) [.., 2]
    int* __restrict__ tickets,            // [B*nkv*slabs], zero between calls
    int sp, int nq, int nkv, int ps, int W, int chunk, int splits, int slabs,
    float scale, float softcap, int window) {
  extern __shared__ uint4 smem_tc[];
  tc::split_kv_slab<P, D>(q, pages, scales, page_table, out, partials, tickets,
                          q_len[blockIdx.x], kv_start[blockIdx.x], sp, nq, nkv,
                          ps, W, chunk, splits, slabs, scale, softcap, window,
                          reinterpret_cast<char*>(smem_tc));
}

template <typename P, int D>
cudaError_t launch_tc(const void* q, const void* pages, const float* scales,
                      const int* page_table, const int* kv_start,
                      const int* q_len, void* out, float* partials,
                      int* tickets, int B, int sp, int nq, int nkv, int ps,
                      int W, int chunk, int splits, int slabs, float scale,
                      float softcap, int window, cudaStream_t stream) {
  if (!tc::split_plan_ok<D>(partials, tickets, chunk, splits, slabs, sp * (nq / nkv)))
    return cudaErrorInvalidValue;
  constexpr int bytes = tc::smem_bytes<P, D>(tc::SLAB_ROWS);
  auto kernel = dense_ragged_kernel_tc<P, D>;
  static tc::SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, nkv * slabs, splits);
  kernel<<<grid, tc::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(pages),
      scales, page_table, kv_start, q_len, static_cast<__nv_bfloat16*>(out),
      partials, tickets, sp, nq, nkv, ps, W, chunk, splits, slabs, scale,
      softcap, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 q, d=256

// grid (ctas): s256::split_kv_cta over the lanes' q_len / kv_start.
template <typename P>
__global__ void __launch_bounds__(s256::THREADS, 1) dense_ragged_kernel_s256(
    const __grid_constant__ CUtensorMap kv_map,  // pages as (D, ps, nkv, 2P)
    const __nv_bfloat16* __restrict__ q,  // [B*sp, nq, 256]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ kv_start,     // [B]
    const int* __restrict__ q_len,        // [B]
    __nv_bfloat16* __restrict__ out,      // [B*sp, nq, 256]
    float* __restrict__ partials,         // s256::PART floats per slot
    int* __restrict__ tickets,            // one per (lane, kv head, slab), zero between calls
    int B, int sp, int nq, int nkv, int ps, int W, int slabs, int pair_cost, float scale,
    float softcap, int window) {
  extern __shared__ uint4 smem_s256[];
  s256::split_kv_cta<P>(&kv_map, q, scales, page_table, s256::DenseLanes{kv_start, q_len},
                        out, partials, tickets, B, sp, nq, nkv, ps, W, slabs, pair_cost,
                        scale, softcap, window, reinterpret_cast<char*>(smem_s256));
}

template <typename P>
cudaError_t launch_s256(const void* q, const void* pages, const float* scales,
                        const int* page_table, const int* kv_start, const int* q_len,
                        void* out, float* partials, int* tickets, int B, int sp, int nq,
                        int nkv, int ps, int W, int num_pages, int pair_cost, int ctas,
                        int slabs, float scale, float softcap, int window,
                        cudaStream_t stream) {
  auto kernel = dense_ragged_kernel_s256<P>;
  static tc::SmemOptIn opt_in;
  CUtensorMap map;
  const cudaError_t err = s256::prepare<P>(kernel, opt_in, pages, num_pages, nkv, ps, ctas,
                                           slabs, sp * (nq / nkv), pair_cost, partials,
                                           tickets, &map);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, s256::THREADS, s256::Smem<P>::ALLOC, stream>>>(
      map, static_cast<const __nv_bfloat16*>(q), scales, page_table, kv_start, q_len,
      static_cast<__nv_bfloat16*>(out), partials, tickets, B, sp, nq, nkv, ps, W, slabs,
      pair_cost, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  The packed buffer holds B*sp rows; sp divides 8.
// partials / tickets / chunk / splits / slabs: the bf16-q split plan and
// its scratch (ops/paged_attention_cuda.py dense_launch_plan); the f32
// instances ignore them.  Returns a cudaError_t (0 = launched).
extern "C" int kt_dense_ragged_paged_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* kv_start, const void* q_len,
    void* out, void* partials, void* tickets, int B, int sp, int nq, int nkv,
    int head_dim, int page_size, int W, int num_pages, int chunk, int splits,
    int slabs, float scale, float softcap, int window, int dtype, int kv_dtype,
    void* stream) {
  if (B <= 0 || sp <= 0 || 8 % sp != 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* ks = static_cast<const int*>(kv_start);
  const int* ql = static_cast<const int*>(q_len);
  float* part = static_cast<float*>(partials);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_DENSE_TC(P, D)                                                       \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&             \
      head_dim == D)                                                            \
  return (int)launch_tc<P, D>(q, pages, sc, pt, ks, ql, out, part, tk, B, sp,   \
                              nq, nkv, page_size, W, chunk, splits, slabs,      \
                              scale, softcap, window, st)
#define KT_DENSE_S256(P)                                                      \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&           \
      head_dim == s256::D)                                                    \
  return (int)launch_s256<P>(q, pages, sc, pt, ks, ql, out, part, tk, B, sp,   \
                             nq, nkv, page_size, W, num_pages, chunk, splits,  \
                             slabs, scale, softcap, window, st)
#define KT_DENSE(T, P, D)                                                    \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch_f32<T, P, D>(q, pages, sc, pt, ks, ql, out, B, sp, nq,  \
                                  nkv, page_size, W, scale, softcap, window, \
                                  st)
  KT_DENSE_TC(__nv_bfloat16, 128);
  KT_DENSE_TC(__nv_bfloat16, 64);
  KT_DENSE_S256(__nv_bfloat16);
  KT_DENSE_TC(int8_t, 128);
  KT_DENSE_TC(int8_t, 64);
  KT_DENSE_S256(int8_t);
  KT_DENSE(float, float, 128);
  KT_DENSE(float, float, 64);
  KT_DENSE(float, float, 256);
  KT_DENSE(float, int8_t, 128);
  KT_DENSE(float, int8_t, 64);
  KT_DENSE(float, int8_t, 256);
#undef KT_DENSE
#undef KT_DENSE_S256
#undef KT_DENSE_TC
  return (int)cudaErrorInvalidValue;
}
