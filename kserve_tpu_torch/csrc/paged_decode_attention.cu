// Paged decode attention: one query token per sequence over its KV pages.
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_decode_kernel and, at
// HEAD_DIM=64, :_packed_decode_kernel (the TPU packed two tokens into one
// 128-lane row; Hopper needs no such layout, d=64 is one more instance).
// Its int8-page instances stand for no Pallas kernel: the JAX package runs
// int8 decode through the XLA gather (kserve_tpu/ops/attention.py:
// paged_attention_xla), and these instances compute that function with the
// Pallas kernels' f32 dequant (q * scale in f32, K's scale on S's columns
// and V's on P), reading half the bytes of a bf16 cache plus 4 B of scale
// per row.
//
// Contract: causal over [0, seq_len) of the lane's pages, within `window`
// when window > 0; a lane with seq_len 0 (inactive) reads no page and no
// scale and its rows are exactly 0.
//
// What bounds it on the H100: bytes.  A decode step reads each live
// sequence's K and V once, sum_b seq_len_b * nkv * d * 2 * 2 B for bf16, at
// 3.35 TB/s, and does ~4 flops per byte read, far below the ~295 flop/byte
// ridge.  So every KV row is read once (the `group` query heads of a kv
// head share the staged rows), and the rest is latency: a step of 8 lanes
// has 64 (lane, kv head) pairs for 132 SMs, so the keys are split across
// CTAs and each CTA's loads overlap its math.
//
// bf16 q (over bf16 or int8 pages): decode is the dense-stride function at
// stride 1 (one query token at position seq_len - 1), so each CTA is the
// dense kernel's.  At d 64 and 128, tc::split_kv_slab (attention_tc.cuh):
//   - split-KV over (lane, kv head, split): the lane's keys split into
//     chunks of `chunk` keys (ops/paged_attention_cuda.py
//     decode_launch_plan); the grid's split axis is a host-side bound from
//     the page table's width alone and each CTA derives its key range from
//     seq_lens[b] in the kernel (no host sync, no metadata launches);
//     surplus CTAs exit at once;
//   - two cp.async stages of 64 keys, each warp 16 keys of a stage on
//     mma.sync m16n8k16 (bf16 in, f32 accumulate): the group's 4 rows
//     fill 4 of an m16 slab's 16, which costs nothing in a kernel held by
//     its loads; int8 stages become exact bf16 tiles;
//   - the warps' (m, l, o) fold in shared memory, and the last split to
//     take the (lane, kv head) ticket merges the f32 partials in-kernel.
// At d=256 (Gemma-2), s256::split_kv_cta (attention_split256.cuh): one
// persistent CTA per SM takes an equal run of the 64-key tiles of every
// live (lane, kv head), landed by TMA from a producer warp through an
// mbarrier ring; four consumer warps take disjoint keys of each stage on
// transposed mma.sync products (the group's rows are the n of m16n8k16),
// int8 rows dequantized in registers; the runs of a (lane, kv head) merge
// in-kernel in run order.
// f32 q (f32 or int8 pages): the first, CUDA-core design in
// attention_common.cuh (TF32 tensor cores cannot meet the 1e-4 f32 gate):
// one CTA per (lane, kv head), 32-key f32 tiles, f32 online softmax.
// Still left: the d 64/128 instances reach 13-34% of the byte bound at a
// 20 MB step (PERF.md); the d=256 design (TMA ring, persistent grid) is
// the candidate for them.
#include "attention_common.cuh"
#include "attention_split256.cuh"
#include "attention_tc.cuh"

namespace {

// ---------------------------------------------------------------- f32 q

constexpr int DEC_KT = 32;   // keys per staged tile (f32 design)
constexpr int DEC_NT = 128;  // threads per CTA (f32 design)

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
cudaError_t launch_f32(const void* q, const void* pages, const float* scales,
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

// ---------------------------------------------------------------- bf16 q

// grid (B, nkv * slabs, splits): tc::split_kv_slab at stride 1, lane b's
// one query token (none when seq_len is 0) at position seq_len - 1.
template <typename P, int D>
__global__ void __launch_bounds__(tc::NT, 2) paged_decode_kernel_tc(
    const __nv_bfloat16* __restrict__ q,  // [B, nq, D]
    const P* __restrict__ pages,          // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ seq_lens,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, nq, D]
    float* __restrict__ partials,         // o [slots, splits, 16, D], (m, l) [.., 2]
    int* __restrict__ tickets,            // [B*nkv*slabs], zero between calls
    int nq, int nkv, int ps, int W, int chunk, int splits, int slabs,
    float scale, float softcap, int window) {
  extern __shared__ uint4 smem_tc[];
  const int seq_len = seq_lens[blockIdx.x];
  tc::split_kv_slab<P, D>(q, pages, scales, page_table, out, partials, tickets,
                          seq_len > 0 ? 1 : 0, seq_len - 1, 1, nq, nkv, ps, W,
                          chunk, splits, slabs, scale, softcap, window,
                          reinterpret_cast<char*>(smem_tc));
}

template <typename P, int D>
cudaError_t launch_tc(const void* q, const void* pages, const float* scales,
                      const int* page_table, const int* seq_lens, void* out,
                      float* partials, int* tickets, int B, int nq, int nkv,
                      int ps, int W, int chunk, int splits, int slabs,
                      float scale, float softcap, int window,
                      cudaStream_t stream) {
  if (!tc::split_plan_ok<D>(partials, tickets, chunk, splits, slabs, nq / nkv))
    return cudaErrorInvalidValue;
  constexpr int bytes = tc::smem_bytes<P, D>(tc::SLAB_ROWS);
  auto kernel = paged_decode_kernel_tc<P, D>;
  static tc::SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B, nkv * slabs, splits);
  kernel<<<grid, tc::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(pages),
      scales, page_table, seq_lens, static_cast<__nv_bfloat16*>(out), partials,
      tickets, nq, nkv, ps, W, chunk, splits, slabs, scale, softcap, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 q, d=256

// grid (ctas): s256::split_kv_cta at stride 1, lane b's one query token
// (none when seq_len is 0) at position seq_len - 1.
template <typename P>
__global__ void __launch_bounds__(s256::THREADS, 1) paged_decode_kernel_s256(
    const __grid_constant__ CUtensorMap kv_map,  // pages as (D, ps, nkv, 2P)
    const __nv_bfloat16* __restrict__ q,  // [B, nq, 256]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ seq_lens,     // [B]
    __nv_bfloat16* __restrict__ out,      // [B, nq, 256]
    float* __restrict__ partials,         // s256::PART floats per slot
    int* __restrict__ tickets,            // one per (lane, kv head, slab), zero between calls
    int B, int nq, int nkv, int ps, int W, int slabs, int pair_cost, float scale,
    float softcap, int window) {
  extern __shared__ uint4 smem_s256[];
  s256::split_kv_cta<P>(&kv_map, q, scales, page_table, s256::DecodeLanes{seq_lens}, out,
                        partials, tickets, B, 1, nq, nkv, ps, W, slabs, pair_cost, scale,
                        softcap, window, reinterpret_cast<char*>(smem_s256));
}

template <typename P>
cudaError_t launch_s256(const void* q, const void* pages, const float* scales,
                        const int* page_table, const int* seq_lens, void* out,
                        float* partials, int* tickets, int B, int nq, int nkv, int ps,
                        int W, int num_pages, int pair_cost, int ctas, int slabs,
                        float scale, float softcap, int window, cudaStream_t stream) {
  auto kernel = paged_decode_kernel_s256<P>;
  static tc::SmemOptIn opt_in;
  CUtensorMap map;
  const cudaError_t err = s256::prepare<P>(kernel, opt_in, pages, num_pages, nkv, ps, ctas,
                                           slabs, nq / nkv, pair_cost, partials, tickets,
                                           &map);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, s256::THREADS, s256::Smem<P>::ALLOC, stream>>>(
      map, static_cast<const __nv_bfloat16*>(q), scales, page_table, seq_lens,
      static_cast<__nv_bfloat16*>(out), partials, tickets, B, nq, nkv, ps, W, slabs,
      pair_cost, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  partials / tickets / chunk / splits / slabs: the bf16-q
// split plan and its scratch (ops/paged_attention_cuda.py
// decode_launch_plan); the f32 instances ignore them.  Returns a
// cudaError_t (0 = launched).
extern "C" int kt_paged_decode_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* seq_lens, void* out, void* partials,
    void* tickets, int B, int nq, int nkv, int head_dim, int page_size, int W,
    int num_pages, int chunk, int splits, int slabs, float scale, float softcap,
    int window, int dtype, int kv_dtype, void* stream) {
  if (B <= 0 || nkv <= 0 || nq % nkv != 0) return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* sl = static_cast<const int*>(seq_lens);
  float* part = static_cast<float*>(partials);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KT_DEC_TC(P, D)                                                      \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&          \
      head_dim == D)                                                         \
  return (int)launch_tc<P, D>(q, pages, sc, pt, sl, out, part, tk, B, nq,    \
                              nkv, page_size, W, chunk, splits, slabs, scale, \
                              softcap, window, s)
#define KT_DEC_S256(P)                                                         \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&            \
      head_dim == s256::D)                                                     \
  return (int)launch_s256<P>(q, pages, sc, pt, sl, out, part, tk, B, nq, nkv,   \
                             page_size, W, num_pages, chunk, splits, slabs,     \
                             scale, softcap, window, s)
#define KT_DEC(T, P, D)                                                     \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)     \
  return (int)launch_f32<T, P, D>(q, pages, sc, pt, sl, out, B, nq, nkv,    \
                                  page_size, W, scale, softcap, window, s)
  KT_DEC_TC(__nv_bfloat16, 128);
  KT_DEC_TC(__nv_bfloat16, 64);
  KT_DEC_S256(__nv_bfloat16);
  KT_DEC_TC(int8_t, 128);
  KT_DEC_TC(int8_t, 64);
  KT_DEC_S256(int8_t);
  KT_DEC(float, float, 128);
  KT_DEC(float, float, 64);
  KT_DEC(float, float, 256);
  KT_DEC(float, int8_t, 128);
  KT_DEC(float, int8_t, 64);
  KT_DEC(float, int8_t, 256);
#undef KT_DEC
#undef KT_DEC_S256
#undef KT_DEC_TC
  return (int)cudaErrorInvalidValue;
}
