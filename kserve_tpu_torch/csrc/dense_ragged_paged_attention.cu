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
// bf16 q (over bf16 or int8 pages):
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
// f32 q (f32 or int8 pages): the first, CUDA-core design in attention_common.cuh
//   (TF32 tensor cores cannot meet the 1e-4 f32 gate): one CTA per (lane,
//   kv head), 16-key tiles, f32 online softmax.
// Still left: TMA loads with a producer warp, and a persistent grid that
// balances splits across SMs instead of the upper-bound grid.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

constexpr int DEN_KT = 16;    // keys per staged tile (f32 design)
constexpr int DEN_NT = 128;   // threads per CTA
constexpr int DEN_ROWS = 16;  // query rows of a tensor-core CTA: one slab
constexpr int DEN_KW = tc::KT / 4;  // keys of a staged tile per warp
constexpr int MAX_SPLITS = 32;  // splits per (lane, kv head, slab), at most

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

// the 4 warps' partial states, folded in shared memory after the key loop
template <int D>
__host__ __device__ constexpr int merge_bytes() { return 4 * DEN_ROWS * (D + 2) * 4; }

// grid (B, nkv * slabs, splits).  Rows of slab zs: rr = 16 zs + r of the
// lane's sp * group rows, token rr / group, head h * group + rr % group.
// Two CTAs per SM at d 128 (their shared memory allows two): the bound
// also keeps ptxas from trading registers for spills.
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
  using namespace tc;
  constexpr int CS = bf16_stride<D>();
  constexpr int SB = stage_bytes<P, D>();
  constexpr int QCH = D / 8;
  static_assert(merge_bytes<D>() <= 2 * SB, "the warps' partials reuse the stages");
  extern __shared__ uint4 smem_tc[];
  char* q_s = reinterpret_cast<char*>(smem_tc);  // [16][CS]
  char* stages = q_s + DEN_ROWS * CS;            // [2][SB]; then the partials
  char* conv = stages + 2 * SB;                  // int8: [2*KT][CS]
  __shared__ int last_s;
  __shared__ float wk_s[DEN_ROWS][MAX_SPLITS];  // the merge's split weights
  __shared__ float inv_s[DEN_ROWS];

  const int b = blockIdx.x;
  const int h = blockIdx.y / slabs;
  const int zs = blockIdx.y - h * slabs;
  const int z = blockIdx.z;
  const int group = nq / nkv;
  const int rows_lane = sp * group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qn = q_len[b];
  const int kv0 = kv_start[b];
  const int64_t row0 = (int64_t)b * sp;
  // global element offset of slab row r (-1: no such row)
  auto out_row = [&](int r) -> int64_t {
    const int rr = zs * DEN_ROWS + r;
    if (rr >= rows_lane) return -1;
    return ((row0 + rr / group) * nq + h * group + rr % group) * (int64_t)D;
  };
  auto is_query = [&](int r) {
    const int rr = zs * DEN_ROWS + r;
    return rr < rows_lane && rr / group < qn;
  };

  // key range [lo, hi) and its splits; a lane with q_len 0 has none
  const int hi = qn > 0 ? min(kv0 + qn, W * ps) : 0;
  int lo = window > 0 ? max(0, kv0 - window + 1) : 0;
  lo = (lo / KT) * KT;
  const int nsp = hi > lo ? min((hi - lo + chunk - 1) / chunk, splits) : 0;
  if (nsp == 0) {  // every row of the slab is 0; nothing is read
    if (z == 0)
      for (int idx = threadIdx.x; idx < DEN_ROWS * D; idx += NT) {
        const int64_t o = out_row(idx / D);
        if (o >= 0) out[o + idx % D] = __float2bfloat16(0.f);
      }
    return;
  }
  if (z >= nsp) return;
  const int s_lo = lo + z * chunk;
  const int s_hi = min(s_lo + chunk, hi);
  const int n = (s_hi - s_lo + KT - 1) / KT;
  const int* pt = page_table + (int64_t)b * W;

  for (int idx = threadIdx.x; idx < DEN_ROWS * QCH; idx += NT) {
    const int r = idx / QCH;
    const int c = idx - r * QCH;
    const bool ok = is_query(r);
    const __nv_bfloat16* src = ok ? q + out_row(r) + c * 8 : q;
    cp_async16(smem_addr(q_s + r * CS + c * 16), src, ok);
  }
  int qpos[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = (lane >> 2) + 8 * k;
    qpos[k] = is_query(r) ? kv0 + (zs * DEN_ROWS + r) / group : -1;
  }
  int qmin, qmax;
  warp_span(qpos, qmin, qmax);

  // each warp takes DEN_KW keys of every staged tile for the slab's rows
  SlabState<D> st;
  key_loop<P, D, DEN_KW>(st, q_s, 0, pages, scales, pt, nkv, ps, h, s_lo, s_hi,
                         n, stages, conv, warp * DEN_KW, qpos, qmin, qmax,
                         window, scale, softcap);

  // fold the 4 warps: each writes its rows' o as [warp][row][D], then
  // (m, l) as [warp][row]
  st.reduce_l();
  float* wo = reinterpret_cast<float*>(stages);
  float* wm = wo + 4 * DEN_ROWS * D;
  float* wl = wm + 4 * DEN_ROWS;
  {
    const int g = lane >> 2;
    const int c = lane & 3;
    float* p0 = wo + (warp * DEN_ROWS + g) * D;
    float* p1 = p0 + 8 * D;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      *reinterpret_cast<float2*>(p0 + 8 * nn + 2 * c) =
          make_float2(st.o[nn][0], st.o[nn][1]);
      *reinterpret_cast<float2*>(p1 + 8 * nn + 2 * c) =
          make_float2(st.o[nn][2], st.o[nn][3]);
    }
    if (c == 0) {
      wm[warp * DEN_ROWS + g] = st.m[0];
      wl[warp * DEN_ROWS + g] = st.l[0];
      wm[warp * DEN_ROWS + g + 8] = st.m[1];
      wl[warp * DEN_ROWS + g + 8] = st.l[1];
    }
  }
  __syncthreads();

  // this CTA's state, 4 floats of a row per step: one split's output, or
  // its partial in scratch (o [slot][split][row][D], then (m, l))
  const int slot = (b * nkv + h) * slabs + zs;
  const int nslots = gridDim.x * gridDim.y;
  float* part_o = partials + (int64_t)slot * splits * DEN_ROWS * D;
  float* part_ml = partials + (int64_t)nslots * splits * DEN_ROWS * D +
                   (int64_t)slot * splits * DEN_ROWS * 2;
  for (int idx = threadIdx.x; idx < DEN_ROWS * D / 4; idx += NT) {
    const int r = idx / (D / 4);
    const int d = (idx - r * (D / 4)) * 4;
    float m = MASKED;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, wm[w * DEN_ROWS + r]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = exp2f(wm[w * DEN_ROWS + r] - m);
      const float4 x = *reinterpret_cast<const float4*>(wo + (w * DEN_ROWS + r) * D + d);
      l += wl[w * DEN_ROWS + r] * wt;
      o.x += x.x * wt;
      o.y += x.y * wt;
      o.z += x.z * wt;
      o.w += x.w * wt;
    }
    if (nsp == 1) {
      const int64_t dst = out_row(r);
      if (dst < 0) continue;
      const float inv = is_query(r) && l > 0.f ? 1.f / l : 0.f;
      *reinterpret_cast<uint2*>(out + dst + d) =
          make_uint2(pack_bf16(o.x * inv, o.y * inv), pack_bf16(o.z * inv, o.w * inv));
    } else {
      *reinterpret_cast<float4*>(part_o + ((int64_t)z * DEN_ROWS + r) * D + d) = o;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + ((int64_t)z * DEN_ROWS + r) * 2) =
            make_float2(m, l);
    }
  }
  if (nsp == 1) return;

  // the last split to arrive merges every split's partial
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(tickets + slot, 1) == nsp - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  {
    // per row: 8 threads fold the splits' (m, l) into each split's weight
    // and the row's 1 / l
    static_assert(DEN_ROWS * 8 == NT, "8 threads per row");
    const int r = threadIdx.x / 8;
    const int sub = threadIdx.x % 8;
    float m = MASKED;
    for (int k = sub; k < nsp; k += 8)
      m = fmaxf(m, __ldcg(part_ml + ((int64_t)k * DEN_ROWS + r) * 2));
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int k = sub; k < nsp; k += 8) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          part_ml + ((int64_t)k * DEN_ROWS + r) * 2));
      const float wt = exp2f(ml.x - m);
      wk_s[r][k] = wt;
      l += ml.y * wt;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (sub == 0) inv_s[r] = is_query(r) && l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  constexpr int CPT = DEN_ROWS * D / 4 / NT;  // float4 chunks per thread
  float4 acc[CPT];
#pragma unroll
  for (int u = 0; u < CPT; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nsp; ++k) {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int r = idx / (D / 4);
      const int d = (idx - r * (D / 4)) * 4;
      const float wt = wk_s[r][k];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          part_o + ((int64_t)k * DEN_ROWS + r) * D + d));
      acc[u].x += x.x * wt;
      acc[u].y += x.y * wt;
      acc[u].z += x.z * wt;
      acc[u].w += x.w * wt;
    }
  }
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int idx = threadIdx.x + u * NT;
    const int r = idx / (D / 4);
    const int d = (idx - r * (D / 4)) * 4;
    const int64_t dst = out_row(r);
    if (dst < 0) continue;
    const float inv = inv_s[r];
    *reinterpret_cast<uint2*>(out + dst + d) = make_uint2(
        pack_bf16(acc[u].x * inv, acc[u].y * inv),
        pack_bf16(acc[u].z * inv, acc[u].w * inv));
  }
  if (threadIdx.x == 0) tickets[slot] = 0;
}

template <typename P, int D>
cudaError_t launch_tc(const void* q, const void* pages, const float* scales,
                      const int* page_table, const int* kv_start,
                      const int* q_len, void* out, float* partials,
                      int* tickets, int B, int sp, int nq, int nkv, int ps,
                      int W, int chunk, int splits, int slabs, float scale,
                      float softcap, int window, cudaStream_t stream) {
  if (partials == nullptr || tickets == nullptr || chunk <= 0 ||
      chunk % tc::KT != 0 || splits <= 0 || splits > MAX_SPLITS || slabs <= 0 ||
      sp * (nq / nkv) > slabs * DEN_ROWS)
    return cudaErrorInvalidValue;
  constexpr int bytes = tc::smem_bytes<P, D>(DEN_ROWS);
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
    int head_dim, int page_size, int W, int chunk, int splits, int slabs,
    float scale, float softcap, int window, int dtype, int kv_dtype,
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
#define KT_DENSE(T, P, D)                                                    \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch_f32<T, P, D>(q, pages, sc, pt, ks, ql, out, B, sp, nq,  \
                                  nkv, page_size, W, scale, softcap, window, \
                                  st)
  KT_DENSE_TC(__nv_bfloat16, 128);
  KT_DENSE_TC(__nv_bfloat16, 64);
  KT_DENSE_TC(int8_t, 128);
  KT_DENSE_TC(int8_t, 64);
  KT_DENSE(float, float, 128);
  KT_DENSE(float, float, 64);
  KT_DENSE(float, int8_t, 128);
  KT_DENSE(float, int8_t, 64);
#undef KT_DENSE
#undef KT_DENSE_TC
  return (int)cudaErrorInvalidValue;
}
