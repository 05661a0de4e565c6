// Ragged paged attention over one packed buffer of prompt chunks and decode
// tokens (the step-0 attention of every `mixed` engine step).
//
// Replaces kserve_tpu/ops/pallas_paged_attention.py:_ragged_kernel, both its
// bf16/f32-page form and its int8-page form (`quantized=True`, :450-516).
//
// Contract (docs/kernels.md of the JAX package): the packed query buffer
// [T, nq, d] holds each lane's slice at an offset that is a multiple of
// BQ=8 (q_start), so every BQ-token block belongs to at most ONE lane.
// The slice's own K/V are already written to the pages, so attention reads
// only pages: query j of lane s sits at kv_start[s]+j and sees keys
// 0..kv_start[s]+j (causal), within `window` when window > 0.  Rows past
// q_len, and rows in no slice, are exactly 0.  No host-side metadata: each
// CTA finds its lane by scanning q_start/q_len (B is at most the engine's
// max_batch_size, a few dozen loads), so a call is one launch.
//
// What bounds it on the H100: for a prefill chunk, operations (sum over
// queries of 4 * keys * d * nq flops at 989 TF/s bf16: 8.6 GFLOP for a
// causal 1,024-token chunk of Llama-3-8B); for a pure-decode packing,
// bytes (each lane's live KV read once at 3.35 TB/s).
//
// bf16 q (over bf16 or int8 pages): tensor cores (attention_tc.cuh).
//   - A CTA owns a tile of up to TQ tokens of ONE lane times the GQA group
//     of one kv head: 64 query rows (TQ = 16 at group 4), one m16 slab per
//     warp.  Tile t of the grid is the lane's tile found by a prefix count
//     of ceil(q_len / TQ) over the lanes, the lane's last (longest) tiles
//     first; the grid is a host-side upper bound (T/8 tiles x nkv) and
//     surplus CTAs only zero the padding rows of their 8-token block.
//   - K/V stream through two shared-memory stages of 64 keys (32 at
//     head_dim 256) filled by cp.async while the previous tile is in the
//     MMA; int8 stages are turned into exact bf16 tiles in shared memory,
//     their scales folded into S (K) and P (V) in f32.
//   - At head_dim 256 each warp's O takes 128 registers, so its query
//     fragments are read from shared memory at every k-step instead of
//     held in registers (attention_tc.cuh QSmem).
//   - Key tiles that the causal limit or the window removes whole are not
//     loaded: the range stops at the tile's last valid query and starts at
//     its first query's window; a warp skips the MMA of a tile none of its
//     rows sees.
//   - Output rows go through shared memory to 16-byte stores.
// f32 q (f32 or int8 pages): the first, CUDA-core design in attention_common.cuh
//   (TF32 tensor cores cannot meet the 1e-4 f32 gate): one CTA per 8-token
//   block x kv head, 16-key tiles, f32 online softmax.
// Still left: wgmma with TMA loads and warp specialisation (a producer warp
// feeding consumer warpgroups), 128-row tiles, and split-KV for long
// decode-shaped lanes, which one CTA per (lane, head) still walks alone.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

constexpr int RAG_BQ = 8;    // query tokens per block (the packing unit)
constexpr int RAG_KT = 16;   // keys per staged tile (f32 design)
constexpr int RAG_NT = 128;  // threads per CTA
constexpr int TC_ROWS = 64;  // query rows per tensor-core CTA: 4 warps x 16

// The lane whose slice holds packed row `row` (slices are disjoint), or -1:
// the kernels' own form of the JAX package's _ragged_block_metadata.  Call
// with a whole warp; every lane gets the answer.
__device__ __forceinline__ int slice_owner(const int* __restrict__ q_start,
                                           const int* __restrict__ q_len,
                                           int B, int row) {
  const int lane = threadIdx.x & 31;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int i = b0 + lane;
    bool hit = false;
    if (i < B) {
      const int qn = q_len[i];
      const int qs = q_start[i];
      hit = qn > 0 && qs <= row && row < qs + qn;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (m) return b0 + __ffs(m) - 1;
  }
  return -1;
}

// The lane of tile `t` in the prefix count of ceil(q_len / tq) tiles per
// lane, and the tile's index within the lane; lane -1 past the last tile.
// Call with a whole warp.
__device__ __forceinline__ int2 tile_of(const int* __restrict__ q_len, int B,
                                        int tq, int t) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int i = b0 + lane;
    const int nt = i < B ? (q_len[i] + tq - 1) / tq : 0;
    int inc = nt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int exc = base + inc - nt;
    const unsigned m = __ballot_sync(0xffffffffu, t >= exc && t < exc + nt);
    if (m) {
      const int src = __ffs(m) - 1;
      return make_int2(b0 + src, __shfl_sync(0xffffffffu, t - exc, src));
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  return make_int2(-1, 0);
}

// ---------------------------------------------------------------- f32 q

template <typename T, typename P, int D>
__global__ void __launch_bounds__(RAG_NT) ragged_kernel(
    const T* __restrict__ q,             // [T, nq, D]
    const P* __restrict__ pages,         // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,    // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,  // [B, W]
    const int* __restrict__ q_start,     // [B]
    const int* __restrict__ kv_start,    // [B]
    const int* __restrict__ q_len,       // [B]
    T* __restrict__ out,                 // [T, nq, D]
    int B, int nq, int nkv, int ps, int W, float scale, float softcap,
    int window) {
  extern __shared__ float4 smem4[];
  __shared__ int owner_s;
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

  if (threadIdx.x < 32) {
    const int o = slice_owner(q_start, q_len, B, g * RAG_BQ);
    if (threadIdx.x == 0) owner_s = o;
  }
  __syncthreads();
  const int s_raw = owner_s;
  const int s = s_raw < 0 ? 0 : s_raw;
  const int qoff = s_raw < 0 ? 0 : g * RAG_BQ - q_start[s];
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
cudaError_t launch_f32(const void* q, const void* pages, const float* scales,
                       const int* page_table, const int* q_start,
                       const int* kv_start, const int* q_len, void* out,
                       int B, int G, int nq, int nkv, int ps, int W,
                       float scale, float softcap, int window,
                       cudaStream_t stream) {
  const int R = RAG_BQ * (nq / nkv);
  const size_t bytes = sizeof(float) * kt::smem_floats<D, RAG_KT>(R);
  auto kernel = ragged_kernel<T, P, D>;
  cudaError_t err = kt::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(G, nkv);
  kernel<<<grid, RAG_NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pages), scales,
      page_table, q_start, kv_start, q_len, static_cast<T*>(out), B, nq, nkv,
      ps, W, scale, softcap, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 q

// grid (tiles, nkv, slabs): blockIdx.z takes rows [64z, 64z+64) of the
// tile's tq * group rows (more than one slab only when group > 64 / tq).
// Two CTAs per SM (their shared memory allows two): the bound also keeps
// ptxas from trading registers for spills.
template <typename P, int D>
__global__ void __launch_bounds__(tc::NT, 2) ragged_kernel_tc(
    const __nv_bfloat16* __restrict__ q,  // [T, nq, D]
    const P* __restrict__ pages,          // [P, 2, nkv, ps, D]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ q_start,      // [B]
    const int* __restrict__ kv_start,     // [B]
    const int* __restrict__ q_len,        // [B]
    __nv_bfloat16* __restrict__ out,      // [T, nq, D]
    int B, int G, int tq, int nq, int nkv, int ps, int W, float scale,
    float softcap, int window) {
  using namespace tc;
  constexpr int CS = bf16_stride<D>();
  constexpr int SB = stage_bytes<P, D>();
  constexpr int QCH = D / 8;  // 16-byte chunks of a bf16 head row
  extern __shared__ uint4 smem_tc[];
  char* q_s = reinterpret_cast<char*>(smem_tc);  // [64][CS]; later the output
  char* stages = q_s + TC_ROWS * CS;             // [2][SB]
  char* conv = stages + 2 * SB;                  // int8: [2*KT][CS]
  __shared__ int plan_s[3];  // tile lane, tile index in the lane, block owner

  const int x = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int group = nq / nkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 0) {
    const int2 tile = tile_of(q_len, B, tq, x);
    const int owner = x < G ? slice_owner(q_start, q_len, B, x * RAG_BQ) : -1;
    if (lane == 0) {
      plan_s[0] = tile.x;
      plan_s[1] = tile.y;
      plan_s[2] = owner;
    }
  }
  __syncthreads();

  // padding rows of 8-token block x (in no slice, or past its lane's
  // q_len) are 0, for the heads of kv head h
  if (z == 0 && x < G) {
    const int owner = plan_s[2];
    const int end = owner >= 0 ? q_start[owner] + q_len[owner] : 0;
    for (int idx = threadIdx.x; idx < RAG_BQ * group * QCH; idx += NT) {
      const int r = idx / (group * QCH);
      const int rest = idx - r * (group * QCH);
      const int row = x * RAG_BQ + r;
      if (owner >= 0 && row < end) continue;
      *reinterpret_cast<uint4*>(out + ((int64_t)row * nq + h * group) * D +
                                rest * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int s = plan_s[0];
  if (s < 0) return;
  const int qn = q_len[s];
  const int qs0 = q_start[s];
  const int kv0 = kv_start[s];
  const int j0 = ((qn + tq - 1) / tq - 1 - plan_s[1]) * tq;  // last tiles first
  const int rows_tile = tq * group;
  const int r0 = z * TC_ROWS;
  const int j_lo = j0 + r0 / group;
  const int j_hi = min(j0 + (min(rows_tile, r0 + TC_ROWS) - 1) / group, qn - 1);
  if (r0 >= rows_tile || j_lo > j_hi) return;

  // queries, unscaled bf16; rows that are no query are zero-filled
  for (int idx = threadIdx.x; idx < TC_ROWS * QCH; idx += NT) {
    const int r = idx / QCH;
    const int c = idx - r * QCH;
    const int rr = r0 + r;
    const int j = j0 + rr / group;
    const bool ok = rr < rows_tile && j < qn;
    const __nv_bfloat16* src = q;
    if (ok) src = q + ((int64_t)(qs0 + j) * nq + h * group + rr % group) * D + c * 8;
    cp_async16(smem_addr(q_s + r * CS + c * 16), src, ok);
  }

  int qpos[2];  // positions of this lane's rows g and g+8 of its warp's slab
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int rr = r0 + warp * 16 + (lane >> 2) + 8 * k;
    const int j = j0 + rr / group;
    qpos[k] = (rr < rows_tile && j < qn) ? kv0 + j : -1;
  }
  int qmin, qmax;
  warp_span(qpos, qmin, qmax);

  // key tiles [lo, hi): from the first query's window to the last query
  constexpr int KT = tile_keys<D>();
  const int hi = min(kv0 + j_hi + 1, W * ps);
  int lo = window > 0 ? max(0, kv0 + j_lo - window + 1) : 0;
  lo = (lo / KT) * KT;
  const int n = hi > lo ? (hi - lo + KT - 1) / KT : 0;
  const int* pt = page_table + (int64_t)s * W;

  SlabState<D> st;
  key_loop<P, D, D, KT>(st, q_s, warp * 16, pages, scales, pt, nkv, ps, h, lo,
                        hi, n, stages, conv, 0, 0, qpos, qmin, qmax, window,
                        scale, softcap);

  // normalized rows as bf16 into q_s (every warp is past its last read of
  // the queries: key_loop ends on a barrier)
  st.reduce_l();
  {
    const int g = lane >> 2;
    const int c = lane & 3;
    const float inv0 = st.l[0] > 0.f ? 1.f / st.l[0] : 0.f;
    const float inv1 = st.l[1] > 0.f ? 1.f / st.l[1] : 0.f;
    char* row0 = q_s + (warp * 16 + g) * CS;
    char* row1 = row0 + 8 * CS;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      *reinterpret_cast<uint32_t*>(row0 + (8 * nn + 2 * c) * 2) =
          pack_bf16(st.o[nn][0] * inv0, st.o[nn][1] * inv0);
      *reinterpret_cast<uint32_t*>(row1 + (8 * nn + 2 * c) * 2) =
          pack_bf16(st.o[nn][2] * inv1, st.o[nn][3] * inv1);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TC_ROWS * QCH; idx += NT) {
    const int r = idx / QCH;
    const int c = idx - r * QCH;
    const int rr = r0 + r;
    const int j = j0 + rr / group;
    if (rr >= rows_tile || j >= qn) continue;
    *reinterpret_cast<uint4*>(
        out + ((int64_t)(qs0 + j) * nq + h * group + rr % group) * D + c * 8) =
        *reinterpret_cast<const uint4*>(q_s + r * CS + c * 16);
  }
}

template <typename P, int D>
cudaError_t launch_tc(const void* q, const void* pages, const float* scales,
                      const int* page_table, const int* q_start,
                      const int* kv_start, const int* q_len, void* out,
                      int B, int G, int tq, int tiles, int slabs, int nq,
                      int nkv, int ps, int W, float scale, float softcap,
                      int window, cudaStream_t stream) {
  if (tq <= 0 || tiles <= 0 || slabs <= 0 ||
      tq * (nq / nkv) > slabs * TC_ROWS)
    return cudaErrorInvalidValue;
  constexpr int bytes = tc::smem_bytes<P, D>(TC_ROWS);
  auto kernel = ragged_kernel_tc<P, D>;
  static tc::SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, nkv, slabs);
  kernel<<<grid, tc::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(pages),
      scales, page_table, q_start, kv_start, q_len,
      static_cast<__nv_bfloat16*>(out), B, G, tq, nq, nkv, ps, W, scale,
      softcap, window);
  return cudaGetLastError();
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  T (the buffer length) is a multiple of 8 and G = T / 8.
// tq / tiles / slabs: the bf16-q tile plan (ops/paged_attention_cuda.py
// ragged_launch_plan); the f32 instances ignore them.  Returns a
// cudaError_t (0 = launched).
extern "C" int kt_ragged_paged_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_start, void* out, int B, int G, int tq, int tiles,
    int slabs, int nq, int nkv, int head_dim, int page_size, int W,
    float scale, float softcap, int window, int dtype, int kv_dtype,
    void* stream) {
  if (B <= 0 || G <= 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scales);
  const int* pt = static_cast<const int*>(page_table);
  const int* qs = static_cast<const int*>(q_start);
  const int* ks = static_cast<const int*>(kv_start);
  const int* ql = static_cast<const int*>(q_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KT_RAG_TC(P, D)                                                          \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&              \
      head_dim == D)                                                             \
  return (int)launch_tc<P, D>(q, pages, sc, pt, qs, ks, ql, out, B, G, tq,       \
                              tiles, slabs, nq, nkv, page_size, W, scale,        \
                              softcap, window, st)
#define KT_RAG(T, P, D)                                                      \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch_f32<T, P, D>(q, pages, sc, pt, qs, ks, ql, out, B, G,   \
                                  nq, nkv, page_size, W, scale, softcap,     \
                                  window, st)
  KT_RAG_TC(__nv_bfloat16, 128);
  KT_RAG_TC(__nv_bfloat16, 64);
  KT_RAG_TC(__nv_bfloat16, 256);
  KT_RAG_TC(int8_t, 128);
  KT_RAG_TC(int8_t, 64);
  KT_RAG_TC(int8_t, 256);
  KT_RAG(float, float, 128);
  KT_RAG(float, float, 64);
  KT_RAG(float, float, 256);
  KT_RAG(float, int8_t, 128);
  KT_RAG(float, int8_t, 64);
  KT_RAG(float, int8_t, 256);
#undef KT_RAG
#undef KT_RAG_TC
  return (int)cudaErrorInvalidValue;
}
