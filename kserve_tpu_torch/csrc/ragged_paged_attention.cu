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
// causal 1,024-token chunk of Llama-3-8B, 33.8 GFLOP (0.0342 ms) for
// Gemma-2-2B's served chunk at positions 3,700-4,723 with its 4,096-token
// window); for a pure-decode packing, bytes (each lane's live KV read once
// at 3.35 TB/s).  The d=256 design's split partials add bytes that the
// function itself does not move: f32 (m, l, o) of each query row of a
// split tile, written once and read back once, 2 x 1,032 B per row and
// split (the served chunk: about 2 x 40 MB, mostly in the 50 MB L2, 24 us
// if it all went to HBM).
//
// bf16 q, head_dim 64 and 128 (over bf16 or int8 pages): tensor cores
// (attention_tc.cuh).
//   - A CTA owns a tile of up to TQ tokens of ONE lane times the GQA group
//     of one kv head: 64 query rows (TQ = 16 at group 4), one m16 slab per
//     warp.  Tile t of the grid is the lane's tile found by a prefix count
//     of ceil(q_len / TQ) over the lanes, the lane's last (longest) tiles
//     first; the grid is a host-side upper bound (T/8 tiles x nkv) and
//     surplus CTAs only zero the padding rows of their 8-token block.
//   - K/V stream through two shared-memory stages of 64 keys filled by
//     cp.async while the previous tile is in the MMA; int8 stages are
//     turned into exact bf16 tiles in shared memory, their scales folded
//     into S (K) and P (V) in f32.
//   - Key tiles that the causal limit or the window removes whole are not
//     loaded: the range stops at the tile's last valid query and starts at
//     its first query's window; a warp skips the MMA of a tile none of its
//     rows sees.
//   - Output rows go through shared memory to 16-byte stores.
// bf16 q, head_dim 256 (Gemma-2; w256 below, blocks in attention_wgmma.cuh):
//   - A CTA owns 128 query rows of one lane and kv head (64 tokens at
//     group 2) in two consumer warpgroups of 64 rows on wgmma: S = Q K^T by
//     m64n64k16 from shared memory (Q and K 128-byte-swizzled, K-major), O
//     += P V by m64n256k16 with P in registers and V read transposed; O is
//     a warpgroup's 64 x 256 f32, 128 registers a thread (setmaxnreg 224).
//   - A producer warpgroup (setmaxnreg 56): one warp issues TMA loads of
//     64-key K and V tiles through two stages, one box per page's rows (or
//     a power-of-two part of them) and 128 bytes of columns, from a 4-D
//     tensor map over the cache (pages as (D, ps, nkv, 2P)), against
//     mbarriers with the expected bytes; it reads the page table one tile
//     ahead.  Over int8 pages the int8 stages land by TMA and three more
//     warps convert each into exact bf16 in the swizzled layout the
//     descriptors read, with the keys' f32 scales beside it.
//   - Each turn of a warpgroup issues one tile's S and the previous tile's
//     P V; its softmax (scale, int8 K scale, softcap, mask on S in f32; P
//     times the int8 V scale before bf16) runs while the P V is in flight.
//   - Split-KV: a tile's key range is divided evenly into runs of at most
//     `chunk` keys, one CTA each (ops/paged_attention_cuda.py
//     ragged_launch_plan: the grid's key tiles at their longest over the
//     132 SMs, 512-2,048 keys), so a 1,024-token chunk beside 4,000-key
//     decode lanes gives 196 CTAs with keys; each warpgroup of a
//     split writes its rows' f32 (m, l, o) and the last to take the slot's
//     ticket folds them (attention_tc.cuh's ticket merge).
//   - The grid is (tiles, nkv, slabs * splits) with tiles bounded by 8 G /
//     TQ + B; CTAs x < tiles zero the padding rows of blocks x, x + tiles,
//     .., and CTAs past their tile's splits exit at once.
// f32 q (f32 or int8 pages): the first, CUDA-core design in attention_common.cuh
//   (TF32 tensor cores cannot meet the 1e-4 f32 gate): one CTA per 8-token
//   block x kv head, 16-key tiles, f32 online softmax.
// Still left: the d=64/128 instances on the wgmma blocks, and split-KV for
// their long decode-shaped lanes, which one CTA per (lane, head) walks.
#include "attention_common.cuh"
#include "attention_tc.cuh"
#include "attention_wgmma.cuh"

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

// ---------------------------------------------------------------- bf16 q, d=256

// The head_dim 256 instances (Gemma-2): wgmma fed by TMA through a
// warp-specialised ring, split-KV with an in-kernel merge (attention_wgmma.cuh).
namespace w256 {

constexpr int D = 256;
constexpr int KT = wg::KT;          // keys per staged tile
constexpr int ROWS = 2 * wg::ROWS;  // query rows of a CTA: 2 consumer warpgroups
constexpr int THREADS = 3 * wg::WG_THREADS;  // + 1 producer warpgroup
constexpr int CONSUMER_REGS = 224;  // 224 x 256 + 56 x 128 = the launch's 168 x 384
constexpr int PRODUCER_REGS = 56;
constexpr int CONVERTERS = 3;  // int8: producer warps 9-11 turn stages into bf16

// Dynamic shared memory, from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes):
//   Q        4 column blocks x [128 rows][128 B]                 64 KB
//   bf16:    K stages [2][4 x [64][128 B]], then V stages alike  128 KB
//   int8:    TMA stages [2][K 2 x [64][128 B] | V alike]          64 KB
//            K converted to bf16 [4 x [64][128 B]], V alike [2]   96 KB
//            their f32 scales, K [64] then V [2][64]              768 B
// (227 KB in all: the int8 V is converted a tile ahead, its K a turn
// ahead, so neither conversion waits on the turn that reads the other)
template <typename P>
struct Smem {
  static constexpr bool I8 = tc::is_int8<P>();
  static constexpr int TILE = D / 64 * KT * 128;   // a bf16 K or V tile: 32 KB
  static constexpr int I8_TILE = D / 128 * KT * 128;  // an int8 one: 16 KB
  static constexpr int Q = 0;
  static constexpr int KV = Q + D / 64 * ROWS * 128;
  static constexpr int CONV = KV + 2 * 2 * I8_TILE;  // int8 only: K, then V [2]
  static constexpr int SCALES = CONV + 3 * TILE;     // int8 only: K [64], V [2][64]
  static constexpr int BYTES = I8 ? SCALES + 3 * KT * 4 : KV + 4 * TILE;
  // bytes the kernel asks for: the layout plus slack to align its base
  static constexpr int ALLOC = BYTES + 1024;
};

// barrier slots: the tiles the consumers read (bf16: the TMA stages;
// int8: the converted tiles, one stage), and int8's TMA stages
enum Bar { KFULL = 0, KEMPTY = 2, VFULL = 4, VEMPTY = 6, TFULL = 8, TEMPTY = 10, NBAR = 12 };
// named barriers: 1 + w, warpgroup w's own; PP_BAR + w, warpgroup w's turn
// at the tensor cores
constexpr int PP_BAR = 3;

// grid (tiles, nkv, slabs * splits); see the header note of this file
template <typename P>
__global__ void __launch_bounds__(THREADS, 1) ragged_kernel_wgmma(
    const __grid_constant__ CUtensorMap kv_map,  // pages as (D, ps, nkv, 2P)
    const __nv_bfloat16* __restrict__ q,  // [T, nq, D]
    const float* __restrict__ scales,     // [P, 2, nkv, ps] (int8 pages only)
    const int* __restrict__ page_table,   // [B, W]
    const int* __restrict__ q_start,      // [B]
    const int* __restrict__ kv_start,     // [B]
    const int* __restrict__ q_len,        // [B]
    __nv_bfloat16* __restrict__ out,      // [T, nq, D]
    float* __restrict__ partials,         // split partials (see wg::store_partial)
    int* __restrict__ tickets,            // one per warpgroup slot, zero between calls
    int B, int G, int tq, int slabs, int chunk_tiles, int nq, int nkv, int ps, int W,
    float scale, float softcap, int window) {
  using S = Smem<P>;
  constexpr bool I8 = S::I8;
  constexpr int QCH = D / 8;  // 16-byte chunks of a bf16 head row
  extern __shared__ uint4 smem_wg[];
  __shared__ __align__(8) uint64_t bars[NBAR];
  __shared__ int plan_s[2];
  __shared__ int last_s[2];
  __shared__ int epi_s[3];  // the consumers' epilogue reads: nsp, j0, q_start
  char* smem = reinterpret_cast<char*>(smem_wg);
  smem += (1024 - (tc::smem_addr(smem) & 1023)) & 1023;

  const int x = blockIdx.x;
  const int h = blockIdx.y;
  const int slab = blockIdx.z % slabs;
  const int split = blockIdx.z / slabs;
  const int group = nq / nkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // padding rows (in no slice, or past the owner's q_len) of the 8-token
  // blocks x, x + tiles, ..., for the heads of kv head h: one CTA per
  // block and head, each warp a block
  if (blockIdx.z == 0) {
    for (int b = x + warp * gridDim.x; b < G; b += (THREADS / 32) * gridDim.x) {
      const int owner = slice_owner(q_start, q_len, B, b * RAG_BQ);
      const int end = owner >= 0 ? q_start[owner] + q_len[owner] : 0;
      for (int idx = lane; idx < RAG_BQ * group * QCH; idx += 32) {
        const int r = idx / (group * QCH);
        const int row = b * RAG_BQ + r;
        if (owner >= 0 && row < end) continue;
        *reinterpret_cast<uint4*>(out + ((int64_t)row * nq + h * group) * D +
                                  (idx - r * group * QCH) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  if (warp == 0) {
    const int2 tile = tile_of(q_len, B, tq, x);
    if (lane == 0) {
      plan_s[0] = tile.x;
      plan_s[1] = tile.y;
    }
  }
  __syncthreads();

  // the tile's rows [r0, r0 + 128) of tq * group: queries j_lo .. j_hi
  const int s = plan_s[0];
  if (s < 0) return;
  const int qn = q_len[s];
  const int qs0 = q_start[s];
  const int kv0 = kv_start[s];
  const int j0 = ((qn + tq - 1) / tq - 1 - plan_s[1]) * tq;  // last tiles first
  const int rows_tile = tq * group;
  const int r0 = slab * ROWS;
  const int j_lo = j0 + r0 / group;
  if (r0 >= rows_tile || j_lo >= qn) return;
  const int j_hi = min(j0 + (min(rows_tile, r0 + ROWS) - 1) / group, qn - 1);
  // key tiles [lo, hi) from the first query's window to the last query,
  // split evenly into nsp runs of at most chunk_tiles tiles
  const int hi = min(kv0 + j_hi + 1, W * ps);
  int lo = window > 0 ? max(0, kv0 + j_lo - window + 1) : 0;
  lo = (lo / KT) * KT;
  const int n_all = (hi - lo + KT - 1) / KT;
  const int nsp = (n_all + chunk_tiles - 1) / chunk_tiles;
  if (split >= nsp) return;
  const int t_first = split * n_all / nsp;
  const int n = (split + 1) * n_all / nsp - t_first;
  const int key_base = lo + t_first * KT;
  // consumer warpgroups with a query row: 2, or 1 when rows 64.. have none
  const int n_wg = (r0 + wg::ROWS < rows_tile && j0 + (r0 + wg::ROWS) / group < qn) ? 2 : 1;

  if (threadIdx.x == 0) {
    epi_s[0] = nsp;
    epi_s[1] = j0;
    epi_s[2] = qs0;
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&bars[KFULL + i], I8 ? CONVERTERS : 1);
      wg::mbar_init(&bars[VFULL + i], I8 ? CONVERTERS : 1);
      wg::mbar_init(&bars[KEMPTY + i], 4 * n_wg);
      wg::mbar_init(&bars[VEMPTY + i], 4 * n_wg);
      wg::mbar_init(&bars[TFULL + i], 1);
      wg::mbar_init(&bars[TEMPTY + i], CONVERTERS);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  const int* pt = page_table + (int64_t)s * W;
  auto arrive_warp = [&](int bar) {  // one arrival per warp
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&bars[bar]);
  };
  if (warp >= 8) {
    // ------------------------------------------------ producer warpgroup
    wg::reg_dealloc<PRODUCER_REGS>();
    // TMA: a tile's K (or V) is nb boxes, each one page's rows (or
    // box_rows of them) by 128 bytes of columns, times the column blocks;
    // lane i of a loading warp finds box i's page and slot a tile ahead
    // and issues box i itself, so a tile's boxes go out in NCB instructions
    const int bh = wg::box_rows(ps);
    const int nb = KT / bh;
    constexpr int NCB = I8 ? D / 128 : D / 64;  // column blocks of a row
    constexpr int CB_COLS = I8 ? 128 : 64;
    auto find = [&](int key0, int i0, int& page, int& slot) {
      const int pos = key0 + (i0 + lane) * bh;
      page = 0;  // keys past the table read the null page (masked)
      if (i0 + lane < nb && pos < W * ps) page = pt[pos / ps];
      slot = pos % ps;
    };
    auto issue = [&](char* dst, uint64_t* bar, int key0, int kv, int page0, int slot0) {
      for (int i0 = 0; i0 < nb; i0 += 32) {
        int page = page0, slot = slot0;
        if (i0 > 0) find(key0, i0, page, slot);
        if (i0 + lane < nb)
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            wg::tma_load_4d(dst + cb * (KT * 128) + (i0 + lane) * bh * 128, &kv_map, bar,
                            cb * CB_COLS, slot, h, 2 * page + kv);
      }
    };
    // expected bytes first (lane 0), then every lane's boxes
    auto expect = [&](uint64_t* bar, uint32_t bytes) {
      if (lane == 0) wg::mbar_expect(bar, bytes);
      __syncwarp();
    };
    int page_c = 0, slot_c = 0, page_n = 0, slot_n = 0;
    if constexpr (!I8) {
      // warp 8 lands the K tiles, warp 9 the V tiles
      if (warp == 8 || warp == 9) {
        const int kv = warp - 8;
        if (kv == 0) wg::tma_prefetch_map(&kv_map);
        find(key_base, 0, page_c, slot_c);
        for (int t = 0; t < n; ++t) {
          const int key0 = key_base + t * KT;
          const int st = t & 1;
          if (t + 1 < n) find(key0 + KT, 0, page_n, slot_n);
          wg::mbar_wait(&bars[(kv ? VEMPTY : KEMPTY) + st], ((t >> 1) & 1) ^ 1);
          expect(&bars[(kv ? VFULL : KFULL) + st], S::TILE);
          issue(smem + S::KV + (2 * kv + st) * S::TILE, &bars[(kv ? VFULL : KFULL) + st],
                key0, kv, page_c, slot_c);
          page_c = page_n;
          slot_c = slot_n;
        }
      }
    } else if (warp == 8) {
      // int8: warp 8 lands the int8 stages by TMA (K and V of a tile on one
      // barrier)
      wg::tma_prefetch_map(&kv_map);
      find(key_base, 0, page_c, slot_c);
      for (int t = 0; t < n; ++t) {
        const int key0 = key_base + t * KT;
        const int st = t & 1;
        if (t + 1 < n) find(key0 + KT, 0, page_n, slot_n);
        char* stage = smem + S::KV + st * 2 * S::I8_TILE;
        wg::mbar_wait(&bars[TEMPTY + st], ((t >> 1) & 1) ^ 1);
        expect(&bars[TFULL + st], 2 * S::I8_TILE);
        issue(stage, &bars[TFULL + st], key0, 0, page_c, slot_c);
        issue(stage + S::I8_TILE, &bars[TFULL + st], key0, 1, page_c, slot_c);
        page_c = page_n;
        slot_c = slot_n;
      }
    } else {
      // and warps 9-11 turn each landed stage into the bf16 K tile and V
      // tile (a stage of two), with the keys' f32 scales (0 past hi: such
      // keys are masked, and a zero V scale keeps their P at 0 whatever
      // the page holds)
      const int tid = threadIdx.x - 9 * 32;
      const int nthr = CONVERTERS * 32;
      float* sc_k = reinterpret_cast<float*>(smem + S::SCALES);
      for (int t = 0; t < n; ++t) {
        // the tile's K scales (index 0..63) and V scales (64..127)
        const int key0 = key_base + t * KT;
        float sc[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = tid + u * nthr;
          const int pos = key0 + (idx & (KT - 1));
          sc[u] = 0.f;
          if (idx < 2 * KT && pos < hi)
            sc[u] = scales[((int64_t)pt[pos / ps] * 2 * nkv + (idx >> 6) * nkv + h) * ps +
                           pos % ps];
        }
        const char* stage = smem + S::KV + (t & 1) * 2 * S::I8_TILE;
        wg::mbar_wait(&bars[TFULL + (t & 1)], (t >> 1) & 1);
        wg::mbar_wait(&bars[KEMPTY], (t & 1) ^ 1);
        wg::convert_i8_tile<D>(stage, smem + S::CONV, tid, nthr);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (tid + u * nthr < KT) sc_k[tid + u * nthr] = sc[u];
        wg::fence_async_shared();
        arrive_warp(KFULL);
        wg::mbar_wait(&bars[VEMPTY + (t & 1)], ((t >> 1) & 1) ^ 1);
        wg::convert_i8_tile<D>(stage + S::I8_TILE, smem + S::CONV + (1 + (t & 1)) * S::TILE,
                               tid, nthr);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = tid + u * nthr;
          if (idx >= KT && idx < 2 * KT) sc_k[idx + (t & 1) * KT] = sc[u];
        }
        wg::fence_async_shared();
        arrive_warp(VFULL + (t & 1));
        arrive_warp(TEMPTY + (t & 1));
      }
    }
  } else {
    // ------------------------------------------------ consumer warpgroups
    wg::reg_alloc<CONSUMER_REGS>();
    const int w = warp >> 2;  // rows [r0 + 64 w, r0 + 64 w + 64) of the tile
    if (w >= n_wg) return;
    const int tid = threadIdx.x & (wg::WG_THREADS - 1);
    const int wr0 = r0 + w * wg::ROWS;
    // the warpgroup's queries, unscaled bf16, into the swizzled Q blocks
    // (rows that are no query zero-filled)
    for (int idx = tid; idx < wg::ROWS * QCH; idx += wg::WG_THREADS) {
      const int r = idx / QCH;
      const int c = idx - r * QCH;
      const int rr = wr0 + r;
      const int j = j0 + rr / group;
      const bool ok = rr < rows_tile && j < qn;
      const __nv_bfloat16* src = q;
      if (ok) src = q + ((int64_t)(qs0 + j) * nq + h * group + rr % group) * D + c * 8;
      tc::cp_async16(tc::smem_addr(smem + S::Q + (c >> 3) * (ROWS * 128) +
                                   (w * wg::ROWS + r) * 128 + (((c & 7) ^ (r & 7)) << 4)),
                     src, ok);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    wg::fence_async_shared();
    wg::named_sync(1 + w, wg::WG_THREADS);

    // the thread's rows (g + 8k of its warp's 16) and the warpgroup's span
    const int g = lane >> 2;
    const int c = lane & 3;
    int qpos[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = wr0 + 16 * (warp & 3) + g + 8 * k;
      const int j = j0 + rr / group;
      qpos[k] = rr < rows_tile && j < qn ? kv0 + j : -1;
    }
    const int qmin = kv0 + j0 + wr0 / group;
    const int qmax = kv0 + min(j0 + (min(rows_tile, wr0 + wg::ROWS) - 1) / group, qn - 1);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {wg::MASKED, wg::MASKED};
    float l[2] = {0.f, 0.f};
    const uint32_t q_base = tc::smem_addr(smem + S::Q) + w * wg::ROWS * 128;
    const float* sc_k = reinterpret_cast<const float*>(smem + S::SCALES);
    // the keys row k sees, relative to key0 + 2c: [lo_rel, hi_rel]
    int hi_pos[2], lo_pos[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      hi_pos[k] = qpos[k] - 2 * c;
      lo_pos[k] = window > 0 ? qpos[k] - window + 1 - 2 * c : -(1 << 30);
    }
    const float sk = scale * (softcap > 0.f ? 2.f * wg::LOG2E / softcap : wg::LOG2E);
    const float cap2 = softcap * wg::LOG2E;
    // two warpgroups take turns at the tensor cores: each turn issues one
    // tile's S = Q K^T and the previous tile's O += P V, and the other
    // warpgroup's softmax runs meanwhile (warpgroup 0 starts).  Every turn
    // issues its products unconditionally (a product under a branch that
    // ptxas cannot prove warpgroup-uniform serializes every wgmma): the
    // first turn S alone, the last P V alone, and a tile none of the
    // warpgroup's rows sees is multiplied like any other (its P is 0).
    const bool pingpong = n_wg == 2;
    if (pingpong && w == 1) wg::named_arrive(PP_BAR, 2 * wg::WG_THREADS);
    float sacc[32];
    uint32_t pa[4][4];
    // the K tile of tile t in stage kst(t) (int8: one converted K tile),
    // its phase parity kpar(t); V tiles always in two stages
    auto kst = [](int t) { return I8 ? 0 : (t & 1); };
    auto kpar = [](int t) { return I8 ? (t & 1) : ((t >> 1) & 1); };
    auto turn_begin = [&]() {
      if (pingpong) wg::named_sync(PP_BAR + w, 2 * wg::WG_THREADS);
      wg::wgmma_fence();
    };
    auto turn_end = [&](bool last) {
      if (pingpong && !(last && w == 1))
        wg::named_arrive(PP_BAR + 1 - w, 2 * wg::WG_THREADS);
    };
    // shared addresses opaque to the compiler, so the descriptors are
    // formed at each use, not hoisted into registers
    auto issue_qk = [&](int t) {
      const uint32_t qb = wg::opaque(q_base);
      const uint32_t kb = wg::opaque(
          tc::smem_addr(smem + (I8 ? S::CONV : S::KV + kst(t) * S::TILE)));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da =
            wg::desc_sw128(qb + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
        const uint64_t db = wg::desc_sw128(kb + (kk >> 2) * (KT * 128) + (kk & 3) * 32, 16, 1024);
        if (kk == 0) wg::wgmma_ss_m64n64<0>(sacc, da, db);
        else wg::wgmma_ss_m64n64<1>(sacc, da, db);
      }
      wg::wgmma_commit();
    };
    auto issue_pv = [&](int t) {
      const uint32_t vb = wg::opaque(
          tc::smem_addr(smem + (I8 ? S::CONV : S::KV + S::TILE) + (1 + (t & 1)) * S::TILE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_rs_m64n256_tb(o, pa[kk], wg::desc_sw128(vb + kk * 16 * 128, KT * 128, 1024));
      wg::wgmma_commit();
    };
    // tile t's S landed: its K released (int8: after reading its scales),
    // its softmax; returns O's rescale factors
    auto softmax = [&](int t, float (&alpha)[2]) {
      wg::fence_regs(sacc);
      const int key0 = key_base + t * KT;
      float ks[16];
      if constexpr (I8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(sc_k + 8 * j + 2 * c);
          ks[2 * j] = v.x;
          ks[2 * j + 1] = v.y;
        }
      }
      arrive_warp(KEMPTY + kst(t));
      // a tile that all of the warpgroup's rows see whole needs no mask
      if (key0 + KT - 1 <= qmin && (window <= 0 || qmax - key0 < window))
        wg::softmax_scores<I8, false>(sacc, m, l, alpha, hi_pos, lo_pos, key0, sk, cap2, ks);
      else
        wg::softmax_scores<I8, true>(sacc, m, l, alpha, hi_pos, lo_pos, key0, sk, cap2, ks);
    };
    // tile t's P V done: its V and P fragments released
    auto pv_done = [&](int t) {
      wg::wgmma_wait<0>();
      wg::fence_regs(o);
      wg::fence_regs(pa);
      arrive_warp(VEMPTY + (t & 1));
    };
    auto wait_v_pack = [&](int t) {
      wg::mbar_wait(&bars[VFULL + (t & 1)], (t >> 1) & 1);
      wg::pack_p<I8>(sacc, sc_k + (1 + (t & 1)) * KT, pa);
    };

    float alpha[2];
    wg::mbar_wait(&bars[KFULL], 0);
    turn_begin();
    issue_qk(0);
    turn_end(false);
    wg::wgmma_wait<0>();
    softmax(0, alpha);  // O is still 0: no rescale
    for (int t = 1; t < n; ++t) {
      wg::mbar_wait(&bars[KFULL + kst(t)], kpar(t));
      wait_v_pack(t - 1);
      turn_begin();
      issue_qk(t);
      issue_pv(t - 1);
      turn_end(false);
      wg::wgmma_wait<1>();  // S landed; P V still running
      softmax(t, alpha);
      pv_done(t - 1);
      // a warp whose row maxima all stayed leaves O as it is
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    }
    wait_v_pack(n - 1);
    turn_begin();
    issue_pv(n - 1);
    turn_end(true);
    pv_done(n - 1);

    // row sums over the quad, then the output: directly with one split,
    // else through the partials and the last split's fold.  What the
    // epilogue needs is read again here (shared memory, blockIdx), not
    // held in registers across the key loop.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
      l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
    }
    const int e_w = threadIdx.x >> 7;
    bool e_ok[2];
    int e_rl[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      e_rl[k] = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * k;
      e_ok[k] = qpos[k] >= 0;
    }
    if (epi_s[0] > 1) {
      const int e_nsp = epi_s[0];
      const int e_split = blockIdx.z / slabs;
      const int slot = ((blockIdx.x * nkv + blockIdx.y) * slabs + blockIdx.z % slabs) * 2 + e_w;
      const int nslots = gridDim.x * nkv * slabs * 2;
      const int splits = gridDim.z / slabs;
      float* po = partials + (int64_t)slot * splits * wg::ROWS * D;
      float* pml = partials + (int64_t)nslots * splits * wg::ROWS * D +
                   (int64_t)slot * splits * wg::ROWS * 2;
      wg::store_partial<D>(po, pml, e_split, e_rl, e_ok, o, m, l);
      if (!wg::last_split(tickets + slot, e_nsp, 1 + e_w, &last_s[e_w])) return;
      wg::fold_partials<D>(po, pml, e_nsp, e_split, e_rl, e_ok, o, m, l);
      if ((threadIdx.x & 127) == 0) tickets[slot] = 0;
    }
    // the output rows' offsets, from shared memory again after the fold
    const int e_group = nq / nkv;
    const int e_wr0 = (blockIdx.z % slabs) * ROWS + e_w * wg::ROWS;
    int64_t orow[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int rr = e_wr0 + e_rl[k];
      orow[k] = ((int64_t)(epi_s[2] + epi_s[1] + rr / e_group) * nq + blockIdx.y * e_group +
                 rr % e_group) * D;
    }
    wg::store_rows(out, orow, e_ok, o, l);
  }
}

template <typename P>
cudaError_t launch(const void* q, const void* pages, const float* scales,
                   const int* page_table, const int* q_start, const int* kv_start,
                   const int* q_len, void* out, void* partials, void* tickets, int B,
                   int G, int tq, int tiles, int slabs, int chunk, int splits, int nq,
                   int nkv, int ps, int W, int num_pages, float scale, float softcap,
                   int window, cudaStream_t stream) {
  if (tq <= 0 || tiles <= 0 || slabs <= 0 || splits <= 0 || chunk <= 0 || chunk % KT ||
      tq * (nq / nkv) > slabs * ROWS || partials == nullptr || tickets == nullptr ||
      (int64_t)slabs * splits > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!wg::page_tensor_map(pages, num_pages, nkv, ps, D, (int)sizeof(P), &map))
    return cudaErrorInvalidValue;
  auto kernel = ragged_kernel_wgmma<P>;
  static tc::SmemOptIn opt_in;
  cudaError_t err = opt_in.ensure(kernel, Smem<P>::ALLOC);
  if (err != cudaSuccess) return err;
  dim3 grid(tiles, nkv, slabs * splits);
  kernel<<<grid, THREADS, Smem<P>::ALLOC, stream>>>(
      map, static_cast<const __nv_bfloat16*>(q), scales, page_table, q_start, kv_start,
      q_len, static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials),
      static_cast<int*>(tickets), B, G, tq, slabs, chunk / KT, nq, nkv, ps, W, scale,
      softcap, window);
  return cudaGetLastError();
}

}  // namespace w256

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16.  kv_dtype (pages): the
// same codes, or 2 = int8 with `scales` [P, 2, nkv, ps] f32 (null
// otherwise).  T (the buffer length) is a multiple of 8 and G = T / 8.
// tq / tiles / slabs / chunk / splits: the bf16-q tile plan
// (ops/paged_attention_cuda.py ragged_launch_plan; chunk and splits, and
// the split scratch `partials` / `tickets`, are read by the head_dim 256
// instances only); the f32 instances ignore them.  num_pages: the cache's
// P.  Returns a cudaError_t (0 = launched).
extern "C" int kt_ragged_paged_attention(
    const void* q, const void* pages, const void* scales,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_start, void* out, void* partials, void* tickets, int B, int G,
    int tq, int tiles, int slabs, int chunk, int splits, int nq, int nkv,
    int head_dim, int page_size, int W, int num_pages, float scale,
    float softcap, int window, int dtype, int kv_dtype, void* stream) {
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
#define KT_RAG_WG(P)                                                             \
  if (kt::is_instance<__nv_bfloat16, P>(dtype, kv_dtype, scales) &&              \
      head_dim == w256::D)                                                       \
  return (int)w256::launch<P>(q, pages, sc, pt, qs, ks, ql, out, partials,       \
                              tickets, B, G, tq, tiles, slabs, chunk, splits,    \
                              nq, nkv, page_size, W, num_pages, scale, softcap,  \
                              window, st)
#define KT_RAG(T, P, D)                                                      \
  if (kt::is_instance<T, P>(dtype, kv_dtype, scales) && head_dim == D)      \
  return (int)launch_f32<T, P, D>(q, pages, sc, pt, qs, ks, ql, out, B, G,   \
                                  nq, nkv, page_size, W, scale, softcap,     \
                                  window, st)
  KT_RAG_TC(__nv_bfloat16, 128);
  KT_RAG_TC(__nv_bfloat16, 64);
  KT_RAG_WG(__nv_bfloat16);
  KT_RAG_TC(int8_t, 128);
  KT_RAG_TC(int8_t, 64);
  KT_RAG_WG(int8_t);
  KT_RAG(float, float, 128);
  KT_RAG(float, float, 64);
  KT_RAG(float, float, 256);
  KT_RAG(float, int8_t, 128);
  KT_RAG(float, int8_t, 64);
  KT_RAG(float, int8_t, 256);
#undef KT_RAG
#undef KT_RAG_WG
#undef KT_RAG_TC
  return (int)cudaErrorInvalidValue;
}
