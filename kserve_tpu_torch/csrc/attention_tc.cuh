// Tensor-core building blocks of the bf16-q paged-attention kernels
// (ragged, dense-stride and decode), for Hopper (sm_90a):
//
//   - cp.async loaders of one paged K/V tile (KT keys of one kv head) into
//     a shared-memory stage, for bf16 pages and for int8 pages with their
//     f32 row scales; positions past the live range are zero-filled and
//     read nothing (no page, no scale);
//   - an int8 -> bf16 pass over a landed int8 stage (|x| <= 127 is exact
//     in bf16; the scales stay f32 and are folded in later);
//   - ldmatrix fragments and mma.sync.m16n8k16 (bf16 in, f32 accumulate);
//   - one warp's online softmax over a 16-row slab in registers: row max
//     and row sum by quad shuffles, P rounded to bf16 in registers as the
//     A operand of P @ V, O accumulated in f32 registers;
//   - the key loop all three kernels run over their staged tiles, the
//     shared-memory size of a CTA, and a launcher's once-per-device opt-in
//     to it;
//   - the split-KV CTA of the dense-stride and decode kernels
//     (`split_kv_slab`): split bounds, key loop, the 4 warps' fold and the
//     in-kernel merge of the splits by the last one to arrive.
//
// Numerics: q stays unscaled bf16 and K bf16 (or exact bf16 of int8), so
// S = Q K^T multiplies exact values with f32 accumulation; the softmax
// scale, the per-key K scale (int8), the softcap and the mask are applied
// to S in f32; the per-key V scale (int8) multiplies P in f32 before P is
// rounded to bf16.  The denominator sums the unrounded f32 P.
//
// Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
// phase reads fall on 8 distinct 16-byte bank groups (no conflicts).
//
// These blocks serve head_dim 64 and 128.  head_dim 256 (Gemma-2) runs on
// designs of its own: the ragged kernel's wgmma CTA (attention_wgmma.cuh,
// ragged_paged_attention.cu) and the dense and decode kernels' persistent
// CTA (attention_split256.cuh).
// Cache layout (the JAX package's): pages [P, 2, nkv, ps, d], K at index 0
// and V at 1 of the second axis; int8 scales [P, 2, nkv, ps].
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace tc {

constexpr float MASKED = -1e30f;  // a masked score (log2 domain); weighs 0
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;  // threads per CTA: 4 warps

// keys per staged K/V tile
template <int D>
__host__ __device__ constexpr int tile_keys() {
  static_assert(D <= 128, "head_dim 256 has designs of its own");
  return 64;
}

template <typename P>
__host__ __device__ constexpr bool is_int8() { return std::is_same<P, int8_t>::value; }

// bytes of one bf16 row of D values in shared memory (padded)
template <int D>
__host__ __device__ constexpr int bf16_stride() { return 2 * D + 16; }
// bytes of one staged page row (bf16 or int8), padded
template <typename P, int D>
__host__ __device__ constexpr int staged_stride() { return (int)sizeof(P) * D + 16; }
// one stage: KT K rows, KT V rows, then (int8) KT K and KT V f32 scales
template <typename P, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * tile_keys<D>() * staged_stride<P, D>() +
         (is_int8<P>() ? 2 * tile_keys<D>() * 4 : 0);
}

// Dynamic shared memory of a CTA of `rows` query rows: the queries (bf16,
// later the output rows), two K/V stages and, for int8 pages, one stage's
// rows as bf16.
template <typename P, int D>
__host__ __device__ constexpr int smem_bytes(int rows) {
  return rows * bf16_stride<D>() + 2 * stage_bytes<P, D>() +
         (is_int8<P>() ? 2 * tile_keys<D>() * bf16_stride<D>() : 0);
}

// A launcher's opt-in of its kernel instance to more dynamic shared memory
// than the 48 KB default (the kernel's static shared memory counts against
// it too), made once per device: later launches make no driver call for it.
struct SmemOptIn {
  std::atomic<uint64_t> done{0};  // bit d: made on device d

  template <typename K>
  cudaError_t ensure(K kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
    if (bit != 0 && (done.load(std::memory_order_acquire) & bit) != 0)
      return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
    return err;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; when !ok nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a @ b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32 (no
// side effects: not volatile, so the compiler may interleave it)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx: ~2 ulp; exp2f's accurate path costs several
// times more, and the softmax takes one per score)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Page-table coordinates of key position `pos`: a shift and a mask when
// the page size is a power of two (ps_log2 >= 0), a division otherwise.
__device__ __forceinline__ void page_slot(int pos, int ps, int ps_log2,
                                          int& page_ix, int& slot) {
  if (ps_log2 >= 0) {
    page_ix = pos >> ps_log2;
    slot = pos & (ps - 1);
  } else {
    page_ix = pos / ps;
    slot = pos - page_ix * ps;
  }
}

// log2 of a power-of-two page size, else -1
__device__ __forceinline__ int page_log2(int ps) {
  return (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
}

// two floats as bf16x2 (lo in the low half: the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 4 int8 values of w as 4 exact bf16 (two bf16x2 words, low bytes
// first), without the quarter-rate int-to-float unit: byte b becomes the
// f32 pattern 0x4B0000xx of 2^23 + (b ^ 0x80), and subtracting 2^23 + 128
// leaves the int exactly; an integer with |x| <= 128 has at most 8
// significant bits, so the upper half of its f32 pattern is its bf16.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632u),
                    __byte_perm(f[2], f[3], 0x7632u));
}

// Issue the async copies of keys [lo, lo + KT) of kv head `h` of the lane
// whose page-table row is `pt` into `stage` (K rows, V rows, then int8
// scales).  Positions at or past `hi` (which the caller keeps within the
// table) are zero-filled and read nothing.  Each thread takes one 16-byte
// column of KPT keys: their page-table entries load together first, then
// the K and V copies (consecutive threads on consecutive 16-byte chunks
// of a row, so each row is one coalesced read).
template <typename P, int D>
__device__ __forceinline__ void issue_kv_tile(
    const P* __restrict__ pages, const float* __restrict__ scales,
    const int* __restrict__ pt, int nkv, int ps, int ps_log2, int h, int lo,
    int hi, char* stage) {
  constexpr int KT = tile_keys<D>();
  constexpr int SS = staged_stride<P, D>();
  constexpr int CH = (int)sizeof(P) * D / 16;  // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(P);     // elements per chunk
  constexpr int KSTEP = NT / CH;               // keys per pass of the CTA
  constexpr int KPT = KT / KSTEP;              // keys per thread
  static_assert(NT % CH == 0 && KT % KSTEP == 0, "tile split");
  const int c = threadIdx.x % CH;
  const int t0 = threadIdx.x / CH;
  const int64_t v_rows = (int64_t)nkv * ps;  // a page's V rows follow its K rows
  int64_t row[KPT];  // K row of each key, -1 past hi
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int pos = lo + t0 + KSTEP * k;
    int page_ix, slot;
    page_slot(pos, ps, ps_log2, page_ix, slot);
    row[k] = pos < hi ? ((int64_t)pt[page_ix] * 2 * nkv + h) * ps + slot : -1;
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int t = t0 + KSTEP * k;
    const bool ok = row[k] >= 0;
    const P* src = ok ? pages + row[k] * D + c * EPC : pages;
    cp_async16(smem_addr(stage + t * SS + c * 16), src, ok);
    cp_async16(smem_addr(stage + (KT + t) * SS + c * 16),
               ok ? src + v_rows * D : pages, ok);
  }
  if constexpr (is_int8<P>()) {
    float* sc = reinterpret_cast<float*>(stage + 2 * KT * SS);
    static_assert(KT <= NT, "one key's scales per thread");
    if (threadIdx.x < KT) {
      const int pos = lo + threadIdx.x;
      const bool ok = pos < hi;
      const float* src = scales;
      if (ok) {
        int page_ix, slot;
        page_slot(pos, ps, ps_log2, page_ix, slot);
        src = scales + ((int64_t)pt[page_ix] * 2 * nkv + h) * ps + slot;
      }
      cp_async4(smem_addr(sc + threadIdx.x), src, ok);
      cp_async4(smem_addr(sc + KT + threadIdx.x), ok ? src + v_rows : scales, ok);
    }
  }
}

// The landed int8 rows of `stage` as exact bf16 rows in `conv` (stride
// bf16_stride<D>), 8 values per thread step.
template <int D>
__device__ __forceinline__ void convert_kv_tile(const char* stage, char* conv) {
  constexpr int KT = tile_keys<D>();
  constexpr int SS = staged_stride<int8_t, D>();
  constexpr int CS = bf16_stride<D>();
  constexpr int C8 = D / 8;
  for (int idx = threadIdx.x; idx < 2 * KT * C8; idx += NT) {
    const int r = idx / C8;
    const int c = idx - r * C8;
    const uint2 u = *reinterpret_cast<const uint2*>(stage + r * SS + c * 8);
    const uint2 lo = i8x4_to_bf16x4(u.x);
    const uint2 hi = i8x4_to_bf16x4(u.y);
    *reinterpret_cast<uint4*>(conv + r * CS + c * 16) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// the K scales of a landed int8 stage (V scales follow at + KT)
template <typename P, int D>
__device__ __forceinline__ const float* stage_scales(const char* stage) {
  return reinterpret_cast<const float*>(stage + 2 * tile_keys<D>() * staged_stride<P, D>());
}

// One warp's online-softmax state over a 16-row slab.  Lane (g = lane/4,
// c = lane%4) holds rows g and g+8: o[n] = {(g, 8n+2c), (g, 8n+2c+1),
// (g+8, 8n+2c), (g+8, 8n+2c+1)}; m in the log2 domain, l this lane's
// partial row sums (reduce_l sums the quad).
template <int D>
struct SlabState {
  float o[D / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = MASKED;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// This lane's ldmatrix address of the A fragment of k-step 0 of the 16
// query rows starting at row `row0` of q_s (bf16, stride bf16_stride<D>);
// k-step kk is 32 bytes on.
template <int D>
__device__ __forceinline__ uint32_t q_frag_addr(const char* q_s, int row0) {
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3;
  const int row = row0 + (i & 1) * 8 + (lane & 7);
  return smem_addr(q_s + row * bf16_stride<D>() + (i >> 1) * 16);
}

// A warp's A fragments of its 16 query rows for the D/16 k-steps of
// S = Q K^T, held in registers, loaded once after the queries land.
template <int D>
struct QRegs {
  uint32_t f[D / 16][4];
  __device__ __forceinline__ void load(const char* q_s, int row0) {
    const uint32_t addr = q_frag_addr<D>(q_s, row0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(f[kk], addr + 32 * kk);
  }
  __device__ __forceinline__ void frag(int kk, uint32_t (&a)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = f[kk][e];
  }
};

// One online-softmax step of a warp's slab over KW keys staged as bf16
// rows (stride bf16_stride<D>) at k_rows / v_rows, absolute positions
// key0 .. key0+KW-1.  S takes all D dims of the queries (qf); O takes the
// DO columns of V that v_rows points at.  qpos[k] is the position of the lane's row g + 8k
// (-1: the row is not a query and sees no key); a key is seen when
// key <= qpos and, with window > 0, qpos - key < window.  I8: ksc / vsc
// are the keys' f32 scales, folded into S's columns and P's columns.
template <int D, int DO, int KW, bool I8, typename Q>
__device__ __forceinline__ void attend(
    SlabState<DO>& st, const Q& qf, const char* k_rows,
    const char* v_rows, const float* ksc, const float* vsc, int key0,
    const int (&qpos)[2], int window, float scale, float softcap) {
  static_assert(KW % 16 == 0, "keys per warp step: a multiple of 16");
  static_assert(D % 64 == 0 && DO % 64 == 0, "head_dim: a multiple of 64");
  constexpr int CS = bf16_stride<D>();
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int i = lane >> 3;

  // S = Q K^T, f32 accumulators: s[j] is keys 8j .. 8j+7
  float s[KW / 8][4];
#pragma unroll
  for (int j = 0; j < KW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // per k-step, the K fragments of every key pair load before the MMAs
  // use them, so the ldmatrix latencies overlap
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    qf.frag(kk, a);
    uint32_t b[KW / 16][4];
#pragma unroll
    for (int jp = 0; jp < KW / 16; ++jp) {
      // matrices (keys 16jp.., dims 16kk..), (16jp.., 16kk+8..),
      // (16jp+8.., 16kk..), (16jp+8.., 16kk+8..): the b0/b1 pairs of key
      // tiles 2jp and 2jp+1
      const int key = 16 * jp + (i >> 1) * 8 + (lane & 7);
      ldsm_x4(b[jp], smem_addr(k_rows + key * CS + (16 * kk + (i & 1) * 8) * 2));
    }
#pragma unroll
    for (int jp = 0; jp < KW / 16; ++jp) {
      mma_bf16(s[2 * jp], a, b[jp][0], b[jp][1]);
      mma_bf16(s[2 * jp + 1], a, b[jp][2], b[jp][3]);
    }
  }

  // scale, softcap and mask in f32; to the log2 domain; row max
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = 8 * j + 2 * c + (e & 1);
      const int key = key0 + kl;
      const int qp = qpos[e >> 1];
      float x = s[j][e] * scale;
      if constexpr (I8) x *= ksc[kl];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const bool ok = key <= qp && (window <= 0 || qp - key < window);
      s[j][e] = ok ? x * LOG2E : MASKED;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = fast_exp2(st.m[r] - mx[r]);  // 1 while every key so far is masked
    st.m[r] = mx[r];
  }

  // P = exp2(S - m); the denominator takes f32 P, P @ V takes bf16 P
  // (times the V scale for int8)
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KW / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[j][e] == MASKED ? 0.f : fast_exp2(s[j][e] - mx[e >> 1]);
      rs[e >> 1] += p;
      if constexpr (I8) s[j][e] = p * vsc[8 * j + 2 * c + (e & 1)];
      else s[j][e] = p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: the accumulators of key tiles 2kk and 2kk+1 are the A
  // fragment of k-step kk; V fragments by ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * kk][0], s[2 * kk][1]),
        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const int key = 16 * kk + (i & 1) * 8 + (lane & 7);
    // matrices (keys 16kk.., dims 16np..), (16kk+8.., 16np..),
    // (16kk.., 16np+8..), (16kk+8.., 16np+8..): the b0/b1 pairs of dim
    // tiles 2np and 2np+1; four loads in flight before their MMAs
#pragma unroll
    for (int n0 = 0; n0 < DO / 16; n0 += 4) {
      uint32_t b[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        ldsm_x4_trans(b[u], smem_addr(v_rows + key * CS +
                                      (16 * (n0 + u) + (i >> 1) * 8) * 2));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_bf16(st.o[2 * (n0 + u)], a, b[u][0], b[u][1]);
        mma_bf16(st.o[2 * (n0 + u) + 1], a, b[u][2], b[u][3]);
      }
    }
  }
}

// Whether a warp whose valid rows sit at positions [qmin, qmax] (qmax < 0:
// no valid row) sees any of the keys key0 .. key0+KW-1.
__device__ __forceinline__ bool warp_sees(int key0, int kw, int qmin, int qmax,
                                          int window) {
  if (qmax < 0 || key0 > qmax) return false;
  return window <= 0 || key0 + kw - 1 > qmin - window;
}

// min and max of the lane's valid row positions over the warp
__device__ __forceinline__ void warp_span(const int (&qpos)[2], int& qmin,
                                          int& qmax) {
  const int big = 0x7fffffff;
  const int lo = min(qpos[0] < 0 ? big : qpos[0], qpos[1] < 0 ? big : qpos[1]);
  qmax = __reduce_max_sync(0xffffffffu, max(qpos[0], qpos[1]));
  qmin = __reduce_min_sync(0xffffffffu, lo);
}

// A CTA's key loop: n tiles of KT = tile_keys<D>() keys from `lo` (keys
// at or past `hi` zero-filled, unread) stream through the two stages at
// `stages` by cp.async, tile it+1 in flight while tile it is in the MMA; int8
// stages are converted into `conv` first.  Each warp attends keys [koff,
// koff+KW) of every tile with its slab of 16 query rows, row `q_row` of q_s
// on, whose async copies the caller has issued (they land with tile 0),
// into the DO output columns from `col0`; qpos is the lane's rows'
// positions (-1: no query) and [qmin, qmax] the warp's span.  st starts
// afresh; on return every copy has landed and the stages are free.
template <typename P, int D, int DO, int KW>
__device__ __forceinline__ void key_loop(
    SlabState<DO>& st, const char* q_s, int q_row, const P* __restrict__ pages,
    const float* __restrict__ scales, const int* __restrict__ pt, int nkv, int ps,
    int h, int lo, int hi, int n, char* stages, char* conv, int koff, int col0,
    const int (&qpos)[2], int qmin, int qmax, int window, float scale,
    float softcap) {
  constexpr int KT = tile_keys<D>();
  constexpr int CS = bf16_stride<D>();
  constexpr int SB = stage_bytes<P, D>();
  const int psl = page_log2(ps);
  if (n > 0) issue_kv_tile<P, D>(pages, scales, pt, nkv, ps, psl, h, lo, hi, stages);
  cp_async_commit();  // the queries and tile 0
  st.init();
  QRegs<D> qf;
  for (int it = 0; it < n; ++it) {
    char* cur = stages + (it & 1) * SB;
    if (it + 1 < n)
      issue_kv_tile<P, D>(pages, scales, pt, nkv, ps, psl, h, lo + (it + 1) * KT,
                          hi, stages + ((it + 1) & 1) * SB);
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and the queries) landed
    __syncthreads();
    if (it == 0) qf.load(q_s, q_row);
    const char* k_rows = cur;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (is_int8<P>()) {
      convert_kv_tile<D>(cur, conv);
      ksc = stage_scales<P, D>(cur) + koff;
      vsc = ksc + KT;
      k_rows = conv;
      __syncthreads();
    }
    const int key0 = lo + it * KT + koff;
    if (warp_sees(key0, KW, qmin, qmax, window))
      attend<D, DO, KW, is_int8<P>()>(st, qf, k_rows + koff * CS,
                                      k_rows + (KT + koff) * CS + col0 * 2, ksc,
                                      vsc, key0, qpos, window, scale, softcap);
    __syncthreads();  // stage `it` (and conv) free for the next copies
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------------------------------------ split-KV CTA

constexpr int SLAB_ROWS = 16;   // query rows of a split-KV CTA: one m16 slab
constexpr int SLAB_KW = 16;     // keys of a staged tile per warp
constexpr int MAX_SPLITS = 32;  // splits per (lane, kv head, slab), at most

// The split CTA's 4 warps each take SLAB_KW keys of a staged tile and
// accumulate all D of O's columns; their partial states fold in shared
// memory after the key loop.
constexpr int KEY_GROUPS = NT / 32;
template <int D>
__host__ __device__ constexpr int fold_bytes() {
  return KEY_GROUPS * SLAB_ROWS * (D + 2) * 4;
}

// Whether a launcher's split plan and scratch are ones split_kv_slab<P, D>
// takes (rows: a lane's query rows, sp * group).
template <int D>
inline bool split_plan_ok(const void* partials, const void* tickets, int chunk,
                          int splits, int slabs, int rows) {
  return partials != nullptr && tickets != nullptr && chunk > 0 &&
         chunk % tile_keys<D>() == 0 && splits > 0 && splits <= MAX_SPLITS &&
         slabs > 0 && rows <= slabs * SLAB_ROWS;
}

// The split-KV CTA of the dense-stride and decode kernels, grid (B, nkv *
// slabs, splits).  Lane b = blockIdx.x holds qn query tokens (0: it reads
// nothing) at packed rows b*sp .. and positions kv0 .. kv0+qn-1; its
// sp * group rows are (token rr / group, head h * group + rr % group), and
// slab zs holds rows [16 zs, 16 zs + 16).  The lane's keys [lo, hi) split
// into chunks of `chunk` keys (at most `splits`).  Split z runs key_loop
// over its chunk and the key groups fold their (m, l, o) in shared memory;
// with one split that is the output.  Otherwise each split writes its
// (m, l, o) in f32 to `partials` (o [slots, splits, 16, D], then (m, l)
// [slots, splits, 16, 2]; slot (b * nkv + h) * slabs + zs), and the last
// split to take the slot's ticket (after __threadfence) merges them and
// resets the ticket: one launch, no host sync.  Tickets are zero between
// calls, so calls that share the scratch must run in stream order.  Rows
// that are no query (past qn, stride padding) are written 0; rows past the
// lane's sp * group are neither read nor written.  `smem` is the CTA's
// dynamic shared memory, smem_bytes<P, D>(SLAB_ROWS).
template <typename P, int D>
__device__ __forceinline__ void split_kv_slab(
    const __nv_bfloat16* __restrict__ q, const P* __restrict__ pages,
    const float* __restrict__ scales, const int* __restrict__ page_table,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
    int* __restrict__ tickets, int qn, int kv0, int sp, int nq, int nkv, int ps,
    int W, int chunk, int splits, int slabs, float scale, float softcap,
    int window, char* smem) {
  constexpr int KT = tile_keys<D>();
  constexpr int CS = bf16_stride<D>();
  constexpr int SB = stage_bytes<P, D>();
  constexpr int QCH = D / 8;
  constexpr int KG = KEY_GROUPS;
  static_assert(KG * SLAB_KW == KT, "the 4 warps tile a stage's keys");
  static_assert(fold_bytes<D>() <= 2 * SB, "the warps' partials reuse the stages");
  char* q_s = smem;                     // [16][CS]
  char* stages = q_s + SLAB_ROWS * CS;  // [2][SB]; then the warps' fold
  char* conv = stages + 2 * SB;         // int8: [2*KT][CS]
  __shared__ int last_s;
  __shared__ float wk_s[SLAB_ROWS][MAX_SPLITS];  // the merge's split weights
  __shared__ float inv_s[SLAB_ROWS];

  const int b = blockIdx.x;
  const int h = blockIdx.y / slabs;
  const int zs = blockIdx.y - h * slabs;
  const int z = blockIdx.z;
  const int group = nq / nkv;
  const int rows_lane = sp * group;
  const int nrows = min(SLAB_ROWS, rows_lane - zs * SLAB_ROWS);  // rows of the slab
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kg = warp;  // the warp's keys of a tile: [16 kg, 16 kg + 16)
  const int64_t row0 = (int64_t)b * sp;
  // global element offset of slab row r < nrows
  auto out_row = [&](int r) -> int64_t {
    const int rr = zs * SLAB_ROWS + r;
    return ((row0 + rr / group) * nq + h * group + rr % group) * (int64_t)D;
  };
  auto is_query = [&](int r) {
    return r < nrows && (zs * SLAB_ROWS + r) / group < qn;
  };

  // key range [lo, hi) and its splits; a lane with qn 0 has none
  const int hi = qn > 0 ? min(kv0 + qn, W * ps) : 0;
  int lo = window > 0 ? max(0, kv0 - window + 1) : 0;
  lo = (lo / KT) * KT;
  const int nsp = hi > lo ? min((hi - lo + chunk - 1) / chunk, splits) : 0;
  if (nsp == 0) {  // every row of the slab is 0; nothing is read
    if (z == 0)
      for (int idx = threadIdx.x; idx < nrows * QCH; idx += NT) {
        const int r = idx / QCH;
        *reinterpret_cast<uint4*>(out + out_row(r) + (idx - r * QCH) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    return;
  }
  if (z >= nsp) return;
  const int s_lo = lo + z * chunk;
  const int s_hi = min(s_lo + chunk, hi);
  const int n = (s_hi - s_lo + KT - 1) / KT;
  const int* pt = page_table + (int64_t)b * W;

  for (int idx = threadIdx.x; idx < SLAB_ROWS * QCH; idx += NT) {
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
    qpos[k] = is_query(r) ? kv0 + (zs * SLAB_ROWS + r) / group : -1;
  }
  int qmin, qmax;
  warp_span(qpos, qmin, qmax);

  // each warp takes SLAB_KW keys of every staged tile for the slab's rows
  SlabState<D> st;
  key_loop<P, D, D, SLAB_KW>(st, q_s, 0, pages, scales, pt, nkv, ps, h, s_lo,
                             s_hi, n, stages, conv, kg * SLAB_KW, 0, qpos,
                             qmin, qmax, window, scale, softcap);

  // fold the key groups: each warp writes its rows' o columns into
  // [group][row][D], then a group's (m, l) as [group][row]
  st.reduce_l();
  float* wo = reinterpret_cast<float*>(stages);
  float* wm = wo + KG * SLAB_ROWS * D;
  float* wl = wm + KG * SLAB_ROWS;
  {
    const int g = lane >> 2;
    const int c = lane & 3;
    float* p0 = wo + (kg * SLAB_ROWS + g) * D;
    float* p1 = p0 + 8 * D;
    if (g < nrows) {
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<float2*>(p0 + 8 * nn + 2 * c) =
            make_float2(st.o[nn][0], st.o[nn][1]);
    }
    if (g + 8 < nrows) {
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<float2*>(p1 + 8 * nn + 2 * c) =
            make_float2(st.o[nn][2], st.o[nn][3]);
    }
    if (c == 0) {
      wm[kg * SLAB_ROWS + g] = st.m[0];
      wl[kg * SLAB_ROWS + g] = st.l[0];
      wm[kg * SLAB_ROWS + g + 8] = st.m[1];
      wl[kg * SLAB_ROWS + g + 8] = st.l[1];
    }
  }
  __syncthreads();

  // this CTA's state, 4 floats of a row per step: one split's output, or
  // its partial in scratch
  const int slot = (b * nkv + h) * slabs + zs;
  const int nslots = gridDim.x * gridDim.y;
  float* part_o = partials + (int64_t)slot * splits * SLAB_ROWS * D;
  float* part_ml = partials + (int64_t)nslots * splits * SLAB_ROWS * D +
                   (int64_t)slot * splits * SLAB_ROWS * 2;
  for (int idx = threadIdx.x; idx < nrows * D / 4; idx += NT) {
    const int r = idx / (D / 4);
    const int d = (idx - r * (D / 4)) * 4;
    float m = MASKED;
#pragma unroll
    for (int w = 0; w < KG; ++w) m = fmaxf(m, wm[w * SLAB_ROWS + r]);
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < KG; ++w) {
      const float wt = exp2f(wm[w * SLAB_ROWS + r] - m);
      const float4 x = *reinterpret_cast<const float4*>(wo + (w * SLAB_ROWS + r) * D + d);
      l += wl[w * SLAB_ROWS + r] * wt;
      o.x += x.x * wt;
      o.y += x.y * wt;
      o.z += x.z * wt;
      o.w += x.w * wt;
    }
    if (nsp == 1) {
      const float inv = is_query(r) && l > 0.f ? 1.f / l : 0.f;
      *reinterpret_cast<uint2*>(out + out_row(r) + d) =
          make_uint2(pack_bf16(o.x * inv, o.y * inv), pack_bf16(o.z * inv, o.w * inv));
    } else {
      *reinterpret_cast<float4*>(part_o + ((int64_t)z * SLAB_ROWS + r) * D + d) = o;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + ((int64_t)z * SLAB_ROWS + r) * 2) =
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
    // and the row's 1 / l (a row past nrows reads nothing)
    static_assert(SLAB_ROWS * 8 == NT, "8 threads per row");
    const int r = threadIdx.x / 8;
    const int sub = threadIdx.x % 8;
    const int kn = r < nrows ? nsp : 0;
    float m = MASKED;
    for (int k = sub; k < kn; k += 8)
      m = fmaxf(m, __ldcg(part_ml + ((int64_t)k * SLAB_ROWS + r) * 2));
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int k = sub; k < kn; k += 8) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          part_ml + ((int64_t)k * SLAB_ROWS + r) * 2));
      const float wt = exp2f(ml.x - m);
      wk_s[r][k] = wt;
      l += ml.y * wt;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (sub == 0) inv_s[r] = is_query(r) && l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();
  constexpr int CPT = SLAB_ROWS * D / 4 / NT;  // float4 chunks per thread, at most
  const int chunks = nrows * D / 4;
  float4 acc[CPT];
#pragma unroll
  for (int u = 0; u < CPT; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  // four splits' loads in flight at a time
#pragma unroll 4
  for (int k = 0; k < nsp; ++k) {
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int idx = threadIdx.x + u * NT;
      if (idx < chunks) {
        const int r = idx / (D / 4);
        const int d = (idx - r * (D / 4)) * 4;
        const float wt = wk_s[r][k];
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            part_o + ((int64_t)k * SLAB_ROWS + r) * D + d));
        acc[u].x += x.x * wt;
        acc[u].y += x.y * wt;
        acc[u].z += x.z * wt;
        acc[u].w += x.w * wt;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CPT; ++u) {
    const int idx = threadIdx.x + u * NT;
    if (idx < chunks) {
      const int r = idx / (D / 4);
      const int d = (idx - r * (D / 4)) * 4;
      const float inv = inv_s[r];
      *reinterpret_cast<uint2*>(out + out_row(r) + d) = make_uint2(
          pack_bf16(acc[u].x * inv, acc[u].y * inv),
          pack_bf16(acc[u].z * inv, acc[u].w * inv));
    }
  }
  if (threadIdx.x == 0) tickets[slot] = 0;
}

}  // namespace tc
