// Hopper building blocks of the wgmma design of the bf16-q paged-attention
// kernels (sm_90a; the ragged kernel's head_dim 256 instances use them):
//
//   - a 4-D tiled TMA tensor map over a page cache [P, 2, nkv, ps, D], seen
//     as dims (D, ps, nkv, 2P) with a box of one page's rows (or a power-of-
//     two part of them) by 128 bytes of columns, 128-byte swizzle; built on
//     the host by cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint (no -lcuda), memoized per (pointer, shape);
//   - mbarrier helpers (init, arrive, arrive with expected bytes, parity
//     wait), the TMA load, proxy and named-barrier fences, setmaxnreg;
//   - wgmma descriptors of 128-byte-swizzled tiles (K-major operands, and
//     MN-major B read with the transpose flag), fence / commit / wait, and
//     the two products of one attention tile: S = Q K^T
//     (m64n64k16, both operands in shared memory) and O += P V (m64n256k16,
//     P in registers);
//   - one consumer warpgroup's online softmax over a 64-key tile (64 query
//     rows; thread (warp w, lane g*4+c) holds rows 16w+g and 16w+g+8 and
//     columns 8j+2c, 8j+2c+1 of every 8-column block j, the wgmma
//     accumulator layout), and the int8 -> bf16 pass into the swizzled
//     layout the descriptors read;
//   - the split-KV merge of a warpgroup's 64 rows: each split writes its
//     rows' (m, l, o) in f32 and the last split to take the slot's ticket
//     folds the others into its registers.
//
// Swizzle: a tile of R rows x 128 bytes (64 bf16 or 128 int8 values) holds
// row r's 16-byte chunk c at r*128 + ((c ^ (r & 7)) * 16), the layout TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer
// and the wgmma descriptors of layout type 1 read.  A head row of 256 bf16
// values spans 4 such column blocks.
//
// Numerics are those of attention_tc.cuh: S = Q K^T of unscaled bf16 (int8
// rows are exact bf16) in f32; scale, the int8 K scale, softcap and mask
// on S in f32; P rounded to bf16 after the int8 V scale; the denominator
// sums the unrounded f32 P.  The softcap's tanh is 1 - 2 / (2^(2y log2 e)
// + 1) by ex2.approx and rcp.approx: within ~2e-5 of cap * tanhf(x / cap)
// at cap 50, against a bf16 output ulp of 2^-8 of the row's scale.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "attention_tc.cuh"

namespace wg {

using tc::fast_exp2;
using tc::LOG2E;
using tc::MASKED;
using tc::pack_bf16;
using tc::smem_addr;

constexpr int ROWS = 64;       // query rows of one consumer warpgroup (wgmma M)
constexpr int KT = 64;         // keys per staged tile
constexpr int WG_THREADS = 128;

// ------------------------------------------------------------ tensor map

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// Rows of one TMA box: the largest power of two that divides the page size
// and the 64-key tile, so a box never leaves its page and a tile is a
// whole number of boxes.
__host__ __device__ constexpr int box_rows(int ps) {
  return (ps & -ps) < KT ? (ps & -ps) : KT;
}

// The tensor map of a page cache [P, 2, nkv, ps, D] of `elem`-byte values
// (2: bf16, 1: int8) as dims (D, ps, nkv, 2P): coordinate (col, slot, head,
// 2 * page + (0: K, 1: V)), box (128 / elem columns, box_rows(ps) slots),
// 128-byte swizzle.  Every coordinate stays below 2^31 (2P is checked), and
// the strides are 64-bit, so caches above 4 GB are mapped whole.  Encoded
// once per (pointer, shape) and kept: the engine's cache is allocated once,
// and a new cache (as each kernel-phase case makes) is encoded on its first
// call.  Returns false when the driver has no encoder or refuses the map.
inline bool page_tensor_map(const void* pages, int64_t P, int nkv, int ps, int D,
                            int elem, CUtensorMap* out) {
  using Key = std::tuple<const void*, int64_t, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  if (P <= 0 || 2 * P >= (int64_t{1} << 31) || ps <= 0 || nkv <= 0) return false;
  const Key key{pages, P, nkv, ps, D, elem};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)ps, (cuuint64_t)nkv,
                              (cuuint64_t)(2 * P)};
  const cuuint64_t row = (cuuint64_t)D * elem;
  const cuuint64_t strides[3] = {row, row * ps, row * ps * nkv};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows(ps), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      4, const_cast<void*>(pages), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  if (cache.size() >= 1024) cache.clear();  // a bound; any entry re-encodes alike
  cache.emplace(key, map);
  *out = map;
  return true;
}

// ------------------------------------------------------------ barriers, TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// whether the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// wait until it has; a wait that never ends (a pipeline fault) traps after
// 2^32 cycles, about 2 s, instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy (wgmma operands, TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ------------------------------------------------------------ wgmma

// descriptor of a 128-byte-swizzled operand at shared address `addr`:
// lbo / sbo in bytes (K-major: sbo = 1024, the 8-row stride, lbo unused;
// MN-major: lbo = the stride of 64-element blocks along N, sbo = 1024, the
// stride of 8-row groups along K)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// x, opaque to the compiler: what is computed from it is computed where
// it is used (no loop-invariant hoisting of descriptors into registers)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}
// pins an accumulator register at this point (no code that reads or
// writes it moves across)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// the same for register A fragments, which the hardware reads until the
// wgmma that takes them completes
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory;
// ACC 0 overwrites D, 1 accumulates
template <int ACC>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(ACC));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]: A bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// ------------------------------------------------------------ softmax

// One online-softmax step of a consumer warpgroup over a 64-key tile at
// absolute positions key0 .. key0+63, S = Q K^T in s (the m64n64
// accumulator: s[4j+e] is row g + 8(e>>1), key key0 + 8j + 2c + (e&1)).
// Row k sees keys key0 + 2c + [lo_pos[k] - key0, hi_pos[k] - key0] (hi_pos
// = qpos - 2c; lo_pos = qpos - window + 1 - 2c, or far below without a
// window; a row that is no query has qpos -1 and sees nothing); MASK false:
// every row sees every key.  The score in the log2 domain is S * sk, sk =
// scale * log2 e, or with a softcap cap (cap2 = cap * log2 e, sk = scale *
// 2 log2 e / cap) cap2 * tanh(..) = cap2 - 2 cap2 / (2^(S sk) + 1), by
// ex2.approx and rcp.approx.  I8: ks[2j+b] is the K scale of key 8j+2c+b.
// On return s holds P = 2^(score - m) in f32 (0 where masked), m and l are
// updated and alpha is the factor the caller rescales O by.
template <bool I8, bool MASK>
__device__ __forceinline__ void softmax_scores(float (&s)[32], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2],
                                               const int (&hi_pos)[2],
                                               const int (&lo_pos)[2], int key0,
                                               float sk, float cap2,
                                               const float (&ks)[16]) {
  const int hi[2] = {hi_pos[0] - key0, hi_pos[1] - key0};
  const int lo[2] = {lo_pos[0] - key0, lo_pos[1] - key0};
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sk;
      if constexpr (I8) x *= ks[2 * j + (e & 1)];
      if (cap2 > 0.f) {
        float r;
        asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fast_exp2(x) + 1.f));
        x = fmaf(-2.f * cap2, r, cap2);
      }
      if constexpr (MASK) {
        const int kl = 8 * j + (e & 1);
        if (kl > hi[e >> 1] || kl < lo[e >> 1]) x = MASKED;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float rs[2] = {0.f, 0.f}, ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(m[r] - mx[r]);  // 1 while every key so far is masked
    m[r] = mx[r];
    ms[r] = mx[r] == MASKED ? 0.f : mx[r];  // a masked score's P is then 0
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = fast_exp2(s[i] - ms[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += p;
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// P (f32, times the key's V scale vsc[key] when I8) as the bf16 A
// fragments of the 4 k-steps of O += P V: k-step kk takes keys 16kk ..
// 16kk+15, i.e. accumulator blocks 2kk and 2kk+1.
template <bool I8>
__device__ __forceinline__ void pack_p(const float (&s)[32], const float* vsc,
                                       uint32_t (&a)[4][4]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      float v0 = 1.f, v1 = 1.f;
      if constexpr (I8) {
        const float2 v = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * c);
        v0 = v.x;
        v1 = v.y;
      }
      a[kk][2 * h] = pack_bf16(s[4 * j] * v0, s[4 * j + 1] * v1);
      a[kk][2 * h + 1] = pack_bf16(s[4 * j + 2] * v0, s[4 * j + 3] * v1);
    }
  }
}

// ------------------------------------------------------------ int8 tiles

// The 4 int8 values of w as 4 exact bf16 (two bf16x2 words, low bytes
// first) in 8 instructions: with y = x & 0x7f and s = x's sign bit, bf16
// 0x4300 | y is 128 + y and 0xc300 | (s << 7) is -(128 + 128 s), and one
// bf16x2 fma adds them: x, exact, as every integer of [-128, 127] is.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t lo7 = w & 0x7f7f7f7fu;
  const uint32_t hi1 = w & 0x80808080u;
  uint32_t r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t sel = h ? 0x5342u : 0x5140u;  // bytes 2h, 2h+1 under 0x43 / 0xc3
    const uint32_t a = __byte_perm(lo7, 0x43434343u, sel);
    const uint32_t c = __byte_perm(hi1, 0xc3c3c3c3u, sel);
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r[h]) : "r"(a), "r"(0x3f803f80u), "r"(c));
  }
  return make_uint2(r[0], r[1]);
}

// The int8 rows of a landed tile (D / 128 column blocks of [64 keys][128
// B], swizzled) as exact bf16 in `dst` (D / 64 column blocks of [64 keys]
// [128 B], swizzled), 16 values per step of thread t of n.
template <int D>
__device__ __forceinline__ void convert_i8_tile(const char* src, char* dst, int t,
                                                int n) {
  constexpr int CHUNKS = KT * D / 16;
  for (int idx = t; idx < CHUNKS; idx += n) {
    const int cb8 = idx / (KT * 8);
    const int r = (idx / 8) % KT;
    const int ch = idx & 7;  // columns 128 cb8 + 16 ch .. + 15
    const uint4 u = *reinterpret_cast<const uint4*>(
        src + cb8 * (KT * 128) + r * 128 + ((ch ^ (r & 7)) << 4));
    char* row = dst + (2 * cb8 + (ch >> 2)) * (KT * 128) + r * 128;
    const int c0 = 2 * (ch & 3);
    const uint2 a = i8x4_to_bf16x4(u.x);
    const uint2 b = i8x4_to_bf16x4(u.y);
    const uint2 e = i8x4_to_bf16x4(u.z);
    const uint2 f = i8x4_to_bf16x4(u.w);
    *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) = make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
        make_uint4(e.x, e.y, f.x, f.y);
  }
}

// ------------------------------------------------------------ split merge

// A warpgroup's rows as bf16 output: row k of the thread (g + 8k) at
// out + row_off[k] when ok[k], normalized by its row sum l.
template <int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const int64_t (&row_off)[2],
                                           const bool (&ok)[2], const float (&o)[NO],
                                           const float (&l)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!ok[k]) continue;
    const float inv = l[k] > 0.f ? 1.f / l[k] : 0.f;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<uint32_t*>(out + row_off[k] + 8 * j + 2 * c) =
          pack_bf16(o[4 * j + 2 * k] * inv, o[4 * j + 2 * k + 1] * inv);
  }
}

// One warpgroup slot's split partials in f32: o [splits][64][D] at po,
// (m, l) [splits][64][2] at pml.  The thread's rows are rl[k] = 16 w + g
// + 8k of the slot's 64 (w the warp within the warpgroup); rows with !ok
// are neither written nor read.
template <int D>
__device__ __forceinline__ void store_partial(float* po, float* pml, int z,
                                              const int (&rl)[2], const bool (&ok)[2],
                                              const float (&o)[D / 2], const float (&m)[2],
                                              const float (&l)[2]) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!ok[k]) continue;
    float* row = po + ((int64_t)z * ROWS + rl[k]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * c) =
          make_float2(o[4 * j + 2 * k], o[4 * j + 2 * k + 1]);
    if (c == 0)
      *reinterpret_cast<float2*>(pml + ((int64_t)z * ROWS + rl[k]) * 2) =
          make_float2(m[k], l[k]);
  }
}

// After each split stored its partial: whether this warpgroup is the last
// of nsp to take `ticket` (named barrier `bar`; flag: one shared int of
// the warpgroup).  The last one sees every other split's partial.
__device__ __forceinline__ bool last_split(int* ticket, int nsp, int bar, int* flag) {
  __threadfence();
  named_sync(bar, WG_THREADS);
  if (threadIdx.x % WG_THREADS == 0) *flag = atomicAdd(ticket, 1) == nsp - 1;
  named_sync(bar, WG_THREADS);
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// Fold the partials of splits 0 .. nsp-1 other than `self` into this
// warpgroup's own (o, m, l), whose l is already the full row sum.  A split
// that saw no key of a row (window edges) holds m = MASKED, l = 0, o = 0
// and weighs 0.
template <int D>
__device__ __forceinline__ void fold_partials(const float* po, const float* pml, int nsp,
                                              int self, const int (&rl)[2],
                                              const bool (&ok)[2], float (&o)[D / 2],
                                              float (&m)[2], float (&l)[2]) {
  const int c = threadIdx.x & 3;
  for (int z = 0; z < nsp; ++z) {
    if (z == self) continue;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!ok[k]) continue;
      const int row = z * ROWS + rl[k];  // 32-bit offsets: fewer registers
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(pml + 2 * row));
      const float mn = fmaxf(m[k], ml.x);
      const float a = fast_exp2(m[k] - mn);
      const float b = fast_exp2(ml.x - mn);
      l[k] = l[k] * a + ml.y * b;
      m[k] = mn;
      const float* src = po + row * D + 2 * c;
      // 8 loads in flight at a time: all D / 8 of them would take the
      // registers O needs
#pragma unroll
      for (int j0 = 0; j0 < D / 8; j0 += 8) {
        asm volatile("" ::: "memory");
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(src + 8 * j));
          o[4 * j + 2 * k] = o[4 * j + 2 * k] * a + x.x * b;
          o[4 * j + 2 * k + 1] = o[4 * j + 2 * k + 1] * a + x.y * b;
        }
      }
    }
  }
}

}  // namespace wg
