// The split-KV CTA of the dense-stride and decode kernels at head_dim 256
// (Gemma-2), bf16 q over bf16 or int8 pages, for Hopper (sm_90a).
//
// What bounds it: bytes.  A decode step or a verify round reads each live
// (lane, kv head)'s K and V once for 2 (decode at group 2) to 8 (verify at
// stride 4) query rows: ~4 flops per byte against the H100's ~295.  So the
// design keeps enough bytes in flight on every SM and spreads them evenly:
//
//   - A persistent grid of `G` CTAs (one per SM: the ring takes the shared
//     memory).  The work is the key tiles (KT = 64 keys) of every live
//     (lane, kv head, slab of ROWS query rows) "pair", in pair order, on a
//     cost axis where each pair also costs `pair_cost` positions for its
//     epilogue (Walker); CTA i takes positions [i C / G, (i + 1) C / G) of
//     the C in all, so the runs cost the same whether they hold a few long
//     pairs or many short ones.  Every CTA derives C and its run from the
//     lanes' metadata on the device (no host sync, one launch); a run that
//     crosses pairs computes one partial per pair it touches.
//   - One producer warp walks the run and lands each tile by TMA into a
//     ring of NS stages (3 x 64 KB bf16, 5 x 32 KB int8): one box per
//     page's rows (or a power-of-two part of them) by 128 bytes of columns
//     from wg::page_tensor_map, issued by one lane each, and int8's f32 row
//     scales beside the rows by cp.async.bulk (plain loads when the page
//     size is no multiple of 4, which the bulk copy's 16-byte alignment
//     needs), all on the stage's full mbarrier.  Consumers only wait on
//     full/empty parity: no copy and no __syncthreads in the key loop.
//   - Four consumer warps each take 16 disjoint keys of every stage across
//     all 256 columns, so no product is computed twice.  A pair's query rows
//     (8) are the n of m16n8k16, so both products run transposed: S^T = K
//     Q^T (A = 16 keys from the stage, B = the rows' queries in registers)
//     and O^T += V^T P^T (A = V^T, B = P^T from S^T's accumulators by
//     movmatrix.trans); O^T is 256 x 8 in f32, 64 registers a thread.
//   - The head dim's order inside a k-step is free as long as K and Q
//     agree: a thread's 4 dims of k-step kk are contiguous (delta()), so one
//     16-byte load of a swizzled K row feeds 2 (bf16) or 4 (int8) k-steps.
//     int8 rows are dequantized in registers: K by the exact 8-instruction
//     int8 -> bf16 pass, V by 8-byte loads of 4 keys, a 4 x 4 byte transpose
//     by prmt into (column, 4 keys) words and the same pass; O's columns
//     are permuted to match (tile 4G + i of O^T holds columns 64G + 8g + i
//     and 64G + 8g + 4 + i).  No bf16 copy of a tile exists.
//   - At the end of a pair's part, the 4 warps fold (m, l, o) in shared
//     memory in a fixed order; a part that is the whole pair writes the
//     rows, else it writes an f32 partial to slot pair + i (unique: a later
//     pair's runs come no earlier).  Only a run's first and last pairs can
//     be shared, so once the run is done it takes their tickets (one fence,
//     no round trip per pair), and the last run of a pair to take its
//     ticket lands the pair's partials by bulk copies in its idle ring,
//     folds them in run order and resets the ticket.
//
// Numerics are those of attention_wgmma.cuh: S of unscaled bf16 q and bf16
// K (int8 rows exact in bf16) in f32; scale, the int8 K scale, the softcap
// (by ex2.approx / rcp.approx) and the mask on S in f32; P times the int8 V
// scale before its bf16 rounding; the denominator sums the f32 P.  A key
// at or past the lane's last query (a box holds a page's rows) is masked.
#pragma once

#include "attention_wgmma.cuh"

namespace s256 {

using tc::fast_exp2;
using tc::LOG2E;
using tc::MASKED;
using tc::pack_bf16;
using tc::smem_addr;

constexpr int D = 256;
constexpr int KT = wg::KT;          // keys per stage
constexpr int ROWS = 8;             // query rows of a pair: the n of m16n8k16
constexpr int CONSUMERS = 4;        // consumer warps
constexpr int WK = KT / CONSUMERS;  // keys of a stage per consumer warp
constexpr int THREADS = 32 * (CONSUMERS + 1);  // + the producer warp
constexpr int PART = ROWS * (D + 2);  // floats of a partial: o [ROWS][D], (m, l) [ROWS]
constexpr int FOLD_BAR = 1;         // the consumer warps' named barrier
// floats of a row of the warps' fold: rows 2c and 2c + 1 of a thread 4
// banks apart, so a warp's stores of a column fall on 32 banks (bf16)
constexpr int FOLD_STRIDE = D + 4;

// Dynamic shared memory, from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes): NS stages of K then V, each
// NCB column blocks of [KT rows][128 B] (int8: then the K and V f32 scales
// of the stage's keys), then the warps' fold [CONSUMERS][ROWS][FOLD_STRIDE]
// f32.
template <typename P>
struct Smem {
  static constexpr bool I8 = tc::is_int8<P>();
  static constexpr int ELEM = (int)sizeof(P);
  static constexpr int CB = 128 / ELEM;  // columns of a 128-byte column block
  static constexpr int NCB = D / CB;     // column blocks of a row
  static constexpr int BLOCK = KT * 128;
  static constexpr int TILE = NCB * BLOCK;  // a K or V tile
  static constexpr int STAGE = 2 * TILE + (I8 ? 1024 : 0);
  static constexpr int NS = I8 ? 5 : 3;
  static constexpr int FOLD = NS * STAGE;
  static constexpr int BYTES = FOLD + CONSUMERS * ROWS * FOLD_STRIDE * 4;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base
  static constexpr int KPC = 4 / ELEM;        // k-steps a 16-byte chunk feeds
};

// The first of the 4 contiguous head dims that thread c (lane % 4) feeds
// k-step kk of S^T with (logical k 2c, 2c+1, 2c+8, 2c+9): chunk 2c + jj of
// column block b, so a quad's 8 lanes of two rows read 8 distinct 16-byte
// bank groups of the swizzled rows.
template <typename P>
__device__ __forceinline__ int delta(int kk, int c) {
  using S = Smem<P>;
  const int cg = kk / S::KPC;  // chunk group: column block cg / 2, jj = cg % 2
  return (cg >> 1) * S::CB + (2 * c + (cg & 1)) * (16 / S::ELEM) + 4 * (kk % S::KPC);
}

// One lane's metadata: (kv0, qn), its query tokens' first position and count.
struct DecodeLanes {  // one token at seq_len - 1, none at seq_len 0
  const int* seq_lens;
  __device__ __forceinline__ int2 operator()(int b) const {
    const int n = seq_lens[b];
    return make_int2(n - 1, n > 0 ? 1 : 0);
  }
};
struct DenseLanes {
  const int* kv_start;
  const int* q_len;
  __device__ __forceinline__ int2 operator()(int b) const {
    return make_int2(kv_start[b], q_len[b]);
  }
};

// A lane's key tiles: n tiles of KT keys from lo (a multiple of KT), from
// its first query's window to its last query; keys at or past hi are
// masked.  qn 0: no tile.
struct LaneRange {
  int kv0, qn, lo, hi, n;
};

__device__ __forceinline__ LaneRange lane_range(int2 m, int W, int ps, int window) {
  LaneRange r;
  r.kv0 = m.x;
  r.qn = m.y;
  r.hi = m.y > 0 ? min(m.x + m.y, W * ps) : 0;
  r.lo = (window > 0 ? max(0, m.x - window + 1) : 0) / KT * KT;
  r.n = r.hi > r.lo ? (r.hi - r.lo + KT - 1) / KT : 0;
  return r;
}

// The CTA whose run holds cost position t of C, runs [i C / R, (i + 1) C / R).
__device__ __forceinline__ int owner(int t, int C, int R) {
  return (int)(((int64_t)(t + 1) * R - 1) / C);
}

// One pair's part of a CTA's run: tiles [ta, tb) of the pair's r.n, the
// pair's first cost position P0.
struct Seg {
  LaneRange r;
  int b, h, zs, ta, tb, P0;
};

// A pair this CTA's run shares with other runs: its segment, the pair's
// index, its runs first .. first + runs - 1 and its nr query rows.
struct Duty {
  Seg sg;
  int pair, first, runs, nr;
};

// 4 values times inv as bf16 at dst
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const float4& x, float inv) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(x.x * inv, x.y * inv), pack_bf16(x.z * inv, x.w * inv));
}

// The partition's cost axis: pairs are (lane, kv head, slab) in that
// order, pp = nkv * slabs of them per lane, each costing the lane's r.n
// key tiles and then A positions for its epilogue (a pair of few tiles
// costs its CTA more than its bytes); a lane without a tile holds no
// pair.  Walks a run [t, t_end) of positions from lane b, whose first
// pair starts at position c: the tiles of each pair the run covers.
template <typename Lanes>
struct Walker {
  Lanes lanes;
  int W, ps, window, pp, slabs, A;
  int t, t_end, b, c;
  LaneRange r;

  __device__ __forceinline__ int lane_cost() const { return r.n > 0 ? (r.n + A) * pp : 0; }

  __device__ __forceinline__ void start(int t0, int t1, int b0, int c0) {
    t = t0;
    t_end = t1;
    b = b0;
    c = c0;
    if (t < t_end) r = lane_range(lanes(b), W, ps, window);
  }

  __device__ __forceinline__ bool next(Seg& s) {
    while (t < t_end) {
      while (t >= c + lane_cost()) {
        c += lane_cost();
        ++b;
        r = lane_range(lanes(b), W, ps, window);
      }
      const int u = r.n + A;
      const int k = (t - c) / u;
      const int P0 = c + k * u;
      if (t - P0 >= r.n) {  // the pair's epilogue share: no tile
        t = P0 + u;
        continue;
      }
      s.r = r;
      s.b = b;
      s.h = k / slabs;
      s.zs = k - s.h * slabs;
      s.P0 = P0;
      s.ta = t - P0;
      s.tb = min(r.n, t_end - P0);
      t = P0 + s.tb;
      return true;
    }
    return false;
  }
};

// an mbarrier's expected transaction bytes for this phase, without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// a bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// the transpose of an 8 x 8 b16 matrix held as m16n8 accumulator pairs
__device__ __forceinline__ uint32_t movm_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The producer warp: lands every tile of the run in the ring.  Lane i
// issues box i of a tile (box_rows(ps) keys of one page, every column
// block of K and of V, and int8's scales); the next tile's pages are read
// while this one waits for its stage.
template <typename P, typename Lanes>
__device__ __forceinline__ void produce(Walker<Lanes> wk, const CUtensorMap* kv_map,
                                        const float* __restrict__ scales,
                                        const int* __restrict__ page_table, int nkv,
                                        char* smem, uint64_t* full, uint64_t* empty) {
  using S = Smem<P>;
  const int lane = threadIdx.x & 31;
  const int ps = wk.ps;
  const int keys = wk.W * ps;
  const int psl = tc::page_log2(ps);
  const int bh = wg::box_rows(ps);
  const int nb = KT / bh;  // boxes of a tile: 64 at most (ps odd)
  const bool bulk = S::I8 && (ps & 3) == 0;
  const uint32_t tx = 2 * S::TILE + (bulk ? 2 * KT * 4 : 0);
  if (lane == 0) wg::tma_prefetch_map(kv_map);
  // box lane + 32 u of tile t of segment sg: its page (0 past the table)
  // and slot
  auto lookup = [&](const Seg& sg, int t, int (&page)[2], int (&slot)[2]) {
    const int* pt = page_table + (int64_t)sg.b * wk.W;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pos = sg.r.lo + t * KT + (lane + 32 * u) * bh;
      int ix;
      tc::page_slot(pos, ps, psl, ix, slot[u]);
      page[u] = lane + 32 * u < nb && pos < keys ? pt[ix] : 0;
    }
  };
  Seg sg;
  bool more = wk.next(sg);
  int t = more ? sg.ta : 0;
  int page[2], slot[2];
  if (more) lookup(sg, t, page, slot);
  for (int k = 0; more; ++k) {
    const Seg cur = sg;
    const int key0 = cur.r.lo + t * KT;
    const int pg[2] = {page[0], page[1]};
    const int sl[2] = {slot[0], slot[1]};
    // the next tile's pages load while this one waits for its stage
    if (++t == sg.tb) {
      more = wk.next(sg);
      t = more ? sg.ta : 0;
    }
    if (more) lookup(sg, t, page, slot);
    const int st = k % S::NS;
    char* stage = smem + st * S::STAGE;
    wg::mbar_wait(&empty[st], ((k / S::NS) & 1) ^ 1);
    if (lane == 0) mbar_expect_tx(&full[st], tx);
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      if (i >= nb) break;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv)
#pragma unroll
        for (int cb = 0; cb < S::NCB; ++cb)
          wg::tma_load_4d(stage + kv * S::TILE + cb * S::BLOCK + i * bh * 128, kv_map,
                          &full[st], cb * S::CB, sl[u], cur.h, 2 * pg[u] + kv);
      if (bulk) {
        const float* src = scales + ((int64_t)pg[u] * 2 * nkv + cur.h) * ps + sl[u];
        float* dst = reinterpret_cast<float*>(stage + 2 * S::TILE) + i * bh;
        bulk_load(dst, src, bh * 4, &full[st]);
        bulk_load(dst + KT, src + (int64_t)nkv * ps, bh * 4, &full[st]);
      }
    }
    if (S::I8 && !bulk) {
      // the K scales (keys 0..63) and V scales (64..127) of the tile
      const int* pt = page_table + (int64_t)cur.b * wk.W;
      float* dst = reinterpret_cast<float*>(stage + 2 * S::TILE);
      for (int idx = lane; idx < 2 * KT; idx += 32) {
        const int pos = key0 + (idx & (KT - 1));
        int ix, sl1;
        tc::page_slot(pos, ps, psl, ix, sl1);
        dst[idx] = pos < keys
                       ? scales[((int64_t)pt[ix] * 2 * nkv + (idx / KT) * nkv + cur.h) * ps + sl1]
                       : 0.f;
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&full[st]);
  }
}

// (x0, x1, x2, x3) -> out: byte i of x_k becomes byte k of out[i]
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140u);
  const uint32_t t1 = __byte_perm(x2, x3, 0x5140u);
  const uint32_t t2 = __byte_perm(x0, x1, 0x7362u);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362u);
  out[0] = __byte_perm(t0, t1, 0x5410u);
  out[1] = __byte_perm(t0, t1, 0x7632u);
  out[2] = __byte_perm(t2, t3, 0x5410u);
  out[3] = __byte_perm(t2, t3, 0x7632u);
}

// One consumer warp's step over its 16 keys kb .. kb+15 (rows WK w .. of
// the landed stage): S^T = K Q^T, the online softmax of the thread's rows
// 2c and 2c+1 (m, l: l this thread's part), O^T += V^T P^T.
template <typename P>
__device__ __forceinline__ void attend(float (&o)[16][4], float (&m)[2], float (&l)[2],
                                       const uint32_t (&qf)[16][2], const char* stage,
                                       int kb, int hi, const int (&qpos)[2], int window,
                                       float sk, float cap2) {
  using S = Smem<P>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int w = threadIdx.x >> 5;
  const int r0 = WK * w + g;  // the thread's keys: stage rows r0 and r0 + 8 (r0 & 7 == g)
  const char* kt = stage;
  const char* vt = stage + S::TILE;

  // S^T: s[0], s[1] key r0 at rows 2c, 2c+1; s[2], s[3] key r0 + 8 (two
  // chains of k-steps, even and odd, so the MMAs' latencies overlap)
  float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int cg = 0; cg < 2 * S::NCB; ++cg) {
    const int off = (cg >> 1) * S::BLOCK + (((2 * c + (cg & 1)) ^ g) << 4);
    const uint4 u0 = *reinterpret_cast<const uint4*>(kt + off + r0 * 128);
    const uint4 u1 = *reinterpret_cast<const uint4*>(kt + off + (r0 + 8) * 128);
    const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
    const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int sub = 0; sub < S::KPC; ++sub) {
      const int kk = S::KPC * cg + sub;
      uint32_t a[4];
      if constexpr (S::I8) {
        const uint2 x0 = wg::i8x4_to_bf16x4(w0[sub]);
        const uint2 x1 = wg::i8x4_to_bf16x4(w1[sub]);
        a[0] = x0.x;
        a[1] = x1.x;
        a[2] = x0.y;
        a[3] = x1.y;
      } else {
        a[0] = w0[2 * sub];
        a[1] = w1[2 * sub];
        a[2] = w0[2 * sub + 1];
        a[3] = w1[2 * sub + 1];
      }
      tc::mma_bf16(s2[kk & 1], a, qf[kk][0], qf[kk][1]);
    }
  }
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = s2[0][e] + s2[1][e];

  // scale, int8 K scale, softcap and mask in f32 (log2 domain); row max
  const float* sc = reinterpret_cast<const float*>(stage + 2 * S::TILE);
  float ks[2] = {1.f, 1.f};
  float vs[2] = {1.f, 1.f};
  if constexpr (S::I8) {
    ks[0] = sc[r0];
    ks[1] = sc[r0 + 8];
    vs[0] = sc[KT + r0];
    vs[1] = sc[KT + r0 + 8];
  }
  bool ok[4];
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = kb + g + 8 * (e >> 1);
    const int qp = qpos[e & 1];
    ok[e] = key <= qp && key < hi && (window <= 0 || qp - key < window);
    float x = s[e] * sk;
    if constexpr (S::I8) x *= ks[e >> 1];
    if (cap2 > 0.f) {
      float r;
      asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fast_exp2(x) + 1.f));
      x = fmaf(-2.f * cap2, r, cap2);
    }
    s[e] = ok[e] ? x : MASKED;
    mx[e & 1] = fmaxf(mx[e & 1], s[e]);
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int sh = 4; sh < 32; sh <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], sh));
    alpha[r] = fast_exp2(m[r] - mx[r]);  // 1 while every key so far is masked
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  // P = 2^(S - m), 0 where masked; P V takes it times the int8 V scale
  float pv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p = ok[e] ? fast_exp2(s[e] - m[e & 1]) : 0.f;
    l[e & 1] += p;
    pv[e] = ok[e] ? p * vs[e >> 1] : 0.f;
  }
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[1];
      o[t][2] *= alpha[0];
      o[t][3] *= alpha[1];
    }
  }
  // P^T's B fragments (keys 2c, 2c+1 | 2c+8, 2c+9 of row g)
  const uint32_t b0 = movm_trans(pack_bf16(pv[0], pv[1]));
  const uint32_t b1 = movm_trans(pack_bf16(pv[2], pv[3]));

  // O^T += V^T P^T over 16 tiles of 16 output columns
  if constexpr (!S::I8) {
    const int key = WK * w + (lane & 7) + ((lane >> 4) << 3);
    const int hb = (lane >> 3) & 1;
    const uint32_t vrow = smem_addr(vt) + key * 128;
#pragma unroll
    for (int t0 = 0; t0 < 16; t0 += 4) {
      uint32_t a[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u;
        tc::ldsm_x4_trans(a[u], vrow + (t >> 2) * S::BLOCK +
                                    (((2 * (t & 3) + hb) ^ (lane & 7)) << 4));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) tc::mma_bf16(o[t0 + u], a[u], b0, b1);
    }
  } else {
    // keys 2c, 2c+1, 2c+8, 2c+9 at columns 64G + 8g .. +7: 8-byte loads,
    // then (column, 4 keys) words by a 4 x 4 byte transpose
#pragma unroll
    for (int G = 0; G < 4; ++G) {
      const int ch = 4 * (G & 1) + (g >> 1);
      const char* base = vt + (G >> 1) * S::BLOCK + (g & 1) * 8;
      uint2 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int key = WK * w + 2 * c + (q & 1) + 8 * (q >> 1);
        v[q] = *reinterpret_cast<const uint2*>(base + key * 128 + ((ch ^ (key & 7)) << 4));
      }
      uint32_t lo[4], hi4[4];  // columns 8g + i and 8g + 4 + i, keys 2c, 2c+1, 2c+8, 2c+9
      transpose4(v[0].x, v[1].x, v[2].x, v[3].x, lo);
      transpose4(v[0].y, v[1].y, v[2].y, v[3].y, hi4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 xl = wg::i8x4_to_bf16x4(lo[i]);
        const uint2 xh = wg::i8x4_to_bf16x4(hi4[i]);
        const uint32_t a[4] = {xl.x, xh.x, xl.y, xh.y};
        tc::mma_bf16(o[4 * G + i], a, b0, b1);
      }
    }
  }
}

// The CTA, grid (G): lanes b < B of sp query-row slots each (the packed
// rows b*sp ..; decode: sp 1), nq / nkv = group heads per kv head; a
// pair's rows rr = ROWS zs + r of the lane's sp * group are (token rr /
// group, head h * group + rr % group).  Rows that are no query (token >=
// qn, every row of a lane without a tile) are written 0 by CTA b % G; the
// others by the pair's last run.  pair_cost: A of the cost axis (Walker).
// partials: PART floats per slot, B * nkv * slabs + G slots; tickets: one
// per pair, zero between calls (so calls that share them run in stream
// order).  `smem`: Smem<P>::ALLOC bytes.
template <typename P, typename Lanes>
__device__ __forceinline__ void split_kv_cta(
    const CUtensorMap* kv_map, const __nv_bfloat16* __restrict__ q,
    const float* __restrict__ scales, const int* __restrict__ page_table, Lanes lanes,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
    int* __restrict__ tickets, int B, int sp, int nq, int nkv, int ps, int W, int slabs,
    int pair_cost, float scale, float softcap, int window, char* smem) {
  using S = Smem<P>;
  __shared__ __align__(8) uint64_t full[S::NS];
  __shared__ __align__(8) uint64_t empty[S::NS];
  __shared__ __align__(8) uint64_t merge_bar[1];
  __shared__ int plan_s[3];  // C, the lane of the run's first position, its first pair's
  __shared__ float wm_s[CONSUMERS][ROWS];
  __shared__ float wl_s[CONSUMERS][ROWS];
  __shared__ int last_s[2];
  smem += (1024 - (smem_addr(smem) & 1023)) & 1023;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = gridDim.x;
  const int group = nq / nkv;
  const int pp = nkv * slabs;

  // C, and the lane holding position T0 of this CTA's run, from every
  // lane's metadata (a warp scan over the lanes)
  auto lane_cost = [&](int b) {
    const int n = b < B ? lane_range(lanes(b), W, ps, window).n : 0;
    return n > 0 ? (n + pair_cost) * pp : 0;
  };
  if (warp == 0) {
    int C = 0;
    for (int b0 = 0; b0 < B; b0 += 32)
      C += __reduce_add_sync(0xffffffffu, lane_cost(b0 + lane));
    const int T0 = (int)((int64_t)blockIdx.x * C / min(G, max(C, 1)));
    int b_first = B, c_first = C, cum = 0;
    for (int b0 = 0; b0 < B && T0 < C; b0 += 32) {
      const int n = lane_cost(b0 + lane);
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int excl = cum + incl - n;
      const unsigned hit = __ballot_sync(0xffffffffu, excl <= T0 && T0 < excl + n);
      if (hit) {
        const int src = __ffs(hit) - 1;
        b_first = b0 + src;
        c_first = __shfl_sync(0xffffffffu, excl, src);
        break;
      }
      cum += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      plan_s[0] = C;
      plan_s[1] = b_first;
      plan_s[2] = c_first;
    }
  }
  if (threadIdx.x == 32) {
    for (int i = 0; i < S::NS; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], CONSUMERS);
    }
    wg::mbar_init(merge_bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  // the runs: [i C / R, (i + 1) C / R) for CTA i < R = min(G, C); the runs
  // that hold a pair's tiles are the CTAs owner(P0) .. owner(P0 + n - 1),
  // each with at least one of them
  const int C = plan_s[0];
  const int R = min(G, C);
  const int T0 = blockIdx.x < R ? (int)((int64_t)blockIdx.x * C / R) : C;
  const int T1 = blockIdx.x < R ? (int)((int64_t)(blockIdx.x + 1) * C / R) : C;
  Walker<Lanes> wk{lanes, W, ps, window, pp, slabs, pair_cost};
  wk.start(T0, T1, plan_s[1], plan_s[2]);

  if (warp == CONSUMERS) {
    produce<P>(wk, kv_map, scales, page_table, nkv, smem, full, empty);
    return;
  }

  // ------------------------------------------------ consumer warps
  const int tid = threadIdx.x;  // 0 .. 32 CONSUMERS - 1
  const int g = lane >> 2;
  const int c = lane & 3;
  // rows that are no query, of lanes b = blockIdx.x + k G
  for (int b = blockIdx.x; b < B; b += G) {
    const LaneRange r = lane_range(lanes(b), W, ps, window);
    for (int j = 0; j < sp; ++j) {
      if (r.n > 0 && j < r.qn) continue;
      uint4* row = reinterpret_cast<uint4*>(out + (int64_t)(b * sp + j) * nq * D);
      for (int idx = tid; idx < nq * D / 8; idx += 32 * CONSUMERS)
        row[idx] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const float sk = scale * (softcap > 0.f ? 2.f * LOG2E / softcap : LOG2E);
  const float cap2 = softcap * LOG2E;
  const int rows_lane = sp * group;
  float* fold = reinterpret_cast<float*>(smem + S::FOLD);
  // a pair's rows that are queries: a prefix r < nr of its ROWS
  auto rows_of = [&](const Seg& sg) {
    return max(0, min(ROWS, min(rows_lane, sg.r.qn * group) - sg.zs * ROWS));
  };
  // global element offset of a pair's row r
  auto row_at = [&](const Seg& sg, int r) {
    const int rr = sg.zs * ROWS + r;
    return ((int64_t)(sg.b * sp + rr / group) * nq + sg.h * group + rr % group) * D;
  };
  // Q^T's B fragments: row g's dims delta(kk, c) .. +3 (0: no query)
  uint32_t qf[16][2];
  auto load_q = [&](const Seg& sg) {
    const bool ok = g < rows_of(sg);
    const __nv_bfloat16* src = q + (ok ? row_at(sg, g) : 0);
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint2 v = ok ? *reinterpret_cast<const uint2*>(src + delta<P>(kk, c))
                         : make_uint2(0u, 0u);
      qf[kk][0] = v.x;
      qf[kk][1] = v.y;
    }
  };
  Seg sg;
  bool more = wk.next(sg);
  if (more) load_q(sg);
  int k = 0;  // the run's tiles so far: stage k % NS, phase k / NS
  Duty duty0, duty1;
  int nduty = 0;
  while (more) {
    // the next segment, whose lane metadata loads meanwhile
    Seg nx;
    const bool more_nx = wk.next(nx);
    if (more_nx && g < rows_of(nx))  // its queries' lines into L1: line c of row g
      asm volatile("prefetch.global.L1 [%0];" :: "l"(q + row_at(nx, g) + 64 * c));
    const int nr = rows_of(sg);
    // the thread's softmax rows 2c, 2c+1 (-1: no query)
    int qpos[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qpos[e] = 2 * c + e < nr ? sg.r.kv0 + (sg.zs * ROWS + 2 * c + e) / group : -1;
    int qmin, qmax;
    tc::warp_span(qpos, qmin, qmax);
    float o[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
    float m[2] = {MASKED, MASKED};
    float l[2] = {0.f, 0.f};
    for (int t = sg.ta; t < sg.tb; ++t, ++k) {
      const int st = k % S::NS;
      wg::mbar_wait(&full[st], (k / S::NS) & 1);
      const int kb = sg.r.lo + t * KT + WK * warp;
      if (tc::warp_sees(kb, WK, qmin, qmax, window))
        attend<P>(o, m, l, qf, smem + st * S::STAGE, kb, sg.r.hi, qpos, window, sk, cap2);
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(&empty[st]);
    }
    // the next segment's queries load during this one's epilogue
    if (more_nx) load_q(nx);

    // the warps' fold: each writes (o, m, l) of the rows to shared memory
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], sh);
    {
      float* w0 = fold + (warp * ROWS + 2 * c) * FOLD_STRIDE;  // row 2c; 2c+1 follows
      if constexpr (!S::I8) {
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          w0[16 * t + g] = o[t][0];
          w0[FOLD_STRIDE + 16 * t + g] = o[t][1];
          w0[16 * t + 8 + g] = o[t][2];
          w0[FOLD_STRIDE + 16 * t + 8 + g] = o[t][3];
        }
      } else {
        // tiles 4G .. 4G+3 hold columns 64G + 8g + (0..3) and + (4..7)
#pragma unroll
        for (int G = 0; G < 4; ++G)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<float4*>(w0 + (e & 1) * FOLD_STRIDE + 64 * G + 8 * g +
                                       4 * (e >> 1)) =
                make_float4(o[4 * G][e], o[4 * G + 1][e], o[4 * G + 2][e], o[4 * G + 3][e]);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wm_s[warp][2 * c + e] = m[e];
          wl_s[warp][2 * c + e] = l[e];
        }
      }
    }
    wg::named_sync(FOLD_BAR, 32 * CONSUMERS);
    // then thread tid takes 4 columns of a query row per step: the rows,
    // or this run's partial of a pair that other runs share
    const int first = owner(sg.P0, C, R);
    const int runs = owner(sg.P0 + sg.r.n - 1, C, R) - first + 1;
    const int pair = (sg.b * nkv + sg.h) * slabs + sg.zs;
    float* part = partials + (int64_t)(pair + blockIdx.x) * PART;
    for (int idx = tid; idx < nr * (D / 4); idx += 32 * CONSUMERS) {
      const int r = idx / (D / 4);
      const int d = (idx - r * (D / 4)) * 4;
      float M = MASKED;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) M = fmaxf(M, wm_s[w][r]);
      float L = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        const float wt = fast_exp2(wm_s[w][r] - M);
        const float4 v =
            *reinterpret_cast<const float4*>(fold + (w * ROWS + r) * FOLD_STRIDE + d);
        L += wl_s[w][r] * wt;
        acc.x += v.x * wt;
        acc.y += v.y * wt;
        acc.z += v.z * wt;
        acc.w += v.w * wt;
      }
      if (runs == 1) {
        store_bf16(out + row_at(sg, r) + d, acc, L > 0.f ? 1.f / L : 0.f);
      } else {
        *reinterpret_cast<float4*>(part + r * D + d) = acc;
        if (d == 0) reinterpret_cast<float2*>(part + ROWS * D)[r] = make_float2(M, L);
      }
    }
    // a shared pair can only be the run's first or last: its ticket is
    // taken once the run is done
    if (runs > 1) (nduty++ == 0 ? duty0 : duty1) = Duty{sg, pair, first, runs, nr};
    wg::named_sync(FOLD_BAR, 32 * CONSUMERS);  // the fold's buffers free again
    sg = nx;
    more = more_nx;
  }

  // this run's tickets, after its partials (one fence for both); the last
  // run of a pair to take its ticket folds the pair's partials in run
  // order and resets the ticket
  if (nduty == 0) return;
  __threadfence();
  wg::named_sync(FOLD_BAR, 32 * CONSUMERS);
  if (tid == 0) last_s[0] = atomicAdd(tickets + duty0.pair, 1) == duty0.runs - 1;
  if (tid == 32 && nduty > 1) last_s[1] = atomicAdd(tickets + duty1.pair, 1) == duty1.runs - 1;
  wg::named_sync(FOLD_BAR, 32 * CONSUMERS);
  int parity = 0;
  for (int j = 0; j < nduty; ++j) {
    if (!last_s[j]) continue;
    const Duty& dt = j ? duty1 : duty0;
    if (dt.nr == 0) {  // a slab without a query row: nothing to merge
      if (tid == 0) tickets[dt.pair] = 0;
      continue;
    }
    __threadfence();
    // the pair's partials land by bulk copies in the idle ring (every tile
    // of the run was consumed): per run its nr rows of o, then its (m, l)
    // of every row; as many runs at once as fit
    const float* p0 = partials + (int64_t)(dt.pair + dt.first) * PART;
    const int rows_bytes = dt.nr * D * 4;
    const int slot_bytes = rows_bytes + ROWS * 8;
    const int batch = S::FOLD / slot_bytes;  // >= 20 runs
    constexpr int ITEMS = ROWS * (D / 4) / (32 * CONSUMERS);
    const int items = dt.nr * (D / 4);
    float4 acc[ITEMS];
    float mx[ITEMS], ls[ITEMS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      mx[u] = MASKED;
      ls[u] = 0.f;
    }
    for (int i0 = 0; i0 < dt.runs; i0 += batch) {
      const int nb = min(batch, dt.runs - i0);
      if (tid == 0) {
        wg::fence_async_shared();
        mbar_expect_tx(merge_bar, nb * slot_bytes);
        for (int i = 0; i < nb; ++i) {
          const float* src = p0 + (int64_t)(i0 + i) * PART;
          bulk_load(smem + i * slot_bytes, src, rows_bytes, merge_bar);
          bulk_load(smem + i * slot_bytes + rows_bytes, src + ROWS * D, ROWS * 8, merge_bar);
        }
        wg::mbar_arrive(merge_bar);
      }
      wg::mbar_wait(merge_bar, parity);
      parity ^= 1;
      // run order, each run rescaled to the running max of its row
      for (int i = 0; i < nb; ++i) {
        const char* slot = smem + i * slot_bytes;
#pragma unroll
        for (int u = 0; u < ITEMS; ++u) {
          const int idx = tid + u * 32 * CONSUMERS;
          if (idx < items) {
            const float2 ml = reinterpret_cast<const float2*>(slot + rows_bytes)[idx / (D / 4)];
            const float4 v = reinterpret_cast<const float4*>(slot)[idx];
            const float mn = fmaxf(mx[u], ml.x);
            const float a = fast_exp2(mx[u] - mn);
            const float wt = fast_exp2(ml.x - mn);
            mx[u] = mn;
            ls[u] = ls[u] * a + ml.y * wt;
            acc[u] = make_float4(acc[u].x * a + v.x * wt, acc[u].y * a + v.y * wt,
                                 acc[u].z * a + v.z * wt, acc[u].w * a + v.w * wt);
          }
        }
      }
      wg::named_sync(FOLD_BAR, 32 * CONSUMERS);  // the slots free for the next batch
    }
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int idx = tid + u * 32 * CONSUMERS;
      if (idx < items) {
        const int r = idx / (D / 4);
        store_bf16(out + row_at(dt.sg, r) + (idx - r * (D / 4)) * 4, acc[u],
                   ls[u] > 0.f ? 1.f / ls[u] : 0.f);
      }
    }
    if (tid == 0) tickets[dt.pair] = 0;
  }
}

// A launcher's checks before it launches the CTA: its plan (`ctas` CTAs,
// slabs of ROWS rows covering a lane's `rows`, a pair's cost) and scratch; then the
// cache's tensor map into `map` and the kernel's opt-in to Smem<P>::ALLOC
// bytes of dynamic shared memory.
template <typename P, typename Kernel>
inline cudaError_t prepare(Kernel kernel, tc::SmemOptIn& opt_in, const void* pages,
                           int num_pages, int nkv, int ps, int ctas, int slabs, int rows,
                           int pair_cost, const void* partials, const void* tickets,
                           CUtensorMap* map) {
  if (ctas <= 0 || slabs <= 0 || rows > slabs * ROWS || pair_cost < 0 ||
      partials == nullptr || tickets == nullptr)
    return cudaErrorInvalidValue;
  if (!wg::page_tensor_map(pages, num_pages, nkv, ps, D, (int)sizeof(P), map))
    return cudaErrorInvalidValue;
  return opt_in.ensure(kernel, Smem<P>::ALLOC);
}

}  // namespace s256
