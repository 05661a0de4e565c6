"""Wrappers of the hand-written CUDA paged-attention kernels (csrc/).

- `ragged_paged_attention_cuda` launches csrc/ragged_paged_attention.cu,
  the port of kserve_tpu/ops/pallas_paged_attention.py:_ragged_kernel.
- `paged_decode_attention_cuda` launches csrc/paged_decode_attention.cu,
  the port of :_decode_kernel and (at head_dim 64) :_packed_decode_kernel.
- `dense_ragged_paged_attention_cuda` launches
  csrc/dense_ragged_paged_attention.cu, the port of :_dense_ragged_kernel
  (the speculative-verify packing, lanes at a stride below RAGGED_BQ).

Each takes a layer's cache as the pages [P, 2, nkv, ps, d] in q's dtype or,
with int8 KV, the tuple (int8 pages, f32 scales [P, 2, nkv, ps]): the
function of the Pallas kernels' `quantized=True` form (for decode, of
kserve_tpu/ops/attention.py:paged_attention_xla's int8 branch).

Every kernel takes head_dim 64, 128 and 256 (`HEAD_DIMS`; any other
raises).  With bf16 q all three kernels run on the tensor cores (bf16
MMA, f32 accumulation; int8 rows become exact bf16 and their scales are
applied in f32 to the scores and to P).  At d 64/128 the dense and decode
kernels and the ragged kernel use mma.sync fed by cp.async double
buffering; the dense and decode kernels split each lane's keys across
CTAs (decode is the dense function at stride 1) and merge the splits
in-kernel, their grids host-side upper bounds from shapes alone
(`dense_launch_plan`, `decode_launch_plan`; the CTAs find their lane and
split from the lane metadata on the device and exit when they have
none).  At d=256 every kernel is fed by TMA through a warp-specialised
mbarrier ring (csrc/attention_wgmma.cuh; each builds a tensor map of the
cache per pages pointer and shape): the ragged kernel runs wgmma on
128-row tiles split across CTAs (`ragged_launch_plan`); the dense and
decode kernels run one persistent CTA per SM (csrc/attention_split256.cuh)
that takes an equal-cost run of the key tiles of every live (lane, kv head,
slab) on mma.sync, int8 rows dequantized in registers, the runs that share
a (lane, kv head, slab) merged in-kernel.  None of them syncs the host.
With f32 q each staged row is dequantized in f32 on CUDA cores (the
first design).

Each wrapper takes CUDA tensors only: it checks device, dtype (q bf16 or
f32), shape and contiguity, raises on anything its kernel does not take,
allocates the output with torch.empty, launches on the current stream
and raises if the launch failed.  The split kernels' f32 partials and
merge tickets are one scratch per device, reused in stream order
(`_split_scratch`).  A wrapper never
falls back to the plain version; the dispatchers in ops/attention.py
route CPU tensors to the plain versions before a wrapper is reached.
`LAUNCHES` counts launches, the int8 instances under their own `*_int8`
keys.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..engine.kvcache import KVLayer
from ._build import load_library

RAGGED_BQ = 8  # query tokens per kernel block; slices start at multiples
HEAD_DIMS = (64, 128, 256)
# element-type codes of the C entry points (q/out take 0 or 1, pages any)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_CODE = 1
_INT8_CODE = 2

_KERNELS = ("ragged_paged_attention", "paged_decode_attention",
            "dense_ragged_paged_attention")
#: kernel instance name -> launches in this process (chip_smoke.py zeroes
#: it before driving the main path and reads it after)
LAUNCHES = {f"{name}{suffix}": 0 for name in _KERNELS for suffix in ("", "_int8")}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


class _Checked(NamedTuple):
    """What _check_common found: the pages, the int8 scales (or None), the
    cache's kv heads and page size, and the C entry points' codes of q's
    and the pages' element types."""
    pages: torch.Tensor
    scales: Optional[torch.Tensor]
    nkv: int
    ps: int
    code: int
    kv_code: int


def _check_common(q: torch.Tensor, kv_pages: KVLayer, ints) -> _Checked:
    """Check what every kernel takes.  Each message is formatted only when
    its check fails, and each shape is read once: the wrappers run
    hundreds of times per engine step."""
    qshape = q.shape
    d = qshape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"CUDA kernel takes head_dim {HEAD_DIMS}, got {d}")
    if not q.is_cuda:
        raise ValueError(f"CUDA kernel needs CUDA tensors, got {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise ValueError(f"CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if isinstance(kv_pages, tuple):
        _require(len(kv_pages) == 2, "a quantized cache is (int8 pages, scales)")
        pages, scales = kv_pages
        if pages.dtype != torch.int8:
            raise ValueError(f"quantized pages must be int8, got {pages.dtype}")
        if scales.dtype != torch.float32:
            raise ValueError(f"KV scales must be float32, got {scales.dtype}")
        if scales.shape != pages.shape[:4]:
            raise ValueError(
                f"KV scales must be [P, 2, nkv, ps] = {tuple(pages.shape[:4])}, "
                f"got {tuple(scales.shape)}")
        extra, kv_code = (scales,), _INT8_CODE
    else:
        pages, scales, extra, kv_code = kv_pages, None, (), code
        if pages.dtype != q.dtype:
            raise ValueError(f"kv_pages dtype {pages.dtype} != q dtype {q.dtype}")
    pshape = pages.shape
    if len(pshape) != 5 or pshape[1] != 2:
        raise ValueError(f"kv_pages must be [P, 2, nkv, ps, d], got {tuple(pshape)}")
    _require(pshape[4] == d, "kv_pages head_dim != q head_dim")
    nq, nkv = qshape[-2], pshape[2]
    if nq % nkv:
        raise ValueError(f"n_heads {nq} not a multiple of n_kv_heads {nkv}")
    index = q.get_device()
    for t in (q, pages, *extra, *ints):
        _require(t.get_device() == index, "all tensors must be on one device")
        _require(t.is_contiguous(), "CUDA kernel needs contiguous tensors")
    for t in ints:
        if t.dtype != torch.int32:
            raise ValueError(f"index tensors must be int32, got {t.dtype}")
    _require(q.data_ptr() % 16 == 0 and pages.data_ptr() % 16 == 0,
             "q and kv_pages must be 16-byte aligned")
    return _Checked(pages, scales, nkv, pshape[3], code, kv_code)


def _scales_ptr(c: _Checked) -> Optional[int]:
    return None if c.scales is None else c.scales.data_ptr()


def _count(name: str, scales: Optional[torch.Tensor]) -> None:
    LAUNCHES[name if scales is None else name + "_int8"] += 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# tensor-core tiles of the bf16-q kernels (csrc/attention_tc.cuh)
TC_ROWS = 64  # query rows of a ragged CTA: 4 warps x one m16 slab
# the ragged kernel's wgmma design at head_dim 256 (csrc/attention_wgmma.cuh)
WGMMA_ROWS = 128  # query rows of a CTA: two consumer warpgroups
WGMMA_WG_ROWS = 64  # query rows of one consumer warpgroup (wgmma M)
WGMMA_KT = 64  # keys per staged K/V tile
# keys per split: as many as fill CARD_SMS CTAs with the grid's (tile, kv
# head) pairs at their longest, within these bounds
RAGGED_MIN_CHUNK = 512
RAGGED_MAX_CHUNK = 2048
CARD_SMS = 132  # an H100 SXM's streaming multiprocessors
SPLIT_ROWS = 16  # query rows of a split-KV (dense or decode) CTA: one m16 slab
SPLIT_MAX_SPLITS = 32  # splits per (lane, kv head, slab), at most
TC_KT = 64  # keys per staged K/V tile of the mma.sync kernels (tc::tile_keys)
# keys per split of the dense and decode kernels at head_dim <= 128, at least
DENSE_MIN_CHUNK = 128
DECODE_MIN_CHUNK = 128
# the dense and decode kernels at head_dim 256 (csrc/attention_split256.cuh)
S256_ROWS = 8  # query rows of a (lane, kv head, slab): the n of m16n8k16
S256_KT = 64  # keys per staged tile, the unit of the CTAs' equal runs
S256_CTAS = CARD_SMS  # a persistent grid: one CTA per SM (its ring's shared memory)
# what the partition charges a (lane, kv head, slab) for its epilogue, in
# key tiles, beside its tiles
S256_PAIR_COST = 2


class RaggedPlan(NamedTuple):
    """Launch shape of the bf16-q ragged kernel: CTA x takes the x-th
    tile of `tq` tokens in a prefix count of ceil(q_len / tq) per lane;
    grid (tiles, nkv, slabs * splits), slab z the rows [rows z, rows z +
    rows) of a tile's tq * group rows.  At head_dim 256 (the wgmma design)
    each tile's key range is split evenly into runs of at most `chunk` keys
    across `splits` CTAs, merged in the kernel; at d <= 128 chunk is 0 and
    one CTA walks a tile's keys."""
    tq: int
    tiles: int
    slabs: int
    rows: int
    chunk: int
    splits: int


@functools.lru_cache(maxsize=256)
def ragged_launch_plan(T: int, B: int, nq: int, nkv: int, keys: int,
                       d: int) -> RaggedPlan:
    """The ragged kernel's grid for a packed buffer of T tokens (slices at
    RAGGED_BQ-aligned offsets) of B lanes whose page tables hold `keys` =
    W * page_size positions, from these shapes alone.  tq is the largest
    power of two with tq * group <= rows (16 at group 4 with d <= 128's 64
    rows; 64 at group 2 with d=256's 128).  `tiles` bounds
    sum(ceil(q_len / tq)) for every packing of T: each tile starts on its
    own RAGGED_BQ block (tq >= 8), or each block holds RAGGED_BQ / tq tiles
    (tq < 8); at d=256 also ceil(q_len / tq) <= 8 * blocks / tq + 1 per
    lane, so B lanes need at most 8 G / tq + B.  At d=256 the CTAs x
    < tiles zero the padding rows of blocks x, x + tiles, ..; at d <= 128
    block x's (tiles >= G).  A tile's keys lie in [0, keys), so
    ceil(keys / chunk) splits of a multiple of WGMMA_KT keys cover any
    tile.  chunk is the key tiles of all (tile, kv head, slab) at their
    longest shared out over CARD_SMS CTAs (one wave: a CTA's fixed cost,
    its queries, pipeline fill and merge, is a few tiles' time), within
    [RAGGED_MIN_CHUNK, RAGGED_MAX_CHUNK] and few enough splits for
    SPLIT_MAX_SPLITS: 576 keys for a first 1,024-token chunk (its longest
    tiles in two runs), 2,048 for a chunk at 4,000 cached tokens."""
    group = nq // nkv
    rows = WGMMA_ROWS if d > 128 else TC_ROWS
    tq = 1
    while 2 * tq * group <= rows:
        tq *= 2
    G = T // RAGGED_BQ
    slabs = -(-tq * group // rows)
    if d <= 128:
        return RaggedPlan(tq=tq, tiles=G * max(1, RAGGED_BQ // tq), slabs=slabs,
                          rows=rows, chunk=0, splits=1)
    tiles = (G * (RAGGED_BQ // tq) if tq < RAGGED_BQ
             else min(G, RAGGED_BQ * G // tq + B))
    key_tiles = -(-keys // WGMMA_KT)
    chunk = -(-tiles * nkv * slabs * key_tiles // CARD_SMS) * WGMMA_KT
    chunk = min(max(chunk, RAGGED_MIN_CHUNK), RAGGED_MAX_CHUNK)
    chunk = max(chunk, -(-key_tiles // SPLIT_MAX_SPLITS) * WGMMA_KT)
    chunk = -(-chunk // WGMMA_KT) * WGMMA_KT
    return RaggedPlan(tq=tq, tiles=tiles, slabs=slabs, rows=rows, chunk=chunk,
                      splits=max(1, -(-keys // chunk)))


def ragged_scratch_shape(nkv: int, plan: RaggedPlan,
                         d: int) -> Tuple[int, int, int, int]:
    """f32 scratch of the d=256 ragged kernel's split partials: per
    (tile, kv head, slab, consumer warpgroup) slot and split, WGMMA_WG_ROWS
    rows of o [d], then the same rows' (m, l) pairs."""
    return (plan.tiles * nkv * plan.slabs * WGMMA_ROWS // WGMMA_WG_ROWS,
            plan.splits, WGMMA_WG_ROWS, d + 2)


class SplitPlan(NamedTuple):
    """Split-KV shape of the bf16-q dense and decode kernels.  At head_dim
    <= 128 (tc::split_kv_slab) each (lane, kv head, slab of SPLIT_ROWS
    rows) covers its keys in splits of `chunk` keys; grid (B, nkv * slabs,
    splits).  At d=256 (s256::split_kv_cta) `splits` CTAs share the
    S256_KT-key tiles of every (lane, kv head, slab of S256_ROWS rows) in
    runs of equal cost, a slab costing its tiles plus `chunk`
    (S256_PAIR_COST); grid (splits)."""
    chunk: int
    splits: int
    slabs: int


def _split_plan(W: int, page_size: int, rows: int, least: int,
                d: int) -> SplitPlan:
    """At d <= 128: a lane's keys lie in [0, W * page_size), so ceil(W *
    page_size / chunk) splits cover any lane; chunk is a multiple of
    TC_KT, at least `least`, and large enough for at most
    SPLIT_MAX_SPLITS.  At d=256: S256_CTAS CTAs, whatever the table.
    `rows` query rows per lane and kv head take ceil(rows / slab rows)
    slabs."""
    if d > 128:
        return SplitPlan(chunk=S256_PAIR_COST, splits=S256_CTAS,
                         slabs=-(-rows // S256_ROWS))
    keys = W * page_size
    chunk = max(least, -(-keys // SPLIT_MAX_SPLITS))
    chunk = -(-chunk // TC_KT) * TC_KT
    return SplitPlan(chunk=chunk, splits=max(1, -(-keys // chunk)),
                     slabs=-(-rows // SPLIT_ROWS))


@functools.lru_cache(maxsize=256)
def dense_launch_plan(W: int, page_size: int, sp: int, nq: int, nkv: int,
                      d: int) -> SplitPlan:
    """The dense kernel's grid for page tables of W pages, sp * group rows
    per lane and kv head, head_dim d; splits of at least DENSE_MIN_CHUNK
    keys at d <= 128."""
    return _split_plan(W, page_size, sp * (nq // nkv), DENSE_MIN_CHUNK, d)


@functools.lru_cache(maxsize=256)
def decode_launch_plan(W: int, page_size: int, nq: int, nkv: int,
                       d: int) -> SplitPlan:
    """The decode kernel's grid for page tables of W pages: the dense
    plan at stride 1 (group rows per lane and kv head); splits of at least
    DECODE_MIN_CHUNK keys at d <= 128.  The grid is a bound from shapes
    alone: each CTA finds its lane's key range from seq_lens in the kernel
    (at d=256 every CTA its run of all lanes' key tiles), so no host sync
    and no launch is needed to plan."""
    return _split_plan(W, page_size, nq // nkv, DECODE_MIN_CHUNK, d)


_NO_PLAN = SplitPlan(chunk=0, splits=0, slabs=0)  # the f32 designs have none


def split_scratch_shape(B: int, nkv: int, plan: SplitPlan,
                        d: int) -> Tuple[int, int, int, int]:
    """f32 scratch of the split partials of one call, (slots, splits, rows,
    width), bounded from shapes alone; there is a merge ticket per slot.
    At d <= 128: per (lane, kv head, slab) and split, SPLIT_ROWS rows of o
    [d], then the same rows' (m, l) pairs (the kernel's layout: o [slots,
    splits, rows, d] followed by (m, l) [slots, splits, rows, 2]).  At
    d=256: a partial of S256_ROWS rows of o [d] and their (m, l) per run
    of a (lane, kv head, slab), the run of CTA i of pair p in slot p + i
    (p + i is unique among the pairs a run touches, so B * nkv * slabs +
    splits slots hold any call's)."""
    if d > 128:
        return (B * nkv * plan.slabs + plan.splits, 1, S256_ROWS, d + 2)
    return (B * nkv * plan.slabs, plan.splits, SPLIT_ROWS, d + 2)


class _Scratch(NamedTuple):
    partials: torch.Tensor  # f32 split partials
    tickets: torch.Tensor  # int32 merge tickets
    partials_ptr: int
    tickets_ptr: int


# device index -> the split-KV kernels' scratch, grown on demand and
# shared by every dense and decode call on the device.  Calls reuse it in
# stream order: each launches on the current stream, which the port
# leaves at the device's default stream (the engine's dispatch threads,
# its decode loop and the spec path's depth-2 chain all enqueue there),
# so a call's CTAs start after the previous call's merge.  Tickets are
# zero between calls: zeroed when made, reset by each merging CTA.  No
# per-call allocation, so a CUDA graph of the decode loop can capture the
# calls as they are.
_SCRATCH: Dict[int, _Scratch] = {}


def _split_scratch(q: torch.Tensor,
                   shape: Tuple[int, int, int, int]) -> Tuple[int, int]:
    """(partials pointer, tickets pointer) for one split-KV call whose
    scratch has `shape` (slots, splits, rows, width)."""
    slots, splits, rows, width = shape
    floats = slots * splits * rows * width
    index = q.get_device()
    sc = _SCRATCH.get(index)
    if sc is None or sc.partials.numel() < floats or sc.tickets.numel() < slots:
        partials, tickets = (None, None) if sc is None else sc[:2]
        if partials is None or partials.numel() < floats:
            partials = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                                   device=q.device)
        if tickets is None or tickets.numel() < slots:
            tickets = torch.zeros(max(slots, 1024), dtype=torch.int32,
                                  device=q.device)
        sc = _Scratch(partials, tickets, partials.data_ptr(), tickets.data_ptr())
        _SCRATCH[index] = sc
    return sc.partials_ptr, sc.tickets_ptr


def _stream(q: torch.Tensor) -> int:
    """The current stream of q's device, where every launch goes."""
    return torch.cuda.current_stream(q.get_device()).cuda_stream


def ragged_paged_attention_cuda(
    q: torch.Tensor,  # [T, nq, d], slices at RAGGED_BQ-aligned offsets
    kv_pages: KVLayer,  # [num_pages, 2, nkv, ps, d] or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W] int32
    q_start: torch.Tensor,  # [B] int32, multiples of RAGGED_BQ
    q_len: torch.Tensor,  # [B] int32 (0 = inactive lane)
    kv_start: torch.Tensor,  # [B] int32
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,  # > 0: sliding-window width
) -> torch.Tensor:
    ints = (page_table, q_start, q_len, kv_start)
    c = _check_common(q, kv_pages, ints)
    T, nq, d = q.shape
    if T % RAGGED_BQ:
        raise ValueError(f"ragged buffer length {T} not a multiple of RAGGED_BQ="
                         f"{RAGGED_BQ}; pad the packed buffer")
    B, W = page_table.shape
    _require(q_start.shape == (B,) and q_len.shape == (B,)
             and kv_start.shape == (B,), "lane metadata must be [B]")
    plan = ragged_launch_plan(T, B, nq, c.nkv, W * c.ps, d)
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    partials_ptr = tickets_ptr = None
    if plan.chunk and c.code == _BF16_CODE:
        partials_ptr, tickets_ptr = _split_scratch(
            q, ragged_scratch_shape(c.nkv, plan, d))
    lib = load_library()
    err = lib.kt_ragged_paged_attention(
        q.data_ptr(), c.pages.data_ptr(), _scales_ptr(c), page_table.data_ptr(),
        q_start.data_ptr(), q_len.data_ptr(), kv_start.data_ptr(),
        out.data_ptr(), partials_ptr, tickets_ptr, B, T // RAGGED_BQ, plan.tq,
        plan.tiles, plan.slabs, plan.chunk, plan.splits, nq, c.nkv, d, c.ps, W,
        c.pages.shape[0], float(scale), float(logit_softcap), int(window),
        c.code, c.kv_code, _stream(q))
    _raise_on(err, "ragged_paged_attention")
    _count("ragged_paged_attention", c.scales)
    return out


def paged_decode_attention_cuda(
    q: torch.Tensor,  # [B, nq, d], one decode token per lane
    kv_pages: KVLayer,  # [num_pages, 2, nkv, ps, d] or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W] int32
    seq_lens: torch.Tensor,  # [B] int32 (0 = inactive lane)
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention on the card: with bf16 q the split-KV tensor-core
    kernel (plan from decode_launch_plan, scratch from _split_scratch), with
    f32 q the CUDA-core one."""
    c = _check_common(q, kv_pages, (page_table, seq_lens))
    B, nq, d = q.shape
    Bt, W = page_table.shape
    _require(Bt == B and seq_lens.shape == (B,),
             "page_table/seq_lens must cover the batch")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    partials_ptr = tickets_ptr = None
    plan = _NO_PLAN
    if c.code == _BF16_CODE:
        plan = decode_launch_plan(W, c.ps, nq, c.nkv, d)
        partials_ptr, tickets_ptr = _split_scratch(
            q, split_scratch_shape(B, c.nkv, plan, d))
    lib = load_library()
    err = lib.kt_paged_decode_attention(
        q.data_ptr(), c.pages.data_ptr(), _scales_ptr(c), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), partials_ptr, tickets_ptr, B, nq,
        c.nkv, d, c.ps, W, c.pages.shape[0], plan.chunk, plan.splits, plan.slabs, float(scale),
        float(logit_softcap), int(window), c.code, c.kv_code, _stream(q))
    _raise_on(err, "paged_decode_attention")
    _count("paged_decode_attention", c.scales)
    return out


def dense_ragged_paged_attention_cuda(
    q: torch.Tensor,  # [B*sp, nq, d], lane i's slice at rows i*sp ..
    kv_pages: KVLayer,  # [num_pages, 2, nkv, ps, d] or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W] int32
    q_len: torch.Tensor,  # [B] int32, <= sp (0 = the lane reads nothing)
    kv_start: torch.Tensor,  # [B] int32
    dense_stride: int,  # sp: divides RAGGED_BQ
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    c = _check_common(q, kv_pages, (page_table, q_len, kv_start))
    T, nq, d = q.shape
    B, W = page_table.shape
    sp = int(dense_stride)
    if not (0 < sp < RAGGED_BQ and RAGGED_BQ % sp == 0):
        raise ValueError(f"dense_stride {sp} must divide RAGGED_BQ={RAGGED_BQ}")
    if T != B * sp:
        raise ValueError(f"dense packing expects T == B*stride ({B}*{sp}), got T={T}")
    _require(q_len.shape == (B,) and kv_start.shape == (B,),
             "lane metadata must be [B]")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    partials_ptr = tickets_ptr = None
    plan = _NO_PLAN
    if c.code == _BF16_CODE:
        plan = dense_launch_plan(W, c.ps, sp, nq, c.nkv, d)
        partials_ptr, tickets_ptr = _split_scratch(
            q, split_scratch_shape(B, c.nkv, plan, d))
    lib = load_library()
    err = lib.kt_dense_ragged_paged_attention(
        q.data_ptr(), c.pages.data_ptr(), _scales_ptr(c), page_table.data_ptr(),
        kv_start.data_ptr(), q_len.data_ptr(), out.data_ptr(), partials_ptr,
        tickets_ptr, B, sp, nq, c.nkv, d, c.ps, W, c.pages.shape[0], plan.chunk,
        plan.splits, plan.slabs, float(scale), float(logit_softcap), int(window),
        c.code, c.kv_code, _stream(q))
    _raise_on(err, "dense_ragged_paged_attention")
    _count("dense_ragged_paged_attention", c.scales)
    return out
