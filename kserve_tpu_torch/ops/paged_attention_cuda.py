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

With bf16 q the ragged and dense kernels run on the tensor cores (bf16
MMA, f32 accumulation; int8 rows become exact bf16 and their scales are
applied in f32 to the scores and to P); their launch shapes come from
`ragged_launch_plan` and `dense_launch_plan`, host-side upper bounds
computed from shapes alone (no host sync): the kernels' CTAs find their
own lane and split and exit when they have none.  With f32 q, and in the
decode kernel, each staged row is dequantized in f32 on CUDA cores.

Each wrapper takes CUDA tensors only: it checks device, dtype (q bf16 or
f32), shape and contiguity, raises on anything its kernel does not take,
allocates the output (and the dense kernel's split scratch) with
torch.empty, launches on the current stream and raises if the launch
failed.  It never falls back to the plain version; the dispatchers in
ops/attention.py route CPU tensors to the plain versions before a wrapper
is reached.  `LAUNCHES` counts launches, the int8 instances under their
own `*_int8` keys.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..engine.kvcache import KVLayer
from ._build import load_library

RAGGED_BQ = 8  # query tokens per kernel block; slices start at multiples
HEAD_DIMS = (64, 128)
# element-type codes of the C entry points (q/out take 0 or 1, pages any)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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


def _check_common(q: torch.Tensor, kv_pages: KVLayer,
                  ints) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Check what every kernel takes; returns (pages, scales or None)."""
    _require(q.is_cuda, f"CUDA kernel needs CUDA tensors, got {q.device}")
    _require(q.dtype in _DTYPE_CODES,
             f"CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if isinstance(kv_pages, tuple):
        _require(len(kv_pages) == 2, "a quantized cache is (int8 pages, scales)")
        pages, scales = kv_pages
        _require(pages.dtype == torch.int8,
                 f"quantized pages must be int8, got {pages.dtype}")
        _require(scales.dtype == torch.float32,
                 f"KV scales must be float32, got {scales.dtype}")
        _require(tuple(scales.shape) == tuple(pages.shape[:4]),
                 f"KV scales must be [P, 2, nkv, ps] = {tuple(pages.shape[:4])}, "
                 f"got {tuple(scales.shape)}")
        extra = (scales,)
    else:
        pages, scales, extra = kv_pages, None, ()
        _require(pages.dtype == q.dtype,
                 f"kv_pages dtype {pages.dtype} != q dtype {q.dtype}")
    _require(pages.dim() == 5 and pages.shape[1] == 2,
             f"kv_pages must be [P, 2, nkv, ps, d], got {tuple(pages.shape)}")
    d = q.shape[-1]
    _require(d in HEAD_DIMS, f"CUDA kernel takes head_dim {HEAD_DIMS}, got {d}")
    _require(pages.shape[4] == d, "kv_pages head_dim != q head_dim")
    nq, nkv = q.shape[-2], pages.shape[2]
    _require(nq % nkv == 0, f"n_heads {nq} not a multiple of n_kv_heads {nkv}")
    for t in (q, pages, *extra, *ints):
        _require(t.device == q.device, "all tensors must be on one device")
        _require(t.is_contiguous(), "CUDA kernel needs contiguous tensors")
    for t in ints:
        _require(t.dtype == torch.int32, f"index tensors must be int32, got {t.dtype}")
    _require(q.data_ptr() % 16 == 0 and pages.data_ptr() % 16 == 0,
             "q and kv_pages must be 16-byte aligned")
    return pages, scales


def _page_args(q: torch.Tensor, pages: torch.Tensor,
               scales: Optional[torch.Tensor]):
    """(pages pointer, scales pointer or None, page dtype code)."""
    if scales is None:
        return pages.data_ptr(), None, _DTYPE_CODES[q.dtype]
    return pages.data_ptr(), scales.data_ptr(), _INT8_CODE


def _count(name: str, scales: Optional[torch.Tensor]) -> None:
    LAUNCHES[name if scales is None else name + "_int8"] += 1


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


# tensor-core tiles of the bf16-q kernels (csrc/attention_tc.cuh)
TC_ROWS = 64  # query rows of a ragged CTA: 4 warps x one m16 slab
TC_KT = 64  # keys per staged K/V tile
DENSE_ROWS = 16  # query rows of a dense CTA: one m16 slab
DENSE_MIN_CHUNK = 128  # keys per split, at least
DENSE_MAX_SPLITS = 32  # splits per (lane, kv head, slab), at most


class RaggedPlan(NamedTuple):
    """Launch shape of the bf16-q ragged kernel: CTA x takes the x-th
    tile of `tq` tokens in a prefix count of ceil(q_len / tq) per lane;
    grid (tiles, nkv, slabs), slab z the rows [64z, 64z+64) of a tile's
    tq * group rows."""
    tq: int
    tiles: int
    slabs: int


def ragged_launch_plan(T: int, nq: int, nkv: int) -> RaggedPlan:
    """The ragged kernel's grid for a packed buffer of T tokens (slices at
    RAGGED_BQ-aligned offsets): tq is the largest power of two with
    tq * group <= TC_ROWS (16 at group 4), and `tiles` bounds
    sum(ceil(q_len / tq)) for every packing of T, since each tile starts on
    its own RAGGED_BQ block (tq >= 8) or each block holds RAGGED_BQ / tq
    tiles (tq < 8)."""
    group = nq // nkv
    tq = 1
    while 2 * tq * group <= TC_ROWS:
        tq *= 2
    G = T // RAGGED_BQ
    return RaggedPlan(tq=tq, tiles=G * max(1, RAGGED_BQ // tq),
                      slabs=-(-tq * group // TC_ROWS))


class DensePlan(NamedTuple):
    """Split-KV shape of the bf16-q dense kernel: each (lane, kv head,
    slab of DENSE_ROWS rows) covers its keys in splits of `chunk` keys;
    grid (B, nkv * slabs, splits)."""
    chunk: int
    splits: int
    slabs: int


def dense_launch_plan(W: int, page_size: int, sp: int, nq: int,
                      nkv: int) -> DensePlan:
    """The dense kernel's grid for page tables of W pages: a lane's keys
    lie in [0, W * page_size), so ceil(W * page_size / chunk) splits
    cover any lane.  chunk is a multiple of TC_KT, at least
    DENSE_MIN_CHUNK, and large enough for at most DENSE_MAX_SPLITS."""
    keys = W * page_size
    chunk = max(DENSE_MIN_CHUNK, -(-keys // DENSE_MAX_SPLITS))
    chunk = -(-chunk // TC_KT) * TC_KT
    return DensePlan(chunk=chunk, splits=max(1, -(-keys // chunk)),
                     slabs=-(-sp * (nq // nkv) // DENSE_ROWS))


def dense_scratch_shape(B: int, nkv: int, plan: DensePlan,
                        d: int) -> Tuple[int, int, int, int]:
    """f32 scratch of the split partials, as one buffer: per (lane, kv
    head, slab) and split, DENSE_ROWS rows of o [d], then the same rows'
    (m, l) pairs (the kernel's layout: o [slots, splits, rows, d] followed
    by (m, l) [slots, splits, rows, 2])."""
    return (B * nkv * plan.slabs, plan.splits, DENSE_ROWS, d + 2)


# device -> int32 merge tickets of the dense kernel, zero between calls
# (the merging CTA resets its ticket); grown on demand, shared by calls in
# stream order
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def _dense_tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


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
    pages, scales = _check_common(q, kv_pages, ints)
    T, nq, d = q.shape
    _require(T % RAGGED_BQ == 0,
             f"ragged buffer length {T} not a multiple of RAGGED_BQ="
             f"{RAGGED_BQ}; pad the packed buffer")
    B, W = page_table.shape
    _require(q_start.shape == (B,) and q_len.shape == (B,)
             and kv_start.shape == (B,), "lane metadata must be [B]")
    nkv = pages.shape[2]
    plan = ragged_launch_plan(T, nq, nkv)
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    lib = load_library()
    pages_ptr, scales_ptr, kv_code = _page_args(q, pages, scales)
    err = lib.kt_ragged_paged_attention(
        q.data_ptr(), pages_ptr, scales_ptr, page_table.data_ptr(),
        q_start.data_ptr(), q_len.data_ptr(), kv_start.data_ptr(),
        out.data_ptr(), B, T // RAGGED_BQ, plan.tq, plan.tiles, plan.slabs,
        nq, nkv, d, pages.shape[3], W, float(scale), float(logit_softcap),
        int(window), _DTYPE_CODES[q.dtype], kv_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "ragged_paged_attention")
    _count("ragged_paged_attention", scales)
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
    ints = (page_table, seq_lens)
    pages, scales = _check_common(q, kv_pages, ints)
    B, nq, d = q.shape
    _require(page_table.shape[0] == B and seq_lens.shape == (B,),
             "page_table/seq_lens must cover the batch")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    lib = load_library()
    pages_ptr, scales_ptr, kv_code = _page_args(q, pages, scales)
    err = lib.kt_paged_decode_attention(
        q.data_ptr(), pages_ptr, scales_ptr, page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, nq, pages.shape[2], d,
        pages.shape[3], page_table.shape[1], float(scale),
        float(logit_softcap), int(window), _DTYPE_CODES[q.dtype], kv_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "paged_decode_attention")
    _count("paged_decode_attention", scales)
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
    ints = (page_table, q_len, kv_start)
    pages, scales = _check_common(q, kv_pages, ints)
    T, nq, d = q.shape
    B, W = page_table.shape
    sp = int(dense_stride)
    _require(0 < sp < RAGGED_BQ and RAGGED_BQ % sp == 0,
             f"dense_stride {sp} must divide RAGGED_BQ={RAGGED_BQ}")
    _require(T == B * sp, f"dense packing expects T == B*stride ({B}*{sp}), got T={T}")
    _require(q_len.shape == (B,) and kv_start.shape == (B,),
             "lane metadata must be [B]")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    nkv, ps = pages.shape[2], pages.shape[3]
    out = torch.empty_like(q)
    partials_ptr = tickets_ptr = None
    plan = DensePlan(chunk=0, splits=0, slabs=0)  # the f32 design has none
    if q.dtype == torch.bfloat16:
        plan = dense_launch_plan(W, ps, sp, nq, nkv)
        shape = dense_scratch_shape(B, nkv, plan, d)
        partials = torch.empty(shape, dtype=torch.float32, device=q.device)
        partials_ptr = partials.data_ptr()
        tickets_ptr = _dense_tickets(q.device, shape[0]).data_ptr()
    lib = load_library()
    pages_ptr, scales_ptr, kv_code = _page_args(q, pages, scales)
    err = lib.kt_dense_ragged_paged_attention(
        q.data_ptr(), pages_ptr, scales_ptr, page_table.data_ptr(),
        kv_start.data_ptr(), q_len.data_ptr(), out.data_ptr(), partials_ptr,
        tickets_ptr, B, sp, nq, nkv, d, ps, W, plan.chunk, plan.splits,
        plan.slabs, float(scale), float(logit_softcap), int(window),
        _DTYPE_CODES[q.dtype], kv_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dense_ragged_paged_attention")
    _count("dense_ragged_paged_attention", scales)
    return out
