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
int8 instances dequantize each staged row by its scale in f32 (the
Pallas kernels' `quantized=True` form; for decode, the function of
kserve_tpu/ops/attention.py:paged_attention_xla's int8 branch).

Each wrapper takes CUDA tensors only: it checks device, dtype (q bf16 or
f32), shape and contiguity, raises on anything its kernel does not take,
allocates the output with torch.empty, launches on the current stream and
raises if the launch failed.  It never falls back to the plain version;
the dispatchers in ops/attention.py route CPU tensors to the plain
versions before a wrapper is reached.  `LAUNCHES` counts launches, the
int8 instances under their own `*_int8` keys.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def ragged_block_metadata(q_start: torch.Tensor, q_len: torch.Tensor,
                          G: int, bq: int = RAGGED_BQ):
    """[G] (lane index, first query offset) per bq-token block, on the
    device with no host sync; blocks outside every slice get lane -1.
    Port of kserve_tpu/ops/pallas_paged_attention.py:_ragged_block_metadata."""
    blk0 = torch.arange(G, dtype=torch.int32, device=q_start.device) * bq
    member = ((blk0[None, :] >= q_start[:, None])
              & (blk0[None, :] < (q_start + q_len)[:, None]))  # [B, G]
    hit = member.any(dim=0)
    lane = member.to(torch.int32).argmax(dim=0).to(torch.int32)
    block_seq = torch.where(hit, lane, torch.full_like(lane, -1))
    block_qoff = torch.where(hit, blk0 - q_start[lane],
                             torch.zeros_like(blk0))
    return block_seq.contiguous(), block_qoff.to(torch.int32).contiguous()


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
    G = T // RAGGED_BQ
    block_seq, block_qoff = ragged_block_metadata(q_start, q_len, G)
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    out = torch.empty_like(q)
    lib = load_library()
    pages_ptr, scales_ptr, kv_code = _page_args(q, pages, scales)
    err = lib.kt_ragged_paged_attention(
        q.data_ptr(), pages_ptr, scales_ptr, page_table.data_ptr(),
        block_seq.data_ptr(), block_qoff.data_ptr(), kv_start.data_ptr(),
        q_len.data_ptr(), out.data_ptr(), G, nq, pages.shape[2], d,
        pages.shape[3], W, float(scale), float(logit_softcap),
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
    out = torch.empty_like(q)
    lib = load_library()
    pages_ptr, scales_ptr, kv_code = _page_args(q, pages, scales)
    err = lib.kt_dense_ragged_paged_attention(
        q.data_ptr(), pages_ptr, scales_ptr, page_table.data_ptr(),
        kv_start.data_ptr(), q_len.data_ptr(), out.data_ptr(), B, sp, nq,
        pages.shape[2], d, pages.shape[3], W, float(scale),
        float(logit_softcap), int(window), _DTYPE_CODES[q.dtype], kv_code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "dense_ragged_paged_attention")
    _count("dense_ragged_paged_attention", scales)
    return out
