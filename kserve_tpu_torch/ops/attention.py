"""Attention over the paged KV cache: the plain PyTorch versions and the
dispatchers that route to the hand-written CUDA kernels.

Port of kserve_tpu/ops/attention.py (the decode and ragged paths):

- `paged_attention_plain` / `ragged_paged_attention_plain` are the gather
  versions (`paged_attention_xla` :171, `ragged_paged_attention_xla` :326).
  They materialize the gathered KV, run on any device, and are what the
  CPU tests and chip_smoke.py hold the kernels against.
- `paged_attention` / `ragged_paged_attention` dispatch on the tensor's
  device: a CPU tensor takes the plain version, a CUDA tensor launches the
  kernel (ops/paged_attention_cuda.py) or raises.  There is no size
  threshold: on the card the kernel always runs.
- `ragged_paged_attention(..., dense_stride=sp)` with sp < RAGGED_BQ is
  the speculative-verify packing (lane i's slice at offset i*sp, so lanes
  share kernel blocks): on the card it goes to the dense-stride kernel.
  The plain version is per-token and serves any packing, so it is the
  plain version of both ragged kernels.

- `causal_prefill_attention` / `chunked_prefill_attention` are the
  legacy prefill programs' attention (:57, :116): XLA code in the JAX
  package, no Pallas kernel, so plain PyTorch on the card as well.

Every paged function takes a layer's cache as the pages [P, 2, nkv, ps,
d] or, with int8 KV, the tuple (int8 pages, f32 scales [P, 2, nkv, ps]).
The plain versions of the kernels dequantize int8 rows in f32, as the
Pallas kernels do (pallas_paged_attention.py:512-516, :659-663), since
they are those kernels' plain versions; the JAX package's XLA gather
rounds the dequantized rows to bf16 instead (ROADMAP §C), and so does
`chunked_prefill_attention`, its port.

`window` is a Python int (0 = full attention), `scale` None means
1/sqrt(head_dim).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engine.kvcache import KVLayer, dequantize_rows
from . import paged_attention_cuda as _cuda

_MASKED = -1e30


def _gather_history(kv_pages: KVLayer, page_table: torch.Tensor,
                    int8_dtype: torch.dtype = torch.float32):
    """Gather each lane's pages -> (k [B, W*ps, nkv, d], v [B, W*ps, nkv, d]),
    int8 rows dequantized in f32 and cast to `int8_dtype`."""
    B, W = page_table.shape
    if isinstance(kv_pages, tuple):
        pages, scales = kv_pages
        table = page_table.long()
        gathered = dequantize_rows(pages[table], scales[table], int8_dtype)
    else:
        gathered = kv_pages[page_table.long()]  # [B, W, 2, nkv, ps, d]
    nkv, ps, d = gathered.shape[3], gathered.shape[4], gathered.shape[5]
    k = gathered[:, :, 0].permute(0, 1, 3, 2, 4).reshape(B, W * ps, nkv, d)
    v = gathered[:, :, 1].permute(0, 1, 3, 2, 4).reshape(B, W * ps, nkv, d)
    return k, v


def paged_attention_plain(
    q: torch.Tensor,  # [B, nq, d], one decode token per lane
    kv_pages: KVLayer,  # [num_pages, 2, nkv, ps, d] or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W]
    seq_lens: torch.Tensor,  # [B] int (length INCLUDING the current token)
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention by gather + masked softmax (f32 math)."""
    B, nq, d = q.shape
    k, v = _gather_history(kv_pages, page_table)
    L, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qg = q.float().reshape(B, nkv, group, d)
    scores = torch.einsum("bkgd,blkd->bkgl", qg, k.float()) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    pos = torch.arange(L, dtype=torch.int32, device=q.device)
    seq_lens = seq_lens.to(q.device)
    mask = pos[None, :] < seq_lens[:, None]  # [B, L]
    if window > 0:
        dist = (seq_lens[:, None] - 1) - pos[None, :]
        mask = mask & (dist < window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, _MASKED))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", weights, v.float()).reshape(B, nq, d)
    # an inactive lane (seq_len 0) is exactly 0, as in the Pallas and CUDA
    # kernels; the JAX gather returned the mean of its null-page rows
    out = torch.where((seq_lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def ragged_token_metadata(q_start: torch.Tensor, q_len: torch.Tensor, T: int):
    """Per-token (lane index, local offset, validity) for a packed ragged
    buffer of T tokens, derived on the tensor's device.  Tokens outside
    every lane's slice get lane -1."""
    idx = torch.arange(T, dtype=torch.int32, device=q_start.device)
    member = ((idx[None, :] >= q_start[:, None])
              & (idx[None, :] < (q_start + q_len)[:, None]))  # [B, T]
    valid = member.any(dim=0)
    lane = member.to(torch.int32).argmax(dim=0).to(torch.int32)
    token_seq = torch.where(valid, lane, torch.full_like(lane, -1))
    token_loc = idx - q_start[lane]
    return token_seq, token_loc, valid


def ragged_paged_attention_plain(
    q: torch.Tensor,  # [T, nq, d] packed ragged query buffer
    kv_pages: KVLayer,  # [num_pages, 2, nkv, ps, d] or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W]
    q_start: torch.Tensor,  # [B] first packed index of each lane's slice
    q_len: torch.Tensor,  # [B] slice length (0 = inactive lane)
    kv_start: torch.Tensor,  # [B] tokens cached BEFORE this slice
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Gather version of the ragged contract: query j of lane i sits at
    kv_start[i]+j and attends causally to the lane's pages (already holding
    the slice's own K/V).  Rows outside every slice are exactly 0."""
    T, nq, d = q.shape
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    k_all, v_all = _gather_history(kv_pages, page_table)  # [B, L, nkv, d]
    L, nkv = k_all.shape[1], k_all.shape[2]
    group = nq // nkv
    token_seq, token_loc, valid = ragged_token_metadata(q_start, q_len, T)
    seq_ix = token_seq.clamp(min=0).long()
    q_pos = kv_start[seq_ix] + token_loc  # [T] absolute query positions
    k_t = k_all[seq_ix]  # [T, L, nkv, d]
    v_t = v_all[seq_ix]
    qg = q.float().reshape(T, nkv, group, d)
    scores = torch.einsum("tkgd,tlkd->tkgl", qg, k_t.float()) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kpos = torch.arange(L, dtype=torch.int32, device=q.device)
    mask = (kpos[None, :] <= q_pos[:, None]) & valid[:, None]  # [T, L]
    if window > 0:
        dist = q_pos[:, None] - kpos[None, :]
        mask = mask & (dist < window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, _MASKED))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgl,tlkd->tkgd", weights, v_t.float()).reshape(T, nq, d)
    out = torch.where(valid[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, scale: Optional[float],
                logit_softcap: float) -> torch.Tensor:
    """Masked GQA softmax attention in f32: q [B, Tq, nq, d], k/v [B, Tk,
    nkv, d], mask [B, Tq, Tk] bool -> [B, Tq, nq, d] in q's dtype."""
    B, Tq, nq, d = q.shape
    nkv = k.shape[2]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qg = q.float().reshape(B, Tq, nkv, nq // nkv, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    if logit_softcap > 0.0:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _MASKED))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", weights, v.float())
    return out.reshape(B, Tq, nq, d).to(q.dtype)


def causal_prefill_attention(
    q: torch.Tensor,  # [B, T, nq, d]
    k: torch.Tensor,  # [B, T, nkv, d]
    v: torch.Tensor,  # [B, T, nkv, d]
    valid_len: torch.Tensor,  # [B] int
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal self-attention over padded prompts, reading no cache (port
    of kserve_tpu/ops/attention.py:57).  Keys past valid_len are masked;
    window > 0 keeps the last `window` keys of each query."""
    T = q.shape[1]
    t = torch.arange(T, device=q.device)
    mask = ((t[None, :] <= t[:, None])[None]
            & (t[None, :] < valid_len.to(q.device)[:, None])[:, None, :])
    if window > 0:
        mask = mask & ((t[:, None] - t[None, :]) < window)[None]
    return _gqa_attend(q, k, v, mask, scale, logit_softcap)


def chunked_prefill_attention(
    q: torch.Tensor,  # [B, C, nq, d] the chunk's queries
    k_chunk: torch.Tensor,  # [B, C, nkv, d] the chunk's keys
    v_chunk: torch.Tensor,  # [B, C, nkv, d]
    kv_pages: KVLayer,  # pages, or (int8 pages, scales), holding the history
    page_table: torch.Tensor,  # [B, W] pages of positions 0 .. history-1
    history_len: torch.Tensor,  # [B] tokens already in the cache
    valid_len: torch.Tensor,  # [B] valid tokens within this chunk
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """A prefill chunk's causal attention (port of kserve_tpu/ops/
    attention.py:116): queries attend to the cached history, gathered from
    the pages, and to the chunk's own causal prefix, which is not read
    from the cache.  As the JAX package's XLA gather, an int8 history is
    dequantized and rounded to bf16, and the chunk's K/V are cast to the
    history's dtype before the scores."""
    B, C = q.shape[:2]
    k_hist, v_hist = _gather_history(kv_pages, page_table.to(q.device),
                                     torch.bfloat16)
    H = k_hist.shape[1]
    k_all = torch.cat([k_hist, k_chunk.to(k_hist.dtype)], dim=1)
    v_all = torch.cat([v_hist, v_chunk.to(v_hist.dtype)], dim=1)
    history_len = history_len.to(q.device)
    hist_pos = torch.arange(H, dtype=torch.int32, device=q.device)
    c = torch.arange(C, dtype=torch.int32, device=q.device)
    hist_mask = (hist_pos[None, :] < history_len[:, None])[:, None, :]
    chunk_mask = ((c[None, :] <= c[:, None])[None]
                  & (c[None, None, :] < valid_len.to(q.device)[:, None, None]))
    mask = torch.cat([hist_mask.expand(B, C, H), chunk_mask], dim=-1)
    if window > 0:
        q_pos = history_len[:, None] + c[None, :]  # [B, C]
        k_pos = torch.cat([hist_pos[None, :].expand(B, H), q_pos], dim=1)
        mask = mask & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    return _gqa_attend(q, k_all, v_all, mask, scale, logit_softcap)


def dense_stride_for(width: int, align: int) -> int:
    """Packed-slice stride for lanes carrying `width` query tokens each
    under a kernel block alignment of `align` (RAGGED_BQ on the kernel
    path, 1 for the plain version).  Port of
    kserve_tpu/ops/attention.py:dense_stride_for.

    - align <= 1: pack densely, stride == width.
    - width a multiple of align, or larger than it: round up to the next
      align multiple (every block still belongs to one lane).
    - width < align: the smallest power of two >= width, which divides
      align: lanes share blocks at this stride (the dense-stride kernel)."""
    if width <= 0:
        raise ValueError(f"slice width must be positive, got {width}")
    if align <= 1 or width % align == 0:
        return width
    if width > align:
        return -(-width // align) * align
    sp = 1
    while sp < width:
        sp *= 2
    return sp


def check_dense_packing(T: int, B: int, dense_stride: int) -> None:
    """The dense packing's shape rules, with the JAX package's messages
    (pallas_paged_attention.py:787-795)."""
    if _cuda.RAGGED_BQ % dense_stride != 0:
        raise ValueError(
            f"dense_stride {dense_stride} must divide RAGGED_BQ="
            f"{_cuda.RAGGED_BQ}")
    if B * dense_stride != T:
        raise ValueError(
            f"dense packing expects T == B*stride "
            f"({B}*{dense_stride}), got T={T}")


def ragged_paged_attention(
    q: torch.Tensor,
    kv_pages: KVLayer,
    page_table: torch.Tensor,
    q_start: torch.Tensor,
    q_len: torch.Tensor,
    kv_start: torch.Tensor,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
    dense_stride: Optional[int] = None,
) -> torch.Tensor:
    """The ragged contract on the tensor's device: the CUDA kernel for a
    CUDA tensor (raising on what it does not take), the plain version for
    a CPU tensor.  `dense_stride` < RAGGED_BQ picks the dense-stride
    kernel; the route depends on it alone, since checking the slices'
    offsets would need a device sync."""
    dense = dense_stride is not None and dense_stride < _cuda.RAGGED_BQ
    if dense:
        check_dense_packing(q.shape[0], page_table.shape[0], dense_stride)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, kv_pages, page_table, q_start, q_len, kv_start,
            logit_softcap=logit_softcap, scale=scale, window=window)
    if dense:
        return _cuda.dense_ragged_paged_attention_cuda(
            q, kv_pages, page_table, q_len, kv_start, dense_stride,
            logit_softcap=logit_softcap, scale=scale, window=window)
    return _cuda.ragged_paged_attention_cuda(
        q, kv_pages, page_table, q_start, q_len, kv_start,
        logit_softcap=logit_softcap, scale=scale, window=window)


def paged_attention(
    q: torch.Tensor,
    kv_pages: KVLayer,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    logit_softcap: float = 0.0,
    scale: Optional[float] = None,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention on the tensor's device (kernel on CUDA, plain on
    CPU); the kernel takes windows and scale overrides natively."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, kv_pages, page_table, seq_lens, logit_softcap=logit_softcap,
            scale=scale, window=window)
    return _cuda.paged_decode_attention_cuda(
        q, kv_pages, page_table, seq_lens, logit_softcap=logit_softcap,
        scale=scale, window=window)
