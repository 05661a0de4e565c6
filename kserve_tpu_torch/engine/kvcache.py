"""Paged KV cache: per-layer device tensors + host-side page allocator.

Port of kserve_tpu/engine/kvcache.py.  Layout per layer (unchanged):
[num_pages, 2, n_kv_heads, page_size, head_dim], page-major, K at index 0
and V at index 1 of the second axis.  Page 0 is the null page: padded
table entries and padding tokens point at it, so every gather and scatter
index is valid.  Writes update the pages in place (`index_put_`), which
takes the place of the JAX package's buffer donation.

With int8 KV (`kv_quant="int8"`) a layer's cache is the tuple (int8 pages,
f32 scales), the scales [num_pages, 2, n_kv_heads, page_size] holding one
symmetric absmax scale per K or V row (kvcache.py:237-265 of the JAX
package).  Quantizing is plain torch on the device, as the JAX package
does it in XLA outside any kernel, and never waits on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple, Union

import torch

from ..device import resolve_device

#: one layer's cache: the pages, or (int8 pages, f32 row scales)
KVLayer = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclass
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    num_pages: int = 1024
    max_pages_per_seq: int = 128
    dtype: str = "bfloat16"


def init_kv_pages(config: KVCacheConfig, device=None) -> List[torch.Tensor]:
    """[n_layers] list of zeroed [num_pages, 2, n_kv_heads, page_size,
    head_dim] tensors on `device` (default CUDA; raises without a card)."""
    device = resolve_device(device)
    shape = (config.num_pages, 2, config.n_kv_heads, config.page_size,
             config.head_dim)
    dtype = getattr(torch, config.dtype)
    return [torch.zeros(shape, dtype=dtype, device=device)
            for _ in range(config.n_layers)]


def init_kv_scales(config: KVCacheConfig, device=None) -> List[torch.Tensor]:
    """[n_layers] list of [num_pages, 2, n_kv_heads, page_size] f32 row
    scales, all ones (the int8 cache's companion arrays), on `device`
    (default CUDA; raises without a card)."""
    device = resolve_device(device)
    shape = (config.num_pages, 2, config.n_kv_heads, config.page_size)
    return [torch.ones(shape, dtype=torch.float32, device=device)
            for _ in range(config.n_layers)]


def layer_pages(layer: KVLayer) -> torch.Tensor:
    """The page tensor of one layer's cache, plain or quantized."""
    return layer[0] if isinstance(layer, tuple) else layer


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] -> (int8 rows, f32 row scales [...]): symmetric absmax,
    scale = max(absmax / 127, 1e-8), round half to even, clip to +-127."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """int8 rows [..., d] times their f32 scales [...], in f32, cast to
    `dtype`."""
    return (q.float() * scale[..., None].float()).to(dtype)


class PageAllocator:
    """Host-side free-list with refcounts; page 0 is reserved (null page
    for padding).  A page returns to the free list only when its last
    reference drops."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # stack, page 0 reserved
        self._refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"KV cache exhausted: need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        for p in pages:
            if p != 0:
                self._refs[p] += 1

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            if self._refs[p] <= 0:
                # a double free must not put the page on the list twice
                # (two sequences would then share it and corrupt KV)
                continue
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)


def pages_needed(n_tokens: int, page_size: int) -> int:
    return (n_tokens + page_size - 1) // page_size


def _scatter_kv(kv_pages: KVLayer, k: torch.Tensor, v: torch.Tensor,
                pages_flat: torch.Tensor, slot_flat: torch.Tensor) -> KVLayer:
    """Write K/V rows ([N, n_kv, d] each) in place at flat (page, slot)
    indices into a plain or quantized cache (the quantized one takes the
    int8 rows and their scales); returns the same cache."""
    pages_ix, slot_ix = pages_flat.long(), slot_flat.long()
    values = torch.stack([k, v], dim=1)  # [N, 2, n_kv, d]
    if isinstance(kv_pages, tuple):
        pages, scales = kv_pages
        # one pass over K and V together: row-wise, so the same bits as
        # quantizing each alone, in half the launches
        q, s = quantize_rows(values)  # [N, 2, n_kv, d] int8, [N, 2, n_kv] f32
        pages[pages_ix, :, :, slot_ix, :] = q
        scales[pages_ix, :, :, slot_ix] = s
        return kv_pages
    kv_pages[pages_ix, :, :, slot_ix, :] = values.to(kv_pages.dtype)
    return kv_pages


def write_ragged_kv(
    kv_pages: KVLayer,  # [num_pages, 2, n_kv, ps, d] or (int8 pages, scales)
    k: torch.Tensor,  # [T, n_kv, d] packed ragged slice keys
    v: torch.Tensor,  # [T, n_kv, d]
    page_table: torch.Tensor,  # [B, max_pages_per_seq]
    token_seq: torch.Tensor,  # [T] lane per packed token (-1 = padding)
    token_pos: torch.Tensor,  # [T] absolute position per packed token
    page_size: int,
) -> KVLayer:
    """Ragged-batch scatter: each packed token lands at its lane's (page,
    slot) for its position; padding tokens write to the null page."""
    valid = token_seq >= 0
    seq_ix = token_seq.clamp(min=0).long()
    col = (token_pos // page_size).clamp(max=page_table.shape[1] - 1).long()
    page = torch.where(valid, page_table[seq_ix, col], torch.zeros_like(token_seq))
    slot = token_pos % page_size
    return _scatter_kv(kv_pages, k, v, page, slot)


def append_token_kv(
    kv_pages: KVLayer,  # [num_pages, 2, n_kv, ps, d] or (int8 pages, scales)
    k: torch.Tensor,  # [B, n_kv, d]
    v: torch.Tensor,  # [B, n_kv, d]
    page_table: torch.Tensor,  # [B, max_pages_per_seq]
    pos: torch.Tensor,  # [B] position being written
    active: torch.Tensor,  # [B] bool: inactive lanes write to the null page
    page_size: int,
) -> KVLayer:
    """Decode-step scatter: one new token per active lane."""
    B = k.shape[0]
    b = torch.arange(B, device=pos.device)
    col = (pos // page_size).clamp(max=page_table.shape[1] - 1).long()
    page = torch.where(active, page_table[b, col], torch.zeros_like(pos))
    slot = pos % page_size
    return _scatter_kv(kv_pages, k, v, page, slot)


def write_prompt_kv_batch(
    kv_pages: KVLayer,  # [num_pages, 2, n_kv, ps, d] or (int8 pages, scales)
    k: torch.Tensor,  # [B, T, n_kv, d]
    v: torch.Tensor,  # [B, T, n_kv, d]
    page_ids: torch.Tensor,  # [B, W] int32, the rows' pages
    valid_len: torch.Tensor,  # [B] int32
    page_size: int,
) -> KVLayer:
    """Batched prompt scatter of the legacy `prefill` program (port of
    kserve_tpu/engine/kvcache.py:131): row b's token t lands at position
    t; tokens past valid_len[b] write to the null page 0."""
    return write_chunk_kv_batch(kv_pages, k, v, page_ids,
                                torch.zeros_like(valid_len), valid_len,
                                page_size)


def write_chunk_kv_batch(
    kv_pages: KVLayer,  # [num_pages, 2, n_kv, ps, d] or (int8 pages, scales)
    k: torch.Tensor,  # [B, C, n_kv, d] chunk keys
    v: torch.Tensor,  # [B, C, n_kv, d]
    page_ids: torch.Tensor,  # [B, W] int32, the sequences' pages
    chunk_start: torch.Tensor,  # [B] absolute position of chunk token 0
    valid_len: torch.Tensor,  # [B] valid tokens within the chunk
    page_size: int,
) -> KVLayer:
    """An offset chunk's scatter (port of kserve_tpu/engine/kvcache.py:150):
    chunk token t of row b lands at position chunk_start[b] + t; tokens
    past valid_len[b] write to the null page 0.  int8 caches take
    quantized rows and their scales."""
    B, C = k.shape[:2]
    t = torch.arange(C, dtype=torch.int32, device=k.device)
    pos = chunk_start.to(k.device)[:, None] + t[None, :]  # [B, C]
    col = (pos // page_size).clamp(max=page_ids.shape[1] - 1).long()
    page = torch.gather(page_ids.to(k.device), 1, col)
    page = torch.where(t[None, :] < valid_len.to(k.device)[:, None], page,
                       torch.zeros_like(page))
    slot = pos % page_size
    return _scatter_kv(kv_pages, k.reshape(B * C, *k.shape[2:]),
                       v.reshape(B * C, *v.shape[2:]), page.reshape(-1),
                       slot.reshape(-1))
