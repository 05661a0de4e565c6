"""Prefill/decode disaggregation wire protocol.

Port of kserve_tpu/protocol/pd.py.  A prefill-role server answers
`POST /v1/prefill/{model}`: the body is JSON `{"prompt_ids": [...],
"params": {...SamplingParams fields...}, "adapter": name | null}`, the
answer the raw KV bytes (application/octet-stream) with an `X-KV-Meta`
header carrying the shape, the dtype, the first sampled token and the
wire layout.  A decode-role server calls it through `PrefillClient` and
decodes on from the transferred pages.

The wire is byte-identical to the JAX package's, so a pair may mix the
two: the KV is [L, P, 2, n_kv, ps, d], C-contiguous, and its dtype string
is numpy's name ("float32", "bfloat16").  Without ml_dtypes a bfloat16
tensor travels as its raw 16-bit words: written through
`tensor.view(torch.int16)`, read back through `np.frombuffer(...,
np.int16)` and `torch.from_numpy(...).view(torch.bfloat16)`.  Neither
side copies the payload: `serialize_kv` hands out a view of the tensor's
memory and `deserialize_kv` a tensor over the received buffer.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch

from ..engine.sampling import SamplingParams
from ..errors import InvalidInput
from ..kvstore.payload import BITS
from .http_client import AsyncHTTPClient

KV_META_HEADER = "X-KV-Meta"
# bump when the wire's axis order changes (engine/kvcache.py's layout)
KV_WIRE_LAYOUT = "page-major-v2"
PREFILL_ROUTE = "/v1/prefill/"


def serialize_kv(kv: torch.Tensor, first_token: int) -> Tuple[str, memoryview]:
    """(meta JSON, payload bytes) of one sequence's KV [L, P, 2, n_kv, ps,
    d], a CPU tensor.  The payload is a byte view of the tensor's memory
    (no copy): keep `kv` alive while it is sent."""
    kv = kv.detach().cpu().contiguous()
    meta = {
        "shape": list(kv.shape),
        "dtype": str(kv.dtype).replace("torch.", ""),
        "first_token": int(first_token),
        # a mixed-version pair fails loudly instead of scattering KV whose
        # axes are swapped but whose shape happens to pass
        "layout": KV_WIRE_LAYOUT,
    }
    bits = kv.view(BITS.get(kv.dtype, kv.dtype)).numpy().reshape(-1)
    return json.dumps(meta), memoryview(bits.view(np.uint8))


def deserialize_kv(meta_json: str, payload) -> Tuple[torch.Tensor, int]:
    """(KV tensor over `payload`'s memory, first token).  A payload that is
    not writable (bytes) is copied once; a bytearray is used in place."""
    meta = json.loads(meta_json)
    layout = meta.get("layout")
    if layout != KV_WIRE_LAYOUT:
        raise RuntimeError(
            f"prefill peer sent KV wire layout {layout!r}, this server needs "
            f"{KV_WIRE_LAYOUT!r}; upgrade the P/D pair together")
    name = meta["dtype"]
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown KV dtype {name!r}")
    stored = BITS.get(dtype, dtype)
    if isinstance(payload, (bytes, memoryview)) and memoryview(payload).readonly:
        payload = bytearray(payload)
    flat = np.frombuffer(payload, dtype=np.dtype(str(stored).replace("torch.", "")))
    kv = torch.from_numpy(flat).view(dtype).reshape(meta["shape"])
    return kv, int(meta["first_token"])


def sampling_params_to_dict(params: SamplingParams) -> dict:
    return dataclasses.asdict(params)


def sampling_params_from_dict(data: dict) -> SamplingParams:
    fields = {f.name for f in dataclasses.fields(SamplingParams)}
    return SamplingParams(**{k: v for k, v in data.items() if k in fields})


def parse_prefill_body(body: dict) -> Tuple[list, SamplingParams, Optional[str]]:
    """The prefill route's request: (prompt ids, params, adapter), or
    InvalidInput (400) (kserve_tpu/protocol/pd.py:82-102)."""
    prompt_ids = body.get("prompt_ids") if isinstance(body, dict) else None
    if not isinstance(prompt_ids, list) or not prompt_ids:
        raise InvalidInput("prompt_ids must be a non-empty list")
    return (prompt_ids, sampling_params_from_dict(body.get("params") or {}),
            body.get("adapter"))


class PrefillClient:
    """The decode role's client of a prefill-role peer, on the port's
    HTTP client (its connections kept alive)."""

    def __init__(self, base_url: str, timeout_s: float = 120.0,
                 client: Optional[AsyncHTTPClient] = None):
        self.base_url = base_url.rstrip("/")
        self.client = client or AsyncHTTPClient(timeout_s=timeout_s)

    async def prefill(self, model_name: str, prompt_ids, params: SamplingParams,
                      adapter: Optional[str] = None) -> Tuple[torch.Tensor, int]:
        """(kv [L, P, 2, n_kv, ps, d], first token).  A 400 from the peer
        (a prompt over its max_prefill_len, logprobs) is the client's
        error and raises InvalidInput; any other failure RuntimeError."""
        url = f"{self.base_url}{PREFILL_ROUTE}{model_name}"
        resp = await self.client.post(url, json={
            "prompt_ids": [int(t) for t in prompt_ids],
            "params": sampling_params_to_dict(params),
            "adapter": adapter,
        })
        if resp.status != 200:
            text = resp.text()[:200]
            if resp.status == 400:
                raise InvalidInput(f"prefill peer refused the request: {text}")
            raise RuntimeError(f"prefill peer {url} -> {resp.status}: {text}")
        meta_json = resp.headers.get(KV_META_HEADER.lower())
        if not meta_json:
            raise RuntimeError(f"prefill peer {url} response missing {KV_META_HEADER}")
        return deserialize_kv(meta_json, resp.body)

    async def close(self) -> None:
        await self.client.aclose()
