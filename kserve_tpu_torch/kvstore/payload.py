"""KV payloads: a dict of CPU torch tensors, one per cache tensor
({"kv": [L, P, 2, n_kv, ps, d]} for a plain cache, {"kv_q", "kv_s"} for
an int8 cache's pages and f32 scales), and their `.npz` form.

numpy has no bfloat16 type here (the JAX package's payloads are
ml_dtypes arrays, which the port does not use), so a bfloat16 tensor is
written as its int16 bit pattern and a JSON table of dtype tags rides
along under DTYPES_KEY; reading restores every tensor bit for bit.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

Payload = Dict[str, torch.Tensor]

DTYPES_KEY = "__dtypes__"
# dtypes whose bits numpy holds as another integer type (numpy has no
# bfloat16 here); the P/D wire (protocol/pd.py) writes them so too
BITS = {torch.bfloat16: torch.int16}


def payload_nbytes(payload: Payload) -> int:
    return int(sum(t.numel() * t.element_size() for t in payload.values()))


def payload_arrays(payload: Payload) -> Dict[str, np.ndarray]:
    """The numpy arrays to write for `payload` (np.savez keywords): each
    tensor's bits and the dtype table."""
    arrays, tags = {}, {}
    for name, t in payload.items():
        if name == DTYPES_KEY:
            raise ValueError(f"payload name {name!r} is reserved")
        t = t.detach().cpu().contiguous()
        tags[name] = str(t.dtype).replace("torch.", "")
        arrays[name] = t.view(BITS.get(t.dtype, t.dtype)).numpy()
    arrays[DTYPES_KEY] = np.asarray(json.dumps(tags, sort_keys=True))
    return arrays


def payload_from_arrays(data) -> Payload:
    """The payload of a loaded `.npz` (`data[name]` -> array).  Raises
    ValueError or KeyError on a missing or mismatched entry."""
    tags = json.loads(str(data[DTYPES_KEY][()]))
    out = {}
    for name, tag in tags.items():
        dtype = getattr(torch, tag, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype tag {tag!r}")
        t = torch.from_numpy(np.array(data[name]))  # a copy the tensor owns
        if t.dtype != BITS.get(dtype, dtype):
            raise ValueError(f"{name}: stored {t.dtype} for {tag}")
        out[name] = t.view(dtype)
    return out
