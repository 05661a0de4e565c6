"""Multi-adapter LoRA for the Llama family, batched S-LoRA style.

Port of kserve_tpu/models/lora.py.  Every registered adapter lives on the
device as stacked tensors per layer per projection, A [n_adapters, in, r]
and B [n_adapters, r, out] (alpha/r folded into B at load).  A request
selects its adapter by id; the forward runs its N tokens as [N, h] and
takes one adapter id per token, so its one-hot is [N, n_adapters] (the
JAX package's forward_ragged indexes adapters by token the same way,
kserve_tpu/models/llama.py:754-761).  The delta of one projection is

    t = einsum('th,ahr->tar', x, A) * onehot[:, :, None]
    delta = einsum('tar,aro->to', t, B)

the function of the reference's 4-operand einsum ('bth,ahr,aro,ba->bto');
a token whose id is -1 has an all-zero one-hot row, hence an exact-zero
delta, so base requests and any mix of adapters share one dispatch.  The
products are plain `torch` products (an XLA einsum in the JAX package,
no Pallas kernel).

Checkpoints are HF PEFT adapter directories (adapter_config.json and
adapter_model.safetensors), read through the port's safetensors reader.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

# PEFT target_modules -> the port's projection names (layer dict keys)
_TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}
TARGETS = tuple(_TARGET_MAP.values())

LoraStack = Dict[str, Dict[str, torch.Tensor]]


def load_peft_adapter(path: str) -> Tuple[dict, Dict[int, Dict[str, tuple]]]:
    """Read one HF PEFT adapter directory.  Returns (config, {layer index:
    {projection: (A [in, r], B [r, out])}}) as host tensors in the file's
    dtype (a bfloat16 B in float32), alpha/r folded into B."""
    from .safetensors_io import iter_tensors

    with open(os.path.join(path, "adapter_config.json")) as f:
        config = json.load(f)
    r = int(config["r"])
    alpha = float(config.get("lora_alpha", r))
    scale = alpha / r
    layers: Dict[int, Dict[str, list]] = {}
    for name, t in iter_tensors(os.path.join(path, "adapter_model.safetensors")):
        # base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight
        parts = name.split(".")
        if "layers" not in parts or parts[-1] != "weight":
            continue
        i = int(parts[parts.index("layers") + 1])
        ours = _TARGET_MAP.get(parts[-3])
        if ours is None:
            continue
        slot = layers.setdefault(i, {}).setdefault(ours, [None, None])
        if parts[-2] == "lora_A":
            slot[0] = t.T  # PEFT stores [r, in] -> [in, r]
        elif parts[-2] == "lora_B":
            # [out, r] -> [r, out], alpha/r folded with the JAX package
            # loader's numpy rounding: the scale in the file's dtype, and a
            # bfloat16 product kept in float32 (numpy promotes it)
            if t.dtype == torch.bfloat16:
                t = t.float()
            slot[1] = t.T * torch.tensor(scale, dtype=t.dtype)
    out: Dict[int, Dict[str, tuple]] = {}
    for i, projs in layers.items():
        out[i] = {}
        for proj, (A, B) in projs.items():
            if A is None or B is None:
                raise ValueError(
                    f"adapter {path}: {proj} in layer {i} missing lora_A or lora_B")
            out[i][proj] = (A, B)
    return config, out


def stack_adapters(
    adapter_dirs: Dict[str, str],
    n_layers: int,
    dtype: str = "bfloat16",
    device=None,
) -> Tuple[Dict[str, int], List[LoraStack]]:
    """Load and stack adapters into per-layer tensors on `device` (default
    CUDA; raises without a card).  Returns (name -> adapter id, per layer
    {projection: {"A": [n, in, r_max], "B": [n, r_max, out]}}).  Ids
    follow the sorted names; ranks are zero-padded to the largest (zero
    rows add exactly nothing); a projection no adapter touches is left
    out, so it costs nothing."""
    device = resolve_device(device)
    names = sorted(adapter_dirs)
    loaded = [load_peft_adapter(adapter_dirs[name])[1] for name in names]
    ids = {name: idx for idx, name in enumerate(names)}
    tdtype = getattr(torch, dtype)
    per_layer: List[LoraStack] = []
    for layer_idx in range(n_layers):
        layer_stack: LoraStack = {}
        for proj in TARGETS:
            shapes = [adapter.get(layer_idx, {}).get(proj) for adapter in loaded]
            present = [s for s in shapes if s is not None]
            if not present:
                continue
            in_dim = present[0][0].shape[0]
            out_dim = present[0][1].shape[1]
            r_max = max(ab[0].shape[1] for ab in present)
            A = np.zeros((len(loaded), in_dim, r_max), np.float32)
            B = np.zeros((len(loaded), r_max, out_dim), np.float32)
            for a_idx, ab in enumerate(shapes):
                if ab is None:
                    continue
                r = ab[0].shape[1]
                A[a_idx, :, :r] = ab[0].float().numpy()
                B[a_idx, :r, :] = ab[1].float().numpy()
            layer_stack[proj] = {
                "A": torch.from_numpy(A).to(device=device, dtype=tdtype),
                "B": torch.from_numpy(B).to(device=device, dtype=tdtype),
            }
        per_layer.append(layer_stack)
    return ids, per_layer


def lora_delta(
    lora: Optional[LoraStack],
    proj: str,
    x: torch.Tensor,  # [N, in]
    onehot: Optional[torch.Tensor],  # [N, n_adapters]
) -> Optional[torch.Tensor]:
    """Per-token adapter delta [N, out] of one projection, or None when no
    adapter touches it (the caller then adds nothing).  Rows whose one-hot
    is all zero (base tokens) get an exact-zero delta."""
    entry = lora.get(proj) if lora else None
    if entry is None or onehot is None:
        return None
    t = torch.einsum("th,ahr->tar", x, entry["A"]) * onehot.to(x.dtype)[:, :, None]
    return torch.einsum("tar,aro->to", t, entry["B"])
