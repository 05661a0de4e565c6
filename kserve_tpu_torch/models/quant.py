"""Int8 weight-only quantization for the Llama family (weight_quant="int8").

Port of kserve_tpu/models/quant.py.  Symmetric per-output-channel int8:
a quantized weight is the dict {"q": int8 [in, out], "s": float32 [out]}
and the product applies the scale after the contraction, in the
activation dtype: (x @ q) * s, the reference's order of operations (a
q * s weight formed first would round differently).  Embeddings quantize
per row ([V, h] with s [V]), which serves the gather (a row scale) and,
for tied embeddings, the transposed lm_head product (an output-channel
scale) with one tensor.  Rounding is half to even, as jnp.round's, so q
is bit-equal to the JAX package's.

The product here is a plain `torch` product: the int8 weight is cast to
the activation dtype per call (the JAX package's is the XLA
convert-and-dot at quant.py:39-43, no Pallas kernel).  Norms, biases and
LoRA stacks stay in the compute dtype; MoE expert stacks are refused, as
in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# layer-dict keys eligible for quantization ([in, out] linears)
LINEAR_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def dense(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for a plain or int8-quantized weight."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


def quantize_array(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over `axis` (the contraction axis); the scales
    attach to the remaining (channel) axis.  Computed where `w` lies."""
    w32 = w.to(torch.float32)
    s = torch.amax(torch.abs(w32), dim=axis)
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # product with its rounded reciprocal, which would move some scales
    # by an ulp away from the host quantizer's (and the JAX package's)
    s = torch.clamp_min(s / torch.full_like(s, 127.0), 1e-12)
    q = torch.clamp(torch.round(w32 / s.unsqueeze(axis)), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def quantize_array_np(w: np.ndarray, axis: int = 0) -> Dict[str, np.ndarray]:
    """Host-side twin of quantize_array for the checkpoint loader: a
    checkpoint quantizes tensor by tensor on the host, so the device never
    holds its bf16 form."""
    w32 = np.asarray(w, np.float32)
    s = np.abs(w32).max(axis=axis) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.round(w32 / np.expand_dims(s, axis)), -127, 127)
    return {"q": q.astype(np.int8), "s": s.astype(np.float32)}


def quantize_params(params: Dict[str, Any], config) -> Dict[str, Any]:
    """A new parameter dict with every layer linear quantized, plus the
    lm_head (untied) or the embedding (tied: it plays the lm_head's role
    transposed, so its scales are per row).  Leaves that are quantized
    already are kept; norms, biases and LoRA stacks stay as they are.
    Raises on MoE layers."""
    if getattr(config, "n_experts", 0) > 0 or any(
            "router" in layer for layer in params["layers"]):
        raise NotImplementedError("weight_quant over MoE experts")
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        qlayer = dict(layer)
        for key in LINEAR_KEYS:
            if key in qlayer and not is_quantized(qlayer[key]):
                qlayer[key] = quantize_array(qlayer[key], axis=0)
        out["layers"].append(qlayer)
    if "lm_head" in params and not is_quantized(params["lm_head"]):
        out["lm_head"] = quantize_array(params["lm_head"], axis=0)
    elif config.tie_word_embeddings and not is_quantized(params["embed"]):
        out["embed"] = quantize_array(params["embed"], axis=1)  # s per row [V]
    return out


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather for a plain or row-quantized embedding table."""
    if is_quantized(embed):
        rows = embed["q"][tokens].to(dtype)
        return rows * embed["s"][tokens][..., None].to(dtype)
    return embed[tokens].to(dtype)


def tied_head_matmul(x: torch.Tensor, embed: Any) -> torch.Tensor:
    """``x @ embed.T`` for the tied lm_head; row scales become
    output-channel scales under the transpose."""
    if is_quantized(embed):
        return (x @ embed["q"].T.to(x.dtype)) * embed["s"].to(x.dtype)
    return x @ embed.T


def param_bytes(config, weight_quant: str = "none") -> int:
    """Analytic parameter footprint in bytes (bf16 leaves, or int8 leaves
    plus f32 scales) of a dense Llama-family config."""
    h, hd = config.hidden_size, config.head_dim
    nq, nkv, f = config.n_heads, config.n_kv_heads, config.intermediate_size
    per_layer = h * (nq * hd) + 2 * h * (nkv * hd) + (nq * hd) * h + 3 * h * f
    linears = config.n_layers * per_layer
    embed = config.vocab_size * h
    head = 0 if config.tie_word_embeddings else config.vocab_size * h
    norms = (2 * config.n_layers + 1) * h
    elt = 2  # bfloat16
    if weight_quant == "int8":
        scales = config.n_layers * (nq * hd + 2 * nkv * hd + h + 2 * f) * 4
        quantized = linears + head
        tied_embed = embed if config.tie_word_embeddings else 0
        if config.tie_word_embeddings:
            scales += config.vocab_size * 4
        plain_embed = 0 if config.tie_word_embeddings else embed
        return (quantized + tied_embed) * 1 + plain_embed * elt + norms * elt + scales
    return (linears + embed + head + norms) * elt

