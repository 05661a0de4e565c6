"""BERT-family encoder on PyTorch: embeddings, rerank (cross-encoder),
sequence classification, fill-mask.

Port of kserve_tpu/models/bert.py.  The functions take a parameter dict
of f32 tensors with the JAX package's keys and layouts (Linear weights
stored [in, out]) and compute in f32, as the reference does:
- the padding mask is an additive f32 bias of -1e30 (:131), so a padded
  key gets weight 0 and a row whose keys are all padding attends
  uniformly, never NaN;
- GELU is the exact erf form (:143, :170);
- the mean pool divides by max(count, 1e-9) and the norm by
  max(norm, 1e-12) (:154-156);
- an id past the end of an embedding table reads its last row, as a JAX
  gather clamps: the byte tokenizer's ids (up to 258) exceed a small
  vocabulary, and positions past max_position_embeddings occur when a
  bucket is longer than the table.  On a card an index past the end
  would be a device-side assert instead.

No product here reaches a Pallas kernel in the JAX package (plain XLA
under jax.jit), so the port's products are `torch.matmul` and its
attention is plain PyTorch.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import layer_norm
from .safetensors_io import iter_tensors

Params = Dict[str, Any]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    dtype: str = "float32"

    @staticmethod
    def tiny(**overrides) -> "BertConfig":
        base = dict(
            vocab_size=128,
            hidden_size=32,
            num_hidden_layers=2,
            num_attention_heads=4,
            intermediate_size=64,
            max_position_embeddings=64,
        )
        base.update(overrides)
        return BertConfig(**base)

    @staticmethod
    def from_hf_config(path_or_dict) -> "BertConfig":
        """An HF config.json (a path or a dict).  `num_labels` is not read,
        as the reference does not read it (kserve_tpu/models/bert.py:53-67):
        a classifier head keeps the default 2 labels."""
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                cfg = json.load(f)
        else:
            cfg = dict(path_or_dict)
        return BertConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 512),
            type_vocab_size=cfg.get("type_vocab_size", 2),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        )


def init_params(config: BertConfig, seed: int = 0, device=None,
                scale: float = 0.02) -> Params:
    """Random f32 parameters with the reference's keys and initial values
    (N(0, scale) matrices, zero biases, unit norms), drawn on the host from
    a seeded torch.Generator and moved to `device` (default CUDA; raises
    without a card): the same seed gives the same weights on every device."""
    device = resolve_device(device)
    h, f = config.hidden_size, config.intermediate_size
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)

    def dense(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32).mul_(scale)
        return w.to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def ln():
        return {"weight": torch.ones(h, dtype=torch.float32, device=device),
                "bias": zeros(h)}

    layers = []
    for _ in range(config.num_hidden_layers):
        layers.append({
            "q": {"w": dense(h, h), "b": zeros(h)},
            "k": {"w": dense(h, h), "b": zeros(h)},
            "v": {"w": dense(h, h), "b": zeros(h)},
            "o": {"w": dense(h, h), "b": zeros(h)},
            "attn_ln": ln(),
            "ffn_in": {"w": dense(h, f), "b": zeros(f)},
            "ffn_out": {"w": dense(f, h), "b": zeros(h)},
            "ffn_ln": ln(),
        })
    return {
        "word_embeddings": dense(config.vocab_size, h),
        "position_embeddings": dense(config.max_position_embeddings, h),
        "token_type_embeddings": dense(config.type_vocab_size, h),
        "embed_ln": ln(),
        "layers": layers,
        "pooler": {"w": dense(h, h), "b": zeros(h)},
        "classifier": {"w": dense(h, config.num_labels), "b": zeros(config.num_labels)},
        "mlm_transform": {"w": dense(h, h), "b": zeros(h)},
        "mlm_ln": ln(),
        "mlm_bias": zeros(config.vocab_size),
    }


def params_from_jax(params_np: Params, device=None) -> Params:
    """The JAX package's params pytree, with numpy leaves, -> this port's
    parameters on `device` (default CUDA; raises without a card): the same
    keys and layouts, f32."""
    device = resolve_device(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [tree(v) for v in x]
        return torch.tensor(np.asarray(x, dtype=np.float32)).to(device)

    return tree(params_np)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] with ids past the end reading the last row (JAX's clamp)."""
    return table[ids.clamp(0, table.shape[0] - 1)]


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def encode(params: Params, config: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder stack -> hidden states [B, T, H] (ids and mask [B, T])."""
    B, T = input_ids.shape
    h = config.hidden_size
    nh = config.num_attention_heads
    hd = h // nh
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    positions = torch.arange(T, device=input_ids.device)
    x = (_rows(params["word_embeddings"], input_ids)
         + _rows(params["position_embeddings"], positions)[None]
         + _rows(params["token_type_embeddings"], token_type_ids))
    x = layer_norm(x, params["embed_ln"]["weight"], params["embed_ln"]["bias"],
                   config.layer_norm_eps)
    # the additive f32 bias of the reference: -1e30 on padded keys
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mask_bias = torch.where(attention_mask[:, None, None, :] > 0, zero,
                            torch.full_like(zero, -1e30))
    scale = 1.0 / math.sqrt(hd)
    for layer in params["layers"]:
        q = _linear(x, layer["q"]).reshape(B, T, nh, hd)
        k = _linear(x, layer["k"]).reshape(B, T, nh, hd)
        v = _linear(x, layer["v"]).reshape(B, T, nh, hd)
        scores = torch.einsum("bthd,bshd->bhts", q, k) * scale + mask_bias
        weights = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhts,bshd->bthd", weights, v).reshape(B, T, h)
        attn = _linear(attn, layer["o"])
        x = layer_norm(x + attn, layer["attn_ln"]["weight"], layer["attn_ln"]["bias"],
                       config.layer_norm_eps)
        ffn = F.gelu(_linear(x, layer["ffn_in"]))
        ffn = _linear(ffn, layer["ffn_out"])
        x = layer_norm(x + ffn, layer["ffn_ln"]["weight"], layer["ffn_ln"]["bias"],
                       config.layer_norm_eps)
    return x


def embed(params: Params, config: BertConfig, input_ids: torch.Tensor,
          attention_mask: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Mean-pooled sentence embeddings [B, H]."""
    hidden = encode(params, config, input_ids, attention_mask)
    mask = attention_mask[..., None].to(hidden.dtype)
    pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)
    if normalize:
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        pooled = pooled / norm.clamp(min=1e-12)
    return pooled


def classify(params: Params, config: BertConfig, input_ids: torch.Tensor,
             attention_mask: torch.Tensor,
             token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence classification logits [B, num_labels] (CLS + pooler)."""
    hidden = encode(params, config, input_ids, attention_mask, token_type_ids)
    cls = torch.tanh(_linear(hidden[:, 0], params["pooler"]))
    return _linear(cls, params["classifier"])


def fill_mask_logits(params: Params, config: BertConfig, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor) -> torch.Tensor:
    """MLM logits [B, T, vocab] (transform + tied decoder)."""
    hidden = encode(params, config, input_ids, attention_mask)
    t = F.gelu(_linear(hidden, params["mlm_transform"]))
    t = layer_norm(t, params["mlm_ln"]["weight"], params["mlm_ln"]["bias"],
                   config.layer_norm_eps)
    return t @ params["word_embeddings"].T + params["mlm_bias"]


# ---------------- HF checkpoint loading ----------------


def load_hf_weights(model_dir: str, config: BertConfig, device=None) -> Params:
    """A local BERT safetensors checkpoint -> parameters on `device`
    (kserve_tpu/models/bert.py:182-246): every *.safetensors file of the
    directory in name order, a `bert.` prefix stripped, Linear weights
    transposed to [in, out], and a missing pooler, classifier or MLM head
    given the reference's zero (unit for a norm weight) defaults."""
    device = resolve_device(device)
    h = config.hidden_size
    tensors: Dict[str, torch.Tensor] = {}
    for f in sorted(os.listdir(model_dir)):
        if f.endswith(".safetensors"):
            for name, t in iter_tensors(os.path.join(model_dir, f)):
                tensors[name.removeprefix("bert.")] = t

    def t(name, transpose=False):
        arr = tensors[name].to(torch.float32)
        return (arr.T if transpose else arr).contiguous().to(device)

    def maybe(name, default, transpose=False):
        if name in tensors:
            return t(name, transpose)
        return default.to(device)

    zeros, ones = torch.zeros, torch.ones
    params: Params = {
        "word_embeddings": t("embeddings.word_embeddings.weight"),
        "position_embeddings": t("embeddings.position_embeddings.weight"),
        "token_type_embeddings": t("embeddings.token_type_embeddings.weight"),
        "embed_ln": {"weight": t("embeddings.LayerNorm.weight"),
                     "bias": t("embeddings.LayerNorm.bias")},
        "layers": [],
        "pooler": {"w": maybe("pooler.dense.weight", zeros(h, h), True),
                   "b": maybe("pooler.dense.bias", zeros(h))},
        "classifier": {
            "w": maybe("classifier.weight", zeros(h, config.num_labels), True),
            "b": maybe("classifier.bias", zeros(config.num_labels))},
        "mlm_transform": {
            "w": maybe("cls.predictions.transform.dense.weight", zeros(h, h), True),
            "b": maybe("cls.predictions.transform.dense.bias", zeros(h))},
        "mlm_ln": {
            "weight": maybe("cls.predictions.transform.LayerNorm.weight", ones(h)),
            "bias": maybe("cls.predictions.transform.LayerNorm.bias", zeros(h))},
        "mlm_bias": maybe("cls.predictions.bias", zeros(config.vocab_size)),
    }
    for i in range(config.num_hidden_layers):
        p = f"encoder.layer.{i}."

        def lin(name):
            return {"w": t(p + name + ".weight", True), "b": t(p + name + ".bias")}

        def norm(name):
            return {"weight": t(p + name + ".weight"), "bias": t(p + name + ".bias")}

        params["layers"].append({
            "q": lin("attention.self.query"),
            "k": lin("attention.self.key"),
            "v": lin("attention.self.value"),
            "o": lin("attention.output.dense"),
            "attn_ln": norm("attention.output.LayerNorm"),
            "ffn_in": lin("intermediate.dense"),
            "ffn_out": lin("output.dense"),
            "ffn_ln": norm("output.LayerNorm"),
        })
    return params


def hf_tensors(params: Params) -> Dict[str, torch.Tensor]:
    """The parameters under BERT's HF checkpoint names (`bert.` prefix,
    Linear weights [out, in]): what load_hf_weights reads back."""
    out = {}

    def put(name, t, transpose=False):
        out[name] = (t.T if transpose else t).contiguous().cpu()

    put("bert.embeddings.word_embeddings.weight", params["word_embeddings"])
    put("bert.embeddings.position_embeddings.weight", params["position_embeddings"])
    put("bert.embeddings.token_type_embeddings.weight", params["token_type_embeddings"])
    put("bert.embeddings.LayerNorm.weight", params["embed_ln"]["weight"])
    put("bert.embeddings.LayerNorm.bias", params["embed_ln"]["bias"])
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "ffn_in": "intermediate.dense", "ffn_out": "output.dense"}
    norms = {"attn_ln": "attention.output.LayerNorm", "ffn_ln": "output.LayerNorm"}
    for i, layer in enumerate(params["layers"]):
        p = f"bert.encoder.layer.{i}."
        for key, name in names.items():
            put(p + name + ".weight", layer[key]["w"], True)
            put(p + name + ".bias", layer[key]["b"])
        for key, name in norms.items():
            put(p + name + ".weight", layer[key]["weight"])
            put(p + name + ".bias", layer[key]["bias"])
    put("bert.pooler.dense.weight", params["pooler"]["w"], True)
    put("bert.pooler.dense.bias", params["pooler"]["b"])
    put("classifier.weight", params["classifier"]["w"], True)
    put("classifier.bias", params["classifier"]["b"])
    put("cls.predictions.transform.dense.weight", params["mlm_transform"]["w"], True)
    put("cls.predictions.transform.dense.bias", params["mlm_transform"]["b"])
    put("cls.predictions.transform.LayerNorm.weight", params["mlm_ln"]["weight"])
    put("cls.predictions.transform.LayerNorm.bias", params["mlm_ln"]["bias"])
    put("cls.predictions.bias", params["mlm_bias"])
    return out
