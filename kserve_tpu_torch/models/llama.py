"""Llama-family decoder in PyTorch (Llama 2/3, Mistral, Qwen2/3 and
Gemma-2-style variants through config knobs: GQA, RoPE theta and llama3
scaling, qkv bias, per-head qk-norm, tied embeddings, sandwich norms,
attention and final logit softcaps, attention-scale override, per-layer
sliding windows, GeGLU; and Mixtral's Mixture-of-Experts MLP, models/moe.py,
when n_experts > 0).

Port of kserve_tpu/models/llama.py: the entry points the `mixed` and
`mixed_decode` programs run, `forward_ragged` (:720, with `logits_at` and
`dense_stride`) and `decode_step` (:656), those the legacy programs run,
`prefill` (:542) and `prefill_chunk` (:625), and their helpers.
Parameters are a plain dict with the JAX package's key names and
layout (`w` is [in, out], `y = x @ w`), so `params_from_jax` carries a JAX
pytree across without a transpose.  A linear may be int8
({"q", "s"}, models/quant.py) and a layer may carry LoRA stacks under
"lora" (models/lora.py); each entry point then takes `adapter_ids`, one
per lane (-1 = the base model), and adds every adapted projection's
delta per token.  The large matrix products are plain `torch` products
(XLA in the JAX package); attention goes through ops/attention.py (the
CUDA kernels on the card; the prefill attention is plain PyTorch, as it
is XLA code in the JAX package).  `load_hf_weights(_streamed)` read a
HuggingFace safetensors checkpoint (models/safetensors_io.py) into that
layout, int8 if asked (MoE expert stacks excepted, as in the JAX
package).  Not ported yet: pipeline and expert parallelism.
"""

from __future__ import annotations

import functools
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..engine.kvcache import (
    KVLayer,
    append_token_kv,
    write_chunk_kv_batch,
    write_prompt_kv_batch,
    write_ragged_kv,
)
from ..ops.attention import (
    causal_prefill_attention,
    chunked_prefill_attention,
    paged_attention,
    ragged_paged_attention,
)
from ..ops.norms import rms_norm, rms_norm_plus_one
from ..ops.rotary import rope_cos_sin, rope_frequencies, rotate
from .lora import lora_delta
from .moe import MoEConfig, init_moe_params, moe_mlp
from .quant import (
    LINEAR_KEYS,
    dense,
    embed_lookup,
    quantize_array_np,
    tied_head_matmul,
)

Params = Dict[str, Any]


def _map_hidden_act(act) -> str:
    if act in (None, "silu", "swish"):
        return "silu"
    if act in ("gelu_pytorch_tanh", "gelu_tanh"):
        return "gelu_tanh"
    raise ValueError(f"unsupported hidden_act {act!r}")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    qk_norm: bool = False  # per-head RMSNorm on q/k before rope (Qwen3)
    hidden_act: str = "silu"  # or "gelu_tanh" (GeGLU)
    norm_plus_one: bool = False  # RMSNorm multiplies by (1 + w)
    embed_scale: bool = False  # inputs scaled by sqrt(hidden_size)
    sandwich_norms: bool = False  # post-attn + post-ffn norms per layer
    attn_logit_softcap: float = 0.0  # tanh cap on attention scores
    query_pre_attn_scalar: Optional[float] = None  # attn scale = qpas**-0.5
    sliding_window: int = 0  # > 0: window on layers marked sliding
    layer_types: Optional[Tuple[str, ...]] = None
    logit_softcap: float = 0.0  # tanh cap on the final logits
    # Mixture-of-Experts (Mixtral-style): n_experts == 0 => dense MLP
    n_experts: int = 0
    n_experts_per_tok: int = 2
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.n_heads
        if self.layer_types is not None:
            self.layer_types = tuple(self.layer_types)

    def layer_window(self, i: int) -> int:
        """Sliding-window width for layer i (0 = full attention)."""
        if self.sliding_window <= 0:
            return 0
        if self.layer_types is None:
            return self.sliding_window
        return (self.sliding_window
                if self.layer_types[i] == "sliding_attention" else 0)

    @property
    def attn_scale(self) -> Optional[float]:
        if self.query_pre_attn_scalar is None:
            return None
        return float(self.query_pre_attn_scalar) ** -0.5

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.n_experts_per_tok,
                         hidden_size=self.hidden_size,
                         intermediate_size=self.intermediate_size)

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            max_position_embeddings=256,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            n_layers=32,
            n_heads=32,
            n_kv_heads=8,
            rope_theta=500000.0,
            max_position_embeddings=8192,
        )

    @staticmethod
    def llama3_1b() -> "LlamaConfig":
        """Llama-3.2-1B shape (head_dim 64)."""
        return LlamaConfig(
            vocab_size=128256,
            hidden_size=2048,
            intermediate_size=8192,
            n_layers=16,
            n_heads=32,
            n_kv_heads=8,
            head_dim=64,
            rope_theta=500000.0,
            max_position_embeddings=8192,
            tie_word_embeddings=True,
        )

    @staticmethod
    def qwen3_0_6b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=151936,
            hidden_size=1024,
            intermediate_size=3072,
            n_layers=28,
            n_heads=16,
            n_kv_heads=8,
            head_dim=128,
            rope_theta=1000000.0,
            max_position_embeddings=32768,
            tie_word_embeddings=True,
            qk_norm=True,
            rms_norm_eps=1e-6,
        )

    @staticmethod
    def gemma2_2b() -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=256000,
            hidden_size=2304,
            intermediate_size=9216,
            n_layers=26,
            n_heads=8,
            n_kv_heads=4,
            head_dim=256,
            rope_theta=10000.0,
            max_position_embeddings=8192,
            tie_word_embeddings=True,
            hidden_act="gelu_tanh",
            norm_plus_one=True,
            embed_scale=True,
            sandwich_norms=True,
            attn_logit_softcap=50.0,
            logit_softcap=30.0,
            query_pre_attn_scalar=256,
            sliding_window=4096,
            layer_types=tuple(
                "sliding_attention" if i % 2 == 0 else "full_attention"
                for i in range(26)),
            rms_norm_eps=1e-6,
        )

    @staticmethod
    def from_hf_config(path_or_dict) -> "LlamaConfig":
        """Map a HuggingFace config.json (Llama/Mistral/Qwen2/Qwen3/Gemma-2/
        Mixtral) onto LlamaConfig."""
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                cfg = json.load(f)
        else:
            cfg = dict(path_or_dict)
        rope_scaling = cfg.get("rope_scaling")
        if rope_scaling is not None:
            # validate eagerly: an unsupported variant must not load
            rope_frequencies(
                cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
                cfg.get("rope_theta", 10000.0),
                rope_scaling,
            )
        gemma2 = cfg.get("model_type") == "gemma2"
        return LlamaConfig(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=(
                cfg["intermediate_size"] if "intermediate_size" in cfg
                else cfg["ffn_dim"]),
            n_layers=cfg["num_hidden_layers"],
            n_heads=cfg["num_attention_heads"],
            n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            attention_bias=cfg.get("attention_bias", False),
            qk_norm=(
                cfg.get("model_type") == "qwen3"
                or any("Qwen3" in a for a in (cfg.get("architectures") or []))),
            hidden_act=_map_hidden_act(
                cfg.get("hidden_act", cfg.get("hidden_activation"))),
            norm_plus_one=gemma2,
            embed_scale=gemma2,
            sandwich_norms=gemma2,
            attn_logit_softcap=cfg.get("attn_logit_softcapping") or 0.0,
            logit_softcap=cfg.get("final_logit_softcapping") or 0.0,
            query_pre_attn_scalar=cfg.get("query_pre_attn_scalar"),
            sliding_window=(cfg.get("sliding_window") or 0) if gemma2 else 0,
            layer_types=(
                tuple(cfg["layer_types"]) if cfg.get("layer_types")
                else tuple(
                    "sliding_attention" if i % 2 == 0 else "full_attention"
                    for i in range(cfg["num_hidden_layers"]))
                if gemma2 and (cfg.get("sliding_window") or 0) > 0
                else None),
            # MixtralForCausalLM fields
            n_experts=cfg.get("num_local_experts", 0),
            n_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        )


def init_params(config: LlamaConfig, seed: int = 1, device=None,
                scale: float = 0.02, weight_quant: str = "none") -> Params:
    """Random parameters made directly on `device` (default CUDA; raises
    without a card) from a seeded torch.Generator: N(0, scale) linears and
    embedding, the JAX package's norm and bias initial values and key
    names.  weight_quant="int8" draws the int8 leaves and their scales
    directly, as the JAX package's init does (uniform int8, whose std of
    ~73 the constant scale maps back onto N(0, scale)); a tied embedding
    is then int8 with row scales, an untied one stays in the model dtype.
    No model-dtype tree of the model is ever made.  With n_experts > 0 a
    layer's MLP is a router [h, E] and expert stacks [E, h, f] / [E, f, h]
    (models/moe.py), which int8 refuses, as the JAX package does."""
    device = resolve_device(device)
    dtype = config.torch_dtype
    h, hd = config.hidden_size, config.head_dim
    nq, nkv, f = config.n_heads, config.n_kv_heads, config.intermediate_size
    quant = weight_quant == "int8"
    if quant and config.n_experts > 0:
        raise NotImplementedError("weight_quant over MoE experts")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def dense_f(*shape):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    def dense_q(*shape, channel_axis=-1):
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        s = torch.full((shape[channel_axis],), scale / 73.0,
                       dtype=torch.float32, device=device)
        return {"q": q, "s": s}

    dense = dense_q if quant else dense_f

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    norm_value = 0.0 if config.norm_plus_one else 1.0
    layers = []
    for i in range(config.n_layers):
        layer = {
            "attn_norm": const(norm_value, h),
            "wq": dense(h, nq * hd),
            "wk": dense(h, nkv * hd),
            "wv": dense(h, nkv * hd),
            "wo": dense(nq * hd, h),
            "mlp_norm": const(norm_value, h),
        }
        if config.n_experts > 0:
            layer.update(init_moe_params(config.moe, gen, device, scale, dtype))
        else:
            layer.update(w_gate=dense(h, f), w_up=dense(h, f), w_down=dense(f, h))
        if config.attention_bias:
            layer["bq"] = const(0.0, nq * hd)
            layer["bk"] = const(0.0, nkv * hd)
            layer["bv"] = const(0.0, nkv * hd)
        if config.qk_norm:
            layer["q_norm"] = const(1.0, hd)
            layer["k_norm"] = const(1.0, hd)
        if config.sandwich_norms:
            layer["post_attn_norm"] = const(0.0, h)
            layer["post_mlp_norm"] = const(0.0, h)
        if config.sliding_window > 0:
            layer["attn_window"] = config.layer_window(i)
        layers.append(layer)
    params: Params = {
        "embed": (dense_q(config.vocab_size, h, channel_axis=0)
                  if quant and config.tie_word_embeddings
                  else dense_f(config.vocab_size, h)),
        "final_norm": const(norm_value, h),
        "layers": layers,
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = dense(h, config.vocab_size)
    return params


def params_from_jax(params_np: Params, config: LlamaConfig, device=None) -> Params:
    """The JAX package's params pytree, with numpy leaves, -> this port's
    parameters on `device` (default CUDA; raises without a card) in
    config.dtype.  Same keys and layouts: an int8 leaf {"q", "s"} stays
    int8 with f32 scales, a layer's LoRA stacks {proj: {"A", "B"}} come
    across in config.dtype, and the per-layer `attn_window` becomes a
    Python int.  An MoE layer's router and expert stacks come across as
    they are."""
    device = resolve_device(device)
    dtype = config.torch_dtype

    def tensor(x):
        if isinstance(x, dict) and set(x) == {"q", "s"}:
            return {"q": torch.tensor(np.asarray(x["q"], dtype=np.int8)).to(device),
                    "s": torch.tensor(np.asarray(x["s"], dtype=np.float32)).to(device)}
        return torch.tensor(np.asarray(x, dtype=np.float32)).to(
            device=device, dtype=dtype)

    layers = []
    for layer in params_np["layers"]:
        out = {}
        for key, value in layer.items():
            if key == "lora":
                out[key] = {proj: {k: tensor(v) for k, v in ab.items()}
                            for proj, ab in value.items()}
            elif key == "attn_window":
                out[key] = int(np.asarray(value))
            else:
                out[key] = tensor(value)
        layers.append(out)
    params: Params = {"layers": layers}
    for key in ("embed", "final_norm", "lm_head"):
        if key in params_np:
            params[key] = tensor(params_np[key])
    return params


# ---------------- HF checkpoint loading ----------------
# Port of kserve_tpu/models/llama.py:994-1265 (load_hf_weights_streamed,
# load_hf_weights) on the port's own safetensors reader.

_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "self_attn.q_proj.bias": "bq",
    "self_attn.k_proj.bias": "bk",
    "self_attn.v_proj.bias": "bv",
    "self_attn.q_norm.weight": "q_norm",
    "self_attn.k_norm.weight": "k_norm",
    "post_attention_layernorm.weight": "mlp_norm",
    # Gemma-2 sandwich norms: HF's post_attention_layernorm is the
    # post-attention norm and pre_feedforward_layernorm the pre-MLP norm;
    # _finish_layers remaps them when the config is sandwich
    "pre_feedforward_layernorm.weight": "pre_ffn_norm_hf",
    "post_feedforward_layernorm.weight": "post_mlp_norm",
    "mlp.gate_proj.weight": "w_gate",
    "mlp.up_proj.weight": "w_up",
    "mlp.down_proj.weight": "w_down",
}

# HF Linear stores [out, in]; the port's layout is [in, out]
_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
# MixtralForCausalLM: block_sparse_moe.gate is the router, and each
# expert's w1 / w3 / w2 its gate / up / down projection
_EXPERT_RE = re.compile(r"^block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight$")
_MOE_PROJ = {"w1": "w_gate", "w3": "w_up", "w2": "w_down"}


def _checkpoint_files(model_dir: str) -> List[str]:
    files = sorted(os.path.join(model_dir, f) for f in os.listdir(model_dir)
                   if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_dir}")
    return files


def _check_quant(weight_quant: str, config: LlamaConfig) -> bool:
    if weight_quant not in ("none", "int8"):
        raise ValueError(f"weight_quant={weight_quant!r}")
    if weight_quant == "int8" and config.n_experts > 0:
        raise NotImplementedError("weight_quant over MoE experts")
    return weight_quant == "int8"


def _place(params: Params, name: str, t: torch.Tensor, config: LlamaConfig,
           device: torch.device, quant: bool, experts: dict) -> None:
    """Route one checkpoint tensor to its slot, on `device` in the
    config's dtype (transposed to [in, out] for the linears).  With
    `quant` the linears and the lm_head (or a tied embedding, per row) are
    quantized to int8 on the host first (quantize_array_np), so the device
    only sees int8 and scales.  An MoE expert's projection is copied into
    its slot of the layer's [E, in, out] stack, made on the device when
    the first expert of that stack arrives; `experts` maps (layer, proj)
    to the experts placed so far.  Rotary tables, layers past
    config.n_layers and unknown names are skipped."""
    dtype = config.torch_dtype

    def on_device(transpose: bool) -> torch.Tensor:
        x = t.to(device=device).to(dtype)
        return x.t().contiguous() if transpose else x

    def quantized(transpose: bool, axis: int = 0) -> dict:
        arr = t.to(torch.float32).numpy()
        qd = quantize_array_np(arr.T if transpose else arr, axis=axis)
        return {"q": torch.from_numpy(qd["q"]).to(device),
                "s": torch.from_numpy(qd["s"]).to(device)}

    if name == "model.embed_tokens.weight":
        params["embed"] = (quantized(False, axis=1)
                           if quant and config.tie_word_embeddings
                           else on_device(False))
        return
    if name == "model.norm.weight":
        params["final_norm"] = on_device(False)
        return
    if name == "lm_head.weight":
        if not config.tie_word_embeddings:
            params["lm_head"] = quantized(True) if quant else on_device(True)
        return
    m = _LAYER_RE.match(name)
    if m is None:
        return  # rotary inv_freq etc.: derived, never loaded
    i, suffix = int(m.group(1)), m.group(2)
    if i >= config.n_layers:
        return
    layer = params["layers"][i]
    if config.n_experts > 0:
        if suffix == "block_sparse_moe.gate.weight":
            layer["router"] = on_device(True)
            return
        em = _EXPERT_RE.match(suffix)
        if em is not None:
            e, proj = int(em.group(1)), _MOE_PROJ[em.group(2)]
            if proj not in layer:
                n_out, n_in = t.shape
                layer[proj] = torch.empty((config.n_experts, n_in, n_out),
                                          dtype=dtype, device=device)
            layer[proj][e].copy_(on_device(True))
            experts.setdefault((i, proj), set()).add(e)
            return
    ours = _HF_LAYER_MAP.get(suffix)
    if ours is None:
        return
    layer[ours] = (quantized(True) if quant and ours in LINEAR_KEYS
                   else on_device(ours in _TRANSPOSED))


def _finish_layers(params: Params, config: LlamaConfig,
                   experts: dict) -> Params:
    """The Gemma-2 norm remap and the per-layer attention windows;
    raises ValueError on an expert stack that is not whole."""
    missing = sorted(key for key, seen in experts.items()
                     if len(seen) < config.n_experts)
    if missing:
        raise ValueError(
            f"checkpoint is missing MoE experts for (layer, proj): {missing[:4]}")
    for i, layer in enumerate(params["layers"]):
        if config.sandwich_norms:
            layer["post_attn_norm"] = layer.pop("mlp_norm")
            layer["mlp_norm"] = layer.pop("pre_ffn_norm_hf")
        else:
            layer.pop("pre_ffn_norm_hf", None)
            layer.pop("post_mlp_norm", None)
        if config.sliding_window > 0:
            layer["attn_window"] = config.layer_window(i)
    return params


def load_hf_weights_streamed(model_dir: str, config: LlamaConfig, device=None,
                             stats: Optional[dict] = None,
                             weight_quant: str = "none") -> Params:
    """A local HF safetensors checkpoint as the port's parameters on
    `device` (default CUDA; raises without a card), read one tensor at a
    time and placed on the device at once, so host staging peaks at one
    tensor.  The result equals `params_from_jax` of the JAX package's
    loader's output.  `stats` is filled as the JAX loader fills it:
    peak_host_bytes (the largest host staging alive at once),
    read_bytes (every tensor's bytes) and n_tensors (every tensor read).
    weight_quant="int8" quantizes each linear on the host as it is read
    (the JAX loader's int8 path, kserve_tpu/models/llama.py:1021-1080), so
    host staging still peaks at about one tensor and the device holds no
    model-dtype copy; over MoE experts it raises, as the JAX loader does.
    A Mixtral checkpoint's experts go into their device stacks one by one,
    in any order and across shards, so host staging stays at one tensor
    there too (the JAX loader holds a layer's experts on the host until
    its stack is whole: its peak_host_bytes differ).  A stack still
    missing an expert at the end raises ValueError."""
    from .safetensors_io import iter_tensors

    quant = _check_quant(weight_quant, config)
    device = resolve_device(device)
    files = _checkpoint_files(model_dir)
    acct = {"peak_host_bytes": 0, "read_bytes": 0, "n_tensors": 0}
    params: Params = {"layers": [dict() for _ in range(config.n_layers)]}
    experts: dict = {}
    for path in files:
        for name, t in iter_tensors(path):
            nbytes = t.numel() * t.element_size()
            acct["read_bytes"] += nbytes
            acct["n_tensors"] += 1
            acct["peak_host_bytes"] = max(acct["peak_host_bytes"], nbytes)
            _place(params, name, t, config, device, quant, experts)
            del t
    if stats is not None:
        stats.update(acct)
    return _finish_layers(params, config, experts)


def load_hf_weights(model_dir: str, config: LlamaConfig, device=None,
                    weight_quant: str = "none") -> Params:
    """The buffered form of `load_hf_weights_streamed`: every tensor of
    every shard is read to the host first, then placed (the JAX package's
    `load_hf_weights`, which requires the embedding and the final norm,
    and of an MoE config every router and expert of the layers it loads).
    weight_quant="int8" quantizes on the host as the streamed form does."""
    from .safetensors_io import iter_tensors

    quant = _check_quant(weight_quant, config)
    device = resolve_device(device)
    tensors: Dict[str, torch.Tensor] = {}
    for path in _checkpoint_files(model_dir):
        tensors.update(iter_tensors(path))
    required = ["model.embed_tokens.weight", "model.norm.weight"]
    for i in range(config.n_layers if config.n_experts > 0 else 0):
        moe = f"model.layers.{i}.block_sparse_moe."
        required += [moe + "gate.weight"] + [
            f"{moe}experts.{e}.{w}.weight"
            for w in ("w1", "w3", "w2") for e in range(config.n_experts)]
    for name in required:
        if name not in tensors:
            raise KeyError(f"checkpoint under {model_dir} has no {name}")
    params: Params = {"layers": [dict() for _ in range(config.n_layers)]}
    experts: dict = {}
    for name in sorted(tensors):
        _place(params, name, tensors[name], config, device, quant, experts)
    return _finish_layers(params, config, experts)


def _norm(x: torch.Tensor, weight: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    if config.norm_plus_one:
        return rms_norm_plus_one(x, weight, config.rms_norm_eps)
    return rms_norm(x, weight, config.rms_norm_eps)


def _act(x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    if config.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _embed(params: Params, tokens: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens.long(), config.torch_dtype)
    if config.embed_scale:
        # the normalizer is cast to the activation dtype first (HF parity)
        x = x * torch.tensor(config.hidden_size ** 0.5, dtype=x.dtype)
    return x


def _maybe_add(y: torch.Tensor, delta: Optional[torch.Tensor]) -> torch.Tensor:
    return y if delta is None else y + delta


def _adapted(layer: Params, key: str, x: torch.Tensor, onehot) -> torch.Tensor:
    """x @ layer[key] (plain or int8) plus the layer's LoRA delta of that
    projection, where one applies."""
    return _maybe_add(dense(x, layer[key]),
                      lora_delta(layer.get("lora"), key, x, onehot))


def _adapter_onehot(params: Params, adapter_ids: Optional[torch.Tensor],
                    n_tokens: int, x: torch.Tensor) -> Optional[torch.Tensor]:
    """[N, n_adapters] one-hot of per-token adapter ids (-1 = base) in the
    activation dtype, or None when no layer carries LoRA stacks (then
    nothing is added anywhere).  Port of kserve_tpu/models/llama.py:473."""
    for layer in params["layers"]:
        lora = layer.get("lora")
        if lora:
            n_a = next(iter(lora.values()))["A"].shape[0]
            if adapter_ids is None:
                return torch.zeros((n_tokens, n_a), dtype=x.dtype, device=x.device)
            arange = torch.arange(n_a, device=adapter_ids.device)
            return (adapter_ids.reshape(-1, 1) == arange).to(x.dtype)
    return None


def _qkv(layer: Params, x: torch.Tensor, config: LlamaConfig, onehot=None):
    """x [N, h] -> q [N, nq, d], k/v [N, nkv, d]."""
    N = x.shape[0]
    q = _adapted(layer, "wq", x, onehot)
    k = _adapted(layer, "wk", x, onehot)
    v = _adapted(layer, "wv", x, onehot)
    if config.attention_bias:
        q = q + layer["bq"]
        k = k + layer["bk"]
        v = v + layer["bv"]
    q = q.reshape(N, config.n_heads, config.head_dim)
    k = k.reshape(N, config.n_kv_heads, config.head_dim)
    v = v.reshape(N, config.n_kv_heads, config.head_dim)
    if config.qk_norm:
        q = rms_norm(q, layer["q_norm"], config.rms_norm_eps)
        k = rms_norm(k, layer["k_norm"], config.rms_norm_eps)
    return q, k, v


def _mlp(layer: Params, x: torch.Tensor, config: LlamaConfig,
         onehot=None) -> torch.Tensor:
    if config.n_experts > 0:
        return moe_mlp(layer, x, config.moe)
    gate = _act(_adapted(layer, "w_gate", x, onehot), config)
    up = _adapted(layer, "w_up", x, onehot)
    return _adapted(layer, "w_down", gate * up, onehot)


def _logits(params: Params, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    x = _norm(x, params["final_norm"], config)
    head = params.get("lm_head")
    logits = (tied_head_matmul(x, params["embed"]) if head is None
              else dense(x, head)).float()
    if config.logit_softcap > 0.0:
        logits = torch.tanh(logits / config.logit_softcap) * config.logit_softcap
    return logits


def _block(layer: Params, x: torch.Tensor, cos, sin, config: LlamaConfig,
           attend, onehot=None) -> torch.Tensor:
    """One transformer block over N tokens x [N, h]; `attend(q, k, v,
    window)` writes K/V to the cache and returns attention [N, nq, d].
    `onehot` [N, n_adapters] selects each token's LoRA adapter."""
    residual = x
    h = _norm(x, layer["attn_norm"], config)
    q, k, v = _qkv(layer, h, config, onehot)
    q = rotate(q, cos, sin)
    k = rotate(k, cos, sin)
    attn = attend(q, k, v, layer.get("attn_window", 0))
    attn = _adapted(layer, "wo", attn.reshape(x.shape[0], -1), onehot)
    if config.sandwich_norms:
        attn = _norm(attn, layer["post_attn_norm"], config)
    x = residual + attn
    residual = x
    out = _mlp(layer, _norm(x, layer["mlp_norm"], config), config, onehot)
    if config.sandwich_norms:
        out = _norm(out, layer["post_mlp_norm"], config)
    return residual + out


def transformer_block(
    layer: Params,
    x: torch.Tensor,  # [B, T, h]
    positions: torch.Tensor,  # [B, T] int
    valid_len: torch.Tensor,  # [B]
    config: LlamaConfig,
    onehot: Optional[torch.Tensor] = None,  # [B*T, n_adapters] per token
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block over padded prompts, reading no cache (prefill form):
    returns (x_out [B, T, h], k, v [B, T, nkv, d]) for the caller to
    write into its pages.  Port of kserve_tpu/models/llama.py:497."""
    B, T, h = x.shape
    cos, sin = rope_cos_sin(positions.reshape(-1), config.head_dim,
                            config.rope_theta, config.rope_scaling)
    kv = []

    def attend(q, k, v, window):
        k, v = (t.reshape(B, T, *t.shape[1:]) for t in (k, v))
        kv.extend((k, v))
        out = causal_prefill_attention(
            q.reshape(B, T, *q.shape[1:]), k, v, valid_len,
            config.attn_logit_softcap, scale=config.attn_scale, window=window)
        return out.reshape(B * T, *out.shape[2:])

    out = _block(layer, x.reshape(B * T, h), cos, sin, config, attend, onehot)
    return out.reshape(B, T, h), kv[0], kv[1]


def _row_onehot(params: Params, adapter_ids, B: int, T: int,
                x: torch.Tensor) -> Optional[torch.Tensor]:
    """The per-token one-hot of [B, T] rows whose adapter is one per row."""
    ids = None
    if adapter_ids is not None:
        ids = adapter_ids.to(x.device).repeat_interleave(T)
    return _adapter_onehot(params, ids, B * T, x)


def _last_logits(params: Params, x: torch.Tensor, valid_len: torch.Tensor,
                 config: LlamaConfig) -> torch.Tensor:
    """[B, vocab] f32 logits at each row's last valid token of x [B, T, h]."""
    last = torch.clamp(valid_len.to(x.device).long() - 1, min=0)
    rows = torch.arange(x.shape[0], device=x.device)
    return _logits(params, x[rows, last], config)


def prefill(
    params: Params,
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] padded prompts
    valid_len: torch.Tensor,  # [B]
    kv_pages: List[KVLayer],  # per layer: pages, or (int8 pages, scales)
    page_ids: torch.Tensor,  # [B, W] int32, each row's pages
    page_size: int,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] LoRA ids (-1 = base)
) -> Tuple[torch.Tensor, List[KVLayer]]:
    """Whole prompts from position 0: each layer attends causally within
    the prompt and writes its K/V into the pages (int8 caches take
    quantized rows while the attention used the unquantized K/V).  Returns
    ([B, vocab] f32 logits at each row's last valid token, pages).  Port
    of kserve_tpu/models/llama.py:542."""
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(B, T)
    x = _embed(params, tokens.reshape(-1), config).reshape(B, T, -1)
    onehot = _row_onehot(params, adapter_ids, B, T, x)
    for layer, pages in zip(params["layers"], kv_pages):
        x, k, v = transformer_block(layer, x, positions, valid_len, config,
                                    onehot)
        write_prompt_kv_batch(pages, k, v, page_ids, valid_len, page_size)
    return _last_logits(params, x, valid_len, config), kv_pages


def chunk_transformer_block(
    layer: Params,
    pages: KVLayer,  # this layer's cache
    x: torch.Tensor,  # [B, C, h]
    chunk_start: torch.Tensor,  # [B]
    valid_len: torch.Tensor,  # [B]
    page_ids: torch.Tensor,  # [B, W]
    page_size: int,
    config: LlamaConfig,
    onehot: Optional[torch.Tensor] = None,  # [B*C, n_adapters] per token
) -> Tuple[torch.Tensor, KVLayer]:
    """One chunked-prefill block: attend to the cached history and the
    chunk's causal prefix, then write the chunk's K/V.  Port of
    kserve_tpu/models/llama.py:577."""
    B, C, h = x.shape
    positions = (chunk_start.to(x.device)[:, None]
                 + torch.arange(C, dtype=torch.int32, device=x.device)[None, :])
    cos, sin = rope_cos_sin(positions.reshape(-1), config.head_dim,
                            config.rope_theta, config.rope_scaling)

    def attend(q, k, v, window):
        k, v = (t.reshape(B, C, *t.shape[1:]) for t in (k, v))
        out = chunked_prefill_attention(
            q.reshape(B, C, *q.shape[1:]), k, v, pages, page_ids, chunk_start,
            valid_len, config.attn_logit_softcap, scale=config.attn_scale,
            window=window)
        write_chunk_kv_batch(pages, k, v, page_ids, chunk_start, valid_len,
                             page_size)
        return out.reshape(B * C, *out.shape[2:])

    out = _block(layer, x.reshape(B * C, h), cos, sin, config, attend, onehot)
    return out.reshape(B, C, h), pages


def prefill_chunk(
    params: Params,
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B, C] one chunk of each prompt (padded)
    chunk_start: torch.Tensor,  # [B] tokens already prefilled (history)
    valid_len: torch.Tensor,  # [B] valid tokens within this chunk
    kv_pages: List[KVLayer],  # per layer: pages, or (int8 pages, scales)
    page_ids: torch.Tensor,  # [B, W] int32, the sequences' pages
    page_size: int,
    adapter_ids: Optional[torch.Tensor] = None,  # [B] LoRA ids (-1 = base)
) -> Tuple[torch.Tensor, List[KVLayer]]:
    """One chunk of a chunked prefill: returns ([B, vocab] f32 logits at
    the chunk's last valid token, pages).  chunk_start 0 is the plain
    prefill of the chunk.  Port of kserve_tpu/models/llama.py:625."""
    B, C = tokens.shape
    x = _embed(params, tokens.reshape(-1), config).reshape(B, C, -1)
    onehot = _row_onehot(params, adapter_ids, B, C, x)
    for layer, pages in zip(params["layers"], kv_pages):
        x, _ = chunk_transformer_block(layer, pages, x, chunk_start, valid_len,
                                       page_ids, page_size, config, onehot)
    return _last_logits(params, x, valid_len, config), kv_pages


def decode_step(
    params: Params,
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B] current tokens
    pos: torch.Tensor,  # [B] int32 their positions
    kv_pages: List[KVLayer],  # per layer: pages, or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W] int32
    active: torch.Tensor,  # [B] bool
    page_size: int,
    attention_fn=None,  # replaces ops.attention.paged_attention (same signature)
    adapter_ids: Optional[torch.Tensor] = None,  # [B] LoRA ids (-1 = base)
) -> Tuple[torch.Tensor, List[KVLayer]]:
    """One decode token per lane; returns ([B, vocab] f32 logits, pages).
    Pages (and, for an int8 cache, their scales) are written in place."""
    attention = attention_fn or paged_attention
    x = _embed(params, tokens, config)  # [B, h]
    onehot = _adapter_onehot(params, adapter_ids, x.shape[0], x)
    cos, sin = rope_cos_sin(pos, config.head_dim, config.rope_theta,
                            config.rope_scaling)
    seq_lens = torch.where(active, pos + 1, torch.zeros_like(pos)).to(torch.int32)
    for layer, pages in zip(params["layers"], kv_pages):
        def attend(q, k, v, window, pages=pages):
            append_token_kv(pages, k, v, page_table, pos, active, page_size)
            return attention(q, pages, page_table, seq_lens,
                             logit_softcap=config.attn_logit_softcap,
                             scale=config.attn_scale, window=window)
        x = _block(layer, x, cos, sin, config, attend, onehot)
    return _logits(params, x, config), kv_pages


def forward_ragged(
    params: Params,
    config: LlamaConfig,
    tokens: torch.Tensor,  # [T] packed ragged token buffer
    token_seq: torch.Tensor,  # [T] lane per token (-1 = padding)
    token_pos: torch.Tensor,  # [T] absolute position per token
    q_start: torch.Tensor,  # [B] first packed index of each lane's slice
    q_len: torch.Tensor,  # [B] slice length (0 = inactive lane)
    kv_start: torch.Tensor,  # [B] tokens cached before the slice
    kv_pages: List[KVLayer],  # per layer: pages, or (int8 pages, scales)
    page_table: torch.Tensor,  # [B, W] int32
    page_size: int,
    last_idx: torch.Tensor,  # [B] packed index of each lane's last token
    attention_fn=None,  # replaces ops.attention.ragged_paged_attention
    logits_at: Optional[torch.Tensor] = None,  # [N] packed indices
    dense_stride: Optional[int] = None,  # dense packing stride (< 8: the
    # speculative-verify layout, lanes sharing kernel blocks)
    adapter_ids: Optional[torch.Tensor] = None,  # [B] LoRA ids (-1 = base)
) -> Tuple[torch.Tensor, List[KVLayer]]:
    """The unified mixed-batch forward: every lane's slice (a prompt, a
    prompt chunk or one decode token) sits in one packed buffer.  Each
    layer writes the slice's K/V into the pages, then runs ragged paged
    attention with the causal mask anchored at each lane's kv offset.
    Returns ([B, vocab] f32 logits at each lane's last token, pages), or
    with `logits_at` the [N, vocab] logits at every listed token (the
    speculative-verify surface: each slice position needs its own
    next-token distribution).  Adapters are selected per token (a token
    takes its lane's id; padding is base), so lanes of different adapters
    share the dispatch (kserve_tpu/models/llama.py:754-761)."""
    if attention_fn is not None:
        attention = attention_fn
    else:
        attention = functools.partial(ragged_paged_attention,
                                      dense_stride=dense_stride)
    x = _embed(params, tokens, config)  # [T, h]
    token_adapters = None
    if adapter_ids is not None:
        lane = token_seq.long().clamp(min=0)
        token_adapters = torch.where(token_seq >= 0, adapter_ids.to(x.device)[lane],
                                     torch.full_like(token_seq, -1))
    onehot = _adapter_onehot(params, token_adapters, x.shape[0], x)
    cos, sin = rope_cos_sin(token_pos, config.head_dim, config.rope_theta,
                            config.rope_scaling)
    for layer, pages in zip(params["layers"], kv_pages):
        def attend(q, k, v, window, pages=pages):
            write_ragged_kv(pages, k, v, page_table, token_seq, token_pos,
                            page_size)
            return attention(q, pages, page_table, q_start, q_len, kv_start,
                             logit_softcap=config.attn_logit_softcap,
                             scale=config.attn_scale, window=window)
        x = _block(layer, x, cos, sin, config, attend, onehot)
    rows = last_idx if logits_at is None else logits_at
    return _logits(params, x[rows.long()], config), kv_pages
