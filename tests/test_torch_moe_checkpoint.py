"""Mixtral checkpoints in the PyTorch port against the JAX package on the
CPU: a tiny Mixtral-form checkpoint (block_sparse_moe.gate and
experts.{e}.w1/w3/w2, HF Linear layout [out, in]) in two safetensors
shards, layer 1's experts split across the shard boundary so that its
stacks fill out of order, read by both of the port's loaders and equal to
`params_from_jax` of the JAX loaders' output; the streamed loader's host
staging one tensor at most; a missing expert refused as each JAX loader
refuses it; int8 over experts refused; Mixtral-8x7B's config.json mapped
as the JAX package maps it; and a --model_dir server built over the
checkpoint."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from kserve_tpu.models import llama as jl
from kserve_tpu_torch.models import llama as tl

MOE = dict(n_experts=4, n_experts_per_tok=2)
# Mixtral-8x7B's published config.json (mistralai/Mixtral-8x7B-v0.1)
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-05, "rope_theta": 1e6,
    "sliding_window": None, "tie_word_embeddings": False, "hidden_act": "silu",
    "num_local_experts": 8, "num_experts_per_tok": 2, "torch_dtype": "bfloat16"}


def _mixtral_tensors(cfg, seed: int = 0) -> dict:
    """A seeded Mixtral-form state dict (float32) for `cfg`, with a layer
    past n_layers (which the loaders skip)."""
    rng = np.random.RandomState(seed)
    h, hd, f, E = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size, cfg.n_experts
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    out = {"model.embed_tokens.weight": w(cfg.vocab_size, h),
           "model.norm.weight": w(h), "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.n_layers + 1):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": w(h),
            p + "post_attention_layernorm.weight": w(h),
            p + "self_attn.q_proj.weight": w(nq, h),
            p + "self_attn.k_proj.weight": w(nkv, h),
            p + "self_attn.v_proj.weight": w(nkv, h),
            p + "self_attn.o_proj.weight": w(h, nq),
            p + "block_sparse_moe.gate.weight": w(E, h)})
        for e in range(E):
            moe = f"{p}block_sparse_moe.experts.{e}."
            out.update({moe + "w1.weight": w(f, h), moe + "w3.weight": w(f, h),
                        moe + "w2.weight": w(h, f)})
    return out


def _write_checkpoint(model_dir, tensors: dict) -> None:
    """Two shards: the second holds layer 1's router and its experts 0 and
    1, so layer 1's stacks get experts 2 and 3 (first shard) before 0 and
    1; plus Mixtral's config.json at the checkpoint's size."""
    late = {n for n in tensors if n.startswith((
        "model.layers.1.block_sparse_moe.gate",
        "model.layers.1.block_sparse_moe.experts.0.",
        "model.layers.1.block_sparse_moe.experts.1."))}
    os.makedirs(model_dir, exist_ok=True)
    for k, part in enumerate((sorted(set(tensors) - late), sorted(late))):
        np_save_file({n: tensors[n] for n in part},
                     os.path.join(model_dir, f"model-0000{k + 1}-of-00002.safetensors"))
    cfg = dict(MIXTRAL_8X7B, vocab_size=512, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=256, num_local_experts=4,
               torch_dtype="float32")
    with open(os.path.join(model_dir, "config.json"), "w") as fh:
        json.dump(cfg, fh)


def _configs(dtype="float32"):
    return (jl.LlamaConfig.tiny(dtype=dtype, **MOE),
            tl.LlamaConfig.tiny(dtype=dtype, **MOE))


def _assert_params_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in ("embed", "final_norm", "lm_head"):
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key])
    assert len(got["layers"]) == len(want["layers"])
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert sorted(g) == sorted(w), i
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].is_contiguous(), (i, k)
            assert torch.equal(g[k], w[k]), (i, k)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("mixtral"))
    tensors = _mixtral_tensors(_configs()[1])
    _write_checkpoint(model_dir, tensors)
    return model_dir, tensors


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loader", ["streamed", "buffered"])
def test_loaders_match_params_from_jax(checkpoint, loader, dtype):
    model_dir, tensors = checkpoint
    jcfg, tcfg = _configs(dtype)
    jstats, tstats = {}, {}
    if loader == "streamed":
        jparams = jl.load_hf_weights_streamed(model_dir, jcfg, stats=jstats)
        got = tl.load_hf_weights_streamed(model_dir, tcfg, device="cpu", stats=tstats)
    else:
        jparams = jl.load_hf_weights(model_dir, jcfg)
        got = tl.load_hf_weights(model_dir, tcfg, device="cpu")
    want = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    _assert_params_equal(got, want)
    layer = got["layers"][1]
    assert tuple(layer["w_down"].shape) == (4, 128, 64)
    # expert 2's gate projection, as written ([out, in]), transposed
    np.testing.assert_array_equal(
        layer["w_gate"][2].float().numpy(),
        torch.tensor(tensors["model.layers.1.block_sparse_moe.experts.2.w1.weight"])
        .to(getattr(torch, dtype)).float().numpy().T)
    if loader == "streamed":
        # every tensor read once; host staging one tensor at most, where
        # the JAX loader holds a layer's experts until its stack is whole
        largest = max(t.nbytes for t in tensors.values())
        assert {k: tstats[k] for k in ("read_bytes", "n_tensors")} == {
            k: jstats[k] for k in ("read_bytes", "n_tensors")}
        assert tstats["peak_host_bytes"] == largest < jstats["peak_host_bytes"]


@pytest.mark.parametrize("loader", ["streamed", "buffered"])
def test_missing_expert_refused_as_in_jax(tmp_path, checkpoint, loader):
    """An expert missing from a stack: the streamed loaders raise
    ValueError at the end (kserve_tpu/models/llama.py:1147), the buffered
    ones KeyError naming the tensor."""
    _, tensors = checkpoint
    gone = "model.layers.0.block_sparse_moe.experts.1.w3.weight"
    _write_checkpoint(str(tmp_path), {n: t for n, t in tensors.items() if n != gone})
    jcfg, tcfg = _configs()
    if loader == "streamed":
        with pytest.raises(ValueError, match=r"missing MoE experts.*\(0, 'w_up'\)"):
            jl.load_hf_weights_streamed(str(tmp_path), jcfg)
        with pytest.raises(ValueError, match=r"missing MoE experts.*\(0, 'w_up'\)"):
            tl.load_hf_weights_streamed(str(tmp_path), tcfg, device="cpu")
    else:
        with pytest.raises(KeyError, match=gone):
            jl.load_hf_weights(str(tmp_path), jcfg)
        with pytest.raises(KeyError, match=gone):
            tl.load_hf_weights(str(tmp_path), tcfg, device="cpu")


@pytest.mark.parametrize("loader", ["streamed", "buffered"])
def test_int8_over_experts_refused_as_in_jax(checkpoint, loader):
    model_dir, _ = checkpoint
    jcfg, tcfg = _configs()
    jload, tload = ((jl.load_hf_weights_streamed, tl.load_hf_weights_streamed)
                    if loader == "streamed" else
                    (jl.load_hf_weights, tl.load_hf_weights))
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        jload(model_dir, jcfg, weight_quant="int8")
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        tload(model_dir, tcfg, device="cpu", weight_quant="int8")


def test_mixtral_config_maps_as_in_jax():
    j = jl.LlamaConfig.from_hf_config(MIXTRAL_8X7B)
    t = tl.LlamaConfig.from_hf_config(MIXTRAL_8X7B)
    for field in t.__dataclass_fields__:
        assert getattr(t, field) == getattr(j, field), field
    assert (t.n_experts, t.n_experts_per_tok, t.sliding_window) == (8, 2, 0)
    assert (t.head_dim, t.n_kv_heads, t.rope_theta) == (128, 8, 1e6)
    assert not t.tie_word_embeddings and t.hidden_act == "silu"


def test_model_dir_server_loads_the_checkpoint(checkpoint):
    """build_model over the checkpoint directory: Mixtral's config.json
    read, the weights streamed in, and a greedy completion through the
    engine; --weight_quant int8 over it refused."""
    import asyncio

    from kserve_tpu_torch.engine.sampling import SamplingParams
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    model_dir, _ = checkpoint
    argv = ["--model_name=mixtral", f"--model_dir={model_dir}", "--device=cpu",
            "--kv_dtype=float32", "--kv_pages=64", "--page_size=8",
            "--max_model_len=128", "--max_prefill_len=32"]
    model = build_model(build_arg_parser().parse_args(argv))
    assert (model.model_config.n_experts, model.model_config.n_layers) == (4, 2)
    engine = model._build_engine()
    assert model.weights_stats["n_tensors"] == len(_mixtral_tensors(
        _configs()[1])) and tuple(engine.params["layers"][0]["router"].shape) == (64, 4)

    async def complete():
        await engine.start()
        try:
            return [o.token_id async for o in engine.generate(
                [3, 4, 5, 6], SamplingParams(temperature=0.0, max_tokens=4,
                                             ignore_eos=True))]
        finally:
            await engine.stop()

    assert len(asyncio.run(complete())) == 4
    int8 = build_model(build_arg_parser().parse_args(argv + ["--weight_quant=int8"]))
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        int8.load()
