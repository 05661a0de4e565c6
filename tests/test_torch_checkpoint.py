"""Checkpoint loading of the PyTorch port against the JAX package on the
CPU: the port's safetensors reader and writer (models/safetensors_io.py)
and `load_hf_weights(_streamed)` over checkpoints written with
`safetensors.numpy.save_file` (as tests/test_llama_model.py writes them),
for Llama, Qwen3 (qk-norm, qkv biases), Gemma-2 (sandwich norms, sliding
windows) and a tied-embedding config, in float32 and bfloat16.  The
port's parameters must equal `params_from_jax` of the JAX loader's output
exactly (same keys, dtypes and bits), and the streamed loader's stats
the JAX ones.  A --model_dir server on the CPU must answer the JAX
engine's greedy tokens over the same directory."""

import asyncio
import json
import os
import struct
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import load_tokenizer as jax_load_tokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.models import safetensors_io as sio

NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

CONFIGS = {
    "llama": dict(),
    "qwen3": dict(qk_norm=True, attention_bias=True, tie_word_embeddings=True,
                  rms_norm_eps=1e-6),
    "gemma2": dict(sandwich_norms=True, norm_plus_one=True, embed_scale=True,
                   hidden_act="gelu_tanh", tie_word_embeddings=True,
                   sliding_window=8,
                   layer_types=("sliding_attention", "full_attention")),
    "tied": dict(tie_word_embeddings=True),
}


def _hf_tensors(kind: str, np_dtype, seed: int = 0) -> dict:
    """A seeded HF-layout state dict for the tiny config of `kind` (Linear
    weights [out, in]), with the tensors a real checkpoint also holds and
    the loaders skip: a rotary table, an lm_head beside tied embeddings,
    and a layer past n_layers."""
    cfg = tl.LlamaConfig.tiny(**CONFIGS[kind])
    rng = np.random.RandomState(seed)
    h, hd, f = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32).astype(np_dtype)

    out = {"model.embed_tokens.weight": w(cfg.vocab_size, h),
           "model.norm.weight": w(h),
           "lm_head.weight": w(cfg.vocab_size, h)}
    for i in range(cfg.n_layers + 1):
        p = f"model.layers.{i}."
        layer = {
            "input_layernorm.weight": w(h), "post_attention_layernorm.weight": w(h),
            "self_attn.q_proj.weight": w(nq, h), "self_attn.k_proj.weight": w(nkv, h),
            "self_attn.v_proj.weight": w(nkv, h), "self_attn.o_proj.weight": w(h, nq),
            "mlp.gate_proj.weight": w(f, h), "mlp.up_proj.weight": w(f, h),
            "mlp.down_proj.weight": w(h, f),
            "self_attn.rotary_emb.inv_freq": w(hd // 2),
        }
        if cfg.attention_bias:
            layer.update({"self_attn.q_proj.bias": w(nq),
                          "self_attn.k_proj.bias": w(nkv),
                          "self_attn.v_proj.bias": w(nkv)})
        if cfg.qk_norm:
            layer.update({"self_attn.q_norm.weight": w(hd),
                          "self_attn.k_norm.weight": w(hd)})
        if cfg.sandwich_norms:
            layer.update({"pre_feedforward_layernorm.weight": w(h),
                          "post_feedforward_layernorm.weight": w(h)})
        out.update({p + k: v for k, v in layer.items()})
    return out


def _write_shards(model_dir, tensors: dict, shards: int = 3) -> None:
    names = sorted(tensors)
    per = -(-len(names) // shards)
    for k in range(0, len(names), per):
        np_save_file({n: tensors[n] for n in names[k:k + per]},
                     os.path.join(model_dir, f"model-{k:05d}.safetensors"))


def _configs(kind: str, dtype: str):
    return (jl.LlamaConfig.tiny(dtype=dtype, **CONFIGS[kind]),
            tl.LlamaConfig.tiny(dtype=dtype, **CONFIGS[kind]))


def _assert_params_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in ("embed", "final_norm", "lm_head"):
        if key in want:
            assert got[key].dtype == want[key].dtype
            assert torch.equal(got[key], want[key]), key
    assert len(got["layers"]) == len(want["layers"])
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert sorted(g) == sorted(w), i
        for k in w:
            if k == "attn_window":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype and g[k].is_contiguous()
                assert torch.equal(g[k], w[k]), (i, k)


@pytest.mark.parametrize("ckpt_dtype,dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16")],
    ids=["f32", "bf16", "f32_to_bf16"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_loaders_match_params_from_jax(tmp_path, kind, ckpt_dtype, dtype):
    _write_shards(str(tmp_path), _hf_tensors(kind, NP_DTYPES[ckpt_dtype]))
    jcfg, tcfg = _configs(kind, dtype)
    want = tl.params_from_jax(
        jax.tree.map(np.asarray, jl.load_hf_weights(str(tmp_path), jcfg)),
        tcfg, device="cpu")
    _assert_params_equal(tl.load_hf_weights(str(tmp_path), tcfg, device="cpu"), want)
    jstats, tstats = {}, {}
    jl.load_hf_weights_streamed(str(tmp_path), jcfg, stats=jstats)
    streamed = tl.load_hf_weights_streamed(str(tmp_path), tcfg, device="cpu",
                                           stats=tstats)
    _assert_params_equal(streamed, want)
    assert tstats == jstats
    if tcfg.tie_word_embeddings:
        assert "lm_head" not in streamed  # the checkpoint's copy is skipped
    if tcfg.sliding_window:
        assert [layer["attn_window"] for layer in streamed["layers"]] == [8, 0]


def test_save_file_round_trip(tmp_path):
    """Every supported dtype, a 0-d and an empty tensor: the port's writer
    and reader are bit-exact both ways, and `safetensors` reads the file."""
    from safetensors.torch import load_file as st_load_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "i8": torch.randint(-128, 127, (7,), generator=g, dtype=torch.int8),
        "i32": torch.randint(-2**31, 2**31 - 1, (2, 2), generator=g, dtype=torch.int32),
        "i64": torch.arange(5, dtype=torch.int64) * (1 << 40),
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 4),
        "strided": torch.randn(4, 6, generator=g).t(),  # written contiguous
    }
    path = str(tmp_path / "a.safetensors")
    sio.save_file(tensors, path)
    for name, got in [*sio.iter_tensors(path)]:
        want = tensors[name]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), name
    theirs = st_load_file(path)
    assert sorted(theirs) == sorted(tensors)
    for name, want in tensors.items():
        assert torch.equal(theirs[name], want), name
    # and what safetensors writes, the port reads
    np_save_file({"x": np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16)},
                 str(tmp_path / "b.safetensors"))
    (name, x), = sio.iter_tensors(str(tmp_path / "b.safetensors"))
    assert x.dtype == torch.bfloat16 and x.tolist() == [0, 1, 2, 3, 4, 5]


def _raw_file(path, header: dict, data: bytes, declared=None) -> str:
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head) if declared is None else declared))
        f.write(head + data)
    return str(path)


@pytest.mark.parametrize("case", [
    "length_past_end", "not_json", "out_of_range", "overlap", "size_mismatch",
    "short"])
def test_corrupt_header_raises(tmp_path, case):
    p = tmp_path / "bad.safetensors"
    ok = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}
    if case == "length_past_end":
        path = _raw_file(p, ok, b"\0" * 8, declared=1 << 20)
    elif case == "not_json":
        p.write_bytes(struct.pack("<Q", 4) + b"{no}")
        path = str(p)
    elif case == "out_of_range":
        path = _raw_file(p, {"a": {"dtype": "F32", "shape": [4],
                                   "data_offsets": [0, 16]}}, b"\0" * 8)
    elif case == "overlap":
        path = _raw_file(p, {**ok, "b": {"dtype": "F32", "shape": [2],
                                         "data_offsets": [4, 12]}}, b"\0" * 16)
    elif case == "size_mismatch":
        path = _raw_file(p, {"a": {"dtype": "F32", "shape": [3],
                                   "data_offsets": [0, 8]}}, b"\0" * 8)
    else:
        p.write_bytes(b"\1\2")
        path = str(p)
    with pytest.raises(sio.SafetensorsError):
        list(sio.iter_tensors(path))


def test_unsupported_dtype_is_named(tmp_path):
    path = _raw_file(tmp_path / "f64.safetensors",
                     {"a": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}},
                     b"\0" * 8)
    with pytest.raises(NotImplementedError, match="F64"):
        list(sio.iter_tensors(path))


def test_moe_and_int8_weights_raise(tmp_path):
    """An MoE checkpoint loads (tests/test_torch_moe_checkpoint.py holds it
    to the JAX loaders), and int8 weights over its experts are refused, as
    in the JAX package."""
    hf = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "num_local_experts": 4}
    jcfg, tcfg = jl.LlamaConfig.from_hf_config(hf), tl.LlamaConfig.from_hf_config(hf)
    assert (tcfg.n_experts, tcfg.n_experts_per_tok) == (4, 2)
    assert (jcfg.n_experts, jcfg.n_experts_per_tok) == (4, 2)
    tensors = {n: t for n, t in _hf_tensors("llama", np.float32).items()
               if ".mlp." not in n}
    rng = np.random.RandomState(1)
    for i in range(2):
        moe = f"model.layers.{i}.block_sparse_moe."
        tensors[moe + "gate.weight"] = rng.standard_normal((4, 64)).astype(np.float32)
        for e in range(4):
            for w, shape in (("w1", (128, 64)), ("w3", (128, 64)), ("w2", (64, 128))):
                tensors[f"{moe}experts.{e}.{w}.weight"] = (
                    rng.standard_normal(shape).astype(np.float32))
    _write_shards(str(tmp_path), tensors, shards=1)
    tcfg.dtype = "float32"
    for load in (tl.load_hf_weights, tl.load_hf_weights_streamed):
        layer = load(str(tmp_path), tcfg, device="cpu")["layers"][1]
        assert tuple(layer["router"].shape) == (64, 4)
        np.testing.assert_array_equal(
            layer["w_down"][3].numpy(),
            tensors["model.layers.1.block_sparse_moe.experts.3.w2.weight"].T)
        # int8 weights load (tests/test_torch_quant.py); over MoE experts
        # they stay refused
        with pytest.raises(NotImplementedError, match="MoE"):
            load(str(tmp_path), tcfg, device="cpu", weight_quant="int8")


def test_missing_checkpoint_raises(tmp_path):
    _, tcfg = _configs("llama", "float32")
    with pytest.raises(FileNotFoundError):
        tl.load_hf_weights_streamed(str(tmp_path), tcfg, device="cpu")


# ---------------------------------------------------------------- serving

HF_CONFIG = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "max_position_embeddings": 256,
             "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
             "tie_word_embeddings": False}
ENGINE = dict(max_batch_size=4, page_size=8, num_pages=128,
              max_pages_per_seq=32, max_prefill_len=64, dtype="float32")
SERVER_ARGS = ["--model_name=ckpt", "--device=cpu", "--kv_dtype=float32",
               "--http_port=0", "--max_batch_size=4", "--page_size=8",
               "--kv_pages=128", "--max_model_len=256", "--max_prefill_len=64"]
PROMPTS = ["The quick brown fox", "It's 2024: café ² 你好",
           "def f(x):\n    return x"]


def _write_model_dir(model_dir) -> None:
    """A tiny Llama checkpoint: config.json, two f32 shards, and a
    byte-level BPE tokenizer.json trained here with Llama-3's split."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(HF_CONFIG, f)
    tensors = _hf_tensors("llama", np.float32, seed=5)
    for k in tensors:  # weights large enough for distinct greedy tokens
        tensors[k] = tensors[k] * 4
    _write_shards(model_dir, tensors, shards=2)
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(
            r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
            r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        PROMPTS * 20 + ["the lazy dog jumps over the fence"] * 20,
        trainers.BpeTrainer(vocab_size=320, show_progress=False,
                            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(["<|begin_of_text|>", "<|eot_id|>"])
    tok.save(os.path.join(model_dir, "tokenizer.json"))
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>"}, f)


async def _jax_texts(engine, tok, n_tokens: int):
    async def one(text):
        params = js.SamplingParams(temperature=0.0, max_tokens=n_tokens,
                                   ignore_eos=True)
        return "".join([o.text_delta async for o in
                        engine.generate(tok.encode(text), params)])

    await engine.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[one(p) for p in PROMPTS]), timeout=300)
    finally:
        await engine.stop()


def test_model_dir_server_matches_jax_engine(tmp_path):
    import http.client

    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    model_dir = str(tmp_path)
    _write_model_dir(model_dir)
    n = 10
    jcfg = jl.LlamaConfig.from_hf_config(os.path.join(model_dir, "config.json"))
    jcfg.dtype = "float32"
    jtok = jax_load_tokenizer(model_dir, jcfg.vocab_size)
    jengine = jeng.LLMEngine(jcfg, jeng.EngineConfig(**ENGINE), jtok,
                             params=jl.load_hf_weights_streamed(model_dir, jcfg),
                             rng_seed=0)
    want = asyncio.run(_jax_texts(jengine, jtok, n))

    model = build_model(build_arg_parser().parse_args(
        SERVER_ARGS + [f"--model_dir={model_dir}"]))
    assert model.model_config.dtype == "float32" and not model.random_weights
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    try:
        assert srv.listening.wait(60), "server did not start"
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        got = []
        for text in PROMPTS:  # one kept-alive connection
            conn.request("POST", "/openai/v1/completions", body=json.dumps({
                "model": "ckpt", "prompt": text, "max_tokens": n,
                "temperature": 0, "ignore_eos": True}),
                headers={"Content-Type": "application/json"})
            resp = json.loads(conn.getresponse().read())
            assert resp["usage"]["prompt_tokens"] == len(jtok.encode(text))
            got.append(resp["choices"][0]["text"])
        conn.close()
        stats = model.weights_stats
    finally:
        srv.request_stop()
        thread.join(30)
    assert not thread.is_alive()
    assert got == want
    assert stats["n_tensors"] == 3 + 10 * 3  # two layers, plus one skipped
    assert stats["read_bytes"] > 0 and stats["peak_host_bytes"] == 512 * 64 * 4
