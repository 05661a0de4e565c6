"""Int8 weights (weight_quant="int8") of the PyTorch port against the JAX
package: the quantizers (torch and numpy) bit-equal to kserve_tpu's in
both axes, round half to even included; quantize_params and param_bytes
equal; the int8 product, gather and tied head in the reference's order of
operations; MoE refused; the port's int8 init laid out as JAX's; the
streamed and buffered int8 loaders equal to JAX's on a tiny checkpoint
written by the port's safetensors writer; forward_ragged / decode_step
logits with int8 weights (tied and untied) within 1e-4 x max|logit| of
JAX's; and greedy engine streams with int8 weights equal to the JAX
engine's.  Everything runs in float32 on the CPU (the JAX side on its
plain XLA path)."""

import asyncio
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.models import quant as jq
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.models import quant as tq
from kserve_tpu_torch.models.safetensors_io import save_file

PS = 8
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
# float32 logits of the same int8 weights through 2 layers: the two
# libraries sum in another order only (~1e-6 relative observed)
LOGIT_REL_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(tied: bool, quantize: bool = True):
    """(JAX config, port config, JAX params, port params) of one tiny
    float32 model, int8 on both sides when `quantize` (JAX's
    quantize_params, carried across by params_from_jax)."""
    over = dict(dtype="float32", tie_word_embeddings=tied)
    jcfg, tcfg = jl.LlamaConfig.tiny(**over), tl.LlamaConfig.tiny(**over)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    if quantize:
        jparams = jq.quantize_params(jparams, jcfg)
    return jcfg, tcfg, jparams, tl.params_from_jax(_np_tree(jparams), tcfg,
                                                    device="cpu")


def _assert_same_leaves(got, want):
    """Port params (torch) equal to JAX params (numpy), leaf by leaf:
    int8 leaves and scales bit-equal, plain leaves equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same_leaves(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_leaves(g, w)
    elif isinstance(got, int):
        assert got == int(np.asarray(want))
    else:
        want = np.asarray(want)
        assert got.dtype == {np.dtype("int8"): torch.int8,
                             np.dtype("float32"): torch.float32}[want.dtype]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantizers_bit_equal_jax(axis):
    rng = np.random.RandomState(3 + axis)
    w = rng.randn(48, 40).astype(np.float32)
    # an all-zero channel (the 1e-12 floor) and exact .5 steps, which round
    # half to even: with a max of 127 the scale is 1 and w/s = w
    if axis == 0:
        w[:, 5] = 0.0
        w[:6, 7] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    else:
        w[5, :] = 0.0
        w[7, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    want = _np_tree(jq.quantize_array(jnp.asarray(w), axis=axis))
    want_np = jq.quantize_array_np(w, axis=axis)
    got = tq.quantize_array(torch.from_numpy(w), axis=axis)
    got_np = tq.quantize_array_np(w, axis=axis)
    for ref in (want, want_np):
        np.testing.assert_array_equal(got["q"].numpy(), ref["q"])
        np.testing.assert_array_equal(got["s"].numpy(), ref["s"])
        np.testing.assert_array_equal(got_np["q"], ref["q"])
        np.testing.assert_array_equal(got_np["s"], ref["s"])
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    half = got_np["q"][1:6, 7] if axis == 0 else got_np["q"][7, 1:6]
    assert half.tolist() == [0, 2, 2, -2, 0]  # half to even


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_quantize_params_and_param_bytes_match_jax(tied):
    jcfg, tcfg, jparams, tparams = _models(tied, quantize=False)
    want = _np_tree(jq.quantize_params(jparams, jcfg))
    got = tq.quantize_params(tparams, tcfg)
    _assert_same_leaves(got, want)
    assert not tq.is_quantized(tparams["layers"][0]["wq"])  # input untouched
    assert tq.is_quantized(got["embed"]) == tied
    for make in ("llama3_8b", "llama3_1b", "gemma2_2b", "tiny"):
        jc, tc = getattr(jl.LlamaConfig, make)(), getattr(tl.LlamaConfig, make)()
        for mode in ("none", "int8"):
            assert tq.param_bytes(tc, mode) == jq.param_bytes(jc, mode)
    # the resident footprint of Llama-3-8B: 16.06 GB bf16, 8.56 GB int8
    eight_b = tl.LlamaConfig.llama3_8b()
    assert round(tq.param_bytes(eight_b) / 1e9, 2) == 16.06
    assert round(tq.param_bytes(eight_b, "int8") / 1e9, 2) == 8.56


def test_dense_gather_and_tied_head_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(6, 32).astype(np.float32)
    w = jq.quantize_array(jnp.asarray(rng.randn(32, 24).astype(np.float32)))
    emb = jq.quantize_array(jnp.asarray(rng.randn(50, 32).astype(np.float32)), axis=1)
    tw = {k: torch.tensor(np.asarray(v)) for k, v in w.items()}
    temb = {k: torch.tensor(np.asarray(v)) for k, v in emb.items()}
    tx = torch.from_numpy(x)
    tok = np.asarray([0, 7, 49, 7], np.int32)
    got = tq.dense(tx, tw)
    # the reference's order: the contraction first, then the scale
    assert torch.equal(got, (tx @ tw["q"].float()) * tw["s"])
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.dense(jnp.asarray(x), w)), **tol)
    np.testing.assert_allclose(
        tq.embed_lookup(temb, torch.from_numpy(tok).long(), torch.float32).numpy(),
        np.asarray(jq.embed_lookup(emb, jnp.asarray(tok), jnp.float32)), **tol)
    np.testing.assert_allclose(
        tq.tied_head_matmul(tx, temb).numpy(),
        np.asarray(jq.tied_head_matmul(jnp.asarray(x), emb)), **tol)
    plain = torch.from_numpy(rng.randn(32, 24).astype(np.float32))
    assert torch.equal(tq.dense(tx, plain), tx @ plain)


def test_moe_refused_as_in_jax():
    _, tcfg, _, tparams = _models(tied=False, quantize=False)
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        tq.quantize_params(tparams, SimpleNamespace(n_experts=8,
                                                    tie_word_embeddings=False))
    routed = dict(tparams, layers=[dict(tparams["layers"][0], router=torch.zeros(1))])
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        tq.quantize_params(routed, tcfg)
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        jq.quantize_params({"layers": []}, jl.LlamaConfig.tiny(n_experts=8))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_init_params_int8_laid_out_as_jax(tied):
    jcfg = jl.LlamaConfig.tiny(tie_word_embeddings=tied)
    tcfg = tl.LlamaConfig.tiny(tie_word_embeddings=tied)
    want = jax.eval_shape(lambda: jl.init_params(
        jcfg, jax.random.PRNGKey(0), weight_quant="int8"))
    got = tl.init_params(tcfg, seed=1, device="cpu", weight_quant="int8")

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))

    assert layout(got) == layout(want)
    assert tq.is_quantized(got["embed"]) == tied
    q = got["layers"][0]["wq"]["q"]
    assert int(q.min()) >= -127 and int(q.max()) <= 127
    assert torch.all(got["layers"][0]["wq"]["s"] == np.float32(0.02 / 73.0))


def _write_checkpoint(path, jcfg, jparams_np):
    """The JAX params of a tiny model in HF form (bfloat16 tensors, one
    safetensors file by the port's writer, and a config.json)."""
    os.makedirs(path, exist_ok=True)
    names = {"attn_norm": ("input_layernorm.weight", False),
             "wq": ("self_attn.q_proj.weight", True),
             "wk": ("self_attn.k_proj.weight", True),
             "wv": ("self_attn.v_proj.weight", True),
             "wo": ("self_attn.o_proj.weight", True),
             "mlp_norm": ("post_attention_layernorm.weight", False),
             "w_gate": ("mlp.gate_proj.weight", True),
             "w_up": ("mlp.up_proj.weight", True),
             "w_down": ("mlp.down_proj.weight", True)}

    def bf16(a, transpose=False):
        t = torch.from_numpy(np.array(a, np.float32))
        return (t.T if transpose else t).contiguous().to(torch.bfloat16)

    tensors = {"model.embed_tokens.weight": bf16(jparams_np["embed"]),
               "model.norm.weight": bf16(jparams_np["final_norm"])}
    if "lm_head" in jparams_np:
        tensors["lm_head.weight"] = bf16(jparams_np["lm_head"], True)
    for i, layer in enumerate(jparams_np["layers"]):
        for key, (hf, transpose) in names.items():
            tensors[f"model.layers.{i}.{hf}"] = bf16(layer[key], transpose)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": jcfg.vocab_size,
                   "hidden_size": jcfg.hidden_size,
                   "intermediate_size": jcfg.intermediate_size,
                   "num_hidden_layers": jcfg.n_layers,
                   "num_attention_heads": jcfg.n_heads,
                   "num_key_value_heads": jcfg.n_kv_heads,
                   "tie_word_embeddings": jcfg.tie_word_embeddings}, f)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_int8_loaders_match_jax(tmp_path, tied):
    jcfg, tcfg, jparams, _ = _models(tied, quantize=False)
    jcfg.dtype = tcfg.dtype = "bfloat16"
    _write_checkpoint(tmp_path, jcfg, _np_tree(jparams))
    jstats, tstats = {}, {}
    want = _np_tree(jl.load_hf_weights_streamed(str(tmp_path), jcfg,
                                                weight_quant="int8", stats=jstats))
    streamed = tl.load_hf_weights_streamed(str(tmp_path), tcfg, device="cpu",
                                           stats=tstats, weight_quant="int8")
    buffered = tl.load_hf_weights(str(tmp_path), tcfg, device="cpu",
                                  weight_quant="int8")
    assert tstats == jstats

    def as_np(tree):
        """Leaves as numpy, bfloat16 ones as float32 (exact)."""
        if isinstance(tree, dict):
            return {k: as_np(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_np(v) for v in tree]
        if torch.is_tensor(tree):
            return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
        a = np.asarray(tree)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a

    for got in (streamed, buffered):
        assert tq.is_quantized(got["layers"][1]["w_down"])
        assert tq.is_quantized(got["embed"]) == tied
        assert tied or tq.is_quantized(got["lm_head"])
        jax.tree.map(np.testing.assert_array_equal, as_np(got), as_np(want))


def _pages(jcfg, tcfg, num_pages):
    kv = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
              head_dim=tcfg.head_dim, page_size=PS, num_pages=num_pages,
              dtype="float32")
    return jax_init_kv_pages(JaxKVConfig(**kv)), init_kv_pages(KVCacheConfig(**kv),
                                                                device="cpu")


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_int8_forward_ragged_and_decode_match_jax(tied):
    jcfg, tcfg, jparams, tparams = _models(tied)
    assert tq.is_quantized(tparams["layers"][0]["wq"])
    jpages, tpages = _pages(jcfg, tcfg, 1 + 2 * 4)
    rng = np.random.RandomState(11)
    p0, p1 = rng.randint(0, 512, 13).tolist(), rng.randint(0, 512, 6).tolist()
    tok = p0 + [0] * 3 + p1 + [0] * 2
    seq = [0] * 13 + [-1] * 3 + [1] * 6 + [-1] * 2
    pos = list(range(13)) + [0] * 3 + list(range(6)) + [0] * 2
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    packed = [i32(tok), i32(seq), i32(pos), i32([0, 16]), i32([13, 6]), i32([0, 0])]
    table = (1 + np.arange(8, dtype=np.int32)).reshape(2, 4)
    last = i32([12, 21])
    jfwd = jax.jit(lambda p, packed, pages, table, last: jl.forward_ragged(
        p, jcfg, *packed, pages, table, PS, last))
    jdec = jax.jit(lambda p, tokens, pos, pages, table, active: jl.decode_step(
        p, jcfg, tokens, pos, pages, table, active, PS))
    jout, jpages = jfwd(jparams, [jnp.asarray(a) for a in packed], jpages,
                        jnp.asarray(table), jnp.asarray(last))
    tout, _ = tl.forward_ragged(tparams, tcfg, *map(torch.from_numpy, packed), tpages,
                                torch.from_numpy(table), PS, torch.from_numpy(last))
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=LOGIT_REL_TOL * scale)
    tokens, dpos, active = i32([5, 9]), i32([13, 6]), np.asarray([True, True])
    jd, _ = jdec(jparams, jnp.asarray(tokens), jnp.asarray(dpos), jpages,
                 jnp.asarray(table), jnp.asarray(active))
    td, _ = tl.decode_step(tparams, tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(dpos), tpages, torch.from_numpy(table),
                           torch.from_numpy(active), PS)
    scale = float(np.abs(np.asarray(jd)).max())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=LOGIT_REL_TOL * scale)


async def _streams(engine, prompts, params_cls, **kw):
    async def one(ids):
        params = params_cls(temperature=0.0, max_tokens=10, ignore_eos=True, **kw)
        return [out.token_id async for out in engine.generate(ids, params)]

    await engine.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[one(p) for p in prompts]), timeout=300)
    finally:
        await engine.stop()


def test_engine_int8_weights_greedy_streams_match_jax():
    """Both engines get the same float32 weights and quantize them at
    construction (weight_quant="int8"), then serve the same greedy
    prompts, one of them chunked over two steps.  (Int8 weights under
    int8 KV pages, with adapters, are tests/test_torch_lora.py's "int8"
    route.)"""
    jcfg, tcfg, jparams, tparams = _models(tied=False, quantize=False)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 20, 45)]
    cfg = dict(ENGINE, weight_quant="int8")
    jengine = jeng.LLMEngine(jcfg, jeng.EngineConfig(**cfg), JaxByteTokenizer(512),
                             params=jparams, rng_seed=0)
    tengine = LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512),
                        params=tparams, rng_seed=0, device="cpu")
    assert tq.is_quantized(tengine.params["lm_head"])
    assert not tq.is_quantized(tparams["lm_head"])
    want = asyncio.run(_streams(jengine, prompts, js.SamplingParams))
    got = asyncio.run(_streams(tengine, prompts, ts.SamplingParams))
    assert [len(s) for s in got] == [10, 10, 10]
    assert got == want


def test_engine_rejects_unknown_weight_quant():
    _, tcfg, _, tparams = _models(tied=False, quantize=False)
    with pytest.raises(ValueError, match="weight_quant='int4'"):
        LLMEngine(tcfg, EngineConfig(**dict(ENGINE, weight_quant="int4")),
                  ByteTokenizer(512), params=tparams, device="cpu")


def test_server_weight_quant_flag():
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    args = build_arg_parser().parse_args(
        ["--model_config=tiny", "--random_weights", "--device=cpu",
         "--kv_dtype=float32", "--weight_quant=int8"])
    model = build_model(args)
    assert model.engine_config.weight_quant == "int8"
    engine = model._build_engine()
    assert tq.is_quantized(engine.params["layers"][0]["w_up"])
    assert build_arg_parser().parse_args([]).weight_quant == "none"
    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(["--weight_quant=int4"])
