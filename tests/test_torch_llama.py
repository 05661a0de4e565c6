"""Llama-family forward of the PyTorch port against the JAX package.

JAX init_params -> numpy -> params_from_jax gives both sides the same
weights; the same packed ragged plans and decode step then run through
kserve_tpu.models.llama and kserve_tpu_torch.models.llama.  Four tiny
configs: Llama-style at head_dim 128 with llama3 rope scaling, a Qwen3-style
qk-norm config with qkv bias and tied embeddings, and two Gemma-2-style
configs with softcaps, a sliding window, query_pre_attn_scalar and sandwich
norms, one at head_dim 256 (gemma2-2b's, the kernels' d=256 instances on
the card), whose greedy engine streams must also equal the JAX engine's.
Everything runs in float32."""

import asyncio

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
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl

PS = 8
# whole-model float32 logits: two libraries' matmuls sum in another order
# through 2 layers; 1e-4 is ~100x the observed difference
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PAGE_TOL = dict(atol=1e-5, rtol=1e-5)  # K/V rows: one projection + rope deep

CONFIGS = {
    "llama_d128": dict(
        hidden_size=512, n_heads=4, n_kv_heads=2,
        rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64}),
    "qwen3_qk_norm": dict(
        hidden_size=256, n_heads=4, n_kv_heads=2, head_dim=128, qk_norm=True,
        attention_bias=True, tie_word_embeddings=True, rms_norm_eps=1e-6),
    "gemma2_style": dict(
        hidden_size=128, n_heads=4, n_kv_heads=2, head_dim=32,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        sandwich_norms=True, attn_logit_softcap=50.0, logit_softcap=30.0,
        query_pre_attn_scalar=24, sliding_window=6,
        layer_types=("sliding_attention", "full_attention"),
        tie_word_embeddings=True, rms_norm_eps=1e-6),
    # gemma2-2b's attention at tiny width: head_dim 256, query_pre_attn_scalar
    # 256, softcaps on, 2 q / 1 kv heads, window 8 on the first layer
    "gemma2_d256": dict(
        hidden_size=128, n_heads=2, n_kv_heads=1, head_dim=256,
        hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
        sandwich_norms=True, attn_logit_softcap=50.0, logit_softcap=30.0,
        query_pre_attn_scalar=256, sliding_window=8,
        layer_types=("sliding_attention", "full_attention"),
        tie_word_embeddings=True, rms_norm_eps=1e-6),
}


def _plan(lanes, B=3, W=4):
    """Packed buffer for lanes {lane: (kv_start, tokens)} at 8-aligned
    offsets; lane i owns pages 1+i*W .. (i+1)*W."""
    tok, seq, pos = [], [], []
    q_start = np.zeros(B, np.int32)
    q_len = np.zeros(B, np.int32)
    kv_start = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    for i, (h, ids) in sorted(lanes.items()):
        q_start[i], q_len[i], kv_start[i] = len(tok), len(ids), h
        last[i] = len(tok) + len(ids) - 1
        pad = -len(ids) % 8
        tok += list(ids) + [0] * pad
        seq += [i] * len(ids) + [-1] * pad
        pos += list(range(h, h + len(ids))) + [0] * pad
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    arr = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return [arr(tok), arr(seq), arr(pos), q_start, q_len, kv_start, table, last]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_ragged_and_decode_match_jax(name):
    overrides = dict(CONFIGS[name], dtype="float32")
    jcfg = jl.LlamaConfig.tiny(**overrides)
    tcfg = tl.LlamaConfig.tiny(**overrides)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    num_pages = 1 + 3 * 4
    jpages = jax_init_kv_pages(JaxKVConfig(
        n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads,
        head_dim=jcfg.head_dim, page_size=PS, num_pages=num_pages,
        dtype="float32"))
    tpages = init_kv_pages(KVCacheConfig(
        n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
        head_dim=tcfg.head_dim, page_size=PS, num_pages=num_pages,
        dtype="float32"), device="cpu")
    rng = np.random.RandomState(len(name))
    prompt0 = rng.randint(0, 512, 18).tolist()
    prompt1 = rng.randint(0, 512, 6).tolist()

    # one jit per JAX entry point: a single compile instead of one per
    # primitive and shape of the eager forward
    jfwd = jax.jit(lambda p, packed, pages, table, last: jl.forward_ragged(
        p, jcfg, *packed, pages, table, PS, last))
    jdec = jax.jit(lambda p, tokens, pos, pages, table, active: jl.decode_step(
        p, jcfg, tokens, pos, pages, table, active, PS))

    def both(plan):
        *packed, table, last = plan
        jl_out, new = jfwd(jparams, [jnp.asarray(a) for a in packed], jpages,
                           jnp.asarray(table), jnp.asarray(last))
        tl_out, _ = tl.forward_ragged(
            tparams, tcfg, *[torch.from_numpy(a) for a in packed], tpages,
            torch.from_numpy(table), PS, torch.from_numpy(last))
        return np.asarray(jl_out), tl_out.numpy(), new

    # step A: lane 0 prefills a first chunk, lane 1 its whole prompt,
    # lane 2 is inactive
    jout, tout, jpages = both(_plan({0: (0, prompt0[:13]), 1: (0, prompt1),
                                     2: (0, [])}))
    np.testing.assert_allclose(tout[:2], jout[:2], **LOGIT_TOL)
    # step B: lane 0 finishes its prompt (chunk on top of history), lane 1
    # decodes one token through the ragged path
    jout, tout, jpages = both(_plan({0: (13, prompt0[13:]), 1: (6, [7])}))
    np.testing.assert_allclose(tout[:2], jout[:2], **LOGIT_TOL)
    for jp, tp in zip(jpages, tpages):
        np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:], **PAGE_TOL)

    # one decode step for lanes 0 and 1 (lane 2 inactive)
    tokens = np.asarray([5, 9, 0], np.int32)
    pos = np.asarray([18, 7, 0], np.int32)
    active = np.asarray([True, True, False])
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)
    jd, jpages = jdec(jparams, jnp.asarray(tokens), jnp.asarray(pos), jpages,
                      jnp.asarray(table), jnp.asarray(active))
    td, _ = tl.decode_step(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos), tpages,
        torch.from_numpy(table), torch.from_numpy(active), PS)
    np.testing.assert_allclose(td.numpy()[:2], np.asarray(jd)[:2], **LOGIT_TOL)
    for jp, tp in zip(jpages, tpages):
        np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:], **PAGE_TOL)


def test_params_from_jax_keeps_keys_and_layout():
    jcfg = jl.LlamaConfig.tiny(dtype="float32", **CONFIGS["gemma2_style"])
    tcfg = tl.LlamaConfig.tiny(dtype="float32", **CONFIGS["gemma2_style"])
    jparams = jax.tree.map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(3)))
    tparams = tl.params_from_jax(jparams, tcfg, device="cpu")
    for j, t in zip(jparams["layers"], tparams["layers"]):
        assert set(j) == set(t)
        assert t["attn_window"] in (0, 6) and isinstance(t["attn_window"], int)
        np.testing.assert_array_equal(t["wq"].numpy(), j["wq"])  # [in, out]
    # the port's own random init has the same keys and shapes
    own = tl.init_params(tcfg, seed=1, device="cpu")
    assert set(own) == set(tparams)
    for a, b in zip(own["layers"], tparams["layers"]):
        assert set(a) == set(b)
        for k in a:
            if torch.is_tensor(a[k]):
                assert a[k].shape == b[k].shape, k
    # an int8 leaf comes across as int8 with f32 scales; an MoE router
    # and expert stacks come across as they are
    q = np.ones((4, 3), np.int8)
    s = np.full((3,), 0.5, np.float32)
    carried = tl.params_from_jax(
        {**jparams, "layers": [{**jparams["layers"][0], "wq": {"q": q, "s": s}}]},
        tcfg, device="cpu")["layers"][0]["wq"]
    assert carried["q"].dtype == torch.int8 and carried["s"].dtype == torch.float32
    np.testing.assert_array_equal(carried["q"].numpy(), q)
    router = np.arange(8, dtype=np.float32).reshape(4, 2)
    stack = np.ones((2, 4, 3), np.float32)
    moe = tl.params_from_jax(
        {**jparams, "layers": [{**jparams["layers"][0], "router": router,
                                "w_gate": stack}]},
        tcfg, device="cpu")["layers"][0]
    np.testing.assert_array_equal(moe["router"].numpy(), router)
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["w_gate"].numpy(), stack)


def test_named_configs_match_jax():
    for name in ("llama3_8b", "llama3_1b", "qwen3_0_6b", "gemma2_2b"):
        j, t = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
        for field in t.__dataclass_fields__:
            assert getattr(t, field) == getattr(j, field), (name, field)
    hf = {"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 96,
          "num_hidden_layers": 3, "num_attention_heads": 4,
          "num_key_value_heads": 2, "model_type": "gemma2", "sliding_window": 8,
          "hidden_activation": "gelu_pytorch_tanh", "query_pre_attn_scalar": 16,
          "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0}
    j, t = jl.LlamaConfig.from_hf_config(hf), tl.LlamaConfig.from_hf_config(hf)
    for field in t.__dataclass_fields__:
        assert getattr(t, field) == getattr(j, field), field


def test_gemma2_d256_greedy_streams_match_jax_engine():
    """The head_dim 256 Gemma-2 through both engines: concurrent greedy
    streams (one prompt past the window of 8, one chunked past the
    16-token bucket) equal token for token."""
    overrides = dict(CONFIGS["gemma2_d256"], dtype="float32")
    jcfg = jl.LlamaConfig.tiny(**overrides)
    tcfg = tl.LlamaConfig.tiny(**overrides)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    engine = dict(max_batch_size=4, page_size=PS, num_pages=32, max_pages_per_seq=8,
                  max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
                  dtype="float32")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 12, 21)]

    async def streams(eng, params_cls):
        async def one(ids):
            params = params_cls(temperature=0.0, max_tokens=10, ignore_eos=True)
            return [o.token_id async for o in eng.generate(ids, params)]

        await eng.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[one(p) for p in prompts]), 120)
        finally:
            await eng.stop()

    want = asyncio.run(streams(jeng.LLMEngine(
        jcfg, jeng.EngineConfig(**engine),
        JaxByteTokenizer(512), params=jparams, rng_seed=0), js.SamplingParams))
    got = asyncio.run(streams(LLMEngine(
        tcfg, EngineConfig(**engine), ByteTokenizer(512), params=tparams,
        rng_seed=0, device="cpu"), ts.SamplingParams))
    assert [len(s) for s in got] == [10, 10, 10]
    assert got == want
