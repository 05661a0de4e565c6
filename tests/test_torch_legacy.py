"""The legacy program set of the PyTorch port against the JAX package: the
prompt and chunk KV scatters, the prefill attentions, llama.prefill and
prefill_chunk, the `prefill` and `prefill_chunk` programs, and whole
engines on both legacy routes (the whole engine, use_ragged=False, and
the mixed engine's iterations with a logprobs or penalized lane), with a
preemption under the legacy route.

All inputs come from a numpy seed; everything runs in float32.  Greedy
and seeded streams must equal the JAX engine's token for token and
logprobs agree within 1e-5.  The JAX engine's full penalty rebuild reads
`generated` of a prefilling slot and raises (ROADMAP C7), so no request
set here puts a penalized lane beside a prompt that is still prefilling
in it."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import kvcache as jkv
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import program_defs
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.ops import attention as ja
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import kvcache as kv
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import LegacyPrograms
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine, resolve_use_mixed
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.ops import attention as ta

PS, NKV, D, P = 8, 2, 16, 16
# whole-model float32 logits through 2 layers: summation order only
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
LP_TOL = 1e-5
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
# tiny Gemma-2-style: softcaps, a window on the first layer, an attention
# scale override, sandwich norms, tied embeddings
GEMMA = dict(hidden_size=128, n_heads=4, n_kv_heads=2, head_dim=32,
             hidden_act="gelu_tanh", norm_plus_one=True, embed_scale=True,
             sandwich_norms=True, attn_logit_softcap=50.0, logit_softcap=30.0,
             query_pre_attn_scalar=24, sliding_window=6,
             layer_types=("sliding_attention", "full_attention"),
             tie_word_embeddings=True, rms_norm_eps=1e-6)


def _cache(kind, seed):
    """A random plain f32 cache, or an int8 one (pages, scales), as numpy."""
    rng = np.random.RandomState(seed)
    if kind == "int8":
        return (rng.randint(-127, 128, (P, 2, NKV, PS, D)).astype(np.int8),
                (rng.rand(P, 2, NKV, PS) * 0.05 + 0.01).astype(np.float32))
    return rng.randn(P, 2, NKV, PS, D).astype(np.float32)


def _t(x):
    return tuple(torch.from_numpy(a.copy()) for a in x) if isinstance(x, tuple) \
        else torch.from_numpy(x.copy())


def _j(x):
    return tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple) else jnp.asarray(x)


def _np(x):
    return tuple(np.asarray(a) for a in x) if isinstance(x, tuple) else np.asarray(x)


@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
@pytest.mark.parametrize("write", ["prompt", "chunk"])
def test_batch_kv_writes_equal_jax(write, kind):
    """Pages (and int8 scales) exact outside the null page, which takes
    every padded row in both."""
    rng = np.random.RandomState(4)
    B, C = 3, 12
    k = rng.randn(B, C, NKV, D).astype(np.float32)
    v = rng.randn(B, C, NKV, D).astype(np.float32)
    table = np.asarray([[3, 5, 7, 0], [9, 2, 0, 0], [11, 12, 13, 14]], np.int32)
    valid = np.asarray([10, 4, 12], np.int32)
    start = np.asarray([0, 0, 0] if write == "prompt" else [5, 3, 17], np.int32)
    if kind == "int8":
        base = _cache("int8", 5)
    else:
        base = _cache("f32", 5).astype(jnp.bfloat16)
    tbase = (_t(base) if kind == "int8"
             else torch.from_numpy(base.astype(np.float32)).to(torch.bfloat16))
    if write == "prompt":
        got = kv.write_prompt_kv_batch(tbase, _t(k), _t(v), _t(table), _t(valid), PS)
        want = jkv.write_prompt_kv_batch(_j(base), _j(k), _j(v), _j(table),
                                         _j(valid), PS)
    else:
        got = kv.write_chunk_kv_batch(tbase, _t(k), _t(v), _t(table), _t(start),
                                      _t(valid), PS)
        want = jkv.write_chunk_kv_batch(_j(base), _j(k), _j(v), _j(table),
                                        _j(start), _j(valid), PS)
    got = (tuple(t.numpy() for t in got) if kind == "int8"
           else (got.float().numpy(),))
    want = _np(want) if kind == "int8" else (np.asarray(want).astype(np.float32),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[1:], w[1:])


@pytest.mark.parametrize("knobs", [
    dict(), dict(logit_softcap=20.0, scale=0.3), dict(window=5),
], ids=["plain", "softcap_scale", "window"])
def test_causal_prefill_attention_matches_jax(knobs):
    rng = np.random.RandomState(6)
    B, T, nq = 3, 12, 4
    q = rng.randn(B, T, nq, D).astype(np.float32)
    k = rng.randn(B, T, NKV, D).astype(np.float32)
    v = rng.randn(B, T, NKV, D).astype(np.float32)
    valid = np.asarray([12, 7, 1], np.int32)
    jk = dict(knobs)
    if "window" in jk:
        jk["window"] = jnp.asarray(jk["window"], jnp.int32)
    want = ja.causal_prefill_attention(_j(q), _j(k), _j(v), _j(valid), **jk)
    got = ta.causal_prefill_attention(_t(q), _t(k), _t(v), _t(valid), **knobs)
    for b, n in enumerate(valid):  # padded query rows are unspecified
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **ATTN_TOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("knobs", [
    dict(), dict(logit_softcap=20.0, scale=0.3), dict(window=6),
], ids=["plain", "softcap_scale", "window"])
def test_chunked_prefill_attention_matches_jax(knobs, kind):
    """A chunk over a cached history; an int8 history is dequantized and
    rounded to bf16 on both sides."""
    rng = np.random.RandomState(7)
    B, C, nq = 3, 8, 4
    q = rng.randn(B, C, nq, D).astype(np.float32)
    k = rng.randn(B, C, NKV, D).astype(np.float32)
    v = rng.randn(B, C, NKV, D).astype(np.float32)
    table = np.asarray([[3, 5, 7, 1], [9, 2, 4, 6], [11, 12, 13, 14]], np.int32)
    history = np.asarray([13, 0, 21], np.int32)
    valid = np.asarray([8, 5, 3], np.int32)
    pages = _cache(kind, 8)
    jk = dict(knobs)
    if "window" in jk:
        jk["window"] = jnp.asarray(jk["window"], jnp.int32)
    want = ja.chunked_prefill_attention(_j(q), _j(k), _j(v), _j(pages), _j(table),
                                        _j(history), _j(valid), **jk)
    got = ta.chunked_prefill_attention(_t(q), _t(k), _t(v), _t(pages), _t(table),
                                       _t(history), _t(valid), **knobs)
    for b, n in enumerate(valid):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(want)[b, :n],
                                   **ATTN_TOL)


def _models(**overrides):
    jcfg = jl.LlamaConfig.tiny(dtype="float32", **overrides)
    tcfg = tl.LlamaConfig.tiny(dtype="float32", **overrides)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tl.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _kv_config(tcfg, num_pages):
    return dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
                head_dim=tcfg.head_dim, page_size=PS, num_pages=num_pages,
                dtype="float32")


@pytest.mark.parametrize("name", ["llama", "gemma2_style"])
def test_prefill_and_prefill_chunk_match_jax(name):
    """A batched prefill of two prompts, then a chunk of each on top of
    it: logits at the last valid token and every written page within
    1e-4."""
    jcfg, tcfg, jparams, tparams = _models(**(GEMMA if name != "llama" else {}))
    rng = np.random.RandomState(9)
    W = 4
    table = (1 + np.arange(2 * W, dtype=np.int32)).reshape(2, W)
    tokens = rng.randint(0, 512, (2, 16)).astype(np.int32)
    valid = np.asarray([11, 16], np.int32)
    kvc = _kv_config(tcfg, 1 + 2 * W)
    jpages = jax_init_kv_pages(JaxKVConfig(**kvc))
    tpages = kv.init_kv_pages(kv.KVCacheConfig(**kvc), device="cpu")
    # one jit per JAX entry point: a compile instead of one per primitive
    jprefill = jax.jit(lambda p, *a: jl.prefill(p, jcfg, *a, PS))
    jchunk = jax.jit(lambda p, *a: jl.prefill_chunk(p, jcfg, *a, PS))
    jl0, jpages = jprefill(jparams, _j(tokens), _j(valid), jpages, _j(table))
    tl0, tpages = tl.prefill(tparams, tcfg, _t(tokens), _t(valid), tpages,
                             _t(table), PS)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), **LOGIT_TOL)
    chunk = rng.randint(0, 512, (2, 8)).astype(np.int32)
    cvalid = np.asarray([8, 5], np.int32)
    jl1, jpages = jchunk(jparams, _j(chunk), _j(valid), _j(cvalid), jpages,
                         _j(table))
    tl1, tpages = tl.prefill_chunk(tparams, tcfg, _t(chunk), _t(valid), _t(cvalid),
                                   tpages, _t(table), PS)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **LOGIT_TOL)
    for jp, tp in zip(jpages, tpages):
        np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:], **LOGIT_TOL)


def _program(jcfg, name):
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    fn, _ = program_defs(jcfg, jeng.EngineConfig(max_logprobs=4, **ENGINE),
                         mesh)[name]
    return jax.jit(fn)


ROWS = [dict(temperature=0.0, repetition_penalty=1.4, logprobs=4),
        dict(temperature=0.9, seed=3, presence_penalty=0.5, logprobs=1),
        dict(temperature=0.0)]


@pytest.mark.parametrize("name", ["prefill", "prefill_lp", "prefill_chunk"])
def test_prefill_programs_match_jax_program(name):
    """Three prompts padded to a batch of 4: first tokens exact (greedy and
    seeded, the repetition penalty counting the prompt), logprobs within
    1e-5, pages within 1e-5; prefill_chunk's logits within 1e-4."""
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.RandomState(10)
    W = 4
    tokens = np.zeros((4, 16), np.int32)
    lens = [13, 5, 9]
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.randint(0, 512, n)
    valid = np.asarray(lens + [0], np.int32)
    table = np.zeros((4, W), np.int32)
    table[:3] = (1 + np.arange(3 * W, dtype=np.int32)).reshape(3, W)
    kvc = _kv_config(tcfg, 1 + 3 * W)
    jpages = jax_init_kv_pages(JaxKVConfig(**kvc))
    tpages = kv.init_kv_pages(kv.KVCacheConfig(**kvc), device="cpu")
    rows = ROWS + [dict(temperature=0.0)]
    jstate = js.SamplingState.from_params([js.SamplingParams(**r) for r in rows])
    tstate = ts.SamplingState.from_params([ts.SamplingParams(**r) for r in rows],
                                          device="cpu")
    programs = LegacyPrograms(tcfg, EngineConfig(max_logprobs=4, **ENGINE))
    adapters = jnp.full((4,), -1, jnp.int32)
    if name == "prefill_chunk":
        start = np.asarray([0, 3, 0, 0], np.int32)
        want, jpages = _program(jcfg, name)(
            jparams, _j(tokens), _j(start), _j(valid), jpages, _j(table), adapters)
        got, tpages = programs.get(name)(tparams, tokens, start, valid, tpages, table)
        np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **LOGIT_TOL)
    else:
        jout = _program(jcfg, name)(jparams, _j(tokens), _j(valid), jpages,
                                    _j(table), jstate, jax.random.PRNGKey(0),
                                    adapters)
        tout = programs.get(name)(tparams, tokens, valid, tpages, table, tstate,
                                  torch.Generator())
        jpages, tpages = jout[-1], tout[-1]
        np.testing.assert_array_equal(tout[0].numpy()[:3], np.asarray(jout[0])[:3])
        if name == "prefill_lp":
            for g, w in zip(tout[1], jout[1]):
                if g.dtype == torch.int32:
                    np.testing.assert_array_equal(g.numpy()[:3], np.asarray(w)[:3])
                else:
                    np.testing.assert_allclose(g.numpy()[:3], np.asarray(w)[:3],
                                               atol=LP_TOL, rtol=0)
    assert programs.built == [name]  # built on first use only
    for jp, tp in zip(jpages, tpages):
        np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:], **ATTN_TOL)


# ---------------------------------------------------------------- engines

PENALIZED = [  # (prompt length, sampling)
    (5, dict(temperature=0.0, logprobs=3)),
    (20, dict(temperature=0.0, frequency_penalty=0.5, presence_penalty=0.3,
              repetition_penalty=1.2)),
    (12, dict(temperature=0.8, seed=5, repetition_penalty=1.3, logprobs=2)),
]
# 45 tokens > the largest bucket (32): _admit_chunked and prefill_chunk
CHUNKED = [(45, dict(temperature=0.0, logprobs=2)), (7, dict(temperature=0.0))]


def _collect(engine, requests, params_cls, max_tokens=12):
    async def one(ids, kw):
        params = params_cls(max_tokens=max_tokens, ignore_eos=True, **kw)
        return [(o.token_id, o.logprob, o.top_logprobs)
                async for o in engine.generate(ids, params)]

    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[one(p, kw) for p, kw in requests]), 120)
        finally:
            await engine.stop()

    return asyncio.run(main())


def _assert_streams_equal(got, want):
    """Tokens exact, logprob and top ids exact or within 1e-5."""
    assert [[t for t, _, _ in s] for s in got] == [[t for t, _, _ in s] for s in want]
    for gs, ws in zip(got, want):
        for (_, glp, gtop), (_, wlp, wtop) in zip(gs, ws):
            assert (glp is None) == (wlp is None)
            if glp is None:
                continue
            assert glp <= 0 and abs(glp - wlp) <= LP_TOL
            assert [t for t, _ in gtop] == [t for t, _ in wtop]
            np.testing.assert_allclose([v for _, v in gtop], [v for _, v in wtop],
                                       atol=LP_TOL, rtol=0)


def _engines(models, use_ragged, **cfg):
    jcfg, tcfg, jparams, tparams = models
    config = dict(ENGINE, **cfg)
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False,
                                use_ragged=use_ragged, **config),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    tengine = LLMEngine(tcfg, EngineConfig(use_ragged=use_ragged, **config),
                        ByteTokenizer(512), params=tparams, rng_seed=0,
                        device="cpu")
    return jengine, tengine


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("case", ["penalized", "chunked"])
def test_whole_engine_legacy_route_matches_jax_engine(models, case):
    """use_ragged=False: batched prefill (padded to a power of two),
    chunked admission of a long prompt, the decode family with its
    depth-2 chain; streams and logprobs equal the JAX engine's."""
    rng = np.random.RandomState(11)
    cases = PENALIZED if case == "penalized" else CHUNKED
    requests = [(rng.randint(0, 256, n).tolist(), kw) for n, kw in cases]
    jengine, tengine = _engines(models, False)
    want = _collect(jengine, requests, js.SamplingParams)
    got = _collect(tengine, requests, ts.SamplingParams)
    assert [len(s) for s in got] == [12] * len(requests)
    _assert_streams_equal(got, want)
    assert tengine.steps == 0
    assert tengine.allocator.free_pages + tengine._prefix_cache.pages_held_alone() == 63
    used = {k for k, n in tengine.legacy_dispatches.items() if n}
    if case == "penalized":
        assert used == {"prefill_lp", "decode_penalized_lp"}
    else:
        assert used >= {"prefill", "prefill_chunk", "sample_first_lp", "decode_lp"}
        # no lane had penalties: the penalized programs were never built
        assert not any("penalized" in n for n in tengine._legacy.built)


def _switch_run(engine, params_cls, plain, joiners):
    """A plain greedy request of 40 tokens; once it has streamed 6, the
    `joiners` ((prompt, sampling) of 12 tokens each) join it.  Returns
    every stream, the plain one first."""
    async def consume(ids, kw, max_tokens, sink, started=None):
        params = params_cls(max_tokens=max_tokens, ignore_eos=True, **kw)
        async for o in engine.generate(ids, params):
            sink.append((o.token_id, o.logprob, o.top_logprobs))
            if started is not None and len(sink) >= 6:
                started.set()

    async def main():
        await engine.start()
        try:
            started, first = asyncio.Event(), []
            task = asyncio.create_task(consume(
                plain, dict(temperature=0.0), 40, first, started))
            await asyncio.wait_for(started.wait(), 60)
            rest = [[] for _ in joiners]
            await asyncio.wait_for(asyncio.gather(
                *[consume(p, kw, 12, s) for (p, kw), s in zip(joiners, rest)],
                task), 120)
            return [first] + rest
        finally:
            await engine.stop()

    return asyncio.run(main())


def test_mixed_engine_switches_to_legacy_and_back(models):
    """use_ragged=None: a plain greedy lane decodes on `mixed`; logprobs and
    penalized requests join it mid-stream, so those iterations run the
    legacy programs (every lane with them), and once they finish the
    plain lane goes on on `mixed`.  Every stream equals the JAX engine's."""
    rng = np.random.RandomState(12)
    plain = rng.randint(0, 256, 9).tolist()
    joiners = [(rng.randint(0, 256, n).tolist(), kw) for n, kw in PENALIZED]

    jengine, tengine = _engines(models, None)
    order = []
    step_legacy, dispatch = tengine._step_legacy, tengine._dispatch

    async def spy_legacy():
        order.append("legacy")
        return await step_legacy()

    def spy_dispatch(plan):
        order.append("mixed")
        return dispatch(plan)

    tengine._step_legacy, tengine._dispatch = spy_legacy, spy_dispatch
    got = _switch_run(tengine, ts.SamplingParams, plain, joiners)
    want = _switch_run(jengine, js.SamplingParams, plain, joiners)
    assert [len(s) for s in got] == [40, 12, 12, 12]
    _assert_streams_equal(got, want)
    first, last = order.index("legacy"), len(order) - order[::-1].index("legacy")
    assert "mixed" in order[:first] and "mixed" in order[last:], order
    assert tengine.legacy_dispatches["decode_penalized_lp"] > 0
    assert tengine.legacy_dispatches["prefill_chunk"] == 3


# 8 pages (7 usable) x 8 tokens for two 48-position requests: the newer
# lane is preempted and re-prefilled through prefill_chunk
SQUEEZED = dict(max_batch_size=4, page_size=8, num_pages=8, max_pages_per_seq=8,
                max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
                dtype="float32")


def test_preemption_under_legacy_route(models):
    """use_ragged=False on a cache too small for both lanes: the newer
    lane, with penalties and logprobs, is preempted, resumes through
    chunked re-prefill (its penalty row rebuilt from its tokens), and its
    stream equals the same request's on 64 pages and the JAX engine's."""
    jcfg, tcfg, jparams, tparams = models
    requests = [([1, 2, 3, 4], dict(temperature=0.0)),
                ([9, 10, 11, 12], dict(temperature=0.0, frequency_penalty=0.4,
                                       repetition_penalty=1.3, logprobs=2))]

    def port(num_pages):
        return LLMEngine(tcfg, EngineConfig(use_ragged=False, **dict(
            SQUEEZED, num_pages=num_pages)), ByteTokenizer(512),
            params=tparams, rng_seed=0, device="cpu")

    roomy = _collect(port(64), requests, ts.SamplingParams, max_tokens=44)
    squeezed = port(8)
    got = _collect(squeezed, requests, ts.SamplingParams, max_tokens=44)
    assert squeezed.preemption_count > 0
    assert squeezed.allocator.free_pages + squeezed._prefix_cache.pages_held_alone() == 7
    _assert_streams_equal(got, roomy)
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False,
                                use_ragged=False, **SQUEEZED),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    want = _collect(jengine, requests, js.SamplingParams, max_tokens=44)
    assert jengine.preemption_count > 0
    _assert_streams_equal(got, want)


@pytest.mark.parametrize("batch, use_ragged, want", [
    (128, None, True), (129, None, False), (160, None, False),
    (160, False, False), (8, False, False), (128, True, True), (160, True, None),
], ids=["128", "129", "160", "160_false", "8_false", "128_true", "160_true_raises"])
def test_use_ragged_resolution_at_the_cuda_alignment(batch, use_ragged, want):
    """On the card slices align to the ragged kernel's 8-token block, so
    above 128 slots a pure-decode step no longer fits the 1,024-token
    bucket: use_ragged=None resolves to the legacy programs there and
    True raises, as in the JAX engine (the CPU engine packs densely and
    cannot reach that size)."""
    config = EngineConfig(max_batch_size=batch, use_ragged=use_ragged)
    if want is None:
        with pytest.raises(NotImplementedError, match="use_ragged=True"):
            resolve_use_mixed(config, 8)
    else:
        assert resolve_use_mixed(config, 8) is want


def test_spec_decode_with_the_legacy_engine_raises(models):
    _, tcfg, _, tparams = models
    with pytest.raises(NotImplementedError, match="spec_decode_k"):
        LLMEngine(tcfg, EngineConfig(use_ragged=False, spec_decode_k=3, **ENGINE),
                  ByteTokenizer(512), params=tparams, device="cpu")



def test_spec_engine_runs_legacy_iterations_and_back(models):
    """--spec_decode_k 3: a plain lane decodes in dense rounds; a request
    with logprobs and a penalty joins, so those iterations run the legacy
    programs (the dense chain ends first); once it finishes the dense
    rounds resume, the draft table rebuilt from every lane's tokens.  All
    streams equal spec off's."""
    _, tcfg, _, tparams = models
    rng = np.random.RandomState(13)
    plain = rng.randint(0, 256, 9).tolist()
    joiners = [(rng.randint(0, 256, 12).tolist(),
                dict(temperature=0.0, logprobs=2, presence_penalty=0.4))]

    def port(**cfg):
        return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, **cfg)),
                         ByteTokenizer(512), params=tparams, rng_seed=0,
                         device="cpu")

    want = _switch_run(port(), ts.SamplingParams, plain, joiners)
    spec = port(spec_decode_k=3)
    order = []
    step_dense, step_legacy = spec._step_dense, spec._step_legacy
    refresh = spec._refresh_draft_table

    async def spy_dense(meta):
        order.append("dense")
        return await step_dense(meta)

    async def spy_legacy():
        order.append("legacy")
        return await step_legacy()

    def spy_refresh():
        order.append("rebuild" if spec._draft_dirty is None else "refresh")
        refresh()

    spec._step_dense, spec._step_legacy = spy_dense, spy_legacy
    spec._refresh_draft_table = spy_refresh
    got = _switch_run(spec, ts.SamplingParams, plain, joiners)
    _assert_streams_equal(got, want)
    first, last = order.index("legacy"), len(order) - order[::-1].index("legacy")
    assert "dense" in order[:first], order
    # the first dense round after the legacy iterations rebuilds the table
    assert order[last:last + 2] == ["dense", "rebuild"], order
