"""Preemption of the PyTorch port's engine under a cache too small for
every lane, against its own roomy runs and the JAX engine.

Ports tests/test_engine.py's TestPreemption exhaustion case (:259-296)
and its chunked re-prefill case (:417): two requests of 4 + 44 tokens
need 12 pages of 8 tokens and the cache has 7, so the newer lane is
preempted, re-prefilled in 16-token chunks once the older one finishes,
and resumes decoding.  With a third, 25-token prompt still prefilling
when a decode lane starves, that prefilling slot is the victim instead.
Every request reaches max_tokens, token for token equal to the same
requests on 64 pages and to the JAX engine on the same 8 (greedy,
float32).  A seeded sampled request keeps its stream (its
sampling counter goes on where it stopped), and the speculative path
(K = 3) preempts before an unchained dispatch only and emits the same
streams."""

import asyncio

import jax
import numpy as np
import pytest

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl

# 8 pages (7 usable) x 8 tokens: room for 56 positions, 48 per request
SQUEEZED = dict(max_batch_size=4, page_size=8, num_pages=8, max_pages_per_seq=8,
                max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
                dtype="float32")
ROOMY = dict(SQUEEZED, num_pages=64)
PROMPTS = ([1, 2, 3, 4], [9, 10, 11, 12])
MAX_TOKENS = 44
# admitted beside the two at once; its second chunk is still to run when
# the decode lanes first outgrow the cache
LONG_PROMPT = list(range(30, 55))
LONG_MAX_TOKENS = 8
SEEDED = dict(temperature=0.8, seed=42)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _run(engine, params_cls, sampling, requests=None):
    """The requests ((prompt, max_tokens) pairs; both PROMPTS by default)
    concurrently, request i with sampling[i]; returns the token streams
    and the last output of each."""
    requests = requests or [(p, MAX_TOKENS) for p in PROMPTS]

    async def one(ids, max_tokens, kw):
        params = params_cls(max_tokens=max_tokens, ignore_eos=True, **kw)
        return [o async for o in engine.generate(ids, params)]

    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(asyncio.gather(
                *[one(p, n, kw) for (p, n), kw in zip(requests, sampling)]),
                120)
        finally:
            await engine.stop()

    outs = asyncio.run(main())
    return [[o.token_id for o in s] for s in outs], [s[-1] for s in outs]


def _port(tcfg, tparams, cfg, **overrides):
    """The port's engine, its preemptions spied on: returns it and the
    prompts of the decoding lanes and of the prefilling slots it
    preempted, in order."""
    engine = LLMEngine(tcfg, EngineConfig(**dict(cfg, **overrides)),
                       ByteTokenizer(512), params=tparams, rng_seed=0,
                       device="cpu")
    preempted = {"decoding": [], "prefilling": []}
    preempt, preempt_prefilling = engine._preempt, engine._preempt_prefilling

    def spy(slot):
        preempted["decoding"].append(slot.prompt_ids)
        preempt(slot)

    def spy_prefilling(slot):
        preempted["prefilling"].append(slot.prefilling["req"].prompt_ids)
        preempt_prefilling(slot)

    engine._preempt = spy
    engine._preempt_prefilling = spy_prefilling
    return engine, preempted


def _assert_complete(engine, last, max_tokens=(MAX_TOKENS, MAX_TOKENS)):
    for out, n in zip(last, max_tokens, strict=True):
        assert out.finished and out.finish_reason == "length"
        assert out.num_generated == n
    assert engine.preemption_count > 0, "the cache was supposed to saturate"
    assert (engine.allocator.free_pages + engine._prefix_cache.pages_held_alone()
            == engine.config.num_pages - 1)


@pytest.mark.parametrize("victim", ["decoding", "prefilling"])
def test_exhausted_cache_preempts_and_matches_roomy_and_jax(models, victim):
    """Greedy: the squeezed port equals itself on 64 pages and the JAX
    engine on the same 8 pages, token for token.  decoding: the newer
    request is the one preempted and re-prefilled (48 positions: three
    16-token chunks).  prefilling: the long prompt, mid-prefill when the
    decode lanes starve, is preempted first; the newer decode lane later."""
    jcfg, tcfg, jparams, tparams = models
    requests = [(p, MAX_TOKENS) for p in PROMPTS]
    if victim == "prefilling":
        requests.append((LONG_PROMPT, LONG_MAX_TOKENS))
    greedy = [dict(temperature=0.0)] * len(requests)
    want, _ = _run(_port(tcfg, tparams, ROOMY)[0], ts.SamplingParams, greedy,
                   requests)
    engine, preempted = _port(tcfg, tparams, SQUEEZED)
    got, last = _run(engine, ts.SamplingParams, greedy, requests)
    _assert_complete(engine, last, [n for _, n in requests])
    assert preempted["decoding"]
    assert all(p == PROMPTS[1] for p in preempted["decoding"])
    if victim == "prefilling":
        assert preempted["prefilling"]
        assert all(p == LONG_PROMPT for p in preempted["prefilling"])
    else:
        assert not preempted["prefilling"]
    assert got == want
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False, **SQUEEZED),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    jgot, _ = _run(jengine, js.SamplingParams, greedy, requests)
    assert jengine.preemption_count > 0
    assert got == jgot


def test_preempted_seeded_stream_is_unchanged(models):
    """The newer request samples with a seed: preempted mid-stream, its
    stream equals the same request's on 64 pages and the JAX engine's."""
    jcfg, tcfg, jparams, tparams = models
    sampling = [dict(temperature=0.0), SEEDED]
    want, _ = _run(_port(tcfg, tparams, ROOMY)[0], ts.SamplingParams, sampling)
    engine, preempted = _port(tcfg, tparams, SQUEEZED)
    got, last = _run(engine, ts.SamplingParams, sampling)
    _assert_complete(engine, last)
    assert preempted["decoding"] and preempted["decoding"][0] == PROMPTS[1]
    assert got == want
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False, **ROOMY),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    assert _run(jengine, js.SamplingParams, sampling)[0][1] == got[1]


def test_spec_path_preempts_between_dispatches(models):
    """--spec_decode_k 3: the dense path grows through _grow_and_preempt
    before each unchained dispatch; the squeezed streams equal spec off on
    64 pages, and the engine ran dense dispatches."""
    _, tcfg, _, tparams = models
    greedy = [dict(temperature=0.0)] * 2
    want, _ = _run(_port(tcfg, tparams, ROOMY)[0], ts.SamplingParams, greedy)
    engine, preempted = _port(tcfg, tparams, SQUEEZED, spec_decode_k=3)
    got, last = _run(engine, ts.SamplingParams, greedy)
    _assert_complete(engine, last)
    assert preempted["decoding"]
    assert engine.dense_steps > 0
    assert got == want
