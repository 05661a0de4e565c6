"""The PyTorch port's `mixed` step and LLMEngine against the JAX package.

Same weights (JAX init_params -> numpy -> params_from_jax), float32 on
both sides, greedy sampling: the port's mixed step must emit JAX's
[steps, B] tokens exactly and write the same pages (within float32
rounding), and the two engines must give identical greedy token streams
for concurrent requests, one of them longer than the largest prefill
bucket (chunked across steps)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import program_defs
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import make_mixed
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl

PS = 8
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")


def _models(**overrides):
    jcfg = jl.LlamaConfig.tiny(dtype="float32", **overrides)
    tcfg = tl.LlamaConfig.tiny(dtype="float32", **overrides)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _mixed_plan(lanes, B=3, W=4):
    """lanes {i: (kv_start, tokens, prompt_total)}: a final prompt chunk
    (kv_start + len(tokens) == prompt_total) or a decode lane (one token,
    kv_start past the prompt).  Every listed lane joins the decode loop."""
    tok, seq, pos = [], [], []
    z = lambda: np.zeros(B, np.int32)  # noqa: E731
    q_start, q_len, kv_start, last = z(), z(), z(), z()
    scan_pos0, step0_emits, capacity, counters = z(), z(), z(), z()
    joins = np.zeros(B, bool)
    for i, (h, ids, prompt_total) in sorted(lanes.items()):
        q_start[i], q_len[i], kv_start[i] = len(tok), len(ids), h
        last[i] = len(tok) + len(ids) - 1
        pad = -len(ids) % 8
        tok += list(ids) + [0] * pad
        seq += [i] * len(ids) + [-1] * pad
        pos += list(range(h, h + len(ids))) + [0] * pad
        joins[i] = True
        scan_pos0[i] = h + len(ids)
        step0_emits[i] = 1
        capacity[i] = W * PS
        counters[i] = max(0, h - prompt_total + 1)
    arr = lambda x: np.asarray(x, np.int32)  # noqa: E731
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    return dict(q_tokens=arr(tok), token_seq=arr(seq), token_pos=arr(pos),
                q_start=q_start, q_len=q_len, kv_start=kv_start, last_idx=last,
                page_table=table, joins=joins,
                scan_tok0=np.full(B, -1, np.int32), scan_pos0=scan_pos0,
                step0_emits=step0_emits, capacity=capacity, counters=counters)


def test_mixed_step_matches_jax_program():
    jcfg, tcfg, jparams, tparams = _models()
    jec = jeng.EngineConfig(**ENGINE)
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    jmixed = jax.jit(program_defs(jcfg, jec, mesh)["mixed"][0])
    tmixed = make_mixed(tcfg, EngineConfig(**ENGINE))
    B, W = 3, 4
    kvc = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
               head_dim=tcfg.head_dim, page_size=PS, num_pages=1 + B * W,
               dtype="float32")
    jpages = jax_init_kv_pages(JaxKVConfig(**kvc))
    tpages = init_kv_pages(KVCacheConfig(**kvc), device="cpu")
    greedy_j = js.SamplingState.from_params([js.SamplingParams(temperature=0.0)] * B)
    greedy_t = ts.SamplingState.from_params([ts.SamplingParams(temperature=0.0)] * B, device="cpu")
    rng = np.random.RandomState(0)
    p0, p1, p2 = (rng.randint(0, 512, n).tolist() for n in (10, 6, 9))

    def step(plan):
        nonlocal jpages
        order = ["q_tokens", "token_seq", "token_pos", "q_start", "q_len",
                 "kv_start", "last_idx"]
        after = ["page_table", "joins", "scan_tok0", "scan_pos0", "step0_emits",
                 "capacity", "counters"]
        jout, jpages = jmixed(
            jparams, *[jnp.asarray(plan[k]) for k in order], jpages,
            *[jnp.asarray(plan[k]) for k in after], greedy_j,
            jax.random.PRNGKey(1), jnp.full((B,), -1, jnp.int32))
        tout, _ = tmixed(tparams, *[plan[k] for k in order], tpages,
                         *[plan[k] for k in after], greedy_t, torch.Generator())
        jout, tout = np.asarray(jout), tout.numpy()
        np.testing.assert_array_equal(tout, jout)  # greedy tokens: exact
        for jp, tp in zip(jpages, tpages):
            # f32 K/V of the same math: summation order only
            np.testing.assert_allclose(tp.numpy()[1:], np.asarray(jp)[1:],
                                       atol=1e-5, rtol=1e-5)
        return tout

    # step 1: two whole prompts; both lanes then decode 3 more tokens
    out = step(_mixed_plan({0: (0, p0, 10), 1: (0, p1, 6)}))
    assert out.shape == (4, B)
    # step 2: lanes 0/1 continue decoding from their last token (KV holds
    # positions < prompt+3), lane 2 prefills a new prompt in the same buffer
    step(_mixed_plan({0: (13, [int(out[3, 0])], 10), 1: (9, [int(out[3, 1])], 6),
                      2: (0, p2, 9)}))


async def _streams(engine, prompts, params_cls):
    async def one(ids):
        params = params_cls(temperature=0.0, max_tokens=12, ignore_eos=True)
        return [out.token_id async for out in engine.generate(ids, params)]

    await engine.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[one(p) for p in prompts]), timeout=300)
    finally:
        await engine.stop()


def test_engine_greedy_streams_match_jax_engine():
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.RandomState(1)
    # 45 tokens > the largest prefill bucket (32): chunked over two steps
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 20, 45)]
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(**ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    tengine = LLMEngine(tcfg, EngineConfig(**ENGINE), ByteTokenizer(512),
                        params=tparams, rng_seed=0, device="cpu")

    want = asyncio.run(_streams(jengine, prompts, js.SamplingParams))
    got = asyncio.run(_streams(tengine, prompts, ts.SamplingParams))
    assert [len(s) for s in got] == [12, 12, 12]
    assert got == want
    assert tengine.prefix_cache_hits == jengine.prefix_cache_hits
    # every page went back to the allocator but those the prefix cache
    # alone holds
    assert (tengine.allocator.free_pages + tengine._prefix_cache.pages_held_alone()
            == ENGINE["num_pages"] - 1)
