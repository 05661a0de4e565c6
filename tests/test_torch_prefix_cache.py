"""The PyTorch port's prefix cache against the JAX package's.

- digests: kserve_tpu_torch.scheduler.prefix.token_prefix_digests gives
  the JAX package's bytes at lengths around page boundaries (the EPP
  picker scores these digests, and persisted pages are named by them);
- PrefixCache: one script of lookups, registrations, adoptions and
  evictions on both caches, each over its own allocator, gives the same
  lookups, hits, free pages, hottest digests and demote-callback pairs;
- engines (tiny model, float32, the same weights): shared-prefix traffic
  gives equal greedy and seeded token streams and equal
  `prefix_cache_hits` with the cache on in both, on the mixed route, the
  legacy route (use_ragged=False) and over an int8 cache; a hit's stream
  equals a cold engine's (the references are tests/test_engine.py's
  TestPrefixCache and int8 cases)."""

import asyncio

import jax
import numpy as np
import pytest

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.kvcache import PageAllocator as JaxPageAllocator
from kserve_tpu.engine.prefix_cache import PrefixCache as JaxPrefixCache
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.scheduler.prefix import token_prefix_digests as jax_digests
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import PageAllocator
from kserve_tpu_torch.engine.prefix_cache import PrefixCache
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.scheduler.prefix import token_prefix_digests

PS = 8
# tests/test_engine.py's TestPrefixCache engine: 16-token chunks, so a
# 34-token prompt prefills in three and a hit leaves a 2-token tail
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=8,
              max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
              dtype="float32")
PREFIX = list(range(3, 35))  # 32 tokens = 4 full pages
SEEDED = dict(temperature=0.8, seed=42)
GREEDY = dict(temperature=0.0)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 15, 16, 17, 33, 64, 65])
@pytest.mark.parametrize("for_lookup", [True, False])
def test_digests_are_the_jax_packages_bytes(n, for_lookup):
    seq = np.random.RandomState(n).randint(0, 128_256, n).tolist()
    want = jax_digests(seq, PS, for_lookup)
    got = token_prefix_digests(seq, PS, for_lookup)
    assert got == want
    assert len(got) == ((n - 1) // PS if for_lookup else n // PS) if n else not got


def _script(cache, alloc):
    """One operation script; returns everything observable, in order."""
    demoted = []
    cache._demote_cb = lambda pairs: demoted.append(list(pairs))
    log = []
    rng = np.random.RandomState(3)
    a = rng.randint(0, 500, 41).tolist()  # 5 full pages, 5 lookup keys
    b = a[:24] + rng.randint(0, 500, 17).tolist()  # shares 3 pages with a
    c = rng.randint(0, 500, 16).tolist()  # exactly 2 pages: 1 lookup key
    pages_a = alloc.allocate(6)
    cache.register(a[:16], pages_a)  # two pages, as after one chunk
    cache.register(a, pages_a, start_page=2)  # the rest, incrementally
    log.append(("a", cache.lookup_run(a)[0], len(cache), alloc.free_pages))
    hits, keys = cache.lookup_run(b)
    log.append(("b", hits, len(keys)))
    alloc.share(hits)
    pages_b = hits + alloc.allocate(6 - len(hits))
    cache.register(b, pages_b)
    alloc.free(pages_a)
    alloc.free(pages_b)
    pages_c = alloc.allocate(2)
    cache.register(c, pages_c)
    log.append(("c", cache.lookup_run(c), cache.lookup(c[:9])))
    alloc.free(pages_c)
    # paged-in entries: one new, one already cached (freed back)
    adopted = alloc.allocate(2)
    cache.adopt([(b"\x07" * 16, adopted[0]),
                 (token_prefix_digests(a, PS)[0], adopted[1])])
    cache.count_adopted_hits([b"\x07" * 16, b"\x08" * 16])
    log.append(("adopt", len(cache), alloc.free_pages, cache.adopted_hits))
    log.append(("hottest", cache.hottest_digests(3), cache.hottest_digests(0)))
    # pressure: evict the coldest pages until 9 are free
    log.append(("ensure", cache.ensure_allocatable(9), alloc.free_pages, len(cache)))
    log.append(("ensure_all", cache.ensure_allocatable(14), len(cache)))
    log.append(("demoted", demoted, sorted(cache.adopted)))
    cache.hits += 5
    log.append(("after", cache.lookup_run(a)[0], cache.hits))
    return log


def test_prefix_cache_script_matches_jax():
    want = _script(*_pair(JaxPrefixCache, JaxPageAllocator))
    got = _script(*_pair(PrefixCache, PageAllocator))
    assert got == want
    # the script reached eviction and demotion
    assert any(entry[0] == "demoted" and entry[1] for entry in got)


def _pair(cache_cls, alloc_cls):
    alloc = alloc_cls(16)
    return cache_cls(PS, True, alloc), alloc


def test_disabled_cache_looks_up_nothing():
    alloc = PageAllocator(16)
    cache = PrefixCache(PS, False, alloc)
    pages = alloc.allocate(3)
    cache.register(PREFIX, pages)
    assert cache.lookup_run(PREFIX) == ([], []) and len(cache) == 0
    cache.adopt([(b"\x01" * 16, pages[0])])
    assert alloc.free_pages == 13


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _waves(engine, params_cls, waves, max_tokens=6):
    """Run `waves` (lists of (prompt, sampling kwargs)) one after another,
    each wave's requests concurrently, in one engine life; returns every
    token stream in order."""

    async def one(ids, kw):
        params = params_cls(**{"max_tokens": max_tokens, "ignore_eos": True,
                               **kw})
        return [o.token_id async for o in engine.generate(ids, params)]

    async def main():
        await engine.start()
        try:
            out = []
            for wave in waves:
                out += await asyncio.wait_for(
                    asyncio.gather(*[one(p, kw) for p, kw in wave]), 120)
            return out
        finally:
            await engine.stop()

    return asyncio.run(main())


# one cold prompt (registers 4 prefix pages), the same prompt again (all
# 4 pages hit), then three concurrent tails on the prefix, one seeded,
# and a prompt sharing nothing
SHARED_WAVES = [
    [(PREFIX + [100, 101], GREEDY)],
    [(PREFIX + [100, 101], GREEDY)],
    [(PREFIX + [200, 201], GREEDY), (PREFIX + [7] * 9, SEEDED),
     (PREFIX[:16] + [50, 51, 52], GREEDY)],
    [(list(range(103, 135)), GREEDY)],
]


@pytest.mark.parametrize("route", ["mixed", "legacy", "int8"])
def test_shared_prefix_streams_and_hits_match_jax_engine(models, route):
    jcfg, tcfg, jparams, tparams = models
    cfg = dict(ENGINE)
    if route == "legacy":
        cfg["use_ragged"] = False
    if route == "int8":
        cfg["kv_quant"] = "int8"
    jengine = jeng.LLMEngine(jcfg, jeng.EngineConfig(use_pallas=False, **cfg),
                             JaxByteTokenizer(512), params=jparams, rng_seed=0)
    tengine = LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512),
                        params=tparams, rng_seed=0, device="cpu")
    want = _waves(jengine, js.SamplingParams, SHARED_WAVES)
    got = _waves(tengine, ts.SamplingParams, SHARED_WAVES)
    assert got == want
    # 4 + 4 + 4 + 2 pages (the two-page prefix of the last tail)
    assert tengine.prefix_cache_hits == jengine.prefix_cache_hits == 14
    assert got[1] == got[0]  # reused KV is the same KV
    assert (tengine.allocator.free_pages + tengine._prefix_cache.pages_held_alone()
            == cfg["num_pages"] - 1)
    if route == "legacy":
        # the hit rows ran the batched prefill_chunk + sample_first
        assert tengine.steps == 0
        assert tengine.legacy_dispatches["sample_first"] >= 1


def test_hit_stream_equals_a_cold_engine(models):
    """tests/test_engine.py:484: a 40-token prompt through a hit equals
    the same prompt on an engine with the cache off."""
    _, tcfg, _, tparams = models
    prompt = list(range(7, 47))
    cold = LLMEngine(tcfg, EngineConfig(prefix_cache=False, **ENGINE),
                     ByteTokenizer(512), params=tparams, device="cpu")
    want = _waves(cold, ts.SamplingParams, [[(prompt, GREEDY)], [(prompt, SEEDED)]])
    assert cold.prefix_cache_hits == 0 and len(cold._prefix_cache) == 0
    warm = LLMEngine(tcfg, EngineConfig(**ENGINE), ByteTokenizer(512),
                     params=tparams, device="cpu")
    got = _waves(warm, ts.SamplingParams, [[(prompt, GREEDY)], [(prompt, SEEDED)]])
    assert warm.prefix_cache_hits == 4
    assert got == want


def test_eviction_before_preemption(models):
    """11 usable pages, 4 of them held by a cached prefix: a lane that
    needs 8 pages evicts cached pages when it starves instead of being
    truncated (kserve_tpu/engine/engine.py:2606-2608)."""
    _, tcfg, _, tparams = models
    engine = LLMEngine(tcfg, EngineConfig(**dict(ENGINE, num_pages=12)),
                       ByteTokenizer(512), params=tparams, device="cpu")
    got = _waves(engine, ts.SamplingParams,
                 [[(PREFIX + [1, 2], GREEDY)],
                  [([5, 6, 7], dict(GREEDY, max_tokens=60))]])
    assert [len(s) for s in got] == [6, 60]
    assert engine.preemption_count == 0
    assert len(engine._prefix_cache) < 4  # the prefix's pages were evicted
