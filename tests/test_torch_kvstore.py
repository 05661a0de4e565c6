"""The PyTorch port's KV hierarchy (kserve_tpu_torch/kvstore) against the
JAX package's (kserve_tpu/kvstore).

- KVTierStore (lru and arc, host alone and host over disk under
  tmp_path) and HierarchicalKVStore (with and without the persistent
  layer): one script of puts, gets, discards and prefix reads on both
  gives the same results, byte counts and stats;
- a bfloat16 and an int8 payload make a bit-exact round trip through the
  disk tier and the persistent layer (numpy has no bfloat16 here: the
  bits travel as int16 with a dtype tag); a corrupt entry, and one the
  JAX package wrote, read as misses;
- engines (tiny model, float32 or int8 pages, the same weights):
  kv_offload="host" spills preempted lanes and injects them back, with
  streams equal to the JAX engine's and the offload bytes back at 0;
  evicted prefix pages demote and page back in with the JAX engine's
  stats; a restart over kv_persist_dir serves a prefix from the
  persistent layer.  The references are tests/test_engine.py's host
  offload cases and tests/test_kvstore.py's engine cases."""

import asyncio
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import program_defs
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.kvstore import HierarchicalKVStore as JaxHierarchicalKVStore
from kserve_tpu.kvstore import KVStoreConfig as JaxKVStoreConfig
from kserve_tpu.kvstore import KVTierStore as JaxKVTierStore
from kserve_tpu.kvstore import PersistentPrefixStore as JaxPersistentPrefixStore
from kserve_tpu.kvstore import TierConfig as JaxTierConfig
from kserve_tpu.models import llama as jl
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import gather_pages, inject, inject_q
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.kvstore import (
    HierarchicalKVStore,
    KVStoreConfig,
    KVTierStore,
    PersistentPrefixStore,
    TierConfig,
)
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.resilience import FakeClock
from kserve_tpu_torch.scheduler.prefix import token_prefix_digests

D = [bytes([i]) * 16 for i in range(1, 7)]
PAGE_BYTES = 2 * 1 * 2 * 2 * 8 * 4 * 4  # one f32 test payload


def _page(fill, torch_form):
    arr = np.full((2, 1, 2, 2, 8, 4), fill, np.float32)
    return {"kv": torch.from_numpy(arr)} if torch_form else {"kv": arr}


def _values(payload):
    """A payload as plain nested lists (numpy or torch alike)."""
    if payload is None:
        return None
    return {k: np.asarray(v).tolist() for k, v in sorted(payload.items())}


def _tier_script(store, torch_form):
    log = []
    for i in range(6):
        log.append(("put", i, store.put(f"k{i}", _page(i, torch_form)),
                    store.host_used, store.disk_used, store.drops))
        if i == 3:
            # a re-read protects k1 (arc: seen again)
            log.append(("peek", _values(store.get("k1", consume=False))))
    log.append(("tiers", [(k, store.tier_of(k)) for k in sorted(store.keys())]))
    log.append(("get", _values(store.get("k5")), store.host_used, store.disk_used))
    log.append(("get_disk", _values(store.get("k2", consume=False))))
    store.discard("k4")
    log.append(("put_big", store.put("big", {"kv": _page(0, torch_form)["kv"][:1]}),
                store.would_fit(PAGE_BYTES), store.would_fit(100 * PAGE_BYTES)))
    log.append(("final", sorted(store.keys()), store.host_used, store.disk_used,
                store.drops, store.contains("k0"), store.get("gone")))
    store.close()
    return log


@pytest.mark.parametrize("disk", [0, 2], ids=["host", "host_disk"])
@pytest.mark.parametrize("policy", ["lru", "arc"])
def test_tier_store_script_matches_jax(tmp_path, policy, disk):
    cfg = dict(host_bytes=3 * PAGE_BYTES, disk_bytes=disk * PAGE_BYTES,
               policy=policy)
    want = _tier_script(JaxKVTierStore(JaxTierConfig(
        disk_dir=str(tmp_path / "jax"), **cfg)), False)
    clock = FakeClock(5.0)
    store = KVTierStore(TierConfig(disk_dir=str(tmp_path / "port"), **cfg),
                        clock=clock)
    got = _tier_script(store, True)
    assert got == want
    assert not list((tmp_path / "port").rglob("*.npz"))  # close() removed them


def _store_script(store, torch_form, persist):
    log = []
    log.append(("spill", store.put("req-1", _page(7, torch_form)),
                store.contains("req-1"), store.host_used))
    for i, d in enumerate(D[:4]):
        log.append(("put_prefix", store.put_prefix(d, _page(i, torch_form),
                                                   persist=i % 2 == 0)))
    store.record_demotion(2)
    log.append(("tiers", [store.prefix_tier_of(d) for d in D]))
    log.append(("run", store.longest_prefix_run(D), store.longest_prefix_run(D[4:]),
                store.longest_prefix_run([])))
    got = store.get_prefix(D[2])
    log.append(("get_prefix", _values(got[0]), got[1], store.get_prefix(D[5])))
    log.append(("needs_persist", store.needs_persist(D)))
    log.append(("spill_get", _values(store.get("req-1")), store.get("req-1"),
                store.host_used, store.disk_used))
    store.record_pagein({"host": 2, "persist": 1}, {"host": 16, "persist": 8})
    log.append(("stats", store.stats_dict(), store.resident_prefix_digests(),
                store.accepts_prefix_pages))
    store.close()
    return log


@pytest.mark.parametrize("persist", [False, True], ids=["tiers", "persist"])
def test_hierarchical_store_script_matches_jax(tmp_path, persist):
    def cfg(side):
        return dict(host_bytes=3 * PAGE_BYTES, disk_bytes=2 * PAGE_BYTES,
                    disk_dir=str(tmp_path / side / "disk"),
                    persist_dir=str(tmp_path / side / "px") if persist else None)

    want = _store_script(JaxHierarchicalKVStore(JaxKVStoreConfig(**cfg("jax"))),
                         False, persist)
    got = _store_script(HierarchicalKVStore(KVStoreConfig(**cfg("port"))),
                        True, persist)
    assert got == want


def test_store_counters_survive_concurrent_threads(tmp_path):
    """Page-in reads and persist writes run on worker threads beside the
    loop's demotions and page-in records: with a short switch interval
    and more threads than cores, no count is lost and the byte counts
    match the entries left."""
    import sys
    import threading

    store = HierarchicalKVStore(KVStoreConfig(
        host_bytes=64 * PAGE_BYTES, persist_dir=str(tmp_path / "px")))
    n_threads, rounds = 2 * (os.cpu_count() or 4), 100
    digests = [bytes([i % 256, i // 256]) * 8 for i in range(n_threads * rounds)]

    def work(t):
        for r in range(rounds):
            d = digests[t * rounds + r]
            store.put_prefix(d, _page(r, True), persist=r % 4 == 0)
            store.get_prefix(d)
            store.longest_prefix_run([d])
            store.record_pagein({"host": 1}, {"host": 8})
            store.record_demotion(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    total = n_threads * rounds
    stats = store.stats_dict()
    # a page another thread's put evicted reads as a miss
    assert stats["pageins"] == stats["demotions"] == stats["hits"] + stats["misses"] == total
    assert store.events[("host", "pagein")] == total
    assert stats["persist_writes"] == store.events[("persist", "store")] == total // 4
    assert store.host_used == sum(store.tiers.nbytes(k) for k in store.tiers.keys())
    assert store.host_used <= 64 * PAGE_BYTES


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_payload_round_trip_is_bit_exact(tmp_path, kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "bf16":
        kv = torch.randn((3, 2, 2, 2, 8, 16), generator=gen).to(torch.bfloat16)
        kv.view(-1)[:4] = torch.tensor([-0.0, 1e-40, 3.0e38, -7.5])
        payload = {"kv": kv}
    else:
        payload = {
            "kv_q": torch.randint(-127, 128, (3, 2, 2, 2, 8, 16), generator=gen,
                                  dtype=torch.int8),
            "kv_s": torch.rand((3, 2, 2, 2, 8), generator=gen) * 1e-2,
        }
    nbytes = sum(t.numel() * t.element_size() for t in payload.values())
    tiers = KVTierStore(TierConfig(host_bytes=1, disk_bytes=4 * nbytes,
                                   disk_dir=str(tmp_path / "disk")))
    assert tiers.put("spill", payload) and tiers.tier_of("spill") == "disk"
    px = PersistentPrefixStore(str(tmp_path / "px"))
    assert px.store(D[0], payload)
    for back in (tiers.get("spill"), PersistentPrefixStore(str(tmp_path / "px")).load(D[0])):
        assert sorted(back) == sorted(payload)
        for name, t in payload.items():
            assert back[name].dtype == t.dtype and back[name].shape == t.shape
            assert torch.equal(_bits(back[name]), _bits(t))
    assert tiers.disk_used == 0


def test_corrupt_and_foreign_persist_entries_read_as_misses(tmp_path):
    root = str(tmp_path)
    # an entry the JAX package wrote (its format 1) is never misread
    JaxPersistentPrefixStore(root).store(D[0], {"kv": np.ones((1, 1, 2), np.float32)})
    px = PersistentPrefixStore(root)
    px.store(D[1], {"kv": torch.ones((1, 1, 2))})
    with open(px._path(D[1]), "r+b") as f:
        f.truncate(40)  # a torn file
    assert D[0] in px and D[1] in px
    events = []
    px._on_event = lambda tier, event: events.append((tier, event))
    assert px.load(D[0]) is None and px.load(D[1]) is None
    assert events == [("persist", "corrupt")] * 2
    assert len(px) == 0 and not os.listdir(root)


def test_read_only_volume_degrades_to_misses(tmp_path, monkeypatch):
    """A volume that refuses the unlink of a corrupt entry (or the
    directory itself) turns the layer read-only: loads miss, stores
    return False, nothing raises."""
    from kserve_tpu_torch.kvstore import persist as P

    px = PersistentPrefixStore(str(tmp_path))
    assert px.store(D[0], {"kv": torch.ones(2)})
    with open(px._path(D[0]), "wb") as f:
        f.write(b"torn")

    def refuse(path):
        raise PermissionError(path)

    monkeypatch.setattr(P.os, "unlink", refuse)
    assert px.load(D[0]) is None and not px.writable
    assert not px.store(D[1], {"kv": torch.ones(2)})
    monkeypatch.setattr(P.os, "makedirs", lambda *a, **k: refuse("dir"))
    nowhere = PersistentPrefixStore(str(tmp_path / "ro"))
    assert not nowhere.writable and not nowhere.store(D[1], {"kv": torch.ones(2)})


def test_dead_process_spill_dirs_are_swept(tmp_path):
    base = str(tmp_path)
    stale = os.path.join(base, "kv-999999-deadbeef")  # pid surely dead
    live = os.path.join(base, f"kv-{os.getpid()}-cafecafe")
    unrelated = os.path.join(base, "not-a-spill-dir")
    for path in (stale, live, unrelated):
        os.makedirs(path)
    store = KVTierStore(TierConfig(host_bytes=1, disk_bytes=1 << 20,
                                   disk_dir=base))
    store.put("k1", {"a": torch.zeros(4)})  # straight to disk
    assert not os.path.exists(stale)
    assert os.path.exists(live) and os.path.exists(unrelated)
    store.close()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_gather_and_inject_match_the_jax_inject(kv_quant):
    """compiled.gather_pages then inject / inject_q into other page ids,
    with padded ids on the null page 0, against the JAX package's
    `inject` / `inject_q` programs on the same cache and payload: the
    pages (and scales) written are the same bits, and the gathered
    payload is the source pages exactly."""
    rng = np.random.RandomState(5)
    L, P, shape = 3, 12, (2, 2, 8, 4)
    if kv_quant == "int8":
        layers = [(rng.randint(-127, 128, (P,) + shape).astype(np.int8),
                   rng.rand(P, *shape[:-1]).astype(np.float32)) for _ in range(L)]
        cache = [(torch.from_numpy(q.copy()), torch.from_numpy(sc.copy()))
                 for q, sc in layers]
    else:
        layers = [rng.randn(P, *shape).astype(np.float32) for _ in range(L)]
        cache = [torch.from_numpy(a.copy()) for a in layers]
    src, dst = [2, 5, 7], [9, 10, 11, 0, 0]  # two padded ids
    payload = {k: v.clone() for k, v in gather_pages(cache, src).items()}
    for name, t in payload.items():
        part = 0 if name in ("kv", "kv_q") else 1
        want = np.stack([(lay[part] if kv_quant == "int8" else lay)[src]
                         for lay in layers])
        np.testing.assert_array_equal(t.numpy(), want)
        pad = torch.zeros((L, 2) + t.shape[2:], dtype=t.dtype)
        payload[name] = torch.cat([t, pad], dim=1)
    if kv_quant == "int8":
        inject_q(cache, payload["kv_q"], payload["kv_s"], dst)
    else:
        inject(cache, payload["kv"], dst)
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    jec = jeng.EngineConfig(page_size=8, dtype="float32", kv_quant=kv_quant)
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    name = "inject_q" if kv_quant == "int8" else "inject"
    fn = program_defs(jcfg, jec, mesh)[name][0]
    ids = jnp.asarray(np.asarray(dst, np.int32))
    if kv_quant == "int8":
        jout = fn([(jnp.asarray(q), jnp.asarray(sc)) for q, sc in layers],
                  jnp.asarray(payload["kv_q"].numpy()),
                  jnp.asarray(payload["kv_s"].numpy()), ids)
        for (jq, js_), (tq, ts_) in zip(jout, cache):
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    else:
        jout = fn([jnp.asarray(a) for a in layers],
                  jnp.asarray(payload["kv"].numpy()), ids)
        for jp, tp in zip(jout, cache):
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


# ---------------------------------------------------------------- engines

SQUEEZED = dict(max_batch_size=4, page_size=8, num_pages=8, max_pages_per_seq=8,
                max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
                dtype="float32")
# tests/test_engine.py make_engine's shape (its TestKVStore cases)
ENGINE = dict(SQUEEZED, num_pages=64, max_prefill_len=32, prefill_buckets=(16, 32))
PREFIX = list(range(3, 35))  # 32 tokens = 4 full pages
GREEDY = dict(temperature=0.0)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(models, cfg):
    jcfg, tcfg, jparams, tparams = models
    jengine = jeng.LLMEngine(jcfg, jeng.EngineConfig(use_pallas=False, **cfg),
                             JaxByteTokenizer(512), params=jparams, rng_seed=0)
    tengine = LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512),
                        params=tparams, rng_seed=0, device="cpu")
    return jengine, tengine


def _waves(engine, params_cls, waves, max_tokens=3, during=None):
    """`waves` (lists of (prompt, sampling kwargs)) one after another, each
    concurrently, in one engine life; `during(engine)` (an async check)
    runs before the stop.  Returns every stream in order."""

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
            if during is not None:
                await during(engine)
            return out
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_host_offload_spills_and_reinjects_like_jax(models, tmp_path, kv_quant):
    """tests/test_engine.py:299 and :799: two lanes of 48 positions on 7
    usable pages.  The newer lane (seeded) is preempted, its pages spill
    to the host tier and are injected back: no re-prefill, streams equal
    the JAX engine's, and the offload bytes return to 0."""
    cfg = dict(SQUEEZED, kv_quant=kv_quant, kv_offload="host", kv_offload_gib=1.0,
               kv_offload_dir=str(tmp_path))
    jengine, tengine = _engines(models, cfg)
    resumes_prefilled = []
    admit_prefilling = tengine._admit_prefilling

    def spy(req, *args, **kw):
        if req.resume is not None:
            resumes_prefilled.append(req.request_id)
        return admit_prefilling(req, *args, **kw)

    tengine._admit_prefilling = spy
    waves = [[([1, 2, 3, 4], GREEDY), ([9, 10, 11, 12], dict(temperature=0.8, seed=42))]]
    want = _waves(jengine, js.SamplingParams, waves, max_tokens=44)
    got = _waves(tengine, ts.SamplingParams, waves, max_tokens=44)
    assert got == want and [len(s) for s in got] == [44, 44]
    assert tengine.preemption_count > 0 and jengine.preemption_count > 0
    counts = tengine.kv_tier_counts
    assert counts["spills"] == counts["resume_injects"] == tengine.preemption_count
    assert counts["spilled_bytes"] == counts["injected_bytes"] > 0
    assert not resumes_prefilled
    assert tengine._offload_bytes == 0 == jengine._offload_bytes
    assert tengine._kv_store.spill_bytes == 0
    assert (tengine.allocator.free_pages + tengine._prefix_cache.pages_held_alone()
            == cfg["num_pages"] - 1)


def test_spill_dropped_under_tier_pressure_reprefills(models, tmp_path):
    """A host tier too small for the spill: the lane re-prefills on resume
    and its stream is unchanged."""
    _, tcfg, _, tparams = models
    waves = [[([1, 2, 3, 4], GREEDY), ([9, 10, 11, 12], GREEDY)]]
    roomy = LLMEngine(tcfg, EngineConfig(**dict(SQUEEZED, num_pages=64)),
                      ByteTokenizer(512), params=tparams, device="cpu")
    want = _waves(roomy, ts.SamplingParams, waves, max_tokens=44)
    engine = LLMEngine(tcfg, EngineConfig(**dict(
        SQUEEZED, kv_offload="host", kv_offload_gib=1e-6,
        kv_offload_dir=str(tmp_path))), ByteTokenizer(512), params=tparams,
        device="cpu")
    assert _waves(engine, ts.SamplingParams, waves, max_tokens=44) == want
    assert engine.preemption_count > 0
    assert engine.kv_tier_counts["resume_injects"] == 0


def test_demote_then_page_in_matches_jax(models, tmp_path):
    """tests/test_kvstore.py:249: on 11 usable pages, cache pressure evicts
    a cold prefix, which demotes into the host tier; the same prefix later
    pages back in and is served as adopted hits, with the JAX engine's
    streams and stats."""
    jengine, tengine = _engines(models, dict(
        ENGINE, num_pages=12, kv_offload="host", kv_offload_gib=1.0,
        kv_offload_dir=str(tmp_path)))
    waves = [[(PREFIX + [100, 101], GREEDY)],
             [([60 + i for i in range(32)] + [1, 2], GREEDY)],
             [([110 + i for i in range(32)] + [3, 4], GREEDY)],
             [(PREFIX + [100, 101], GREEDY)]]
    want = _waves(jengine, js.SamplingParams, waves)
    got = _waves(tengine, ts.SamplingParams, waves)
    assert got == want and got[3] == got[0]
    stats = tengine.prefix_store_stats()
    jstats = jengine.scheduler_state()["prefix_store"]
    assert stats["demotions"] > 0 and stats["pageins"] > 0
    assert stats["adopted_hit_tokens"] > 0
    assert stats == jstats
    assert tengine.prefix_cache_hits == jengine.prefix_cache_hits
    assert tengine.pagein_seconds


def test_page_in_lands_after_a_dispatch_that_writes_cancelled_pages(
        models, tmp_path):
    """A client leaves while the dispatch that writes its lane is being
    enqueued, and a page-in's reads finish meanwhile: the pages its cancel
    freed reach the page-in only after that dispatch is enqueued in full
    (the run loop alone allocates, between dispatches), so the adopted
    prefix pages still equal their tier payload afterwards."""
    _, tcfg, _, tparams = models
    engine = LLMEngine(tcfg, EngineConfig(**dict(
        ENGINE, num_pages=12, kv_offload="host", kv_offload_gib=1.0,
        kv_offload_dir=str(tmp_path))), ByteTokenizer(512), params=tparams,
        device="cpu")
    prompt = PREFIX + [100, 101]
    keys = token_prefix_digests(prompt, ENGINE["page_size"], True)
    dispatch = engine._dispatch
    held, go = threading.Event(), threading.Event()

    def held_dispatch(plan):
        # the first dispatch enqueued while a page-in is pending waits for
        # the client to leave and for the page-in's reads to finish
        if not held.is_set() and any(r.pagein == "pending" for r in engine._waiting):
            held.set()
            assert go.wait(30)
        return dispatch(plan)

    engine._dispatch = held_dispatch

    async def drain(ids, n):
        params = ts.SamplingParams(max_tokens=n, ignore_eos=True, **GREEDY)
        return [o.token_id async for o in engine.generate(ids, params)]

    async def until(cond):
        t0 = time.monotonic()
        while not cond():
            assert time.monotonic() - t0 < 30
            await asyncio.sleep(0.005)

    async def main():
        await engine.start()
        try:
            first = await drain(prompt, 3)
            # two colder prompts evict the prefix, which demotes
            await drain([60 + i for i in range(32)] + [1, 2], 3)
            await drain([110 + i for i in range(32)] + [3, 4], 3)
            assert not engine._prefix_cache.contains_key(keys[0])
            leaver = asyncio.ensure_future(drain([7, 8, 9, 10, 11], 30))
            await until(lambda: any(s.request_id is not None and s.generated
                                    for s in engine._slots))
            again = asyncio.ensure_future(drain(prompt, 3))
            await asyncio.to_thread(held.wait, 30)
            lane = next(s for s in engine._slots if s.request_id is not None)
            engine.cancel(lane.request_id)
            await until(lambda: not engine._pagein_tasks)
            go.set()
            assert await asyncio.wait_for(again, 30) == first
            leaver.cancel()
        finally:
            go.set()
            await engine.stop()

    asyncio.run(main())
    assert held.is_set()
    for key in keys[:4]:
        page = engine._prefix_cache._pages[key]
        payload, _ = engine._kv_store.get_prefix(key)
        assert torch.equal(gather_pages(engine.kv_pages, [page])["kv"], payload["kv"])
    adopted = [k for k in keys[:4] if k in engine._prefix_cache.adopted]
    assert adopted
    assert engine.prefix_store_stats()["adopted_hit_tokens"] == 8 * len(adopted)


def test_restart_serves_prefix_from_persist(models, tmp_path):
    """tests/test_kvstore.py:289: a reused prefix is written through to
    kv_persist_dir; a new engine over the same directory pages it in from
    there on its first request and gives the same stream."""
    _, tcfg, _, tparams = models
    cfg = EngineConfig(**dict(ENGINE, kv_persist_dir=str(tmp_path)))

    def engine():
        return LLMEngine(tcfg, cfg, ByteTokenizer(512), params=tparams,
                         device="cpu")

    async def persisted(e):
        t0 = time.monotonic()
        while e.prefix_store_stats()["persist_digests"] < 4:
            assert time.monotonic() - t0 < 10, e.prefix_store_stats()
            await asyncio.sleep(0.01)

    first = engine()
    base = _waves(first, ts.SamplingParams,
                  [[(PREFIX + [100, 101], GREEDY)], [(PREFIX + [110, 111], GREEDY)]],
                  max_tokens=5, during=persisted)
    assert first.prefix_store_stats()["persist_writes"] == 4
    second = engine()
    again = _waves(second, ts.SamplingParams, [[(PREFIX + [100, 101], GREEDY)]],
                   max_tokens=5)
    stats = second.prefix_store_stats()
    assert stats["pageins"] >= 4 and stats["pagein_tokens_by_tier"]["persist"] >= 32
    assert stats["adopted_hit_tokens"] == 32 and second.prefix_cache_hits == 4
    assert again[0] == base[0]


def test_server_flags_reach_the_engine_config(tmp_path, monkeypatch):
    from kserve_tpu_torch.runtimes import generative_server as gs

    monkeypatch.setattr(
        gs, "TorchGenerativeModel",
        lambda name, mc, ec, **kw: ec)
    base = ["--model_config=tiny", "--random_weights", "--device=cpu"]
    monkeypatch.setenv("KSERVE_TPU_KV_PERSIST", str(tmp_path / "env"))
    ec = gs.build_model(gs.build_arg_parser().parse_args(base + [
        "--kv_offload=host", "--kv_offload_gib=1.5", "--kv_offload_disk_gib=2",
        f"--kv_offload_dir={tmp_path}", "--kv_offload_policy=arc"]))
    assert (ec.kv_offload, ec.kv_offload_gib, ec.kv_offload_disk_gib,
            ec.kv_offload_dir, ec.kv_offload_policy, ec.kv_persist_dir) == (
        "host", 1.5, 2.0, str(tmp_path), "arc", str(tmp_path / "env"))
    assert ec.prefix_cache is None  # on: resolved by the engine
    ec = gs.build_model(gs.build_arg_parser().parse_args(
        base + [f"--kv_persist_dir={tmp_path}"]))
    assert ec.kv_offload == "none" and ec.kv_persist_dir == str(tmp_path)
