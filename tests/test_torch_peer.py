"""The cross-replica KV page fabric of the PyTorch port (kserve_tpu_torch/
kvstore/peer.py, the engine's peer leg, the page route, the HTTP client
and FaultInjectingTransport) against the JAX package's (tests/
test_kvstore.py's peer classes, tests/test_rest_server.py:337-353):

- the wire codec: the port's encode_page gives the JAX package's bytes,
  and every tampering (header, payload, trailer, truncation, a real page
  under another key, a rotten payload) is refused by both; the port's
  payloads round-trip bit for bit, and a JAX format-1 page is refused;
- PeerPageIndex and digest_set_wire: one script on both gives the same
  answers;
- PeerPageClient under a FakeClock, each side over its fault-injecting
  transport: a hit, a 404, a corrupt page, a partition that opens the
  breaker and heals, a slow peer, a retried 503, a fail-over past a liar
  and the self URL give the same outcomes, calls, clock and breakers;
- engines: B pages in A's persisted prefix from tier `peer` and gives the
  JAX engine's greedy stream, with the pages bit-equal to A's files and
  written through to B's own directory; a corrupt page mid-run truncates
  the run; a JAX peer's format-1 pages read as misses; the scheduler
  state's `peer_pages` and `peer` blocks have the JAX keys;
- over sockets: a tiny CPU server answers the page route with 200 and the
  verifiable wire form or 404, and after a page-in through the port's
  HTTP client GET /metrics shows the KV and peer series."""

import asyncio
import dataclasses
import http.client
import io
import json
import threading
import time

import httpx
import jax
import numpy as np
import pytest
import torch

from kserve_tpu import kvstore as jkv
from kserve_tpu import resilience as jres
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch import kvstore as tkv
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import gather_pages
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.kvstore.payload import payload_arrays
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.protocol import http_client as hc
from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model
from kserve_tpu_torch.scheduler.prefix import token_prefix_digests

D1, D2, D3 = (bytes([i]) * 16 for i in (1, 2, 3))
SHAPE = (2, 1, 2, 2, 8, 4)


def port_file(fill=1.0, dtype=torch.float32) -> bytes:
    """A port persist entry's file bytes (format 2)."""
    buf = io.BytesIO()
    np.savez(buf, fmt=np.int64(tkv.persist.PERSIST_FORMAT),
             **payload_arrays({"kv": torch.full(SHAPE, fill).to(dtype)}))
    return buf.getvalue()


def jax_file(fill=1.0) -> bytes:
    """A JAX persist entry's file bytes (format 1)."""
    buf = io.BytesIO()
    np.savez(buf, fmt=jkv.persist.PERSIST_FORMAT, kv=np.full(SHAPE, fill, np.float32))
    return buf.getvalue()


# ---------------------------------------------------------------- codec


def test_encode_page_is_the_jax_wire_and_round_trips():
    raw = port_file(3.0, torch.bfloat16)
    wire = tkv.encode_page(D1, raw)
    assert wire == jkv.encode_page(D1, raw)
    assert bytes(tkv.decode_page(wire, D1)) == raw == jkv.decode_page(wire, D1)
    got = tkv.decode_payload(tkv.decode_page(wire, D1))
    assert got["kv"].dtype == torch.bfloat16
    assert torch.equal(got["kv"], torch.full(SHAPE, 3.0).to(torch.bfloat16))
    # a JAX peer's format-1 file verifies as bytes but is no port payload
    jwire = jkv.encode_page(D1, jax_file())
    with pytest.raises(tkv.PageVerifyError, match="format"):
        tkv.decode_payload(tkv.decode_page(jwire, D1))


def _tampered(kind):
    raw = port_file()
    wire = tkv.encode_page(D1, raw)
    if kind == "header":
        return [bytes(w) for w in (
            bytearray(wire[:off]) + bytes([wire[off] ^ 0xFF]) + wire[off + 1:]
            for off in (0, 3, 4, 5, 6, 13, 21, 24, 29))]
    if kind == "payload":
        start = len(wire) - 16 - len(raw)
        return [wire[:off] + bytes([wire[off] ^ 1]) + wire[off + 1:]
                for off in range(start, len(wire) - 16, len(raw) // 9)]
    if kind == "trailer":
        return [wire[:-1] + bytes([wire[-1] ^ 0x80])]
    if kind == "truncated":
        return [wire[:len(wire) - cut] for cut in (1, 7, 16, len(wire) // 2)]
    if kind == "key_swap":
        return [tkv.encode_page(D2, raw)]
    return []


@pytest.mark.parametrize("kind", ["header", "payload", "trailer", "truncated",
                                  "key_swap", "rotten"])
def test_tampered_pages_refused_like_jax(kind):
    if kind == "rotten":
        wire = tkv.encode_page(D1, b"not an npz at all")
        with pytest.raises(tkv.PageVerifyError):
            tkv.decode_payload(tkv.decode_page(wire, D1))
        with pytest.raises(jkv.PageVerifyError):
            jkv.decode_payload(jkv.decode_page(wire, D1))
        return
    cases = _tampered(kind)
    assert cases
    for wire in cases:
        with pytest.raises(tkv.PageVerifyError):
            tkv.decode_page(wire, D1)
        with pytest.raises(jkv.PageVerifyError):
            jkv.decode_page(wire, D1)


def test_index_and_digest_sets_match_jax():
    def script(mod):
        idx, log = mod.PeerPageIndex(), []
        log.append(idx.update("http://b:1", mod.digest_set_wire(1, [D1])))
        log.append(idx.update("http://a:1", mod.digest_set_wire(2, [D2, D1])))
        log.append((idx.peers_for(D1), idx.peers_for(D2)))
        log.append(idx.update("http://a:1", mod.digest_set_wire(1, [D3])))  # stale
        log.append(idx.update("http://a:1", mod.digest_set_wire(3, [D3])))
        log.append((idx.peers_for(D2), idx.peers_for(D3), idx.has(D1), idx.has(D2)))
        log.append((idx.update("http://a:1", None), idx.update("http://a:1", "x"),
                    idx.update("http://c:1", {"generation": "x", "digests": ["zz"]})))
        log.append((idx.snapshot(), idx.generation("http://a:1"),
                    idx.generation("http://z:1")))
        idx.forget("http://a:1")
        log.append((idx.peers_for(D3), idx.snapshot()))
        digests = [bytes([i]) * 16 for i in range(10)]
        log.append((mod.digest_set_wire(5, digests, cap=4), mod.digest_set_wire(5, digests)))
        return log

    assert script(tkv) == script(jkv)


# ---------------------------------------------------------------- client

PEER_A, PEER_B = "http://peer-a:8080", "http://peer-b:8080"
# scenario: (fault specs as (target, kind, kwargs), peers, self_url, steps);
# a step is "fetch" or ("advance", seconds)
SCENARIOS = {
    "hit": ([], (PEER_A,), None, ["fetch"]),
    "miss_404": ([], (PEER_A,), None, ["fetch"]),
    "corrupt": ([("peer-a", "peer_corrupt", {})], (PEER_A,), None, ["fetch"]),
    "partition_then_heal": (
        [("peer-a", "peer_partition", {"count": 3})], (PEER_A,), None,
        ["fetch", "fetch", ("advance", 11.0), "fetch"]),
    "slow": ([("peer-a", "peer_slow", {"latency_s": 3.0})], (PEER_A,), None,
             ["fetch"]),
    "retried_503": ([("peer-a", "http_status", {"status": 503, "count": 1,
                                                "retry_after_s": 0.02})],
                    (PEER_A,), None, ["fetch"]),
    "failover_past_liar": ([("peer-a", "peer_corrupt", {})], (PEER_A, PEER_B),
                           None, ["fetch"]),
    "self_url": ([], (PEER_A,), PEER_A, ["fetch"]),
}


def _client_run(side: str, scenario: str):
    """One scenario through one package's client; the comparable record."""
    specs, peers, self_url, steps = SCENARIOS[scenario]
    mod, res = (tkv, tres) if side == "port" else (jkv, jres)
    clock = res.FakeClock()
    plan = res.FaultPlan([res.FaultSpec(target=t, kind=k, **kw) for t, k, kw in specs])
    status = 404 if scenario == "miss_404" else 200

    def body():
        if status == 404:
            return {"error": "page not resident"}
        return mod.encode_page(D1, port_file(4.0) if side == "port" else jax_file(4.0))

    if side == "port":
        transport = tres.FaultInjectingTransport(
            plan, handler=lambda m, url, h, b: (status, body()), clock=clock)
        http = hc.AsyncHTTPClient(transport=transport)
    else:
        transport = jres.FaultInjectingTransport(
            plan, handler=lambda request: (status, body()), clock=clock)
        http = httpx.AsyncClient(transport=transport)
    index = mod.PeerPageIndex()
    for url in peers:
        index.update(url, mod.digest_set_wire(1, [D1]))
    client = mod.PeerPageClient(
        http, index=index, self_url=self_url, clock=clock,
        retry=res.RetryPolicy(max_attempts=3, base_backoff_s=0.01,
                              max_backoff_s=0.05, retry_budget_s=5.0, seed=1),
        breakers=res.BreakerRegistry(
            res.BreakerConfig(window=4, failure_threshold=0.5, min_volume=1,
                              open_for_s=10.0), clock=clock))

    async def main():
        got = []
        for step in steps:
            if step == "fetch":
                payload = await client.fetch_page(D1)
                got.append(None if payload is None
                           else np.asarray(payload["kv"]).tolist())
            else:
                clock.advance(step[1])
        await http.aclose()
        return got

    fetched = asyncio.run(main())
    return {"fetched": fetched, "stats": dict(client.stats),
            "bad_pages": dict(client.bad_pages), "calls": list(transport.calls),
            "now": clock.now(), "sleeps": list(clock.sleeps),
            "breakers": client.breakers.snapshot(),
            "snapshot_keys": sorted(client.snapshot())}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_peer_client_outcomes_match_jax(scenario):
    got, want = _client_run("port", scenario), _client_run("jax", scenario)
    assert got == want
    if scenario in ("hit", "failover_past_liar", "retried_503"):
        assert got["fetched"][-1] == np.full(SHAPE, 4.0).tolist()
    if scenario == "corrupt":
        assert got["calls"] == ["peer-a"] and got["stats"]["corrupt"] == 1
        assert got["bad_pages"] == {PEER_A: 1}
    if scenario == "partition_then_heal":
        assert got["stats"]["timeout"] == got["stats"]["breaker_open"] == 1
        assert got["stats"]["hit"] == 1 and len(got["calls"]) == 4


# ---------------------------------------------------------------- engines

ENGINE = dict(max_batch_size=4, page_size=8, num_pages=64, max_pages_per_seq=8,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
PREFIX = list(range(3, 35))  # 32 tokens = 4 full pages
PROMPT = PREFIX + [100, 101]
GREEDY = dict(max_tokens=5, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engine(models, persist_dir):
    _, tcfg, _, tparams = models
    return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, kv_persist_dir=persist_dir)),
                     ByteTokenizer(512), params=tparams, rng_seed=0, device="cpu")


async def _stream(engine, ids):
    return [o.token_id async for o in engine.generate(ids, ts.SamplingParams(**GREEDY))]


async def _settle(engine):
    """Wait for the engine's page-in and write-through tasks."""
    t0 = time.monotonic()
    while engine._pagein_tasks:
        assert time.monotonic() - t0 < 30
        await asyncio.sleep(0.01)


def _serving(engines):
    """A handler transport answering the page route from `engines`
    ({base url: engine with read_peer_page}), as the REST server does."""
    def handler(method, url, headers, body):
        base, _, hexd = url.partition(tkv.PAGE_ROUTE + "/")
        wire = engines[base].read_peer_page(bytes.fromhex(hexd))
        return (200, wire) if wire is not None else (404, {"error": "page not resident"})
    return handler


@pytest.fixture(scope="module")
def donors(models, tmp_path_factory):
    """A (the port) and J (the JAX engine) each answer PROMPT, then a
    second prompt on the same 4-page prefix, whose hit persists it."""
    root = tmp_path_factory.mktemp("donors")
    jcfg, _, jparams, _ = models
    j = jeng.LLMEngine(jcfg, jeng.EngineConfig(
        use_pallas=False, kv_persist_dir=str(root / "j"), **ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    a = _engine(models, str(root / "a"))

    async def wave(engine, params_cls):
        await engine.start()
        try:
            out = []
            for ids in (PROMPT, PREFIX + [110, 111]):
                out.append([o.token_id async for o in engine.generate(
                    ids, params_cls(**GREEDY))])
            t0 = time.monotonic()
            while len(engine._kv_store.persist) < 4:
                assert time.monotonic() - t0 < 30
                await asyncio.sleep(0.01)
            return out
        finally:
            await engine.stop()

    want = asyncio.run(wave(j, js.SamplingParams))
    got = asyncio.run(wave(a, ts.SamplingParams))
    assert got == want
    return a, j, want[0]


def _fetcher(models, tmp_path, donors_by_url, plan=None, self_url="http://b"):
    engine = _engine(models, str(tmp_path / "b"))
    transport = tres.FaultInjectingTransport(plan or tres.FaultPlan([]),
                                             handler=_serving(donors_by_url))
    index = tkv.PeerPageIndex()
    for url, donor in donors_by_url.items():
        assert index.update(url, donor.scheduler_state()["peer_pages"])
    client = tkv.PeerPageClient(hc.AsyncHTTPClient(transport=transport),
                                index=index, self_url=self_url)
    engine.set_peer_client(client)
    return engine, client


def _page_in(engine):
    async def main():
        await engine.start()
        try:
            out = await _stream(engine, PROMPT)
            await _settle(engine)
            return out
        finally:
            await engine.stop()
    return asyncio.run(main())


def test_peer_page_in_matches_jax_and_writes_through(models, donors, tmp_path):
    a, _, want = donors
    b, client = _fetcher(models, tmp_path, {"http://a": a})
    assert _page_in(b) == want
    stats = b.prefix_store_stats()
    assert stats["pagein_tokens_by_tier"] == {"peer": 32}
    assert stats["adopted_hit_tokens"] == 32 and b.prefix_cache_hits == 4
    assert client.stats == {"hit": 4, "miss": 0, "corrupt": 0, "timeout": 0,
                            "breaker_open": 0}
    # the adopted pages are A's files bit for bit, and now B's own too
    keys = token_prefix_digests(PROMPT, ENGINE["page_size"], True)
    for key in keys:
        page = b._prefix_cache._pages[key]
        want_kv = a._kv_store.persist.load(key)["kv"]
        assert torch.equal(gather_pages(b.kv_pages, [page])["kv"], want_kv)
        assert torch.equal(b._kv_store.persist.load(key)["kv"], want_kv)
    assert b._kv_store.events[("peer", "pagein")] == 4
    assert b.scheduler_state()["peer_pages"]["digests"] == sorted(k.hex() for k in keys)


def test_corrupt_page_mid_run_truncates_the_run(models, donors, tmp_path):
    a, _, want = donors
    plan = tres.FaultPlan([tres.FaultSpec(target="a", kind="peer_corrupt",
                                          after=2, count=1)])
    c, client = _fetcher(models, tmp_path, {"http://a": a}, plan=plan)
    assert _page_in(c) == want
    assert client.stats["hit"] == 2 and client.stats["corrupt"] == 1
    assert client.bad_pages == {"http://a": 1}
    assert c.prefix_store_stats()["pagein_tokens_by_tier"] == {"peer": 16}
    keys = token_prefix_digests(PROMPT, ENGINE["page_size"], True)
    assert keys[2] not in c._prefix_cache.adopted
    assert c.scheduler_state()["peer"]["bad_pages"] == {"http://a": 1}


def test_jax_peer_pages_read_as_misses(models, donors, tmp_path):
    """A JAX peer's pages are its format 1: verified as bytes, refused as
    payloads, counted, nothing adopted, and the stream is unchanged."""
    _, j, want = donors
    d, client = _fetcher(models, tmp_path, {"http://j": j})
    assert _page_in(d) == want
    assert client.stats["corrupt"] == 1 and client.stats["hit"] == 0
    assert not d._prefix_cache.adopted
    assert "peer" not in d.prefix_store_stats()["pagein_tokens_by_tier"]


def test_peer_state_blocks_have_the_jax_keys(models, donors, tmp_path):
    a, j, _ = donors
    b, _ = _fetcher(models, tmp_path, {"http://a": a})
    jclient = jkv.PeerPageClient(httpx.AsyncClient(), index=jkv.PeerPageIndex())
    j.set_peer_client(jclient)
    port, jax_ = a.scheduler_state(), j.scheduler_state()
    assert port["peer_pages"] == jax_["peer_pages"]  # same tokens, same digests
    assert set(b.scheduler_state()["peer"]) == set(jax_["peer"])
    assert set(b.scheduler_state()) == set(jax_)
    j.set_peer_client(None)


# ---------------------------------------------------------------- sockets

SERVER = ["--model_name=tiny", "--model_config=tiny", "--random_weights",
          "--device=cpu", "--kv_dtype=float32", "--http_port=0",
          "--max_model_len=256", "--kv_pages=128", "--max_prefill_len=64"]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _scrape(port):
    status, body = _get(port, "/metrics")
    assert status == 200
    out = {}
    for line in body.decode().splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def test_page_route_and_metrics_over_sockets(tmp_path):
    model = build_model(build_arg_parser().parse_args(
        SERVER + [f"--kv_persist_dir={tmp_path / 'a'}"]))
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60)
    base = f"http://127.0.0.1:{srv.port}"
    ids = list(range(40, 72)) + [5, 6]  # two full 16-token pages + a tail
    try:
        for tail in ([5, 6], [7, 8]):
            body = json.dumps({"model": "tiny", "prompt": ids[:32] + tail,
                               "max_tokens": 4, "temperature": 0,
                               "ignore_eos": True})
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
            conn.request("POST", "/openai/v1/completions", body=body)
            assert conn.getresponse().status == 200
            conn.close()
        t0 = time.monotonic()
        while True:
            state = json.loads(_get(srv.port, "/v1/internal/scheduler/state")[1])
            wire = state["models"]["tiny"].get("peer_pages", {})
            if len(wire.get("digests", ())) == 2:
                break
            assert time.monotonic() - t0 < 30, state
            time.sleep(0.02)
        before = _scrape(srv.port)
        status, page = _get(srv.port, f"{tkv.PAGE_ROUTE}/{wire['digests'][0]}")
        assert status == 200
        digest = bytes.fromhex(wire["digests"][0])
        assert tkv.decode_payload(tkv.decode_page(page, digest))["kv"].shape == (
            2, 1, 2, 2, 16, 16)
        assert _get(srv.port, f"{tkv.PAGE_ROUTE}/{'00' * 16}")[0] == 404
        assert _get(srv.port, f"{tkv.PAGE_ROUTE}/zz")[0] == 404
        # B (the same seeded weights) pages the prefix in over the socket
        def engine(label, persist):
            cfg = dataclasses.replace(model.engine_config, kv_persist_dir=persist)
            return LLMEngine(model.model_config, cfg, model.tokenizer,
                             device="cpu", metrics_label=label)

        b = engine("tiny-b", str(tmp_path / "b"))
        ref = engine("tiny-ref", None)
        index = tkv.PeerPageIndex()
        index.update(base, wire)
        client = tkv.PeerPageClient(hc.AsyncHTTPClient(), index=index)
        b.set_peer_client(client)

        async def run(engine):
            await engine.start()
            try:
                out = await _stream(engine, ids[:32] + [5, 6])
                await _settle(engine)
                return out
            finally:
                await engine.stop()
                await client.client.aclose()

        assert asyncio.run(run(b)) == asyncio.run(run(ref))
        after = _scrape(srv.port)
    finally:
        srv.request_stop()
        thread.join(30)

    def delta(series):
        return after.get(series, 0.0) - before.get(series, 0.0)

    assert client.stats["hit"] == 2
    assert delta("kv_peer_pages_served_total") == 3
    assert delta('kv_peer_fetch_total{outcome="hit"}') == 2
    assert delta("kv_peer_fetch_seconds_count") == 2
    assert delta('kv_prefix_hit_tokens_total{model_name="tiny-b",tier="peer"}') == 32
    assert delta('kv_prefix_hit_tokens_total{model_name="tiny-b",tier="hbm"}') == 32
    assert delta('kv_pagein_seconds_count{model_name="tiny-b"}') == 1
    assert delta('kv_tier_events_total{tier="peer",event="pagein"}') == 2
    assert after['kv_tier_events_total{tier="persist",event="store"}'] >= 2


def test_http_client_keeps_alive_reads_chunked_and_maps_errors():
    """The port's client against its own server (one connection for
    several requests, a 404 body) and a raw one (a chunked body, a body
    cut short), and a refused connect."""
    from kserve_tpu_torch.model_repository import ModelRepository
    from kserve_tpu_torch.protocol.rest.server import RESTServer

    async def main():
        server = RESTServer(ModelRepository(), host="127.0.0.1", port=0)
        port = await server.start()
        transport = hc.SocketTransport(timeout_s=10)
        client = hc.AsyncHTTPClient(transport=transport)
        try:
            for _ in range(3):
                resp = await client.get(f"http://127.0.0.1:{port}/metrics")
                assert resp.status == 200 and b"# TYPE" in bytes(resp.body)
            conns = len(server._writers)
            resp = await client.post(f"http://127.0.0.1:{port}/openai/v1/completions",
                                     json={"model": "x", "prompt": "hi"})
            assert resp.status == 404 and "not served" in resp.text()
        finally:
            await client.aclose()
            await server.stop()
        with pytest.raises(hc.ConnectError):
            await hc.AsyncHTTPClient().get(f"http://127.0.0.1:{port}/metrics")
        # a chunked answer, and one cut short
        async def answer(reader, writer):
            await reader.readuntil(b"\r\n\r\n")
            writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                         b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n"
                         b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\nshort")
            await writer.drain()
            await reader.readuntil(b"\r\n\r\n")
            writer.close()

        raw = await asyncio.start_server(answer, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{raw.sockets[0].getsockname()[1]}/"
        client = hc.AsyncHTTPClient()
        try:
            assert bytes((await client.get(url)).body) == b"hello world"
            with pytest.raises(hc.ReadError):
                await client.get(url)
        finally:
            await client.aclose()
            raw.close()
        return conns

    assert asyncio.run(main()) == 1
