"""The port's EPP (scheduler/epp.py) and the streamed form of its HTTP
client (protocol/http_client.py), on the CPU.

Over two tiny port servers (`--device cpu`, the tiny Llama): a greedy
completion through the EPP equals the same completion sent to the
replica that served it, a streamed chat is relayed whole, and one
traceparent links the EPP's spans to the replica's request span and its
engine spans.  Against fake upstreams on the standard-library wire: the
proxy relays an SSE body chunk by chunk (the upstream sends its second
event only after the client has read the first through the EPP), a large
x-generation-checkpoint header passes both ways, a whole answer that
comes after the client's timeout is relayed (the timeout bounds the
connect only), /pick makes no canary pick while the proxy would, /state carries `fleet`, no replica answers
503, and a dead replica answers 502 until its breaker opens and the EPP
answers 503.  The client's streamed form yields a chunked body chunk by
chunk and a length-framed one whole, and pools the connection after."""

import asyncio
import http.client
import json
import threading
import time

import pytest

from kserve_tpu.scheduler import epp as jepp
from kserve_tpu_torch import tracing
from kserve_tpu_torch.lifecycle import CHECKPOINT_HEADER
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.protocol import http_client as hc
from kserve_tpu_torch.protocol.rest.http_server import HTTPServer
from kserve_tpu_torch.resilience import BreakerRegistry
from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model
from kserve_tpu_torch.scheduler import epp as tepp
from kserve_tpu_torch.scheduler.health import HealthConfig, FleetHealth
from kserve_tpu_torch.scheduler.picker import EndpointPicker

ARGS = ["--model_name=tiny", "--model_config=tiny", "--random_weights",
        "--device=cpu", "--kv_dtype=float32", "--http_port=0",
        "--max_model_len=256", "--kv_pages=128", "--max_prefill_len=64"]


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        data = json.dumps(body) if isinstance(body, dict) else body
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def replicas():
    servers = []
    for _ in range(2):
        model = build_model(build_arg_parser().parse_args(ARGS))
        srv = ModelServer(http_port=0, host="127.0.0.1")
        thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
        thread.start()
        assert srv.listening.wait(60), "server did not start"
        servers.append((srv, thread))
    yield [srv for srv, _ in servers]
    for srv, thread in servers:
        srv.request_stop()
        thread.join(30)
        assert not thread.is_alive()


class EPPThread:
    """An EPPServer over `urls` on its own event loop in a thread."""

    def __init__(self, urls, poll=True, **picker_kw):
        picker_kw.setdefault("poll_interval_s", 0.05)
        self.picker = EndpointPicker(urls, breakers=BreakerRegistry(), **picker_kw)
        self.server = tepp.EPPServer(self.picker, host="127.0.0.1", port=0)
        self._ready = threading.Event()
        self._poll = poll
        self._thread = threading.Thread(target=asyncio.run, args=(self._run(),),
                                        daemon=True)
        self._thread.start()
        assert self._ready.wait(30)
        self.port = self.server.port

    async def _run(self):
        self.loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        await self.server.start()
        if self._poll:
            await self.picker.start_polling()
        self._ready.set()
        await self._stop.wait()
        await self.server.stop()
        await self.server.close()

    def stop(self):
        self.loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(30)
        assert not self._thread.is_alive()


def _served_by(replicas, trace_id):
    """Indices of the replicas whose telemetry holds a request of `trace_id`."""
    out = []
    for i, srv in enumerate(replicas):
        _, _, raw = _request(srv.port, "GET", "/admin/telemetry")
        recent = json.loads(raw)["models"]["tiny"]["recent"]
        if any(tl.get("trace_id") == trace_id for tl in recent):
            out.append(i)
    return out


def test_proxy_relays_completions_and_streams(replicas):
    epp = EPPThread([f"http://127.0.0.1:{s.port}" for s in replicas])
    try:
        body = {"model": "tiny", "prompt": "the same prefix " * 8, "max_tokens": 8,
                "temperature": 0, "ignore_eos": True}
        trace = "ab" * 16
        status, headers, raw = _request(epp.port, "POST", "/openai/v1/completions", body,
                                        {"traceparent": f"00-{trace}-{'cd' * 8}-01",
                                         "x-request-id": "via-epp"})
        assert status == 200 and headers["x-request-id"] == "via-epp"
        via = json.loads(raw)
        (served,) = _served_by(replicas, trace)
        _, _, raw = _request(replicas[served].port, "POST", "/openai/v1/completions", body)
        direct = json.loads(raw)
        assert via["choices"][0]["text"] == direct["choices"][0]["text"]
        assert via["usage"] == direct["usage"] and via["usage"]["completion_tokens"] == 8
        # the text affinity learned on the first pick routes the prefix back
        status, _, _ = _request(epp.port, "POST", "/openai/v1/completions", body,
                                {"traceparent": f"00-{'ef' * 16}-{'cd' * 8}-01"})
        assert status == 200 and _served_by(replicas, "ef" * 16) == [served]
        chat = {"model": "tiny", "stream": True, "max_tokens": 6, "temperature": 0,
                "ignore_eos": True, "messages": [{"role": "user", "content": "hi"}]}
        status, headers, raw = _request(epp.port, "POST", "/openai/v1/chat/completions",
                                        chat)
        events = [line[len("data: "):] for line in raw.decode().split("\n")
                  if line.startswith("data: ")]
        assert status == 200 and headers["Content-Type"] == "text/event-stream"
        assert events[-1] == "[DONE]" and len(events) == 6 + 2
        # the EPP's own routes
        status, _, raw = _request(epp.port, "GET", "/state")
        state = json.loads(raw)
        assert status == 200 and state["fleet"]["total_replicas"] == 2
        assert {r["url"] for r in state["replicas"]} == set(epp.picker.replicas)
        assert _request(epp.port, "GET", "/healthz")[:1] == (200,)
    finally:
        epp.stop()


class _Collector:
    """An OTLP/HTTP JSON collector on the standard library."""

    def __init__(self):
        import http.server

        spans = self.spans = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                doc = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                for rs in doc["resourceSpans"]:
                    for ss in rs["scopeSpans"]:
                        spans.extend(ss["spans"])
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def collector(monkeypatch):
    c = _Collector()
    monkeypatch.setenv(tracing.ENDPOINT_ENV, f"http://127.0.0.1:{c.port}")
    tracing.shutdown_tracing()
    yield c
    tracing.shutdown_tracing()
    c.close()


def test_one_linked_trace_from_the_epp_to_the_engine(replicas, collector):
    epp = EPPThread([f"http://127.0.0.1:{s.port}" for s in replicas])
    try:
        chat = {"model": "tiny", "stream": True, "max_tokens": 5, "temperature": 0,
                "ignore_eos": True, "messages": [{"role": "user", "content": "trace me"}]}
        status, _, _ = _request(epp.port, "POST", "/openai/v1/chat/completions", chat)
        assert status == 200
    finally:
        epp.stop()
    # a replica's request span ends once its answer is written, which may
    # be just after the EPP has relayed it
    want = {"epp.proxy", "POST /{tail}", "POST /openai/v1/chat/completions",
            "engine.queue", "engine.prefill", "engine.decode"}
    deadline = time.monotonic() + 20
    while True:
        tracing.get_tracer().exporter.force_flush()
        by_name = {}
        for s in collector.spans:
            by_name.setdefault(s["name"], []).append(s)
        if want <= set(by_name) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    (proxy,) = by_name["epp.proxy"]
    trace = proxy["traceId"]
    linked = {s["name"]: s for s in collector.spans if s["traceId"] == trace}
    epp_req = linked["POST /{tail}"]
    req = linked["POST /openai/v1/chat/completions"]
    assert proxy["parentSpanId"] == epp_req["spanId"] and "parentSpanId" not in epp_req
    assert req["parentSpanId"] == proxy["spanId"]
    for name in ("engine.queue", "engine.prefill", "engine.decode"):
        assert linked[name]["parentSpanId"] == req["spanId"], name
    attrs = {a["key"]: a["value"] for a in linked["engine.decode"]["attributes"]}
    assert attrs["tokens"] == {"intValue": "5"}
    req_attrs = {a["key"]: a["value"] for a in req["attributes"]}
    assert req_attrs["http.status_code"] == {"intValue": "200"}
    assert req_attrs["kserve.model"] == {"stringValue": "tiny"}
    proxy_attrs = {a["key"]: a["value"] for a in proxy["attributes"]}
    assert proxy_attrs["kserve.backend"]["stringValue"].startswith("http://127.0.0.1:")
    assert int(proxy["startTimeUnixNano"]) <= int(req["startTimeUnixNano"])
    assert int(req["endTimeUnixNano"]) <= int(proxy["endTimeUnixNano"])


class FakeUpstream(HTTPServer):
    """A replica stand-in: `handler(method, path, headers, body, writer,
    server)` answers."""

    def __init__(self, handler):
        super().__init__("127.0.0.1", 0)
        self.handler = handler

    async def _respond(self, method, path, query, headers, body, writer, keep_alive):
        await self.handler(method, path, headers, body, writer, self, keep_alive)


def _epp_on_loop(urls, **picker_kw):
    picker = EndpointPicker(urls, breakers=BreakerRegistry(), **picker_kw)
    return tepp.EPPServer(picker, host="127.0.0.1", port=0)


def test_proxy_relays_sse_chunk_by_chunk():
    async def main():
        first_read = asyncio.Event()

        async def sse(method, path, headers, body, writer, srv, keep_alive):
            writer.write(srv._head(200, "text/event-stream", None, keep_alive))
            writer.write(srv._chunk(b"data: one\n\n"))
            await writer.drain()
            # a buffering proxy would never let the client see "one"
            await asyncio.wait_for(first_read.wait(), 10)
            writer.write(srv._chunk(b"data: two\n\n") + b"0\r\n\r\n")
            await writer.drain()

        up = FakeUpstream(sse)
        await up.start()
        epp = _epp_on_loop([f"http://127.0.0.1:{up.port}"])
        await epp.start()
        client = hc.AsyncHTTPClient(timeout_s=10)
        try:
            resp = await client.stream("POST", f"http://127.0.0.1:{epp.port}/openai/v1/"
                                       "chat/completions", {}, b'{"stream": true}')
            pieces = []
            async for piece in resp.body():
                pieces.append(piece)
                first_read.set()
            await resp.aclose()
        finally:
            await client.aclose()
            await epp.stop()
            await epp.close()
            await up.stop()
        return resp.status, resp.headers, pieces

    status, headers, pieces = asyncio.run(main())
    assert status == 200 and headers["content-type"] == "text/event-stream"
    assert pieces == [b"data: one\n\n", b"data: two\n\n"]


def test_a_slow_whole_answer_is_relayed():
    """The client's timeout bounds the connect only: a whole completion
    answers when it is done, long after."""
    async def main():
        async def slow(method, path, headers, body, writer, srv, keep_alive):
            await asyncio.sleep(0.6)
            await srv._send_json(writer, 200, {"done": True}, keep_alive)

        up = FakeUpstream(slow)
        await up.start()
        picker = EndpointPicker([f"http://127.0.0.1:{up.port}"], breakers=BreakerRegistry())
        epp = tepp.EPPServer(picker, host="127.0.0.1", port=0,
                             client=hc.AsyncHTTPClient(timeout_s=0.2))
        await epp.start()
        client = hc.AsyncHTTPClient(timeout_s=10)
        try:
            return await client.post(f"http://127.0.0.1:{epp.port}/openai/v1/completions",
                                     json={"prompt": "x"})
        finally:
            await client.aclose()
            await epp.stop()
            await epp.close()
            await up.stop()

    resp = asyncio.run(main())
    assert resp.status == 200 and json.loads(bytes(resp.body)) == {"done": True}


def test_large_checkpoint_header_passes_both_ways():
    big = "c" * (300 << 10)

    async def main():
        seen = {}

        async def drained(method, path, headers, body, writer, srv, keep_alive):
            seen.update(headers)
            await srv._send_json(writer, 503, {"error": "draining"}, keep_alive,
                                 headers={CHECKPOINT_HEADER: big, "Retry-After": "1"})

        up = FakeUpstream(drained)
        await up.start()
        epp = _epp_on_loop([f"http://127.0.0.1:{up.port}"])
        await epp.start()
        client = hc.AsyncHTTPClient(timeout_s=10)
        try:
            resp = await client.post(f"http://127.0.0.1:{epp.port}/openai/v1/completions",
                                     json={"prompt": "x"}, headers={CHECKPOINT_HEADER: big})
        finally:
            await client.aclose()
            await epp.stop()
            await epp.close()
            await up.stop()
        return resp, seen

    resp, seen = asyncio.run(main())
    assert resp.status == 503 and resp.headers[CHECKPOINT_HEADER] == big
    assert resp.headers["retry-after"] == "1" and seen[CHECKPOINT_HEADER] == big
    assert json.loads(bytes(resp.body)) == {"error": "draining"}


def test_pick_makes_no_canary_and_state_carries_fleet():
    a, b = "http://a:8080", "http://b:8080"
    health = FleetHealth(HealthConfig(reprobe_interval_s=0.0))
    epp = EPPThread([a, b], poll=False, health=health)
    try:
        state = {"queue_depth": 0, "free_pages": 10, "page_size": 16,
                 "prefix_digests": []}
        epp.picker.observe_state(a, state)
        epp.picker.observe_state(b, dict(state, watchdog={"state": "stall_confirmed"}))
        assert health.is_quarantined(b) and health.wants_canary(b)
        for _ in range(3):
            status, _, raw = _request(epp.port, "POST", "/pick", {"prompt": "hello"})
            assert status == 200 and json.loads(raw) == {
                "endpoint": a, "queue_depth": 0, "lifecycle": "READY"}
        assert health.wants_canary(b)  # /pick took no canary
        assert epp.picker.pick_ex(prompt_text="hello") == (epp.picker.replicas[b], True)
        status, _, raw = _request(epp.port, "GET", "/state")
        fleet = json.loads(raw)["fleet"]
        assert fleet["total_replicas"] == 2 and fleet["quarantined_replicas"] == 1
        assert fleet["ready_replicas"] == 1
        assert [r["health_status"] for r in fleet["replicas"]] == ["healthy", "quarantined"]
    finally:
        epp.stop()


def _dead_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_no_replica_503_and_a_dead_replica_opens_its_breaker():
    empty = EPPThread([], poll=False)
    try:
        status, _, raw = _request(empty.port, "POST", "/openai/v1/completions",
                                  {"prompt": "x"})
        assert status == 503 and json.loads(raw) == {"error": "no healthy replica"}
        assert _request(empty.port, "POST", "/pick", {"prompt": "x"})[0] == 503
    finally:
        empty.stop()
    dead = f"http://127.0.0.1:{_dead_port()}"
    epp = EPPThread([dead], poll_interval_s=0.02, unhealthy_after=10 ** 6)
    try:
        statuses = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            status, _, raw = _request(epp.port, "POST", "/openai/v1/completions",
                                      {"prompt": "x"})
            statuses.append(status)
            if status == 503:
                break
        assert statuses[0] == 502 and statuses[-1] == 503, statuses
        assert json.loads(raw) == {"error": "no healthy replica"}
        (rep,) = json.loads(_request(epp.port, "GET", "/state")[2])["replicas"]
        assert rep["breaker"] == "open" and rep["url"] == dead
    finally:
        epp.stop()


def test_entry_point_flags_match_jax_and_pool_selector_is_refused():
    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    # --target-port and --namespace only scope --pool-selector's discovery,
    # and come with it (ROADMAP A12)
    jax_flags = flags(jepp.build_arg_parser())
    assert {"target_port", "namespace"} <= set(jax_flags)
    for dest in ("target_port", "namespace"):
        del jax_flags[dest]
    assert flags(tepp.build_arg_parser()) == jax_flags
    with pytest.raises(SystemExit):
        tepp.build_arg_parser().parse_args(["--replicas", "http://a:1",
                                            "--namespace", "ns"])
    with pytest.raises(SystemExit, match="A12"):
        tepp.main(["--pool-selector", "app=llm"])
    args = tepp.build_arg_parser().parse_args(
        ["--replicas", "http://a:1,http://b:2", "--strategy", "prefix-cache,slo-aware"])
    picker = tepp.build_picker(args)
    assert sorted(picker.replicas) == ["http://a:1", "http://b:2"]
    assert picker.queue_weight == 0.0 and picker.prefix_weight == 4.0
    assert picker.latency_predictor is not None and picker.latency_weight == 4.0


# ---------------- the client's streamed form ----------------


def test_client_streams_chunked_and_length_framed_bodies():
    chunks = [b"alpha", b"b" * 70000, b"gamma"]
    whole = b"x" * 150000

    async def handle(reader, writer):
        while True:
            head = await reader.readuntil(b"\r\n\r\n")
            if head.startswith(b"GET /chunked"):
                writer.write(b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n")
                for c in chunks:
                    writer.write(b"%x\r\n%s\r\n" % (len(c), c))
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
            else:
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s"
                             % (len(whole), whole))
            await writer.drain()

    async def main():
        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        transport = hc.SocketTransport(timeout_s=10)
        client = hc.AsyncHTTPClient(transport)
        try:
            resp = await client.stream("GET", f"http://127.0.0.1:{port}/chunked")
            got_chunks = [p async for p in resp.body()]
            await resp.aclose()
            pooled = sum(len(v) for v in transport._idle.values())
            resp = await client.stream("GET", f"http://127.0.0.1:{port}/length")
            got_whole = [p async for p in resp.body()]
            await resp.aclose()
            # an abandoned body closes its connection instead of pooling it
            resp = await client.stream("GET", f"http://127.0.0.1:{port}/length")
            first = await resp.body().__anext__()
            await resp.aclose()
            buffered = await client.get(f"http://127.0.0.1:{port}/length")
        finally:
            await client.aclose()
            server.close()
            await server.wait_closed()
        return got_chunks, pooled, got_whole, first, buffered

    got_chunks, pooled, got_whole, first, buffered = asyncio.run(main())
    assert got_chunks == chunks and pooled == 1
    assert b"".join(got_whole) == whole and all(len(p) <= 1 << 16 for p in got_whole)
    assert len(got_whole) >= 3 and whole.startswith(first)
    assert bytes(buffered.body) == whole


def test_client_head_limit_holds_a_checkpoint_field():
    from kserve_tpu_torch.lifecycle import CHECKPOINT_FIELD_SIZE_LIMIT
    from kserve_tpu_torch.protocol.rest.http_server import MAX_HEAD_BYTES

    # the client and the server bound a head by one shared limit
    assert hc.MAX_HEAD_BYTES == MAX_HEAD_BYTES > CHECKPOINT_FIELD_SIZE_LIMIT
