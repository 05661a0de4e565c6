"""Request spans, engine spans, logging context and /admin/profile of the
port (tracing.py, observability/spans.py, logging.py, observability/
introspection.py), on the CPU.

emit_timeline_spans gives the JAX function's span names, attributes and
events on the same timelines (recording tracers on both sides).  A
server's request span is named by its route template, carries the JAX
middleware's attributes, stays clean on a mapped 4xx and is an error when
an exception escapes.  A tiny CPU server answering a request with an
incoming traceparent exports its request span and its engine spans,
under that trace id, to a standard-library collector as OTLP/HTTP JSON;
a dead collector neither fails nor holds up a request (its losses are
counted).  Log records carry the request and trace ids.  POST
/admin/profile answers 202, 409 while capturing, 400 out of range, and
writes a Chrome trace."""

import asyncio
import http.client
import json
import logging
import os
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from kserve_tpu.observability import spans as jspans
from kserve_tpu.observability import timeline as jtimeline
from kserve_tpu.tracing import TraceContext as JTraceContext
from kserve_tpu_torch import logging as tlogging
from kserve_tpu_torch import metrics, tracing
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.observability import spans as tspans
from kserve_tpu_torch.observability import timeline as ttimeline
from kserve_tpu_torch.protocol.rest.http_server import HTTPError, HTTPServer
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model

ARGS = ["--model_name=tiny", "--model_config=tiny", "--random_weights",
        "--device=cpu", "--kv_dtype=float32", "--http_port=0",
        "--max_model_len=256", "--kv_pages=128", "--max_prefill_len=64"]


class RecordingSpan:
    def __init__(self, name, attributes):
        self.name = name
        self.attributes = dict(attributes or {})
        self.events = []
        self.ended = False

    def add_event(self, name, attributes=None):
        self.events.append((name, dict(attributes or {})))

    def end(self, end_time=None):
        self.ended = True


class RecordingTracer:
    def __init__(self):
        self.spans = []

    def start_span(self, name, attributes=None, **kwargs):
        span = RecordingSpan(name, attributes)
        self.spans.append(span)
        return span


class CMTracer:
    """A tracer with start_as_current_span only (the JAX tests' kind)."""

    def __init__(self):
        self.spans = []

    @contextmanager
    def start_as_current_span(self, name, attributes=None):
        span = RecordingSpan(name, attributes)
        self.spans.append(span)
        yield span


def _timelines(mod, ctx_cls, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        trace = (ctx_cls("%032x" % (i + 1), "%016x" % (i + 7)) if rng.random() < 0.7
                 else None)
        tl = mod.RequestTimeline(f"req-{i}", model_name="m", trace=trace)
        t = float(rng.uniform(0, 10))
        tl.mark_received(t)
        marks = ["mark_admitted", "mark_prefill_start", "mark_prefill_end"]
        for name in marks[:int(rng.integers(0, 4))]:
            t += float(rng.uniform(0, 0.1))
            getattr(tl, name)(t)
        for _ in range(int(rng.integers(0, 6))):
            t += float(rng.uniform(0, 0.05))
            tl.mark_token(t)
            if rng.random() < 0.3:
                tl.add_event(t, "preempted", lane=int(rng.integers(0, 8)))
        reason = [None, "stop", "length", "cancelled"][int(rng.integers(0, 4))]
        if reason is not None or rng.random() < 0.5:
            tl.mark_finished(t + 0.01, reason)
        out.append(tl)
    return out


@pytest.mark.parametrize("tracer_cls", [RecordingTracer, CMTracer])
def test_emit_timeline_spans_matches_jax(tracer_cls):
    def run(mod_spans, mod_tl, ctx_cls, **kw):
        tracer = tracer_cls()
        for tl in _timelines(mod_tl, ctx_cls, seed=5):
            mod_spans.emit_timeline_spans(tracer, tl, **kw)
        return [(s.name, s.attributes, s.events) for s in tracer.spans]

    want = run(jspans, jtimeline, JTraceContext)
    assert want and {w[0] for w in want} == {"engine.queue", "engine.prefill",
                                             "engine.decode"}
    assert run(tspans, ttimeline, tracing.TraceContext) == want
    assert run(tspans, ttimeline, tracing.TraceContext,
               to_wall_ns=lambda t: int(t * 1e9)) == want
    tspans.emit_timeline_spans(None, None)


def test_timeline_payload_carries_the_trace_id():
    ctx = tracing.TraceContext("ab" * 16, "cd" * 8)
    for mod, c in ((jtimeline, JTraceContext("ab" * 16, "cd" * 8)), (ttimeline, ctx)):
        tl = mod.RequestTimeline("r", "m", trace=c)
        tl.mark_received(1.0)
        assert tl.to_dict()["trace_id"] == "ab" * 16
    assert "trace_id" not in ttimeline.RequestTimeline("r").to_dict()


class ListExporter:
    def __init__(self):
        self.spans = []

    def submit(self, span):
        self.spans.append(span)


@pytest.fixture
def recording():
    exporter = ListExporter()
    tracing.set_tracer_for_tests(tracing.Tracer(exporter))
    yield exporter
    tracing.shutdown_tracing()


class Boom(HTTPServer):
    async def _respond(self, method, path, query, headers, body, writer, keep_alive):
        if path == "/boom":
            raise RuntimeError("kaboom")
        if path == "/teapot":
            raise HTTPError(404, "no teapot")
        await self._send_json(writer, 200, {"ok": True}, keep_alive)


def _call(port, method, path, headers=None, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _serve(server, calls):
    async def main():
        port = await server.start()
        try:
            return [await asyncio.to_thread(_call, port, *c) for c in calls]
        finally:
            await server.stop()

    return asyncio.run(main())


def test_request_span_names_status_and_errors(recording):
    parent = tracing.TraceContext("12" * 16, "34" * 8)
    statuses = _serve(Boom("127.0.0.1", 0), [
        ("GET", "/ok", {"traceparent": parent.to_header()}),
        ("GET", "/boom"), ("GET", "/teapot")])
    assert [s for s, _ in statuses] == [200, 500, 404]
    ok, boom, teapot = recording.spans
    assert (ok.name, ok.trace_id, ok.parent_span_id) == ("GET /ok", "12" * 16, "34" * 8)
    assert ok.attributes == {"http.method": "GET", "http.target": "/ok",
                             "trace_id": "12" * 16, "span_id": ok.span_id,
                             "http.status_code": 200}
    assert ok.status_code == tracing.STATUS_UNSET and ok.kind == tracing.SPAN_KIND_SERVER
    assert boom.status_code == tracing.STATUS_ERROR and boom.status_message == "kaboom"
    assert boom.events[0][1:] == ("exception", {"exception.type": "RuntimeError",
                                                "exception.message": "kaboom"})
    assert boom.attributes["http.status_code"] == 500 and boom.parent_span_id is None
    assert teapot.status_code == tracing.STATUS_UNSET
    assert teapot.attributes["http.status_code"] == 404
    assert all(s.end_ns >= s.start_ns for s in recording.spans)


def test_request_span_is_named_by_the_route_template(recording):
    from kserve_tpu_torch.model import Model

    class Doubler(Model):
        def __init__(self, name):
            super().__init__(name)
            self.ready = True

        async def predict(self, payload, headers=None, response_headers=None):
            return {"predictions": [2 * x for x in payload["instances"]]}

    server = RESTServer(ModelRepository({"m1": Doubler("m1"), "m2": Doubler("m2")}),
                        "127.0.0.1", 0)
    body = json.dumps({"instances": [1, 2]})
    out = _serve(server, [("POST", "/v1/models/m1:predict", {}, body),
                          ("POST", "/v1/models/m2:predict", {}, body),
                          ("GET", "/v2/models/m1/ready"),
                          ("POST", "/v1/models/nope:predict", {}, body),
                          ("GET", "/admin/telemetry")])
    assert [s for s, _ in out] == [200, 200, 200, 404, 200]
    names = [s.name for s in recording.spans]
    assert names == ["POST /v1/models/{model_name}:predict",
                     "POST /v1/models/{model_name}:predict",
                     "GET /v2/models/{model_name}/ready",
                     "POST /v1/models/{model_name}:predict",
                     "GET /admin/telemetry"]
    assert [s.attributes.get("kserve.model") for s in recording.spans] == [
        "m1", "m2", "m1", "nope", None]
    assert [s.attributes["http.status_code"] for s in recording.spans] == [
        200, 200, 200, 404, 200]
    assert all(s.status_code == tracing.STATUS_UNSET for s in recording.spans)


class _Collector:
    def __init__(self):
        import http.server

        docs = self.docs = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                docs.append((self.path, self.headers["Content-Type"], json.loads(
                    self.rfile.read(int(self.headers["Content-Length"])))))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def spans(self):
        return [s for _, _, d in self.docs for rs in d["resourceSpans"]
                for ss in rs["scopeSpans"] for s in ss["spans"]]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def tiny_server():
    model = build_model(build_arg_parser().parse_args(ARGS))
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60), "server did not start"
    yield srv
    srv.request_stop()
    thread.join(30)
    assert not thread.is_alive()


def _complete(port, headers, tokens=6):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/openai/v1/completions", body=json.dumps({
            "model": "tiny", "prompt": "hello spans", "max_tokens": tokens,
            "temperature": 0, "ignore_eos": True}),
            headers={"Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_exports_request_and_engine_spans_as_otlp_json(tiny_server, monkeypatch):
    collector = _Collector()
    monkeypatch.setenv(tracing.ENDPOINT_ENV, f"http://127.0.0.1:{collector.port}")
    tracing.shutdown_tracing()
    try:
        status, out = _complete(tiny_server.port, {
            "traceparent": f"00-{'5a' * 16}-{'6b' * 8}-01"})
        assert status == 200 and out["usage"]["completion_tokens"] == 6
        # the request span ends once its answer is written, which may be
        # just after the client has read it
        want = {"POST /openai/v1/completions", "engine.queue", "engine.prefill",
                "engine.decode"}
        deadline = time.monotonic() + 20
        while True:
            assert tracing.get_tracer().exporter.force_flush(10)
            got = {s["name"] for s in collector.spans() if s["traceId"] == "5a" * 16}
            if want <= got or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        stats = tracing.tracer_stats()
    finally:
        tracing.shutdown_tracing()
        collector.close()
    assert stats["exported"] >= 4 and stats["dropped"] == stats["failed"] == 0
    path, ctype, doc = collector.docs[0]
    assert path == "/v1/traces" and ctype == "application/json"
    resource = doc["resourceSpans"][0]["resource"]["attributes"]
    assert resource == [{"key": "service.name",
                         "value": {"stringValue": "kserve-tpu-torch"}}]
    spans = {s["name"]: s for s in collector.spans() if s["traceId"] == "5a" * 16}
    req = spans["POST /openai/v1/completions"]
    assert req["parentSpanId"] == "6b" * 8 and req["kind"] == 2
    for name in ("engine.queue", "engine.prefill", "engine.decode"):
        s = spans[name]
        assert s["parentSpanId"] == req["spanId"] and len(s["spanId"]) == 16
        assert int(req["startTimeUnixNano"]) <= int(s["startTimeUnixNano"]) <= int(
            s["endTimeUnixNano"]) <= int(req["endTimeUnixNano"])
    attrs = {a["key"]: a["value"] for a in spans["engine.decode"]["attributes"]}
    assert attrs["tokens"] == {"intValue": "6"}
    assert attrs["finish_reason"] == {"stringValue": "length"}


def test_a_dead_collector_neither_fails_nor_holds_a_request(tiny_server, monkeypatch):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    monkeypatch.setenv(tracing.ENDPOINT_ENV, f"http://127.0.0.1:{dead}")
    tracing.shutdown_tracing()
    before = metrics.TRACING_SPANS.labels(outcome="failed").get()
    try:
        t0 = time.perf_counter()
        for _ in range(3):
            assert _complete(tiny_server.port, {}, tokens=2)[0] == 200
        wall = time.perf_counter() - t0
        tracing.get_tracer().exporter.force_flush(10)
        stats = tracing.tracer_stats()
    finally:
        tracing.shutdown_tracing()
    assert wall < 30
    assert stats["exported"] == 0 and stats["failed"] >= 3 and stats["export_errors"] >= 1
    assert metrics.TRACING_SPANS.labels(outcome="failed").get() - before == stats["failed"]


def test_exporter_drops_and_counts_when_its_queue_is_full():
    exporter = tracing.OTLPHTTPExporter("http://127.0.0.1:9", max_queue=2, delay_s=60)
    tracer = tracing.Tracer(exporter)
    try:
        for i in range(5):
            tracer.start_span(f"s{i}").end()
        assert exporter.dropped == 3 and exporter.stats()["queued"] == 2
    finally:
        exporter._stop = True
        exporter._flush.set()


def test_tracer_is_off_without_an_endpoint(monkeypatch):
    monkeypatch.delenv(tracing.ENDPOINT_ENV, raising=False)
    tracing.shutdown_tracing()
    assert tracing.get_tracer() is None and tracing.tracer_stats() is None
    tracing.shutdown_tracing()


def test_log_records_carry_request_and_trace_ids():
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.request_id, record.trace_id))

    handler = Keep()
    handler.addFilter(tlogging.RequestContextFilter())
    log = logging.getLogger("kserve_tpu_torch.test_spans")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        log.info("outside")
        headers = {"traceparent": f"00-{'77' * 16}-{'88' * 8}-01", "x-request-id": "rid-1"}
        with tracing.request_scope(headers):
            log.info("inside")
            with tlogging.bind_log_context(request_id="rid-2", trace_id="t-2"):
                log.info("bound")
            assert tlogging.current_request_id() == "rid-1"
    finally:
        log.removeHandler(handler)
    assert records == [("-", "-"), ("rid-1", "77" * 16), ("rid-2", "t-2")]
    fmt = logging.Formatter(tlogging.KSERVE_TPU_LOGGER_FORMAT)
    rec = logging.LogRecord("x", logging.INFO, "f.py", 1, "m", None, None)
    tlogging.RequestContextFilter().filter(rec)
    assert "rid=- tid=-" in fmt.format(rec)


def test_admin_profile_202_409_400_and_a_trace_file(tiny_server, tmp_path):
    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", tiny_server.port, timeout=60)
        try:
            conn.request("POST", "/admin/profile", body=json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    assert post({"seconds": 0})[0] == 400
    assert post({"seconds": 301})[0] == 400
    assert post({"seconds": "soon"})[0] == 400
    status, info = post({"seconds": 0.5, "dir": str(tmp_path)})
    assert status == 202 and info["activities"] == ["CPU"]
    assert info["trace"] == os.path.join(info["dir"], "trace.json")
    assert post({"seconds": 0.5, "dir": str(tmp_path)})[0] == 409
    _complete(tiny_server.port, {}, tokens=2)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        conn = http.client.HTTPConnection("127.0.0.1", tiny_server.port, timeout=60)
        conn.request("GET", "/admin/telemetry")
        prof = json.loads(conn.getresponse().read())["profiler"]
        conn.close()
        if not prof["active"] and prof["capture"]["done"]:
            break
        time.sleep(0.1)
    assert prof["capture"]["trace"] == info["trace"]
    with open(info["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
