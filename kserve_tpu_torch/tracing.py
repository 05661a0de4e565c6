"""W3C trace-context propagation and request spans for the data plane
(port of kserve_tpu/tracing.py:47-220; its aiohttp middlewares are the
wire's in protocol/rest/http_server.py).

Two layers, separable as in the JAX package:

- **Propagation** (always on): `TraceContext` is one `traceparent` hop
  (00-<trace id>-<span id>-<flags>).  Each request a server answers binds
  its context, a child of the caller's or a fresh root, with its request
  id (`request_scope`); every outbound hop (the inference client's
  attempts, the graph router's steps, the EPP's proxy) writes its child
  header through `propagate_headers`, so a multi-hop request stays one
  trace.

- **Spans** (opt-in): with `OTEL_EXPORTER_OTLP_ENDPOINT` set,
  `setup_tracing` builds the port's own `Tracer`, whose finished spans an
  `OTLPHTTPExporter` daemon thread POSTs in batches to
  `<endpoint>/v1/traces` as OTLP/HTTP JSON.  Without the endpoint there is
  no tracer and `get_tracer()` returns None, so the request span costs
  nothing.  The JAX package exports OTLP over gRPC through
  opentelemetry-sdk (kserve_tpu/tracing.py:156-167); the card machine has
  neither, so the port speaks OTLP's HTTP/JSON encoding (ROADMAP C20).
  A span takes its ids from the bound `TraceContext`: a server's request
  span IS the context its request was bound to, and the spans below it
  are its children.  The exporter drops spans (counted) when its bounded
  queue is full, and a failed export is logged and counted; neither ever
  reaches a request or the engine loop.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import http.client
import json
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, MutableMapping, Optional, Tuple
from urllib.parse import urlsplit

from .metrics import TRACING_SPANS

logger = logging.getLogger(__name__)

TRACEPARENT_HEADER = "traceparent"
REQUEST_ID_HEADER = "x-request-id"


@dataclass(frozen=True)
class TraceContext:
    """One W3C trace-context hop: 32-hex trace id, 16-hex span id."""

    trace_id: str
    span_id: str
    flags: str = "01"

    @staticmethod
    def new_root() -> "TraceContext":
        return TraceContext(trace_id=os.urandom(16).hex(), span_id=os.urandom(8).hex())

    def child(self) -> "TraceContext":
        """Same trace, fresh span id: the outbound hop's context."""
        return TraceContext(trace_id=self.trace_id, span_id=os.urandom(8).hex(),
                            flags=self.flags)

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    @staticmethod
    def parse(header: Optional[str]) -> Optional["TraceContext"]:
        """A `traceparent` value, or None when it is malformed (the hop then
        starts a fresh trace rather than failing the request)."""
        if not header:
            return None
        parts = header.strip().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
        if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return TraceContext(trace_id=trace_id, span_id=span_id, flags=flags[:2] or "01")

    @staticmethod
    def from_headers(headers: Mapping[str, str]) -> Optional["TraceContext"]:
        """The context of lower-cased request headers."""
        return TraceContext.parse(headers.get(TRACEPARENT_HEADER))

    @staticmethod
    def derive(parent: Optional["TraceContext"]) -> "TraceContext":
        """A child of `parent`, or a fresh root when this process is the
        trace's first hop."""
        return parent.child() if parent is not None else TraceContext.new_root()


_current_trace: contextvars.ContextVar[Optional[TraceContext]] = (
    contextvars.ContextVar("kserve_tpu_torch_trace", default=None))
_current_request_id: contextvars.ContextVar[Optional[str]] = (
    contextvars.ContextVar("kserve_tpu_torch_request_id", default=None))


def current_trace_context() -> Optional[TraceContext]:
    return _current_trace.get()


def current_request_id() -> Optional[str]:
    return _current_request_id.get()


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    token = _current_trace.set(ctx)
    try:
        yield ctx
    finally:
        _current_trace.reset(token)


@contextlib.contextmanager
def request_scope(headers: Mapping[str, str]) -> Iterator[Tuple[TraceContext, str]]:
    """Bind one request's context: a child of its `traceparent` (or a new
    root) and its `x-request-id` (or a new `req-<hex>` id), both taken from
    lower-cased request headers."""
    ctx = TraceContext.derive(TraceContext.from_headers(headers))
    request_id = headers.get(REQUEST_ID_HEADER) or f"req-{os.urandom(6).hex()}"
    token = _current_request_id.set(request_id)
    try:
        with trace_scope(ctx):
            yield ctx, request_id
    finally:
        _current_request_id.reset(token)


def propagate_headers(headers: MutableMapping[str, str],
                      parent: Optional[TraceContext] = None) -> TraceContext:
    """Write a `traceparent` that is a child of `parent` (or of the bound
    context), a fresh root when this process is the first hop; returns the
    context written."""
    ctx = TraceContext.derive(parent or current_trace_context())
    headers[TRACEPARENT_HEADER] = ctx.to_header()
    return ctx




# ---------------------------------------------------------------- spans

SPAN_KIND_INTERNAL = 1
SPAN_KIND_SERVER = 2
SPAN_KIND_CLIENT = 3
STATUS_UNSET, STATUS_OK, STATUS_ERROR = 0, 1, 2

_current_span: contextvars.ContextVar[Optional["Span"]] = (
    contextvars.ContextVar("kserve_tpu_torch_span", default=None))


def current_span() -> Optional["Span"]:
    """The span of start_as_current_span around this code, or None."""
    return _current_span.get()


class Span:
    """One timed operation of a trace: the OpenTelemetry span API's
    subset the data plane uses.  Times are wall-clock nanoseconds."""

    __slots__ = ("name", "trace_id", "span_id", "parent_span_id", "kind",
                 "start_ns", "end_ns", "attributes", "events", "status_code",
                 "status_message", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str, span_id: str,
                 parent_span_id: Optional[str], kind: int, start_ns: int,
                 attributes: Optional[Mapping[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.kind = kind
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.events: List[tuple] = []  # (time ns, name, attributes)
        self.status_code = STATUS_UNSET
        self.status_message = ""

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def is_recording(self) -> bool:
        return self.end_ns is None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[Mapping[str, Any]] = None,
                  timestamp: Optional[int] = None) -> None:
        self.events.append((timestamp or time.time_ns(), name, dict(attributes or {})))

    def record_exception(self, exc: BaseException) -> None:
        self.add_event("exception", {"exception.type": type(exc).__name__,
                                     "exception.message": str(exc)})

    def set_status(self, status: str, description: str = "") -> None:
        """"ERROR" or "OK" (else unset), with a description."""
        self.status_code = {"ERROR": STATUS_ERROR, "OK": STATUS_OK}.get(status, STATUS_UNSET)
        self.status_message = description

    def end(self, end_time: Optional[int] = None) -> None:
        if self.end_ns is not None:
            return
        self.end_ns = end_time if end_time is not None else time.time_ns()
        self._tracer._finished(self)


class Tracer:
    """Starts spans and hands the finished ones to `exporter` (anything
    with `submit(span)`).  A span's ids come from, in this order: the
    `context` passed (the span IS that hop), the `trace_id` and
    `parent_span_id` attributes (the engine's retrospective spans,
    observability/spans.py), the current span, the bound TraceContext;
    else it starts a new trace."""

    def __init__(self, exporter=None, service_name: str = "kserve-tpu-torch"):
        self.exporter = exporter
        self.service_name = service_name

    def start_span(self, name: str, attributes: Optional[Mapping[str, Any]] = None, *,
                   context: Optional[TraceContext] = None,
                   parent_span_id: Optional[str] = None,
                   kind: int = SPAN_KIND_INTERNAL,
                   start_time: Optional[int] = None) -> Span:
        attrs = attributes or {}
        if context is not None:
            trace_id, span_id = context.trace_id, context.span_id
        elif attrs.get("trace_id") and attrs.get("parent_span_id"):
            trace_id, span_id = attrs["trace_id"], os.urandom(8).hex()
            parent_span_id = attrs["parent_span_id"]
        else:
            parent = current_span() or current_trace_context()
            if parent is None:
                trace_id = os.urandom(16).hex()
            else:
                trace_id, parent_span_id = parent.trace_id, parent.span_id
            span_id = os.urandom(8).hex()
        return Span(self, name, trace_id, span_id, parent_span_id, kind,
                    start_time if start_time is not None else time.time_ns(), attrs)

    @contextlib.contextmanager
    def start_as_current_span(self, name: str,
                              attributes: Optional[Mapping[str, Any]] = None,
                              **kwargs) -> Iterator[Span]:
        """A span that is the current one inside the block; an exception
        escaping the block marks it as an error."""
        span = self.start_span(name, attributes, **kwargs)
        token = _current_span.set(span)
        try:
            yield span
        except Exception as exc:
            mark_span_error(span, exc)
            raise
        finally:
            _current_span.reset(token)
            span.end()

    def _finished(self, span: Span) -> None:
        if self.exporter is not None:
            self.exporter.submit(span)


# ---------------------------------------------------------------- OTLP/HTTP


def _otlp_value(value) -> dict:
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    if isinstance(value, (list, tuple)):
        return {"arrayValue": {"values": [_otlp_value(v) for v in value]}}
    return {"stringValue": str(value)}


def _otlp_attributes(attrs: Mapping[str, Any]) -> List[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()
            if v is not None]


def otlp_span(span: Span) -> dict:
    """One span in OTLP's JSON encoding (ids in hex, times as strings)."""
    out = {"traceId": span.trace_id, "spanId": span.span_id, "name": span.name,
           "kind": span.kind, "startTimeUnixNano": str(span.start_ns),
           "endTimeUnixNano": str(span.end_ns),
           "attributes": _otlp_attributes(span.attributes),
           "events": [{"timeUnixNano": str(t), "name": n,
                       "attributes": _otlp_attributes(a)} for t, n, a in span.events],
           "status": {"code": span.status_code}}
    if span.parent_span_id:
        out["parentSpanId"] = span.parent_span_id
    if span.status_message:
        out["status"]["message"] = span.status_message
    return out


def otlp_request(spans: List[Span], service_name: str) -> dict:
    """An ExportTraceServiceRequest: resourceSpans -> scopeSpans -> spans."""
    return {"resourceSpans": [{
        "resource": {"attributes": _otlp_attributes({"service.name": service_name})},
        "scopeSpans": [{"scope": {"name": "kserve_tpu_torch"},
                        "spans": [otlp_span(s) for s in spans]}]}]}


class OTLPHTTPExporter:
    """Finished spans to `<endpoint>/v1/traces` as OTLP/HTTP JSON, from a
    daemon thread: `submit` only enqueues (a full queue drops the span and
    counts it), the thread sends batches of up to `max_batch` spans at
    least every `delay_s`, and encodes them there, off the caller's
    thread.  A failed export is logged and its spans counted as failed."""

    def __init__(self, endpoint: str, service_name: str = "kserve-tpu-torch",
                 max_queue: int = 4096, max_batch: int = 512,
                 delay_s: float = 0.2, timeout_s: float = 5.0):
        parts = urlsplit(endpoint if "://" in endpoint else "http://" + endpoint)
        if parts.scheme != "http":
            raise ValueError(f"OTLP endpoint must be http://, got {endpoint!r}")
        self.host, self.port = parts.hostname or "localhost", parts.port or 4318
        self.path = parts.path.rstrip("/") + "/v1/traces"
        self.endpoint = f"http://{self.host}:{self.port}{self.path}"
        self.service_name = service_name
        self.max_batch = max_batch
        self.delay_s = delay_s
        self.timeout_s = timeout_s
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._flush = threading.Event()
        # spans queued and not yet exported or lost, under _done
        self._pending = 0
        self._done = threading.Condition()
        self._stop = False
        self.exported = self.dropped = self.failed = self.export_errors = 0
        self._thread = threading.Thread(target=self._run, name="otlp-exporter",
                                        daemon=True)
        self._thread.start()

    def submit(self, span: Span) -> None:
        with self._done:
            try:
                self._queue.put_nowait(span)
            except queue.Full:
                self.dropped += 1
                TRACING_SPANS.labels(outcome="dropped").inc()
                return
            self._pending += 1

    def stats(self) -> dict:
        return {"endpoint": self.endpoint, "queued": self._queue.qsize(),
                "exported": self.exported, "dropped": self.dropped,
                "failed": self.failed, "export_errors": self.export_errors}

    def force_flush(self, timeout_s: float = 10.0) -> bool:
        """Send what is queued now; True once every span submitted so far
        is exported or counted lost."""
        self._flush.set()
        with self._done:
            return self._done.wait_for(lambda: self._pending == 0, timeout_s)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        self.force_flush(timeout_s)
        self._stop = True
        self._flush.set()
        self._thread.join(timeout_s)

    def _run(self) -> None:
        while not self._stop:
            self._flush.wait(self.delay_s)
            self._flush.clear()
            while True:
                batch = []
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                if not batch:
                    break
                self._export(batch)
                with self._done:
                    self._pending -= len(batch)
                    self._done.notify_all()

    def _export(self, batch: List[Span]) -> None:
        try:
            body = json.dumps(otlp_request(batch, self.service_name)).encode()
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("POST", self.path, body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
            finally:
                conn.close()
            if not 200 <= resp.status < 300:
                raise OSError(f"collector answered {resp.status}")
        except Exception as exc:  # noqa: BLE001 — an export never reaches a request
            self.failed += len(batch)
            self.export_errors += 1
            TRACING_SPANS.labels(outcome="failed").inc(len(batch))
            if self.export_errors == 1 or self.export_errors % 100 == 0:
                logger.warning("span export to %s failed (%d failures, %d spans "
                               "lost): %s", self.endpoint, self.export_errors,
                               self.failed, exc)
            return
        self.exported += len(batch)
        TRACING_SPANS.labels(outcome="exported").inc(len(batch))


# ---------------------------------------------------------------- tracer

ENDPOINT_ENV = "OTEL_EXPORTER_OTLP_ENDPOINT"
_tracer: Optional[Tracer] = None
_configured = False
# servers on several threads may ask for the tracer first at once
_setup_lock = threading.Lock()


def setup_tracing(service_name: str = "kserve-tpu-torch") -> None:
    """Configure the process's tracer once: an OTLP/HTTP exporter to
    $OTEL_EXPORTER_OTLP_ENDPOINT, or no tracer when it is unset."""
    global _tracer, _configured
    with _setup_lock:
        if _configured:
            return
        endpoint = os.environ.get(ENDPOINT_ENV)
        if endpoint:  # no endpoint -> no tracer -> no request span at all
            _tracer = Tracer(OTLPHTTPExporter(endpoint, service_name), service_name)
            atexit.register(shutdown_tracing)
            logger.info("OTLP/HTTP tracing enabled -> %s", _tracer.exporter.endpoint)
        _configured = True


def set_tracer_for_tests(tracer) -> None:
    global _tracer, _configured
    _tracer = tracer
    _configured = True


def get_tracer():
    if not _configured:
        setup_tracing()
    return _tracer


def tracer_stats() -> Optional[dict]:
    """The exporter's counts (exported, dropped, failed), or None."""
    exporter = getattr(_tracer, "exporter", None)
    return exporter.stats() if hasattr(exporter, "stats") else None


def shutdown_tracing(timeout_s: float = 10.0) -> None:
    """Flush and stop the exporter; the next get_tracer() reads the
    environment again."""
    global _tracer, _configured
    with _setup_lock:
        exporter = getattr(_tracer, "exporter", None)
        _tracer, _configured = None, False
    if hasattr(exporter, "shutdown"):
        exporter.shutdown(timeout_s)


def mark_span_error(span, exc: BaseException) -> None:
    """Record an exception on a span and flip it to ERROR status."""
    if hasattr(span, "record_exception"):
        span.record_exception(exc)
    if hasattr(span, "set_status"):
        span.set_status("ERROR", str(exc))
    else:
        span.set_attribute("error", True)


def add_span_event(name: str, **attributes) -> None:
    """Attach an event to the current span, if any (breaker transitions)."""
    span = current_span()
    if span is not None and span.is_recording():
        span.add_event(name, attributes=attributes)
