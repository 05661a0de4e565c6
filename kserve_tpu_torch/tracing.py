"""W3C trace-context propagation for the data plane (the dependency-free
half of kserve_tpu/tracing.py:47-136, :223-238).

`TraceContext` is one `traceparent` hop (00-<trace id>-<span id>-<flags>).
Each request a server answers binds its context, a child of the caller's
or a fresh root, with its request id (`request_scope`); every outbound hop
(the inference client's attempts, the graph router's steps) writes its
child header through `propagate_headers`, so a multi-hop request stays
one trace.

Spans are not emitted: the card machine has no opentelemetry, so
`get_tracer()` is None.  OpenTelemetry spans and the engine's child spans
are still to port.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Iterator, Mapping, MutableMapping, Optional, Tuple

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


def get_tracer():
    """No span tracer: the card machine has no opentelemetry."""
    return None
