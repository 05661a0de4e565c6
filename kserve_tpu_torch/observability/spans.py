"""Engine child spans, emitted from a finished RequestTimeline (port of
kserve_tpu/observability/spans.py).

The engine loop runs apart from any request's asyncio context, so the
request's current span cannot reach it.  Instead every timeline carries
the TraceContext its request was bound to, and when a generation reaches
a terminal state the engine emits retrospective queue / prefill / decode
spans tagged with that trace's ids (`trace_id`, and `parent_span_id`: the
replica's request span).  So the EPP's proxy span, the replica's request
span and these engine spans form one trace.

Span events carry the timeline's lifecycle events (preemptions,
checkpoints, resumes).  `to_wall_ns` maps the engine clock's seconds to
wall-clock nanoseconds: a tracer that takes `start_time` / `end_time`
(the OpenTelemetry API's and the port's Tracer) then places each span
where it happened.
"""

from __future__ import annotations

from typing import Callable, Optional

from .timeline import RequestTimeline

_PHASES = (
    # (span name, start attr, end attr)
    ("engine.queue", "received", "admitted"),
    ("engine.prefill", "prefill_start", "prefill_end"),
    ("engine.decode", "first_token_at", "finished_at"),
)


def _end(span, end_ns: Optional[int]) -> None:
    if hasattr(span, "end"):
        if end_ns is None:
            span.end()
        else:
            span.end(end_time=end_ns)


def _start_span(tracer, name: str, attributes: dict, start_ns: Optional[int]):
    """tracer.start_span, or for contextmanager-only fakes
    start_as_current_span entered and ended inline."""
    if hasattr(tracer, "start_span"):
        if start_ns is None:
            return tracer.start_span(name, attributes=attributes), None
        return tracer.start_span(name, attributes=attributes, start_time=start_ns), None
    cm = tracer.start_as_current_span(name, attributes=attributes)
    return cm.__enter__(), cm


def emit_timeline_spans(tracer, tl: Optional[RequestTimeline],
                        to_wall_ns: Optional[Callable[[float], int]] = None) -> None:
    """Emit the engine span tree of one finished timeline.  A None tracer
    or a timeline without stamps is a no-op; the caller wraps this so a
    failure never reaches the engine loop."""
    if tracer is None or tl is None:
        return
    base = {
        "kserve.request_id": tl.request_id,
        "kserve.model": tl.model_name,
    }
    if tl.trace is not None:
        base["trace_id"] = tl.trace.trace_id
        base["parent_span_id"] = tl.trace.span_id
    for name, start_attr, end_attr in _PHASES:
        t0 = getattr(tl, start_attr)
        t1 = getattr(tl, end_attr)
        if t0 is None or t1 is None:
            continue
        attrs = dict(base)
        attrs["start_s"] = t0
        attrs["duration_s"] = t1 - t0
        if name == "engine.decode":
            attrs["tokens"] = tl.n_generated
            if tl.finish_reason:
                attrs["finish_reason"] = tl.finish_reason
        span, cm = _start_span(tracer, name, attrs,
                               to_wall_ns(t0) if to_wall_ns is not None else None)
        try:
            if name == "engine.decode" and hasattr(span, "add_event"):
                for ev in tl.events:
                    detail = {k: v for k, v in ev.items() if k != "name"}
                    span.add_event(ev["name"], attributes=detail)
        finally:
            if cm is not None:
                cm.__exit__(None, None, None)
            else:
                _end(span, to_wall_ns(t1) if to_wall_ns is not None else None)
