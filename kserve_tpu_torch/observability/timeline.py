"""Request-lifecycle timelines: the engine's per-request telemetry.

Port of kserve_tpu/observability/timeline.py (the same classes, fields,
payload keys and percentile rule, the autoscaler's signal view
`signal_windows()` included).  Each timeline carries the TraceContext its
request was bound to (`trace`): the engine's queue / prefill / decode
spans (observability/spans.py) hang below the request's span through it,
and its `trace_id` is in the timeline's payload.  Every generation is stamped with a `RequestTimeline` as it
moves through the engine (received -> admitted -> prefill start/end ->
first token -> per-token -> finished, cancelled, error or preempted: a
drain's checkpoint), from the engine's monotonic clock.

The `TimelineRecorder` keeps a bounded ring of finished timelines plus
rolling sample windows (TTFT, ITL, queue wait, e2e, decode-step and
prefill-chunk durations) that back `GET /admin/telemetry`.

TTFT is first token minus *received* (queue wait included: the client
experiences it); ITL is the gap between consecutive emitted tokens.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

# bounded per-timeline storage: events and ITL samples never grow past
# these caps even for max_model_len generations (overflow keeps aggregate
# count/sum so means stay exact)
MAX_EVENTS = 64
MAX_ITL_SAMPLES = 4096


class RequestTimeline:
    """Clock-stamped lifecycle of one generation.  Times are the engine's
    monotonic seconds; only differences are meaningful."""

    __slots__ = (
        "request_id", "model_name", "trace", "received", "admitted",
        "prefill_start", "prefill_end", "first_token_at", "finished_at",
        "finish_reason", "n_prompt_tokens", "n_generated", "itls",
        "itl_overflow_n", "itl_overflow_sum", "events", "_last_token_at",
        "recorded",
    )

    def __init__(self, request_id: str, model_name: str = "",
                 trace: Any = None):
        self.request_id = request_id
        self.model_name = model_name
        # the tracing.TraceContext bound when the request entered, or None
        self.trace = trace
        self.received: Optional[float] = None
        self.admitted: Optional[float] = None
        self.prefill_start: Optional[float] = None
        self.prefill_end: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.n_prompt_tokens = 0
        self.n_generated = 0
        self.itls: List[float] = []
        self.itl_overflow_n = 0
        self.itl_overflow_sum = 0.0
        self.events: List[dict] = []
        self._last_token_at: Optional[float] = None
        # set by the engine once this timeline has been fed to the
        # recorder/metrics — makes terminal recording idempotent across
        # overlapping teardown paths (finish vs cancel vs stop)
        self.recorded = False

    # ---- stamps (first-write-wins where re-admission can re-stamp) ----

    def mark_received(self, t: float) -> None:
        if self.received is None:
            self.received = t

    def mark_admitted(self, t: float) -> None:
        # queue wait is measured to the FIRST admission; a preemption
        # re-seat must not shrink it retroactively
        if self.admitted is None:
            self.admitted = t

    def mark_prefill_start(self, t: float) -> None:
        if self.prefill_start is None:
            self.prefill_start = t

    def mark_prefill_end(self, t: float) -> None:
        self.prefill_end = t

    def mark_token(self, t: float) -> None:
        """One emitted token: the first sets TTFT, later ones append ITL."""
        self.n_generated += 1
        if self.first_token_at is None:
            self.first_token_at = t
        elif self._last_token_at is not None:
            gap = t - self._last_token_at
            if len(self.itls) < MAX_ITL_SAMPLES:
                self.itls.append(gap)
            else:
                self.itl_overflow_n += 1
                self.itl_overflow_sum += gap
        self._last_token_at = t

    def mark_finished(self, t: float, reason: Optional[str]) -> None:
        if self.finished_at is None:
            self.finished_at = t
            self.finish_reason = reason

    def add_event(self, t: float, name: str, **detail) -> None:
        """Span-event seam: preemptions, checkpoints, resumes, errors."""
        if len(self.events) < MAX_EVENTS:
            self.events.append({"t": t, "name": name, **detail})

    # ---- derived latencies (None until both stamps exist) ----

    @staticmethod
    def _delta(a: Optional[float], b: Optional[float]) -> Optional[float]:
        if a is None or b is None:
            return None
        return b - a

    @property
    def queue_wait_s(self) -> Optional[float]:
        return self._delta(self.received, self.admitted)

    @property
    def ttft_s(self) -> Optional[float]:
        return self._delta(self.received, self.first_token_at)

    @property
    def prefill_s(self) -> Optional[float]:
        return self._delta(self.prefill_start, self.prefill_end)

    @property
    def decode_s(self) -> Optional[float]:
        return self._delta(self.first_token_at, self.finished_at)

    @property
    def e2e_s(self) -> Optional[float]:
        return self._delta(self.received, self.finished_at)

    @property
    def mean_itl_s(self) -> Optional[float]:
        n = len(self.itls) + self.itl_overflow_n
        if n == 0:
            return None
        return (sum(self.itls) + self.itl_overflow_sum) / n

    def to_dict(self, max_events: int = 16) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "request_id": self.request_id,
            "model_name": self.model_name,
            "received": self.received,
            "admitted": self.admitted,
            "prefill_start": self.prefill_start,
            "prefill_end": self.prefill_end,
            "first_token_at": self.first_token_at,
            "finished_at": self.finished_at,
            "finish_reason": self.finish_reason,
            "n_prompt_tokens": self.n_prompt_tokens,
            "n_generated": self.n_generated,
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": self.ttft_s,
            "prefill_s": self.prefill_s,
            "e2e_s": self.e2e_s,
            "mean_itl_s": self.mean_itl_s,
            "events": self.events[:max_events],
        }
        if self.trace is not None:
            d["trace_id"] = getattr(self.trace, "trace_id", None)
        return d


def percentiles(samples) -> Dict[str, Any]:
    """{p50,p90,p99,mean,max,n} by nearest-rank over a bounded window —
    deterministic (no interpolation) so chaos tests can assert exactly."""
    xs = sorted(samples)
    n = len(xs)
    if n == 0:
        return {"n": 0}

    def rank(q: float) -> float:
        return xs[min(n - 1, int(q * n))]

    return {
        "n": n,
        "p50": rank(0.50),
        "p90": rank(0.90),
        "p99": rank(0.99),
        "mean": sum(xs) / n,
        "max": xs[-1],
    }


class TimelineRecorder:
    """Bounded in-memory telemetry behind `GET /admin/telemetry`: a ring of
    recent finished timelines plus rolling sample windows for the latency
    series.  Pure host-side bookkeeping — never touches the device."""

    def __init__(self, max_timelines: int = 128, max_samples: int = 2048):
        self.timelines: deque = deque(maxlen=max_timelines)
        self._ttft: deque = deque(maxlen=max_samples)
        self._itl: deque = deque(maxlen=max_samples)
        self._queue_wait: deque = deque(maxlen=max_samples)
        self._e2e: deque = deque(maxlen=max_samples)
        self._step: deque = deque(maxlen=max_samples)
        self._prefill_chunk: deque = deque(maxlen=max_samples)
        self.finished_count = 0
        self.preempted_count = 0
        self.aborted_count = 0
        self.step_count = 0

    def observe(self, tl: RequestTimeline) -> None:
        """Record a timeline that reached a terminal state.  Preempted /
        cancelled / errored timelines land in the ring (operators debugging
        a drain want them) but not in the latency windows — a half
        generation's e2e is noise."""
        self.timelines.append(tl)
        if tl.finish_reason not in ("stop", "length"):
            if tl.finish_reason == "preempted":
                self.preempted_count += 1
            else:
                self.aborted_count += 1
            return
        self.finished_count += 1
        if tl.ttft_s is not None:
            self._ttft.append(tl.ttft_s)
        if tl.queue_wait_s is not None:
            self._queue_wait.append(tl.queue_wait_s)
        if tl.e2e_s is not None:
            self._e2e.append(tl.e2e_s)
        self._itl.extend(tl.itls)

    def signal_windows(self) -> Dict[str, Any]:
        """The latency percentiles an endpoint picker or autoscaler reads
        (the compact subset of snapshot() that scheduler_state() carries;
        kserve_tpu/observability/timeline.py:235)."""
        ttft = percentiles(self._ttft)
        itl = percentiles(self._itl)
        return {
            "ttft_p50_s": ttft.get("p50"),
            "ttft_p99_s": ttft.get("p99"),
            "itl_p99_s": itl.get("p99"),
            "finished": self.finished_count,
        }

    def record_step(self, seconds: float) -> None:
        """One decode step: a multi-token dispatch+fetch chunk."""
        self.step_count += 1
        self._step.append(seconds)

    def record_prefill_chunk(self, seconds: float) -> None:
        self._prefill_chunk.append(seconds)

    def snapshot(self, max_recent: int = 32) -> Dict[str, Any]:
        # [-0:] would slice the WHOLE ring, the opposite of "none"
        recent = list(self.timelines)[-max_recent:] if max_recent > 0 else []
        return {
            "counts": {
                "finished": self.finished_count,
                "preempted": self.preempted_count,
                "aborted": self.aborted_count,
                "decode_steps": self.step_count,
            },
            "ttft_s": percentiles(self._ttft),
            "itl_s": percentiles(self._itl),
            "queue_wait_s": percentiles(self._queue_wait),
            "e2e_s": percentiles(self._e2e),
            "decode_step_s": percentiles(self._step),
            "prefill_chunk_s": percentiles(self._prefill_chunk),
            "recent": [tl.to_dict() for tl in reversed(recent)],
        }
