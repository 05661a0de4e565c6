"""Prometheus metrics of the port's engine, in the text exposition format
0.0.4, on the standard library (the card machine has no
prometheus_client).

Port of the series of kserve_tpu/metrics.py that the port feeds, under
the same names, help texts, labels and buckets: the request stages of
`Model.__call__` (preprocess, predict, postprocess, explain), token counters,
occupancy / queue / free-page gauges, the wedge gauge, the request-timeline
histograms (TTFT, ITL, queue wait, e2e), decode-step and prefill-chunk
durations, preemptions, speculative draft outcomes, the startup phases,
load shedding, deadline rejections, breaker transitions and client
retries, the lifecycle series (state,
drain duration, checkpoints, resumes, tokens salvaged), and the KV
hierarchy's and the peer page fabric's (tier events, prefix hit tokens by
tier, page-in seconds, peer fetches and pages served), and the
autoscaler's (decisions, target replicas, signals, hold outcomes at the
gateway).  The JAX package's
other series come with their modules.  `GET /metrics`
serves `generate_latest()`.

As in prometheus_client, the series live in one process-wide registry.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_INF = float("inf")


def _float_to_go_string(d: float) -> str:
    """A sample value or bucket bound as prometheus_client writes it."""
    d = float(d)
    if d == _INF:
        return "+Inf"
    if d == -_INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _labels(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str]):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        _REGISTRY.append(self)
        if not self.labelnames:
            self.labels()  # an unlabeled series is exposed from the start

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels {self.labelnames}, "
                             f"got {sorted(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _new_child(self):
        raise NotImplementedError

    def _items(self):
        with self._lock:
            return sorted(self._children.items())

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.documentation}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in self._items():
            lines.extend(child.samples(self.name, list(zip(self.labelnames, key))))
        return lines


class _Value:
    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def get(self) -> float:
        return self._value

    def samples(self, name, pairs):
        return [f"{name}{_labels(pairs)} {_float_to_go_string(self._value)}"]


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class _HistogramChild:
    def __init__(self, bounds: Tuple[float, ...]):
        self._bounds = bounds
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break

    def samples(self, name, pairs):
        with self._lock:
            counts, total = list(self._counts), self._sum
        out, cum = [], 0
        for bound, n in zip(self._bounds, counts):
            cum += n
            le = pairs + [("le", _float_to_go_string(bound))]
            out.append(f"{name}_bucket{_labels(le)} {_float_to_go_string(cum)}")
        out.append(f"{name}_count{_labels(pairs)} {_float_to_go_string(cum)}")
        out.append(f"{name}_sum{_labels(pairs)} {_float_to_go_string(total)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        """An unlabeled counter's increment."""
        self.labels().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        """An unlabeled gauge's value."""
        self.labels().set(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, documentation, labelnames, buckets):
        bounds = tuple(float(b) for b in buckets)
        if bounds[-1] != _INF:
            bounds += (_INF,)
        self.buckets = bounds
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        """An unlabeled histogram's observation."""
        self.labels().observe(value)


# every series below, in definition order (filled at import)
_REGISTRY: List[_Metric] = []


def generate_latest() -> bytes:
    """Every series in the text exposition format 0.0.4."""
    lines: List[str] = []
    for metric in _REGISTRY:
        lines.extend(metric.expose())
    return ("\n".join(lines) + "\n").encode("utf-8")


# ---------------------------------------------------------------- series
# kserve_tpu/metrics.py:13-24: the stages of Model.__call__, in
# prometheus_client's default buckets

_DEFAULT_BUCKETS = (.005, .01, .025, .05, .075, .1, .25, .5, .75, 1.0, 2.5,
                    5.0, 7.5, 10.0)
PRE_HIST_TIME = Histogram(
    "request_preprocess_seconds", "pre-process request latency", ["model_name"],
    _DEFAULT_BUCKETS)
POST_HIST_TIME = Histogram(
    "request_postprocess_seconds", "post-process request latency", ["model_name"],
    _DEFAULT_BUCKETS)
PREDICT_HIST_TIME = Histogram(
    "request_predict_seconds", "predict request latency", ["model_name"],
    _DEFAULT_BUCKETS)
EXPLAIN_HIST_TIME = Histogram(
    "request_explain_seconds", "explain request latency", ["model_name"],
    _DEFAULT_BUCKETS)


def get_labels(model_name: str) -> dict:
    return {"model_name": model_name}


# kserve_tpu/metrics.py:27-41 (generative engine), :46-49 (preemptions)

GENERATED_TOKENS = Counter(
    "engine_generated_tokens_total", "decode tokens generated", ["model_name"]
)
PROMPT_TOKENS = Counter(
    "engine_prompt_tokens_total", "prompt tokens prefill-processed", ["model_name"]
)
ENGINE_BATCH_OCCUPANCY = Gauge(
    "engine_batch_occupancy", "active sequences in the decode batch", ["model_name"]
)
ENGINE_QUEUE_DEPTH = Gauge(
    "engine_queue_depth", "requests waiting for admission", ["model_name"]
)
ENGINE_KV_PAGES_FREE = Gauge(
    "engine_kv_pages_free", "free KV cache pages", ["model_name"]
)
ENGINE_WEDGED = Gauge(
    "engine_wedged", "1 once a device fetch blew the step deadline "
    "(liveness fails; pod restart expected)", ["model_name"]
)
ENGINE_PREEMPTIONS = Counter(
    "engine_preemptions_total",
    "sequences preempted back to the queue on KV pressure", ["model_name"],
)

# Resilience and lifecycle layers (kserve_tpu/metrics.py:131-180): load
# shedding and deadline rejections by component (rest | engine), the
# replica's one-hot lifecycle state, drain wall time, and the portable
# checkpoints and resumes with the tokens they carried over.
SHED_REQUESTS = Counter(
    "resilience_shed_requests_total",
    "requests bounced with 429 + Retry-After at admission",
    ["component"],
)
DEADLINE_REJECTED = Counter(
    "resilience_deadline_rejected_total",
    "requests rejected because their propagated deadline had expired",
    ["component"],
)
# per-backend circuit breakers (the graph router's), labelled by state
# only: a backend is a pod ip:port, an unbounded label under churn
BREAKER_TRANSITIONS = Counter(
    "resilience_breaker_transitions_total",
    "circuit breaker state transitions",
    ["state"],
)
# retries beyond a request's first try, per client loop: rest (the
# inference client) and graph (the router's steps)
RETRY_ATTEMPTS = Counter(
    "request_retry_attempts_total",
    "retry attempts issued beyond a request's first try, per client loop",
    ["component"],
)
LIFECYCLE_STATE = Gauge(
    "replica_lifecycle_state",
    "1 for the replica's current lifecycle state "
    "(STARTING/READY/DRAINING/TERMINATING), 0 otherwise",
    ["state"],
)
DRAIN_DURATION = Histogram(
    "lifecycle_drain_duration_seconds",
    "wall time from drain start (SIGTERM / POST /admin/drain) until every "
    "in-flight generation finished or was checkpointed",
    [], buckets=(0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                 1.0, 2.5, 5.0, 7.5, 10.0, float("inf")),
)
GENERATION_CHECKPOINTS = Counter(
    "generation_checkpoints_total",
    "live generations snapshotted into portable checkpoints",
    ["model_name", "reason"],
)
GENERATION_RESUMES = Counter(
    "generation_resumes_total",
    "generations resumed from a checkpoint on this replica",
    ["model_name"],
)
TOKENS_SALVAGED = Counter(
    "generation_tokens_salvaged_total",
    "decoded tokens carried across a drain/preemption via checkpoint "
    "instead of being re-decoded from scratch",
    ["model_name"],
)


def record_breaker_transition(backend: str, state: str) -> None:
    """The BreakerRegistry on_transition hook (kserve_tpu/metrics.py:389);
    `backend` is part of the hook's signature but not a label."""
    BREAKER_TRANSITIONS.labels(state=state).inc()


def set_lifecycle_state(state: str) -> None:
    """One-hot replica_lifecycle_state (kserve_tpu/metrics.py:383)."""
    for s in ("STARTING", "READY", "DRAINING", "TERMINATING"):
        LIFECYCLE_STATE.labels(state=s).set(1.0 if s == state else 0.0)


# Request-lifecycle telemetry (kserve_tpu/metrics.py:221-266).
# Sub-millisecond buckets on ITL because decode steps are ~1-10 ms;
# TTFT/e2e reach minutes because long-prompt prefill + queueing
# legitimately do.  All observations come from the engine's Clock.
_TTFT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, float("inf"),
)
_ITL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, float("inf"),
)
REQUEST_TTFT = Histogram(
    "request_ttft_seconds",
    "time to first token: request received by the engine -> first token "
    "emitted (queue wait included — the client experiences it)",
    ["model_name"], buckets=_TTFT_BUCKETS,
)
REQUEST_ITL = Histogram(
    "request_inter_token_seconds",
    "inter-token latency: gap between consecutive emitted tokens",
    ["model_name"], buckets=_ITL_BUCKETS,
)
REQUEST_QUEUE_WAIT = Histogram(
    "request_queue_wait_seconds",
    "received -> admitted into a decode slot (first admission)",
    ["model_name"], buckets=_TTFT_BUCKETS,
)
REQUEST_E2E = Histogram(
    "request_e2e_seconds",
    "received -> finished (full generation wall time)",
    ["model_name"], buckets=_TTFT_BUCKETS,
)
ENGINE_STEP_DURATION = Histogram(
    "engine_decode_step_seconds",
    "wall time of one decode step: a steps_per_sync-token chunk dispatched "
    "and its tokens fetched",
    ["model_name"], buckets=_ITL_BUCKETS,
)
ENGINE_PREFILL_CHUNK_DURATION = Histogram(
    "engine_prefill_chunk_seconds",
    "wall time of one compiled prefill call (batched admission or one "
    "long-prompt chunk)",
    ["model_name"], buckets=_TTFT_BUCKETS,
)
# Speculative decoding (kserve_tpu/metrics.py:287-298)
SPEC_TOKENS = Counter(
    "engine_spec_tokens_total",
    "speculative-decoding draft tokens by outcome (drafted | accepted | "
    "rejected); bonus target samples are ordinary generated tokens and "
    "are not counted here",
    ["model_name", "outcome"],
)

# Replica startup phases (kserve_tpu/metrics.py:300-316); the port feeds
# `weights` (checkpoint read or random init, and device placement),
# `compile` (on CUDA: building or loading the kernel library, the
# counterpart of the JAX engine's XLA compile) and `ready` (construct ->
# serving).
STARTUP_PHASES = ("trace", "compile", "aot_load", "weights", "ready")
_STARTUP_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, float("inf"),
)
ENGINE_STARTUP = Histogram(
    "engine_startup_seconds",
    "replica startup wall time by phase: trace (jaxpr+lowering), compile "
    "(XLA), aot_load (executable deserialization from the AOT cache), "
    "weights (checkpoint read + device placement), ready (total "
    "construct->serving)",
    ["model_name", "phase"], buckets=_STARTUP_BUCKETS,
)


def observe_startup_phase(model_name: str, phase: str, seconds: float) -> None:
    """Record one engine_startup_seconds observation (phase must be in
    STARTUP_PHASES; anything else is a programming error worth raising)."""
    if phase not in STARTUP_PHASES:
        raise ValueError(f"unknown startup phase {phase!r}")
    ENGINE_STARTUP.labels(model_name=model_name, phase=phase).observe(seconds)


def observe_request_timeline(model_name: str, timeline) -> None:
    """Export one finished RequestTimeline to the histograms
    (observability/timeline.py keeps the ring-buffer/percentile view)."""
    if timeline.queue_wait_s is not None:
        REQUEST_QUEUE_WAIT.labels(model_name=model_name).observe(
            timeline.queue_wait_s)
    if timeline.ttft_s is not None:
        REQUEST_TTFT.labels(model_name=model_name).observe(timeline.ttft_s)
    if timeline.e2e_s is not None:
        REQUEST_E2E.labels(model_name=model_name).observe(timeline.e2e_s)
    itl = REQUEST_ITL.labels(model_name=model_name)
    for gap in timeline.itls:
        itl.observe(gap)


# Hierarchical KV store and the cross-replica page fabric
# (kserve_tpu/metrics.py:64-120).  `tier` and `event` / `outcome` are
# closed sets; peer identity lives in the scheduler state's peer block,
# never in a label.
KV_TIER_EVENTS = Counter(
    "kv_tier_events_total",
    "hierarchical KV store page movements (demote | pagein | drop | "
    "store | corrupt), by tier",
    ["tier", "event"],
)
KV_PREFIX_HIT_TOKENS = Counter(
    "kv_prefix_hit_tokens_total",
    "prompt tokens served from cached prefix pages instead of being "
    "prefilled, by the tier that held them "
    "(hbm | host | disk | persist | peer)",
    ["model_name", "tier"],
)
_PAGE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, float("inf"),
)
KV_PAGEIN_SECONDS = Histogram(
    "kv_pagein_seconds",
    "wall time of one async prefix page-in: tier read scheduled -> pages "
    "uploaded and adopted into the HBM prefix cache",
    ["model_name"], buckets=_PAGE_BUCKETS,
)
KV_PEER_FETCH_TOTAL = Counter(
    "kv_peer_fetch_total",
    "cross-replica KV page fetch attempts by outcome: hit = verified and "
    "adopted, miss = peer answered 404, corrupt = payload failed digest "
    "verification (lying peer — also health evidence), timeout = "
    "transport failure / deadline / retries exhausted, breaker_open = "
    "skipped because the peer's circuit was open",
    ["outcome"],
)
KV_PEER_FETCH_SECONDS = Histogram(
    "kv_peer_fetch_seconds",
    "wall time of one peer page fetch: request issued -> payload "
    "digest-verified (successful fetches only)",
    [], buckets=_PAGE_BUCKETS,
)
KV_PEER_PAGES_SERVED = Counter(
    "kv_peer_pages_served_total",
    "persisted px- pages this replica served to peers over "
    "GET /v1/internal/kv/pages/{digest}",
    [],
)

# Gray-failure fleet health (kserve_tpu/metrics.py:192-216): the endpoint
# picker's health-score distribution and quarantine transitions.  `stat`
# and `transition` are closed sets; replica identity stays out of the
# labels (it rides the picker snapshot and the EPP's /state).
REPLICA_HEALTH_SCORE = Gauge(
    "replica_health_score",
    "fleet health-score distribution at the latest poll (min | median | "
    "max over replicas; per-replica scores live in the EPP /state)",
    ["stat"],
)
QUARANTINE_TRANSITIONS = Counter(
    "replica_quarantine_transitions_total",
    "gray-failure health state transitions "
    "(quarantine | reintroduce | degrade | restore)",
    ["transition"],
)


def record_quarantine_transition(transition: str) -> None:
    """FleetHealth's transition hook; replica identity stays in /state."""
    QUARANTINE_TRANSITIONS.labels(transition=transition).inc()


# The span exporter (tracing.py; the port's own series): spans sent to the
# collector, dropped because the export queue was full, and lost with a
# failed export.
TRACING_SPANS = Counter(
    "tracing_spans_total",
    "finished spans by export outcome (exported | dropped | failed)",
    ["outcome"],
)


# The autoscaler (kserve_tpu/metrics.py:332-355).  `action` and `reason`
# come from the closed ACTIONS / REASONS sets of autoscale/policy.py;
# `signal` is a fixed set of FleetSignals fields; `outcome` the hold
# queue's closed set of ends.  No replica labels: per-replica detail lives
# in the EPP's /state.
AUTOSCALER_DECISIONS = Counter(
    "autoscaler_decisions_total",
    "scaling decisions taken by the EPP-signal autoscaler loop, by action "
    "and policy reason",
    ["action", "reason"],
)
AUTOSCALER_TARGET_REPLICAS = Gauge(
    "autoscaler_target_replicas",
    "replica count the autoscaler currently wants (post-clamp)",
    [],
)
AUTOSCALER_SIGNAL = Gauge(
    "autoscaler_signal",
    "fleet-wide autoscaling signals at the latest decision tick "
    "(ready_replicas | queue_depth | inflight | shed_rate_per_s | "
    "arrival_rate_per_s | held_requests | ttft_p99_s)",
    ["signal"],
)
GATEWAY_HOLDS = Counter(
    "gateway_hold_outcomes_total",
    "zero-window hold-and-replay outcomes at the gateway "
    "(replayed | expired | overflow | failed)",
    ["outcome"],
)
