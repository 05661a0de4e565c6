"""Scaling policies: every replica-count decision, explained (port of
kserve_tpu/autoscale/policy.py, pure Python).

Two policies behind one `ScalingPolicy` interface:

- `ReactivePolicy`: threshold scaling on the serving-native signals
  (queue depth per ready replica, shed rate, TTFT p99 against an SLO)
  with a hysteresis band (`queue_high` to scale up, the lower
  `queue_low` to step down), a cooldown per direction, and scale-to-zero
  after a sustained idle window.  A wake from zero on held demand
  bypasses the up cooldown: a parked request never waits out a timer.
- `PredictivePolicy`: wraps a ReactivePolicy and *prewarms*: an arrival
  rate accelerating past a threshold buys capacity before the queue
  exists (burst slope), and a `PeriodicDetector` that learns recurring
  burst onsets prewarms a pool shortly before the next predicted one.

Every `decide()` returns a `ScalingDecision` whose `reason` comes from
the closed `REASONS` set, the label of `autoscaler_decisions_total`.

The policies read no clock: all time comes from `FleetSignals.at_s`, so
a decision is a pure function of the snapshot stream.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

from .signals import FleetSignals

# the closed decision vocabulary (metrics label + report key + docs)
REASONS = (
    "queue_depth",  # queue per ready replica past the high watermark
    "shed_rate",  # fleet is bouncing 429s
    "ttft_slo",  # TTFT p99 window past the SLO target
    "hold_demand",  # demand at zero: held/queued work with nothing ready
    "burst_slope",  # arrival rate accelerating (predictive)
    "periodic_prewarm",  # learned recurring burst imminent (predictive)
    "low_load",  # load fell below the low watermark: step down
    "idle_zero",  # sustained zero demand: scale to zero
    "cooldown",  # a move was wanted but its cooldown gate held
    "steady",  # nothing to do
)

ACTIONS = ("scale_up", "scale_down", "hold")


@dataclass(frozen=True)
class ScalingDecision:
    """One tick's verdict: what the policy wants and why.  `target` is
    pre-clamp (the loop applies min/max bounds and records the clamped
    value it actuates)."""

    at_s: float
    current: int
    target: int
    reason: str
    signals: FleetSignals

    def __post_init__(self):
        if self.reason not in REASONS:
            raise ValueError(f"unknown scaling reason {self.reason!r}")

    @property
    def action(self) -> str:
        if self.target > self.current:
            return "scale_up"
        if self.target < self.current:
            return "scale_down"
        return "hold"

    def to_dict(self) -> dict:
        return {
            "at_s": self.at_s,
            "current": self.current,
            "target": self.target,
            "action": self.action,
            "reason": self.reason,
        }


class ScalingPolicy:
    """The interface: one snapshot in, one explained decision out.
    Implementations may keep state (cooldown stamps, learned patterns)
    but must derive all time from `signals.at_s`."""

    def decide(self, signals: FleetSignals, current: int) -> ScalingDecision:
        raise NotImplementedError


@dataclass
class ReactiveConfig:
    """Thresholds for `ReactivePolicy` (the JAX package's defaults, which
    its fleet simulator validated)."""

    # hysteresis band on load (queue + seated work) per ready replica:
    # scale up above high, step down only below the (lower) low mark
    queue_high_per_replica: float = 6.0
    queue_low_per_replica: float = 1.0
    shed_rate_up_per_s: float = 0.2  # any sustained shedding buys capacity
    ttft_p99_slo_s: Optional[float] = None  # None disables the TTFT trigger
    idle_to_zero_s: float = 10.0  # sustained zero demand before 0
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 8.0
    max_step_up: int = 2  # cap replicas added per decision


class ReactivePolicy(ScalingPolicy):
    def __init__(self, config: Optional[ReactiveConfig] = None):
        self.config = config or ReactiveConfig()
        self._last_up_at: Optional[float] = None
        self._last_down_at: Optional[float] = None
        self._idle_since: Optional[float] = None

    # predictive prewarms count as scale-ups for cooldown purposes
    def note_scale_up(self, at_s: float) -> None:
        self._last_up_at = at_s

    def _cooled(self, last: Optional[float], cooldown_s: float,
                now: float) -> bool:
        return last is None or (now - last) >= cooldown_s

    def decide(self, signals: FleetSignals, current: int) -> ScalingDecision:
        cfg = self.config
        now = signals.at_s
        if signals.demand:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now

        def done(target: int, reason: str) -> ScalingDecision:
            if target > current:
                self._last_up_at = now
            elif target < current:
                self._last_down_at = now
            return ScalingDecision(
                at_s=now, current=current, target=target, reason=reason,
                signals=signals)

        # -------- wake from zero: held demand bypasses every cooldown
        if current == 0 or signals.ready_replicas == 0:
            if signals.demand:
                backlog = signals.held_requests + signals.queue_depth
                want = max(1, math.ceil(
                    backlog / max(cfg.queue_high_per_replica, 1.0)))
                return done(max(current, want), "hold_demand")
            if current == 0:
                return done(0, "steady")
            # replicas exist but none ready yet (starting): hold
            return done(current, "steady")

        ready = signals.ready_replicas
        load = signals.queue_depth + signals.inflight
        load_per_ready = load / ready

        # -------- scale up (priority: shed > ttft > queue)
        up_reason = None
        if signals.shed_rate_per_s > cfg.shed_rate_up_per_s:
            up_reason = "shed_rate"
        elif (cfg.ttft_p99_slo_s is not None
              and signals.ttft_p99_s is not None
              and signals.ttft_p99_s > cfg.ttft_p99_slo_s):
            up_reason = "ttft_slo"
        elif signals.queue_depth / ready > cfg.queue_high_per_replica:
            up_reason = "queue_depth"
        if up_reason is not None:
            if not self._cooled(self._last_up_at, cfg.up_cooldown_s, now):
                return done(current, "cooldown")
            step = min(
                cfg.max_step_up,
                max(1, math.ceil(
                    signals.queue_depth
                    / max(cfg.queue_high_per_replica * ready, 1.0)) - 1),
            )
            return done(current + max(step, 1), up_reason)

        # -------- scale to zero after a sustained idle window
        if (self._idle_since is not None
                and now - self._idle_since >= cfg.idle_to_zero_s):
            if not self._cooled(self._last_down_at, cfg.down_cooldown_s, now):
                return done(current, "cooldown")
            return done(0, "idle_zero")

        # -------- step down inside the hysteresis band
        if current > 1 and load_per_ready < cfg.queue_low_per_replica:
            if not self._cooled(self._last_down_at, cfg.down_cooldown_s, now):
                return done(current, "cooldown")
            return done(current - 1, "low_load")

        return done(current, "steady")


@dataclass
class PredictiveConfig:
    """Prewarming knobs for `PredictivePolicy` (wraps a ReactiveConfig)."""

    # arrival acceleration (req/s^2 over slope_window_s) that buys capacity
    # before the queue exists
    slope_up_per_s2: float = 1.0
    slope_prewarm_replicas: int = 1  # extra replicas per slope trigger
    # periodic learner: an instantaneous arrival rate past this marks a
    # burst onset; >= min_intervals consistent gaps predict the next one
    burst_rate_per_s: float = 10.0
    min_period_s: float = 10.0
    period_tolerance_frac: float = 0.2
    min_intervals: int = 2
    prewarm_lead_s: float = 5.0  # start prewarming this early
    prewarm_hold_s: float = 10.0  # keep the pool past the predicted onset
    prewarm_replicas: int = 2  # pool size ready at the predicted burst
    max_onsets: int = 16  # burst history bound


class PeriodicDetector:
    """Learns recurring burst onsets from the instantaneous arrival rate.

    An onset is recorded when the rate crosses `burst_rate_per_s` from
    below; the burst ends once the rate falls under half the threshold
    (hysteresis so one burst logs one onset).  When the last
    `min_intervals` onset gaps agree within `period_tolerance_frac`, the
    next onset is predicted at `last + mean(gap)` — time-of-day/periodic
    prewarming learned online, no offline profile."""

    def __init__(self, config: PredictiveConfig):
        self.config = config
        self.onsets: List[float] = []
        self._in_burst = False

    def observe(self, at_s: float, rate_per_s: float) -> None:
        cfg = self.config
        if not self._in_burst and rate_per_s >= cfg.burst_rate_per_s:
            self._in_burst = True
            if not self.onsets or at_s - self.onsets[-1] >= cfg.min_period_s:
                self.onsets.append(at_s)
                del self.onsets[:-cfg.max_onsets]
        elif self._in_burst and rate_per_s < cfg.burst_rate_per_s / 2.0:
            self._in_burst = False

    def predict_next(self) -> Optional[float]:
        cfg = self.config
        need = cfg.min_intervals + 1
        if len(self.onsets) < need:
            return None
        recent = self.onsets[-need:]
        gaps = [b - a for a, b in zip(recent, recent[1:])]
        mean = sum(gaps) / len(gaps)
        if mean < cfg.min_period_s:
            return None
        if any(abs(g - mean) > cfg.period_tolerance_frac * mean
               for g in gaps):
            return None
        return self.onsets[-1] + mean


@dataclass
class PredictivePolicy(ScalingPolicy):
    """Reactive scaling plus prewarming.  The reactive verdict is the
    floor — prediction only ever *adds* capacity (monotone max), so a
    wrong prediction costs warm-replica-minutes, never availability."""

    reactive: ReactivePolicy = field(default_factory=ReactivePolicy)
    config: PredictiveConfig = field(default_factory=PredictiveConfig)

    def __post_init__(self):
        self.detector = PeriodicDetector(self.config)

    def decide(self, signals: FleetSignals, current: int) -> ScalingDecision:
        cfg = self.config
        now = signals.at_s
        self.detector.observe(now, signals.arrival_rate_per_s)
        base = self.reactive.decide(signals, current)
        target, reason = base.target, base.reason

        predicted = self.detector.predict_next()
        if (predicted is not None
                and predicted - cfg.prewarm_lead_s
                <= now
                <= predicted + cfg.prewarm_hold_s):
            if cfg.prewarm_replicas > target:
                target, reason = cfg.prewarm_replicas, "periodic_prewarm"
        elif (signals.arrival_slope_per_s2 > cfg.slope_up_per_s2
              and current + cfg.slope_prewarm_replicas > target):
            target = current + cfg.slope_prewarm_replicas
            reason = "burst_slope"

        if target == base.target:
            return base
        if target > current:
            # a prewarm is a scale-up for cooldown bookkeeping too
            self.reactive.note_scale_up(now)
        return replace(base, target=target, reason=reason)
