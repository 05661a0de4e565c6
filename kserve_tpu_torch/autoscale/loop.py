"""The autoscaler control loop: signals -> policy -> actuation (port of
kserve_tpu/autoscale/loop.py).

`AutoscalerLoop.run()` ticks on an injectable clock: it snapshots the
fleet (`signals_fn`), asks the policy, clamps to [min_replicas,
max_replicas], and actuates when the target moved.  Two properties the
rest of the system depends on:

- **Demand wake**: `notify_demand()` (wired to the hold gateway's
  `on_hold`) interrupts the sleep between ticks, so a request arriving
  into a zero window starts a scale-from-zero the instant it is held,
  not a poll interval later.
- **No swallowed failures**: `run()` lets exceptions escape.  A dead
  autoscaler must be loud, not a fleet frozen at its last size: the CLI
  (`__main__.py`) logs and exits nonzero, so its pod restarts.

Every decision goes to the bounded `decisions` log and to the
reason-labelled `autoscaler_decisions_total`, `autoscaler_target_replicas`
and `autoscaler_signal` series.
"""

from __future__ import annotations

import asyncio
import inspect
from collections import deque
from dataclasses import replace
from typing import Awaitable, Callable, Deque, Optional, Union

from ..logging import logger
from ..metrics import (
    AUTOSCALER_DECISIONS,
    AUTOSCALER_SIGNAL,
    AUTOSCALER_TARGET_REPLICAS,
)
from ..resilience import MONOTONIC, Clock
from .policy import ScalingDecision, ScalingPolicy
from .signals import FleetSignals

SignalsFn = Callable[[], Union[FleetSignals, Awaitable[FleetSignals]]]


class ReplicaActuator:
    """What the loop drives: the current desired count and a way to move
    it.  `scale_to` is awaited inline — an actuation failure is a loop
    failure, not a lost log line."""

    async def current_replicas(self) -> int:
        raise NotImplementedError

    async def scale_to(self, n: int) -> None:
        raise NotImplementedError


class AutoscalerLoop:
    def __init__(
        self,
        policy: ScalingPolicy,
        signals_fn: SignalsFn,
        actuator: ReplicaActuator,
        *,
        clock: Clock = MONOTONIC,
        interval_s: float = 1.0,
        min_replicas: int = 0,
        max_replicas: int = 8,
        decision_log: int = 512,
    ):
        if max_replicas < max(min_replicas, 1):
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas {min_replicas}")
        self.policy = policy
        self.signals_fn = signals_fn
        self.actuator = actuator
        self.clock = clock
        self.interval_s = interval_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.decisions: Deque[ScalingDecision] = deque(maxlen=decision_log)
        self.ticks = 0
        self._stopped = False
        self._wake: Optional[asyncio.Event] = None

    # ---------------- external control ----------------

    def notify_demand(self) -> None:
        """A held request (or any demand source) wants capacity NOW:
        interrupt the inter-tick sleep.  Safe from any coroutine on the
        loop's thread; a no-op before run() starts (the first tick is
        immediate anyway)."""
        if self._wake is not None:
            self._wake.set()

    def stop(self) -> None:
        self._stopped = True
        if self._wake is not None:
            self._wake.set()

    # ---------------- the loop ----------------

    async def run(self) -> None:
        self._wake = asyncio.Event()
        while not self._stopped:
            await self.tick()
            await self._sleep()

    async def tick(self) -> ScalingDecision:
        """One decision cycle (public: a caller may single-step the loop)."""
        signals = self.signals_fn()
        if inspect.isawaitable(signals):
            signals = await signals
        current = await self.actuator.current_replicas()
        decision = self.policy.decide(signals, current)
        clamped = max(self.min_replicas,
                      min(self.max_replicas, decision.target))
        if clamped != decision.target:
            decision = replace(decision, target=clamped)
        self._record(decision)
        if decision.target != current:
            logger.info(
                "autoscaler: %s %d -> %d (%s)", decision.action, current,
                decision.target, decision.reason)
            await self.actuator.scale_to(decision.target)
        self.ticks += 1
        return decision

    def _record(self, decision: ScalingDecision) -> None:
        self.decisions.append(decision)
        AUTOSCALER_DECISIONS.labels(
            action=decision.action, reason=decision.reason).inc()
        AUTOSCALER_TARGET_REPLICAS.set(decision.target)
        s = decision.signals
        g = AUTOSCALER_SIGNAL
        g.labels(signal="ready_replicas").set(s.ready_replicas)
        g.labels(signal="queue_depth").set(s.queue_depth)
        g.labels(signal="inflight").set(s.inflight)
        g.labels(signal="shed_rate_per_s").set(s.shed_rate_per_s)
        g.labels(signal="arrival_rate_per_s").set(s.arrival_rate_per_s)
        g.labels(signal="held_requests").set(s.held_requests)
        if s.ttft_p99_s is not None:
            g.labels(signal="ttft_p99_s").set(s.ttft_p99_s)

    async def _sleep(self) -> None:
        if self._wake.is_set():
            self._wake.clear()
            return  # demand arrived during the tick: go again immediately
        timer = asyncio.ensure_future(self.clock.sleep(self.interval_s))
        waker = asyncio.ensure_future(self._wake.wait())
        try:
            await asyncio.wait({timer, waker},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in (timer, waker):
                if not t.done():
                    t.cancel()
            self._wake.clear()

    # ---------------- introspection ----------------

    def decision_counts(self) -> dict:
        """{"action:reason": n} over the retained decision log."""
        out: dict = {}
        for d in self.decisions:
            key = f"{d.action}:{d.reason}"
            out[key] = out.get(key, 0) + 1
        return out
