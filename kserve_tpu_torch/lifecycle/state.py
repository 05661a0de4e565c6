"""Replica lifecycle state machine: STARTING -> READY -> DRAINING ->
TERMINATING.

Port of kserve_tpu/lifecycle/state.py.  One object per serving process,
owned by the ModelServer and read by the REST server's admission gate,
the readiness probe and the scheduler-state endpoint:

- READY        accepting traffic; readiness green.
- DRAINING     SIGTERM (or POST /admin/drain) arrived: readiness red so the
               endpoint controller stops routing here, liveness green so
               kubelet does not kill the drain, new inference refused with
               503 + Retry-After, in-flight requests get the drain budget.
- TERMINATING  the budget expired (the leftovers were checkpointed) or a
               second signal escalated; the process is exiting.

Transitions are forward-only and idempotent: a second drain request gets
the budget already running, and a second SIGTERM escalates by EXPIRING
that budget in place (`escalate()`), which every drain loop polls.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

from ..metrics import DRAIN_DURATION, set_lifecycle_state
from ..resilience import MONOTONIC, Clock, Deadline

STARTING = "STARTING"
READY = "READY"
DRAINING = "DRAINING"
TERMINATING = "TERMINATING"
STATES = (STARTING, READY, DRAINING, TERMINATING)

# the drain budget: seconds an in-flight generation may keep decoding after
# SIGTERM before it is checkpointed
DRAIN_GRACE_ENV = "KSERVE_TPU_DRAIN_GRACE"
DEFAULT_DRAIN_GRACE_S = 30.0


def normalize_drain_grace(value) -> Optional[float]:
    """One candidate drain-grace value as seconds, or None when it must not
    be used: float() takes 'inf' and 'nan', but a non-finite or negative
    budget is a deadline that never expires, so nothing in flight would
    ever be checkpointed before kubelet's SIGKILL."""
    try:
        grace = float(value)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(grace) or grace < 0:
        return None
    return grace


def drain_grace_from_env(env=None) -> float:
    env = os.environ if env is None else env
    grace = normalize_drain_grace(env.get(DRAIN_GRACE_ENV, DEFAULT_DRAIN_GRACE_S))
    return DEFAULT_DRAIN_GRACE_S if grace is None else grace


class ReplicaDrainingError(RuntimeError):
    """New work refused because this replica is draining or stopped: 503
    + Retry-After at the protocol layer, so the client's retry lands on a
    healthy replica."""

    def __init__(self, detail: str = "replica is draining; retry another replica",
                 retry_after_s: float = 1.0):
        super().__init__(detail)
        self.retry_after_s = retry_after_s


class ReplicaLifecycle:
    """The replica's lifecycle state and drain budget, on an injectable
    clock (tests drive drains on a FakeClock)."""

    def __init__(self, clock: Clock = MONOTONIC,
                 drain_grace_s: Optional[float] = None,
                 on_transition: Optional[Callable[[str], None]] = None):
        self.clock = clock
        self.drain_grace_s = (drain_grace_from_env() if drain_grace_s is None
                              else float(drain_grace_s))
        self.on_transition = on_transition
        self._state = STARTING
        self._drain_deadline: Optional[Deadline] = None
        self._drain_started: Optional[float] = None
        set_lifecycle_state(STARTING)

    @property
    def state(self) -> str:
        return self._state

    @property
    def ready(self) -> bool:
        """Readiness: red unless READY (a draining replica leaves the
        endpoint set while its liveness stays green)."""
        return self._state == READY

    @property
    def accepting(self) -> bool:
        """Admission: closed once draining begins (STARTING admits: model
        readiness gates that phase)."""
        return self._state in (STARTING, READY)

    @property
    def drain_deadline(self) -> Optional[Deadline]:
        """The running drain budget (None before a drain)."""
        return self._drain_deadline

    def _to(self, state: str) -> None:
        if STATES.index(state) <= STATES.index(self._state):
            return  # forward-only, idempotent
        self._state = state
        set_lifecycle_state(state)
        if self.on_transition is not None:
            self.on_transition(state)

    def mark_ready(self) -> None:
        self._to(READY)

    def begin_drain(self, grace_s: Optional[float] = None) -> Deadline:
        """Flip to DRAINING and start the drain budget; idempotent (a
        SIGTERM and a POST /admin/drain share one budget).  Returns the
        budget every engine drain loop honours."""
        if self._drain_deadline is not None:
            self._to(DRAINING)
            return self._drain_deadline
        grace = self.drain_grace_s if grace_s is None else float(grace_s)
        self._drain_started = self.clock.now()
        self._drain_deadline = Deadline.after(grace, self.clock)
        self._to(DRAINING)
        return self._drain_deadline

    def escalate(self) -> None:
        """Second SIGTERM: expire the drain budget in place (in-flight
        generations checkpoint on the drain loop's next poll) and go to
        TERMINATING."""
        if self._drain_deadline is not None:
            self._drain_deadline.expires_at = self.clock.now()
        else:
            self._drain_deadline = Deadline.after(0.0, self.clock)
        self._to(TERMINATING)

    def finish_drain(self) -> None:
        """Every in-flight generation finished or was checkpointed: record
        the drain's duration and settle in TERMINATING."""
        if self._drain_started is not None:
            DRAIN_DURATION.observe(max(self.clock.now() - self._drain_started, 0.0))
            self._drain_started = None
        self._to(TERMINATING)
