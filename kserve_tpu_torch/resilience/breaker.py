"""Per-backend circuit breakers: fast failure isolation.

Port of kserve_tpu/resilience/breaker.py (the peer page client keeps one
breaker per peer URL).

Classic three-state machine over a rolling outcome window:

- **closed** — traffic flows; outcomes are recorded.  When the failure
  rate over the last `window` outcomes reaches `failure_threshold` (and
  at least `min_volume` outcomes exist — two early failures must not
  condemn a backend), the breaker opens.
- **open** — traffic is refused locally (`allow()` is False) for
  `open_for_s`; the broken backend gets silence to recover instead of a
  retry storm.
- **half_open** — after the cooldown, a SINGLE probe is admitted per
  cooldown period (`allow()` grants it; concurrent callers are refused,
  and an unreported probe re-grants after another `open_for_s` so a
  dropped probe cannot wedge the state machine).  The first recorded
  success closes the breaker (window reset), the first failure re-opens
  it for another cooldown.

`allow()` consumes the half-open probe and is for the call site that
actually SENDS; pick/candidate filtering must use the non-consuming
`available()` (open = excluded, half-open = eligible) or it would burn
the probe on requests routed elsewhere.

State reads perform the time-based open -> half_open move, so no timer
task is needed and a `FakeClock` makes the whole machine a pure function
of recorded outcomes + advanced time.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Optional

from .clock import MONOTONIC, Clock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# (backend, new_state) -> None; the metrics hook signature
TransitionHook = Callable[[str, str], None]


@dataclass
class BreakerConfig:
    window: int = 20
    failure_threshold: float = 0.5
    min_volume: int = 5
    open_for_s: float = 30.0


class CircuitBreaker:
    def __init__(
        self,
        config: Optional[BreakerConfig] = None,
        clock: Clock = MONOTONIC,
        on_transition: Optional[TransitionHook] = None,
        name: str = "",
    ):
        self.config = config or BreakerConfig()
        self.clock = clock
        self.name = name
        self.on_transition = on_transition
        self._outcomes: Deque[bool] = deque(maxlen=self.config.window)
        self._state = CLOSED
        self._opened_at = 0.0
        self._probe_granted_at: Optional[float] = None

    @property
    def state(self) -> str:
        if (
            self._state == OPEN
            and (self.clock.now() - self._opened_at) >= self.config.open_for_s
        ):
            self._probe_granted_at = None
            self._transition(HALF_OPEN)
        return self._state

    def available(self) -> bool:
        """Non-consuming eligibility read for pick/candidate filtering:
        open = excluded, closed/half-open = eligible."""
        return self.state != OPEN

    def allow(self) -> bool:
        """May a request be SENT to this backend right now?  Open refuses;
        half-open grants one probe per cooldown period — concurrent
        callers are refused so a recovering backend sees one request, not
        a thundering herd of them."""
        st = self.state
        if st == OPEN:
            return False
        if st == HALF_OPEN:
            now = self.clock.now()
            if (
                self._probe_granted_at is not None
                and now - self._probe_granted_at < self.config.open_for_s
            ):
                return False
            self._probe_granted_at = now
        return True

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._outcomes.clear()
            self._probe_granted_at = None
            self._transition(CLOSED)
            return
        self._outcomes.append(True)

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._reopen()
            return
        self._outcomes.append(False)
        if self._state == CLOSED and self._should_open():
            self._reopen()

    def _should_open(self) -> bool:
        n = len(self._outcomes)
        if n < self.config.min_volume:
            return False
        failures = sum(1 for ok in self._outcomes if not ok)
        return failures / n >= self.config.failure_threshold

    def _reopen(self) -> None:
        self._outcomes.clear()
        self._opened_at = self.clock.now()
        self._transition(OPEN)

    def _transition(self, new_state: str) -> None:
        if new_state == self._state:
            return
        self._state = new_state
        if self.on_transition is not None:
            self.on_transition(self.name, new_state)


class BreakerRegistry:
    """Per-backend breakers, created on first sight and keyed by whatever
    backend identifier the caller uses (replica base url, host:port)."""

    def __init__(
        self,
        config: Optional[BreakerConfig] = None,
        clock: Clock = MONOTONIC,
        on_transition: Optional[TransitionHook] = None,
    ):
        self.config = config or BreakerConfig()
        self.clock = clock
        self.on_transition = on_transition
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, backend: str) -> CircuitBreaker:
        breaker = self._breakers.get(backend)
        if breaker is None:
            breaker = CircuitBreaker(
                self.config, self.clock, self.on_transition, name=backend
            )
            self._breakers[backend] = breaker
        return breaker

    def allow(self, backend: str) -> bool:
        return self.get(backend).allow()

    def available(self, backend: str) -> bool:
        return self.get(backend).available()

    def record_success(self, backend: str) -> None:
        self.get(backend).record_success()

    def record_failure(self, backend: str) -> None:
        self.get(backend).record_failure()

    def state(self, backend: str) -> str:
        return self.get(backend).state

    def forget(self, backend: str) -> None:
        """Drop a backend's breaker (pod churn: a recycled ip:port must not
        inherit the dead pod's state, and the registry must not grow
        unboundedly under replica turnover)."""
        self._breakers.pop(backend, None)

    def snapshot(self) -> Dict[str, str]:
        return {name: b.state for name, b in self._breakers.items()}
