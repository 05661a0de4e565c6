"""Bounded hold-and-replay queue: the zero-window gateway primitive (port
of kserve_tpu/autoscale/hold.py).

A request that arrives while the fleet is scaled to zero is *held*:
registering with the queue signals demand (the `on_hold` hook wakes the
autoscaler at once), and the caller parks until a backend is ready, then
replays.  The queue is bounded and deadline-aware:

- a hold whose request deadline (or the default hold budget) expires is
  woken with `HoldExpiredError`; the gateway answers **504**;
- a hold arriving at a full queue first evicts holds already expired;
  if the queue is still full it is refused with `HoldOverflowError`
  (**503 + Retry-After**);
- `release_all()` wakes every waiter in arrival order (FIFO replay);
  `fail_all(exc)` hands a wake failure to every waiter at once, so a
  dead backend fails N holds in one pass, not N timeouts.

The clock is injectable: the activator runs it on real time, tests on a
`FakeClock`, where holding, expiry and replay order are a pure function
of virtual time.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Callable, Dict, Optional, Tuple

from ..resilience import MONOTONIC, Clock, Deadline


class HoldExpiredError(TimeoutError):
    """The hold outlived its deadline before a backend came up (-> 504)."""


class HoldOverflowError(RuntimeError):
    """The hold queue is full of live holds (-> 503 + Retry-After)."""

    def __init__(self, retry_after_s: float):
        super().__init__(
            f"hold queue full; retry after {retry_after_s:g}s")
        self.retry_after_s = retry_after_s


class HoldQueue:
    def __init__(
        self,
        clock: Clock = MONOTONIC,
        max_holds: int = 512,
        default_hold_s: float = 120.0,
        retry_after_s: float = 1.0,
        on_hold: Optional[Callable[[], None]] = None,
    ):
        self.clock = clock
        self.max_holds = max_holds
        self.default_hold_s = default_hold_s
        self.retry_after_s = retry_after_s
        # demand signal: fired on every accepted hold (the autoscaler's
        # notify_demand — a parked request must not wait out a poll tick)
        self.on_hold = on_hold
        self._seq = itertools.count()
        # insertion-ordered: release_all wakes in arrival order (FIFO)
        self._holds: Dict[int, Tuple[float, asyncio.Future]] = {}
        self.stats = {"held": 0, "replayed": 0, "expired": 0, "overflow": 0,
                      "failed": 0}

    @property
    def held(self) -> int:
        return len(self._holds)

    def _evict_expired(self) -> None:
        now = self.clock.now()
        for key, (expires_at, fut) in list(self._holds.items()):
            if expires_at <= now and not fut.done():
                fut.set_exception(HoldExpiredError(
                    "hold expired before the backend became ready"))
                # the waiter wakes and pops itself; drop our entry now so
                # capacity frees immediately for the newcomer
                self._holds.pop(key, None)

    async def hold(self, deadline: Optional[Deadline] = None) -> None:
        """Park until released (returns None -> replay), or raise
        HoldExpiredError / HoldOverflowError / the fail_all exception."""
        budget = self.default_hold_s
        if deadline is not None:
            budget = min(budget, deadline.remaining())
        if budget <= 0:
            self.stats["expired"] += 1
            raise HoldExpiredError("request deadline already expired")
        if len(self._holds) >= self.max_holds:
            self._evict_expired()
            if len(self._holds) >= self.max_holds:
                self.stats["overflow"] += 1
                raise HoldOverflowError(self.retry_after_s)
        expires_at = self.clock.now() + budget
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        key = next(self._seq)
        self._holds[key] = (expires_at, fut)
        self.stats["held"] += 1
        if self.on_hold is not None:
            self.on_hold()
        timer = asyncio.ensure_future(self.clock.sleep(budget))
        try:
            await asyncio.wait({fut, timer},
                               return_when=asyncio.FIRST_COMPLETED)
            if fut.done():
                try:
                    fut.result()  # raises the fail_all/eviction exception
                except HoldExpiredError:
                    self.stats["expired"] += 1
                    raise
                except BaseException:
                    self.stats["failed"] += 1
                    raise
                self.stats["replayed"] += 1
                return
            self.stats["expired"] += 1
            raise HoldExpiredError(
                "hold expired before the backend became ready")
        finally:
            self._holds.pop(key, None)
            if not timer.done():
                timer.cancel()
            if not fut.done():
                fut.cancel()

    def release_all(self) -> int:
        """Wake every waiter for replay, in arrival order.  Returns the
        number released."""
        n = 0
        for key, (_, fut) in list(self._holds.items()):
            if not fut.done():
                fut.set_result(None)
                n += 1
            self._holds.pop(key, None)
        return n

    def fail_all(self, exc: BaseException) -> int:
        """Fail every waiter with `exc` (a wake that timed out / errored):
        one dead backend fails N holds in one pass."""
        n = 0
        for key, (_, fut) in list(self._holds.items()):
            if not fut.done():
                fut.set_exception(exc)
                n += 1
            self._holds.pop(key, None)
        return n
