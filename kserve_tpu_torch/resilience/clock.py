"""Injectable monotonic clock.

Port of kserve_tpu/resilience/clock.py.  The KV tier store, request
deadlines, the replica lifecycle's drain budget, the engine's timelines
and its watchdog read a `Clock`, so a test can advance a `FakeClock`
instead of sleeping.
"""

from __future__ import annotations

import asyncio
import time
from typing import List


class Clock:
    """Real monotonic time and asyncio sleep (the default)."""

    def now(self) -> float:
        return time.monotonic()

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for tests: `sleep` advances virtual time at
    once (one event-loop yield), and `advance` moves it without an await."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self.sleeps: List[float] = []  # every sleep requested, in order

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds

    async def sleep(self, seconds: float) -> None:
        self.sleeps.append(seconds)
        self._now += max(seconds, 0.0)
        await asyncio.sleep(0)


MONOTONIC = Clock()
