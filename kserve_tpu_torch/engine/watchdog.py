"""Engine watchdog: gray-failure stall detection inside LLMEngine.

Port of kserve_tpu/engine/watchdog.py.  A gray failure leaves the
replica alive, answering probes and /state, while it has quietly
stopped retiring tokens (a fetch worker stuck below the step deadline, a
thrashing page-in).  Nothing restarts it and every stream seated on it
hangs until the client's deadline.  The engine drives this
clock-injectable monitor:

- **progress**: the engine stamps ``note_progress()`` whenever tokens are
  routed, a prefill chunk advances or a request is seated.  Seated or
  queued work with no progress for ``suspect_after_s`` flips the state
  to ``stall_suspected``; another ``confirm_after_s`` confirms it.
- **fetch-worker liveness**: ``fetch_started()``/``fetch_done()`` bracket
  each device fetch, so a confirmed stall reads ``fetch_stalled`` (the
  worker is stuck mid-fetch) or ``no_progress`` (the loop spins without
  retiring anything).
- **tracked tasks**: page-in and persist tasks alive past
  ``task_stall_s`` are cancelled and counted.

On ``stall_confirmed`` the engine self-drains with checkpoints (reason
"stall"): each stream gets a portable `GenerationCheckpoint`, the engine
refuses admission, the ``on_stall_confirmed`` hook lets the server flip
its ReplicaLifecycle, and the state rides ``scheduler_state()["watchdog"]``
to the endpoint picker.

Off by default (``KSERVE_TPU_WATCHDOG``): a cold start may pause longer
than any useful stall budget.  On CUDA the engine loads the kernel
library and drives one warm-up generation before it reports ready, so the
first served dispatch neither builds nor loads kernels.
"""

from __future__ import annotations

import asyncio
import os
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import logging

from ..resilience import MONOTONIC, Clock

logger = logging.getLogger(__name__)

# the closed state vocabulary exported through scheduler_state()
WATCHDOG_OK = "ok"
WATCHDOG_SUSPECTED = "stall_suspected"
WATCHDOG_CONFIRMED = "stall_confirmed"
WATCHDOG_STATES = (WATCHDOG_OK, WATCHDOG_SUSPECTED, WATCHDOG_CONFIRMED)

WATCHDOG_ENV = "KSERVE_TPU_WATCHDOG"


def watchdog_enabled_from_env(env=None) -> bool:
    env = os.environ if env is None else env
    return str(env.get(WATCHDOG_ENV, "")).strip().lower() in (
        "1", "true", "on", "yes")


@dataclass
class WatchdogConfig:
    """Stall budgets.  suspect + confirm is the detection budget: how
    long a gray replica may hold streams hostage before it self-drains
    and the fleet routes around it."""

    interval_s: float = 0.5  # tick cadence
    suspect_after_s: float = 5.0  # busy + no progress this long -> suspected
    confirm_after_s: float = 5.0  # suspected this long -> confirmed
    task_stall_s: float = 30.0  # tracked async task alive this long -> cancelled
    salvage_grace_s: float = 0.0  # self-drain budget (0 = checkpoint now)


class EngineWatchdog:
    """The monitor object.  Pure state + probes — the engine supplies
    `busy` (seated or queued work exists) and progress/fetch stamps; the
    tick task evaluates on the injected clock, so a test drives detection
    deterministically on a FakeClock."""

    def __init__(
        self,
        config: Optional[WatchdogConfig] = None,
        clock: Clock = MONOTONIC,
        *,
        busy: Callable[[], bool],
        on_confirmed: Callable[[str], None],
        tasks: Optional[Callable[[], Iterable]] = None,
    ):
        self.config = config or WatchdogConfig()
        self._clock = clock
        self._busy = busy
        self._on_confirmed = on_confirmed
        self._tasks = tasks
        self.state = WATCHDOG_OK
        self.reason: Optional[str] = None
        self.suspected_count = 0
        self.confirmed_count = 0
        self.cancelled_tasks = 0
        self._last_progress = clock.now()
        self._suspected_at: Optional[float] = None
        self._fetch_started: Optional[float] = None
        self._task = None
        self._stopped = False

    # ---------------- engine-side stamps ----------------

    def note_progress(self) -> None:
        """Forward motion: tokens routed, a prefill chunk advanced, an
        admission seated.  Clears a suspicion; a CONFIRMED stall is
        terminal for this engine life (the self-drain already ran)."""
        self._last_progress = self._clock.now()
        if self.state == WATCHDOG_SUSPECTED:
            self.state = WATCHDOG_OK
            self.reason = None
            self._suspected_at = None

    def fetch_started(self) -> None:
        self._fetch_started = self._clock.now()

    def fetch_done(self) -> None:
        self._fetch_started = None

    # ---------------- evaluation ----------------

    def _diagnose(self, now: float) -> str:
        if (self._fetch_started is not None
                and now - self._fetch_started >= self.config.suspect_after_s):
            return "fetch_stalled"
        return "no_progress"

    def _reap_stalled_tasks(self, now: float) -> None:
        """Cancel tracked async tasks (page-in / persist write-through)
        alive past the stall budget: they are optimizations whose finally
        blocks release their held requests, so cancellation un-sticks the
        work they pinned."""
        if self._tasks is None:
            return
        for task in list(self._tasks()):
            started = getattr(task, "_wd_started_s", None)
            if (started is not None and not task.done()
                    and now - started >= self.config.task_stall_s):
                task.cancel()
                self.cancelled_tasks += 1
                logger.warning(
                    "watchdog cancelled a stalled engine task "
                    "(alive %.1fs > budget %.1fs)",
                    now - started, self.config.task_stall_s)

    def tick(self) -> None:
        now = self._clock.now()
        self._reap_stalled_tasks(now)
        if self.state == WATCHDOG_CONFIRMED:
            return  # terminal: the self-drain already fired
        if not self._busy():
            # idle is not a stall; keep the baseline fresh so the first
            # seated request starts a clean window
            self._last_progress = now
            if self.state == WATCHDOG_SUSPECTED:
                self.state = WATCHDOG_OK
                self.reason = None
                self._suspected_at = None
            return
        stalled_for = now - self._last_progress
        if stalled_for < self.config.suspect_after_s:
            if self.state == WATCHDOG_SUSPECTED:
                self.state = WATCHDOG_OK
                self.reason = None
                self._suspected_at = None
            return
        if self.state == WATCHDOG_OK:
            self.state = WATCHDOG_SUSPECTED
            self._suspected_at = now
            self.reason = self._diagnose(now)
            self.suspected_count += 1
            logger.warning(
                "watchdog: stall suspected (%s; %.2fs without progress, "
                "work seated)", self.reason, stalled_for)
            return
        if now - self._suspected_at >= self.config.confirm_after_s:
            self.state = WATCHDOG_CONFIRMED
            self.reason = self._diagnose(now)
            self.confirmed_count += 1
            logger.error(
                "watchdog: stall CONFIRMED (%s; %.2fs without progress) — "
                "flipping readiness and self-draining with checkpoints",
                self.reason, stalled_for)
            try:
                self._on_confirmed(self.reason)
            except Exception:  # noqa: BLE001 — the monitor must survive a
                # broken handler; the state is already exported via /state
                logger.exception("watchdog on_confirmed handler failed")

    def snapshot(self) -> dict:
        """The structured block scheduler_state() exports (consumed by
        the EPP's fleet health scoring and /state observers)."""
        return {
            "state": self.state,
            "reason": self.reason,
            "suspected_total": self.suspected_count,
            "confirmed_total": self.confirmed_count,
            "cancelled_tasks_total": self.cancelled_tasks,
        }

    # ---------------- the tick task ----------------

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._stopped = False
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._stopped:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a monitor crash must never
                # take the engine with it (and must keep monitoring)
                logger.exception("watchdog tick failed")
            await self._clock.sleep(self.config.interval_s)

    def stop(self) -> None:
        """Cancel the tick task (a live watchdog sleeps and ticks again
        every interval forever)."""
        self._stopped = True
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = None
