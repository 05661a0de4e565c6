"""On-demand profiling: `POST /admin/profile` (port of kserve_tpu/
observability/introspection.py:41-154; `GET /admin/telemetry` is
RESTServer._telemetry).

A `ProfilerSession` captures `torch.profiler` for N seconds (CPU
activity, plus CUDA activity when the server has an engine on a CUDA
device) and writes the capture as a Chrome trace (`trace.json`) into a
directory of its own under $KSERVE_TPU_PROFILE_DIR, or under the `dir` of
the request's body.  The route answers 202 with the target, 409 while a
capture runs (the profiler is one per process, so two servers of one
process share the busy state), 400 for `seconds` outside (0, 300], and
501 only when the build has no profiler or cannot start it.

The capture runs on a thread of its own, which starts the profiler,
sleeps the N seconds, stops it and writes the trace: the serving loop,
the thread the engine dispatches from, does not wait for torch.profiler
as a whole (its first start initialises CUPTI and can take seconds, its
stop collects every event), only while the profiler holds the GIL, which
the stop's collection can do for a second or more at a time.  The route
answers once the profiler has started.  torch.profiler records CPU operators on the thread that
started it only, so a capture holds the CUDA kernels of every thread of
the process and none of the serving loop's CPU operators; the answer's
`cpu_ops` says so.
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "KSERVE_TPU_PROFILE_DIR"
DEFAULT_PROFILE_DIR = "/tmp/kserve-tpu-profiles"
MAX_PROFILE_SECONDS = 300.0
TRACE_FILE = "trace.json"

# the session whose capture holds the process's profiler, if any
_holder: Optional["ProfilerSession"] = None


class ProfilerBusyError(RuntimeError):
    """A capture is already in flight (maps to HTTP 409)."""


class ProfilerSession:
    """One-at-a-time torch.profiler capture.  `cuda()` says whether to
    record CUDA activity too."""

    def __init__(self, cuda: Callable[[], bool] = lambda: False):
        self._default_dir = os.environ.get(PROFILE_DIR_ENV, DEFAULT_PROFILE_DIR)
        self._cuda = cuda
        self._thread: Optional[threading.Thread] = None
        self._current: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def status(self) -> dict:
        # the capture thread replaces the dict whole, never edits it
        return {"active": self.active, "capture": self._current}

    async def start(self, seconds: float, out_dir: Optional[str] = None) -> dict:
        """Start a capture of `seconds`; returns once the profiler runs."""
        global _holder
        if not (0 < seconds <= MAX_PROFILE_SECONDS):
            raise ValueError(f"profile seconds must be in (0, {MAX_PROFILE_SECONDS:g}]")
        if _holder is not None and _holder.active:
            raise ProfilerBusyError(
                f"profile capture already running: {_holder._current}")
        from torch import profiler

        target = os.path.join(out_dir or self._default_dir,
                              time.strftime("trace-%Y%m%d-%H%M%S", time.gmtime()))
        n, base = 1, target
        while os.path.exists(target):
            n += 1
            target = f"{base}-{n}"
        os.makedirs(target)
        activities = [profiler.ProfilerActivity.CPU]
        if self._cuda():
            activities.append(profiler.ProfilerActivity.CUDA)
        current = {"dir": target, "trace": os.path.join(target, TRACE_FILE),
                   "seconds": seconds, "activities": [a.name for a in activities],
                   "cpu_ops": "the capture thread's only", "done": False}
        loop = asyncio.get_running_loop()
        started = loop.create_future()
        self._current = current
        self._thread = threading.Thread(
            target=self._capture, name="profiler-capture", daemon=True,
            args=(profiler.profile(activities=activities), current, loop, started))
        # busy from here: a second call while this one starts gets 409
        _holder = self
        self._thread.start()
        await started
        logger.info("profiler capture started: %s (%.3gs, %s)", target, seconds,
                    current["activities"])
        return dict(self._current)

    def _capture(self, prof, current: dict, loop, started) -> None:
        """The capture thread: start, sleep, stop, write the trace."""
        def settle(exc: Optional[BaseException]) -> None:
            if not started.done():
                if exc is None:
                    started.set_result(None)
                else:
                    started.set_exception(exc)

        t0 = time.perf_counter()
        try:
            prof.start()
        except Exception as exc:  # noqa: BLE001 — the route maps it to 501
            loop.call_soon_threadsafe(settle, exc)
            return
        # what the capture costs: the start and the stop, on this thread
        current = self._current = dict(current, start_s=time.perf_counter() - t0)
        loop.call_soon_threadsafe(settle, None)
        time.sleep(current["seconds"])
        try:
            t1 = time.perf_counter()
            prof.stop()
            t2 = time.perf_counter()
            prof.export_chrome_trace(current["trace"])
            self._current = dict(current, stop_s=t2 - t1,
                                 export_s=time.perf_counter() - t2, done=True)
            logger.info("profiler capture written: %s", current["trace"])
        except (RuntimeError, OSError) as exc:
            # the capture is over either way; only the file may be missing
            self._current = dict(current, error=str(exc))
            logger.warning("profiler capture failed: %s", exc)


async def profile_route(profiler: ProfilerSession, body: bytes):
    """(status, payload) of POST /admin/profile with a JSON body
    {"seconds": s, "dir": d}, both optional (2 s, the default dir)."""
    import json

    try:
        payload = json.loads(body) if body else {}
    except ValueError:
        payload = {}
    if not isinstance(payload, dict):
        payload = {}
    try:
        seconds = float(payload.get("seconds", 2.0))
    except (TypeError, ValueError):
        return 400, {"error": "seconds must be a number"}
    try:
        info = await profiler.start(seconds, out_dir=payload.get("dir"))
    except ProfilerBusyError as e:
        return 409, {"error": str(e)}
    except ValueError as e:
        return 400, {"error": str(e)}
    except (ImportError, RuntimeError, OSError) as e:
        # no profiler in this build / unwritable dir: best-effort tooling
        return 501, {"error": str(e)}
    return 202, info
