"""Model server: registers the models in a `ModelRepository`, starts each
model's engine, then serves them over the standard-library REST server
until a shutdown signal or `request_stop()`.

Port of kserve_tpu/model_server.py (no gRPC; /metrics, /admin/telemetry
and /v1/internal/scheduler/state are routes of the REST server).  Models
with an engine (the generative ones) become ready once it has started; a
predictive `Model` is loaded before the server starts, and the server
refuses to start if no model is ready and none starts an engine
(NoModelReady).  The server owns the replica's `ReplicaLifecycle`
(lifecycle/state.py): STARTING until every engine has started, then
READY.  The first SIGTERM or SIGINT, or a POST /admin/drain, runs
`drain_async`: readiness goes red, new inference is refused with 503,
and every model's drain runs concurrently under the budget of
`begin_drain()` ($KSERVE_TPU_DRAIN_GRACE, 30 s by default), checkpointing
what it cannot finish.  A signal then stops the server once the drain
is done; a second signal escalates, expiring the budget in place
(kserve_tpu/model_server.py:114-118, :178-262).  A watchdog's confirmed
stall starts the same drain.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import threading
from typing import List, Optional

from .errors import NoModelReady
from .lifecycle import GenerationCheckpoint, ReplicaLifecycle
from .model import BaseModel, _maybe_await
from .model_repository import ModelRepository
from .protocol.rest.server import RESTServer

logger = logging.getLogger(__name__)


def _has_engine(model) -> bool:
    """Whether `model` starts an engine (overrides BaseModel.start_engine)."""
    return getattr(type(model), "start_engine", None) not in (
        None, BaseModel.start_engine)


class ModelServer:
    def __init__(self, http_port: int = 8080, host: str = "0.0.0.0",
                 lifecycle: Optional[ReplicaLifecycle] = None):
        self.http_port = http_port
        self.host = host
        self.port: Optional[int] = None  # the bound port once listening
        self.listening = threading.Event()
        self.lifecycle = lifecycle or ReplicaLifecycle()
        self.models: List = []
        self.rest: Optional[RESTServer] = None  # while serving
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._signalled = False
        self._drain_task: Optional[asyncio.Task] = None

    def start(self, models: List) -> None:
        """Serve `models` until stopped (blocks)."""
        asyncio.run(self.serve(models))

    async def serve(self, models: List) -> None:
        self.models = list(models)
        if not any(getattr(m, "ready", False) or _has_engine(m) for m in models) and models:
            raise NoModelReady(self.models)
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._loop.add_signal_handler(sig, self._on_signal)
        repository = ModelRepository(models={m.name: m for m in models})
        rest = self.rest = RESTServer(
            repository, self.host, self.http_port,
            lifecycle=self.lifecycle, on_drain=self.drain_async)
        try:
            for model in models:
                if _has_engine(model):
                    await model.start_engine()
                    self._wire_stall_hook(model)
            self.port = await rest.start()
            self.lifecycle.mark_ready()
            self.listening.set()
            await self._stop.wait()
            if self._drain_task is not None:
                await self._drain_task
        finally:
            await rest.stop()
            for model in models:
                await _maybe_await(model.stop())
            logger.info("model server stopped")

    def _wire_stall_hook(self, model) -> None:
        """A confirmed engine stall flips this replica's readiness red
        (DRAINING); the engine checkpoints its own streams.  Liveness stays
        green, so no kubelet kill loses the checkpoints."""
        engine = getattr(model, "engine", None)
        if engine is None or not hasattr(engine, "on_stall_confirmed"):
            return

        def on_stall(reason: str) -> None:
            logger.error("engine stall confirmed (%s): flipping replica "
                         "readiness (DRAINING)", reason)
            self.lifecycle.begin_drain()

        engine.on_stall_confirmed = on_stall

    async def drain_async(self) -> List[GenerationCheckpoint]:
        """The graceful drain: DRAINING, every model's drain under one
        budget, concurrently (an engine drained later would go on seating
        work while the others spend the budget), then TERMINATING.
        Idempotent: a signal and POST /admin/drain share the budget."""
        deadline = self.lifecycle.begin_drain()
        logger.info("draining replica: budget %.1fs (signal again to escalate)",
                    max(deadline.remaining(), 0.0))
        drains = [m.drain(deadline) for m in self.models
                  if getattr(m, "drain", None) is not None]
        checkpoints: List[GenerationCheckpoint] = []
        for result in await asyncio.gather(*drains):
            checkpoints.extend(result)
        self.lifecycle.finish_drain()
        if checkpoints:
            logger.info("drain complete: %d generation(s) checkpointed for "
                        "resume elsewhere", len(checkpoints))
        return checkpoints

    def _on_signal(self) -> None:
        """The first signal drains, then stops the server; a second one
        escalates: the drain budget expires in place."""
        if not self._signalled:
            self._signalled = True
            self._drain_task = self._loop.create_task(self._drain_then_stop())
        else:
            logger.warning("second shutdown signal: escalating to immediate "
                           "shutdown (drain budget expired in place)")
            self.lifecycle.escalate()

    async def _drain_then_stop(self) -> None:
        try:
            await self.drain_async()
        except Exception:  # noqa: BLE001 — the server must still stop
            logger.exception("graceful drain failed")
        self._stop.set()

    def request_stop(self) -> None:
        """Thread-safe: ask a running `serve` to shut down (no drain)."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
