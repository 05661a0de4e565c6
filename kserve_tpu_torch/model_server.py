"""Model server: starts each model's engine, then serves them over the
standard-library REST server until SIGINT/SIGTERM or `request_stop()`.

Port of the generative part of kserve_tpu/model_server.py (no gRPC and
no lifecycle drain yet; /metrics and /admin/telemetry are routes of the
REST server)."""

from __future__ import annotations

import asyncio
import logging
import signal
import threading
from typing import List, Optional

from .protocol.rest.server import RESTServer

logger = logging.getLogger(__name__)


class ModelServer:
    def __init__(self, http_port: int = 8080, host: str = "0.0.0.0"):
        self.http_port = http_port
        self.host = host
        self.port: Optional[int] = None  # the bound port once listening
        self.listening = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None

    def start(self, models: List) -> None:
        """Serve `models` until stopped (blocks)."""
        asyncio.run(self.serve(models))

    async def serve(self, models: List) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._loop.add_signal_handler(sig, self._stop.set)
        rest = RESTServer({m.name: m for m in models}, self.host, self.http_port)
        try:
            for model in models:
                await model.start_engine()
            self.port = await rest.start()
            self.listening.set()
            await self._stop.wait()
        finally:
            await rest.stop()
            for model in models:
                await model.stop()
            logger.info("model server stopped")

    def request_stop(self) -> None:
        """Thread-safe: ask a running `serve` to shut down."""
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
