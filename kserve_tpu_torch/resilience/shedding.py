"""Admission-time load shedding (port of kserve_tpu/resilience/
shedding.py, without its aiohttp middleware: the port's REST server runs
the same gate itself).

Past a queue watermark new inference work is refused at the door with
429 + `Retry-After`, instead of being queued into latency that blows
every deadline behind it.  A hysteresis band (shed at the watermark,
resume at `resume_fraction` x watermark) keeps it from flapping.  Only
inference POSTs are shed: probes, metrics and listings keep answering.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class ShedConfig:
    # depth at which new inference POSTs start bouncing; <= 0 disables
    queue_watermark: int = 256
    # stop shedding once depth falls to watermark * resume_fraction
    resume_fraction: float = 0.75
    # the Retry-After hint handed to shed clients
    retry_after_s: float = 1.0

    @classmethod
    def from_env(cls, env=None) -> "ShedConfig":
        env = os.environ if env is None else env
        return cls(
            queue_watermark=int(env.get("KSERVE_TPU_SHED_WATERMARK", "256")),
            resume_fraction=float(
                env.get("KSERVE_TPU_SHED_RESUME_FRACTION", "0.75")),
            retry_after_s=float(env.get("KSERVE_TPU_SHED_RETRY_AFTER_S", "1.0")),
        )


class LoadShedder:
    """Hysteresis watermark over a queue depth the caller supplies."""

    def __init__(self, config: Optional[ShedConfig] = None,
                 on_shed: Optional[Callable[[], None]] = None):
        self.config = config or ShedConfig()
        self.on_shed = on_shed
        self._shedding = False
        self.shed_count = 0

    @property
    def enabled(self) -> bool:
        return self.config.queue_watermark > 0

    @property
    def shedding(self) -> bool:
        return self._shedding

    @property
    def retry_after_s(self) -> float:
        return self.config.retry_after_s

    def should_shed(self, depth: int) -> bool:
        """The admission decision for one request at queue depth `depth`."""
        if not self.enabled:
            return False
        if self._shedding:
            if depth <= self.config.queue_watermark * self.config.resume_fraction:
                self._shedding = False
        elif depth >= self.config.queue_watermark:
            self._shedding = True
        if self._shedding:
            self.shed_count += 1
            if self.on_shed is not None:
                self.on_shed()
        return self._shedding


def is_inference_path(path: str) -> bool:
    """POST paths that enqueue model work (v1 predict/explain, v2 infer,
    the OpenAI heads, timeseries forecast, P/D prefill).  Admin POSTs, the
    very actions that heal an overload, are never shed."""
    return (
        ":predict" in path
        or ":explain" in path
        or path.endswith("/infer")
        or path.startswith("/openai/")
        or path.startswith("/v1/timeseries/")
        or path.startswith("/v1/prefill/")
    )
