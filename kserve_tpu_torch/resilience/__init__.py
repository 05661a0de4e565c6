"""Injectable clocks (port of kserve_tpu/resilience/clock.py)."""

from .clock import MONOTONIC, Clock, FakeClock  # noqa: F401
