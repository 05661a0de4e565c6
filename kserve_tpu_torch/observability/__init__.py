"""Request telemetry of the port (kserve_tpu/observability/ without the
tracer and the profiler)."""

from .timeline import RequestTimeline, TimelineRecorder, percentiles

__all__ = ["RequestTimeline", "TimelineRecorder", "percentiles"]
