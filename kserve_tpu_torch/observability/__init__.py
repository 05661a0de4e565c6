"""Request telemetry of the port (kserve_tpu/observability/): timelines,
the engine's child spans and the on-demand profiler."""

from .introspection import ProfilerBusyError, ProfilerSession
from .spans import emit_timeline_spans
from .timeline import RequestTimeline, TimelineRecorder, percentiles

__all__ = ["ProfilerBusyError", "ProfilerSession", "RequestTimeline",
           "TimelineRecorder", "emit_timeline_spans", "percentiles"]
