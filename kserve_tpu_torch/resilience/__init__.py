"""The resilience layer of the port (kserve_tpu/resilience without its
HTTP client pieces): injectable clocks, the propagated request deadline,
admission-time load shedding and the engine's fault seams."""

from .clock import MONOTONIC, Clock, FakeClock  # noqa: F401
from .deadline import (  # noqa: F401
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceededError,
    current_deadline,
    deadline_scope,
)
from .faults import FaultPlan, FaultSpec, ReplicaCrashError  # noqa: F401
from .shedding import LoadShedder, ShedConfig, is_inference_path  # noqa: F401
