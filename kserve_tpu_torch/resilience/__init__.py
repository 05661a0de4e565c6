"""The resilience layer of the port (kserve_tpu/resilience): injectable
clocks, the propagated request deadline, admission-time load shedding,
the retry policy and per-backend circuit breakers the peer page client
rides, and the fault plan with its engine seams and HTTP transport."""

from .breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerConfig,
    BreakerRegistry,
    CircuitBreaker,
)
from .clock import MONOTONIC, Clock, FakeClock  # noqa: F401
from .deadline import (  # noqa: F401
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceededError,
    current_deadline,
    deadline_scope,
)
from .faults import (  # noqa: F401
    FaultInjectingTransport,
    FaultPlan,
    FaultSpec,
    ReplicaCrashError,
)
from .retry import RETRYABLE_STATUSES, RetryPolicy, parse_retry_after  # noqa: F401
from .shedding import LoadShedder, ShedConfig, is_inference_path  # noqa: F401
