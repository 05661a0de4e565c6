"""Endpoint-picker (EPP) scheduler of the port (kserve_tpu/scheduler/):
the picker scores decode replicas by live queue depth, prefix-cache
affinity and fleet health, and `python -m kserve_tpu_torch.scheduler.epp`
proxies or picks per request."""

from .health import (  # noqa: F401
    DEGRADED,
    HEALTHY,
    QUARANTINED,
    FleetHealth,
    HealthConfig,
)
from .picker import EndpointPicker, Replica  # noqa: F401
