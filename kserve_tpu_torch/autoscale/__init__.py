"""The EPP-signal autoscaler of the port (kserve_tpu/autoscale): fleet
signals, the reactive and predictive policies, the bounded hold-and-replay
queue of the zero window, the control loop and the Deployment actuator.
`python -m kserve_tpu_torch.autoscale` runs the loop against an EPP and an
apiserver; `kserve_tpu_torch.activator` is the hold gateway."""

from .actuator import DeploymentActuator
from .hold import HoldExpiredError, HoldOverflowError, HoldQueue
from .loop import AutoscalerLoop, ReplicaActuator
from .policy import (
    ACTIONS,
    REASONS,
    PeriodicDetector,
    PredictiveConfig,
    PredictivePolicy,
    ReactiveConfig,
    ReactivePolicy,
    ScalingDecision,
    ScalingPolicy,
)
from .signals import ArrivalHistory, FleetSignals, RateTracker, ReplicaSignals

__all__ = [
    "ACTIONS", "REASONS", "ArrivalHistory", "AutoscalerLoop", "DeploymentActuator",
    "FleetSignals", "HoldExpiredError", "HoldOverflowError", "HoldQueue",
    "PeriodicDetector", "PredictiveConfig", "PredictivePolicy", "RateTracker",
    "ReactiveConfig", "ReactivePolicy", "ReplicaActuator", "ReplicaSignals",
    "ScalingDecision", "ScalingPolicy",
]
