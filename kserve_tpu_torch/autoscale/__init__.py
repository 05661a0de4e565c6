"""Autoscaling signals of the port (kserve_tpu/autoscale/signals.py); the
policies, the loop and the actuator are still to port."""

from .signals import ArrivalHistory, FleetSignals, RateTracker, ReplicaSignals

__all__ = ["ArrivalHistory", "FleetSignals", "RateTracker", "ReplicaSignals"]
