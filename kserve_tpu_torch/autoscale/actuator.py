"""In-cluster actuation: drive a Deployment's replica count (port of
kserve_tpu/autoscale/actuator.py).

The replicas patch the activator's `deployment_scaler` makes for its
0 -> 1 wake, generalized to `scale_to(n)` for the autoscaler loop.  All
apiserver I/O runs in a worker thread: the loop must keep ticking (and
answering `notify_demand`) while a patch is in flight on a slow
apiserver.
"""

from __future__ import annotations

import asyncio

from ..logging import logger
from .loop import ReplicaActuator


class DeploymentActuator(ReplicaActuator):
    def __init__(self, cluster, deployment: str, namespace: str = "default",
                 pods_per_replica: int = 1):
        if pods_per_replica < 1:
            raise ValueError(f"pods_per_replica {pods_per_replica} < 1")
        self.cluster = cluster
        self.deployment = deployment
        self.namespace = namespace
        # one logical replica = this many pods (slice groups, engine DP):
        # the loop reasons in replicas, the Deployment is patched in pods,
        # and the pod count stays a whole-slice multiple — the invariant
        # KEDA's podsPerReplica carried for the ScaledObject this replaces
        self.pods_per_replica = pods_per_replica

    def _get(self) -> dict:
        dep = self.cluster.get("Deployment", self.deployment, self.namespace)
        if dep is None:
            raise RuntimeError(
                f"deployment {self.namespace}/{self.deployment} not found")
        return dep

    async def current_replicas(self) -> int:
        dep = await asyncio.to_thread(self._get)
        pods = int(dep.get("spec", {}).get("replicas") or 0)
        return pods // self.pods_per_replica

    async def scale_to(self, n: int) -> None:
        pods = int(n) * self.pods_per_replica

        def _patch() -> None:
            dep = self._get()
            if int(dep.get("spec", {}).get("replicas") or 0) != pods:
                dep.setdefault("spec", {})["replicas"] = pods
                self.cluster.apply(dep)
                logger.info("autoscaler: patched %s/%s replicas=%d pods "
                            "(%d x %d)", self.namespace, self.deployment,
                            pods, n, self.pods_per_replica)

        await asyncio.to_thread(_patch)
