"""Deterministic fault injection: the engine's seams of
kserve_tpu/resilience/faults.py (`FaultSpec`, `FaultPlan`,
`ReplicaCrashError`).

A `FaultPlan` is a seeded, ordered list of `FaultSpec`s.  A call site
asks `plan.decide(target)` with a stable target string; the plan matches
by substring, counts matching calls and decides whether to inject.  The
same plan and call sequence give the same faults.  The engine honours two
targets: "engine.fetch" (kinds `wedge`: the fetch blew the step deadline,
and `replica_crash`: the process died) and "engine.preempt" (kind
`preempt`: the newest decoding lane goes back to the queue).  The JAX
package's HTTP transport over httpx has no counterpart here yet.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class ReplicaCrashError(RuntimeError):
    """An injected `replica_crash` fault fired inside the engine: every
    in-flight stream fails and nothing is checkpointed."""


@dataclass
class FaultSpec:
    target: str  # substring matched against the call target
    # latency | connect_error | http_status | wedge | partial_stream |
    # preempt | replica_crash | clock_skew | slow_decode | wedged_fetch |
    # flapping | peer_corrupt | peer_partition | peer_slow (the JAX
    # package's vocabulary; the engine acts on wedge, replica_crash and
    # preempt)
    kind: str
    status: int = 503
    latency_s: float = 0.0
    retry_after_s: Optional[float] = None
    probability: float = 1.0  # < 1.0 draws from the plan's seeded RNG
    after: int = 0  # skip the first N matching calls
    count: Optional[int] = None  # inject at most N times (None = forever)
    skew: float = 1.0


class FaultPlan:
    """Seeded decisions over an ordered spec list (the first match wins)."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self._rng = random.Random(seed)
        self._seen: Dict[int, int] = {}
        self._injected: Dict[int, int] = {}
        self.log: List[Tuple[str, str]] = []  # (target, kind) per injection

    def decide(self, target: str) -> Optional[FaultSpec]:
        for i, spec in enumerate(self.specs):
            if spec.target not in target:
                continue
            seen = self._seen.get(i, 0)
            self._seen[i] = seen + 1
            if seen < spec.after:
                continue
            done = self._injected.get(i, 0)
            if spec.count is not None and done >= spec.count:
                continue
            if spec.probability < 1.0 and self._rng.random() >= spec.probability:
                continue
            self._injected[i] = done + 1
            self.log.append((target, spec.kind))
            return spec
        return None
