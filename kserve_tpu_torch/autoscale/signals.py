"""Serving-native autoscaling signals: the `FleetSignals` snapshot (port
of kserve_tpu/autoscale/signals.py:35-289, pure Python).

- `ReplicaSignals` / `FleetSignals`: one EPP scrape cycle's view of a
  replica / of the fleet, a value object; `demand` says whether the
  fleet has (or is about to have) work;
- `ArrivalHistory`: bucketed arrival counts over a rolling window:
  `rate()` for load-proportional sizing, `slope()` for burst onsets;
- `RateTracker`: a cumulative counter -> a per-second rate between
  observations (shed counters are totals).

The EPP builds `FleetSignals` from its picker's snapshot
(`from_replica_states`) and exports it under `fleet` in its `/state`;
the autoscaler CLI (autoscale/__main__.py) rebuilds it from that JSON
with `FleetSignals.from_dict`.
"""

from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ReplicaSignals:
    """One replica's slice of the fleet snapshot (the autoscaling-relevant
    subset of its `/v1/internal/scheduler/state` payload)."""

    url: str = ""
    healthy: bool = True
    lifecycle: str = "READY"
    queue_depth: int = 0
    inflight: int = 0
    sheds_total: int = 0
    shedding: bool = False
    ttft_p99_s: Optional[float] = None
    itl_p99_s: Optional[float] = None
    # hierarchical prefix-store block (docs/kv_hierarchy.md): resident
    # digest count + hit/miss/demotion/page-in tallies, carried verbatim
    # from the replica's /state through the picker snapshot.  The first
    # cut of the global prefix index (ROADMAP item 2): a prefix-aware
    # router reads which replica already holds a prompt's pages — and a
    # scale-from-zero policy knows a wake will be prefix-HOT, not cold.
    prefix_store: Optional[Mapping] = None
    # gray-failure health status (scheduler/health.py): healthy |
    # degraded | quarantined.  A quarantined replica is excluded from
    # picks, so it must be excluded from ready_replicas too — otherwise
    # a gray replica SUPPRESSES the very scale-up that would route
    # around it (ReactivePolicy sizes load per ready replica).
    health_status: str = "healthy"


@dataclass(frozen=True)
class FleetSignals:
    """The fleet-wide snapshot a `ScalingPolicy` decides on.  All values
    observed at `at_s` on the source's (injectable) clock — policies must
    reason from `at_s`, never from wall time, so the simulator's decisions
    replay byte-identically."""

    at_s: float = 0.0
    ready_replicas: int = 0  # healthy + READY + not quarantined (pickable)
    total_replicas: int = 0  # every replica the source knows, up or down
    quarantined_replicas: int = 0  # gray replicas excluded from picks
    queue_depth: int = 0  # summed admission queues
    inflight: int = 0  # summed seated generations
    shed_rate_per_s: float = 0.0  # fleet 429s/sec since the last snapshot
    ttft_p99_s: Optional[float] = None  # worst replica rolling window
    itl_p99_s: Optional[float] = None
    arrival_rate_per_s: float = 0.0  # smoothed gateway arrivals/sec
    arrival_slope_per_s2: float = 0.0  # d(arrival rate)/dt estimate
    held_requests: int = 0  # requests parked at the hold gateway
    replicas: Tuple[ReplicaSignals, ...] = field(default_factory=tuple)

    @property
    def demand(self) -> bool:
        """Any evidence the fleet has (or is about to have) work."""
        return (
            self.held_requests > 0
            or self.queue_depth > 0
            or self.inflight > 0
            or self.arrival_rate_per_s > 0.0
        )

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "FleetSignals":
        """Rebuild from the EPP `/state` ``fleet`` JSON block (the
        autoscaler's wire form).  Unknown keys are ignored, so an EPP of a
        later version does not break an older autoscaler."""
        reps = tuple(
            ReplicaSignals(**{
                k: v for k, v in r.items()
                if k in ReplicaSignals.__dataclass_fields__
            })
            for r in d.get("replicas", ())
            if isinstance(r, dict)
        )
        fields = {
            k: v for k, v in d.items()
            if k in cls.__dataclass_fields__ and k != "replicas"
        }
        return cls(replicas=reps, **fields)

    @classmethod
    def from_replica_states(
        cls,
        states: Sequence[Dict],
        at_s: float,
        *,
        arrival_rate_per_s: float = 0.0,
        arrival_slope_per_s2: float = 0.0,
        shed_rate_per_s: float = 0.0,
        held_requests: int = 0,
    ) -> "FleetSignals":
        """Aggregate per-replica state dicts (the picker `snapshot()` /
        `/state` ``replicas`` shape) into one fleet snapshot."""
        reps: List[ReplicaSignals] = []
        for s in states:
            tel = s.get("telemetry") or {}
            shed = s.get("shed") or {}
            reps.append(ReplicaSignals(
                url=str(s.get("url", "")),
                healthy=bool(s.get("healthy", True)),
                lifecycle=str(s.get("lifecycle") or "READY").upper(),
                queue_depth=int(s.get("queue_depth", 0) or 0),
                inflight=int(s.get("inflight", 0) or 0),
                sheds_total=int(
                    s.get("sheds_total", shed.get("count", 0)) or 0),
                shedding=bool(s.get("shedding", shed.get("shedding"))),
                ttft_p99_s=s.get("ttft_p99_s", tel.get("ttft_p99_s")),
                itl_p99_s=s.get("itl_p99_s", tel.get("itl_p99_s")),
                prefix_store=s.get("prefix_store"),
                health_status=str(
                    (s.get("health") or {}).get("status")
                    or s.get("health_status") or "healthy"),
            ))
        ready = [
            r for r in reps
            if r.healthy and r.lifecycle not in ("DRAINING", "TERMINATING")
            # a quarantined replica takes no picks: counting it as ready
            # would let a gray replica suppress the scale-up that routes
            # around it (ReactivePolicy divides load by ready_replicas)
            and r.health_status != "quarantined"
        ]
        quarantined = sum(
            1 for r in reps if r.health_status == "quarantined")
        ttfts = [r.ttft_p99_s for r in ready if r.ttft_p99_s is not None]
        itls = [r.itl_p99_s for r in ready if r.itl_p99_s is not None]
        return cls(
            at_s=at_s,
            ready_replicas=len(ready),
            total_replicas=len(reps),
            quarantined_replicas=quarantined,
            queue_depth=sum(r.queue_depth for r in ready),
            inflight=sum(r.inflight for r in ready),
            shed_rate_per_s=shed_rate_per_s,
            ttft_p99_s=max(ttfts) if ttfts else None,
            itl_p99_s=max(itls) if itls else None,
            arrival_rate_per_s=arrival_rate_per_s,
            arrival_slope_per_s2=arrival_slope_per_s2,
            held_requests=held_requests,
            replicas=tuple(reps),
        )


class ArrivalHistory:
    """Bucketed request-arrival counts over a bounded rolling window.

    `record(t)` stamps one arrival; `rate(now)` is the smoothed
    arrivals/sec over `rate_window_s`; `slope(now)` compares the most
    recent half of `slope_window_s` against the half before it — positive
    means the arrival process is accelerating (burst onset).  Purely
    arithmetic over (time, count) pairs: deterministic under virtual
    clocks and cheap enough for the proxy hot path.

    """

    def __init__(self, bucket_s: float = 1.0, window_s: float = 120.0):
        if bucket_s <= 0:
            raise ValueError("bucket_s must be > 0")
        self.bucket_s = bucket_s
        self.window_s = window_s
        self._buckets: "deque[Tuple[int, int]]" = deque()  # (bucket, count)
        self.total = 0

    def record(self, t: float, n: int = 1) -> None:
        b = int(t / self.bucket_s)
        if self._buckets and self._buckets[-1][0] == b:
            self._buckets[-1] = (b, self._buckets[-1][1] + n)
        else:
            self._buckets.append((b, n))
        self.total += n
        self._evict(b)

    def _evict(self, newest_bucket: int) -> None:
        horizon = newest_bucket - int(self.window_s / self.bucket_s)
        while self._buckets and self._buckets[0][0] < horizon:
            self._buckets.popleft()

    def _count_between(self, t0: float, t1: float) -> int:
        b0 = int(t0 / self.bucket_s)
        b1 = int(t1 / self.bucket_s)
        return sum(c for b, c in self._buckets if b0 <= b <= b1)

    def rate(self, now: float, window_s: Optional[float] = None) -> float:
        w = window_s if window_s is not None else min(self.window_s, 30.0)
        if w <= 0:
            return 0.0
        return self._count_between(now - w, now) / w

    def slope(self, now: float, window_s: float = 10.0) -> float:
        """(recent-half rate - prior-half rate) / half-width: the arrival
        acceleration in requests/sec^2."""
        half = window_s / 2.0
        if half <= 0:
            return 0.0
        recent = self._count_between(now - half, now) / half
        prior = self._count_between(now - window_s, now - half) / half
        return (recent - prior) / half


class RateTracker:
    """Cumulative counter -> per-second rate between observations (shed
    counters are lifetime totals; policies want the current rate).  A
    counter reset (replica restart) reads as rate 0, not a negative
    spike.

    `min_interval_s` protects shared trackers from scraper storms: the
    EPP's tracker is consulted on every `/state` GET, and without a floor
    a dashboard polling next to the autoscaler would collapse the
    measurement window to milliseconds — one shed reads as hundreds/sec,
    or the other scraper absorbs the whole delta and the autoscaler reads
    0 mid-storm.  Below the floor the last computed rate is re-served
    without advancing the baseline."""

    def __init__(self, min_interval_s: float = 0.0) -> None:
        self.min_interval_s = min_interval_s
        self._last_total: Optional[int] = None
        self._last_t: Optional[float] = None
        self._rate = 0.0

    def update(self, total: int, now: float) -> float:
        if self._last_total is None or self._last_t is None:
            self._last_total, self._last_t = total, now
            return 0.0
        dt = now - self._last_t
        if dt <= 0 or dt < self.min_interval_s:
            return self._rate  # another scraper just advanced the baseline
        delta = total - self._last_total
        self._last_total, self._last_t = total, now
        # counter reset across a restart reads as 0, not a negative spike
        self._rate = 0.0 if delta < 0 else delta / dt
        return self._rate
