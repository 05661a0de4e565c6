"""Fleet health scoring and quarantine: routing around gray replicas
(port of kserve_tpu/scheduler/health.py).

A gray replica is alive, polls green and is far too slow.  `FleetHealth`
turns the signals that ride the EPP's poll (TTFT / ITL p99 windows, queue
depth, the error EWMA, the engine watchdog block) into a per-replica
score in [0, 1]: each poll's instant score comes from outlier ratios
against the fleet median plus hard evidence (watchdog `stall_suspected`
/ `stall_confirmed`, errors, a queue that does not drain), and the score
is the EWMA of those instants.

States: **healthy** (full weight), **degraded** (score under
`degraded_below`: weight-reduced in pick scoring), **quarantined** (score
under `quarantine_below`, or `stall_confirmed`: excluded from picks).
Quarantine is left only by proof: one live request every
`reprobe_interval_s` is routed to the replica as a canary, and
`heal_successes` successful canaries in a row reintroduce it, with a
grace window in which its stale latency windows are not penalized.
Transitions are counted (`replica_quarantine_transitions_total`) and kept
in a bounded history; per-replica scores ride the picker's snapshot, the
`replica_health_score` gauge carries the fleet's min / median / max.
"""

from __future__ import annotations

import logging
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..metrics import REPLICA_HEALTH_SCORE, record_quarantine_transition
from ..resilience import MONOTONIC, Clock

logger = logging.getLogger(__name__)

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
HEALTH_STATES = (HEALTHY, DEGRADED, QUARANTINED)

# the closed transition vocabulary (metrics label + report key)
TRANSITIONS = ("quarantine", "reintroduce", "degrade", "restore")


@dataclass
class HealthConfig:
    """Scoring + quarantine knobs.  Ratios are vs the fleet median, so
    the same config works at any absolute latency scale."""

    ewma_alpha: float = 0.4  # per-poll smoothing of the instant score
    # latency outlier ratios (replica p99 / fleet-median p99)
    latency_ratio_degraded: float = 2.0  # soft penalty starts here
    latency_ratio_sick: float = 4.0  # hard penalty (gray-slow replica)
    queue_ratio_sick: float = 4.0  # queue depth vs fleet median (+1)
    # outlier detection needs a baseline: with fewer than this many
    # OTHER replicas reporting, the "median" is one peer and ordinary
    # load asymmetry (a drain concentrating traffic on the survivor)
    # reads as sickness — latency/queue penalties are disabled below it
    min_latency_peers: int = 2
    degraded_below: float = 0.6  # score -> weight-reduced
    quarantine_below: float = 0.25  # score -> excluded from picks
    reprobe_interval_s: float = 5.0  # one canary request per interval
    canary_timeout_s: float = 10.0  # unreported canary re-arms after this
    heal_successes: int = 2  # consecutive OK canaries to reintroduce
    # after reintroduction, latency-ratio penalties are suspended for
    # this long AND until the replica's reported p99s visibly DROP from
    # their quarantine-era values: a quarantined replica served no
    # traffic, so its rolling windows still hold sick samples — window
    # half-life can be minutes, and re-penalizing stale numbers flaps
    # the replica straight back into quarantine forever.  A replica
    # that is STILL sick re-quarantines through fresh evidence (hedge
    # stalls, errors, watchdog) — never through the stale windows.
    reintroduce_grace_s: float = 8.0
    # "visibly refreshed" = the window fell under this fraction of its
    # captured stale value
    stale_refresh_ratio: float = 0.9
    # hard bound on post-reintroduction latency blindness: past this,
    # scoring resumes even if the window never visibly refreshed (a
    # near-idle replica's ring can hold sick samples indefinitely)
    stale_max_s: float = 300.0


@dataclass
class ReplicaHealth:
    """Mutable per-replica scoring state."""

    score: float = 1.0
    status: str = HEALTHY
    quarantined_at: Optional[float] = None
    reintroduced_at: Optional[float] = None
    last_canary_at: Optional[float] = None
    canary_inflight: bool = False
    canary_successes: int = 0
    # queue-drain tracking: (load, at_s) of the previous observation
    last_load: Optional[float] = None
    last_load_at: Optional[float] = None
    # quarantine-era p99 values captured after reintroduction: the
    # window is treated as stale until it drops visibly below these
    stale_latency: Dict[str, float] = field(default_factory=dict)


class FleetHealth:
    """Per-replica health scores + quarantine state for one picker."""

    MAX_TRANSITIONS = 4096  # bounded history (report/test surface)

    def __init__(self, config: Optional[HealthConfig] = None,
                 clock: Clock = MONOTONIC):
        self.config = config or HealthConfig()
        self.clock = clock
        self._h: Dict[str, ReplicaHealth] = {}
        # [(at_s, url, transition)] — deterministic under virtual clocks,
        # exported into the fleet simulator's goodput report
        self.transitions: List[tuple] = []
        # fleet-wide latency medians stashed at each observe: the
        # baseline canary outcomes are judged against (a canary that
        # served 200 at gray-sick latency is not proof of health)
        self._fleet_medians: Dict[str, Optional[float]] = {}

    # ---------------- observation ----------------

    def observe(self, replica, peers, error_level: float = 0.0) -> None:
        """Ingest one replica's freshly-polled state.  `replica` is a
        `picker.Replica`; `peers` the fleet's Replica iterable (medians
        are computed over the *other*, non-quarantined, alive rows so a
        sick replica never drags its own baseline up)."""
        now = self.clock.now()
        h = self._h.setdefault(replica.url, ReplicaHealth())
        inst = self._instant_score(replica, peers, h, error_level, now)
        alpha = self.config.ewma_alpha
        h.score = alpha * inst + (1.0 - alpha) * h.score
        for attr in ("ttft_p99_s", "itl_p99_s"):
            # "" matches no replica url: the median over the whole
            # healthy non-quarantined fleet (canary judging baseline)
            self._fleet_medians[attr] = self._peer_median("", peers, attr)
        hard_stall = getattr(replica, "watchdog", "ok") == "stall_confirmed"
        self._transition(replica.url, h, now, hard_stall=hard_stall)
        self._export_gauges()

    def _peer_median(self, url: str, peers, attr: str) -> Optional[float]:
        vals = sorted(
            v for r in peers
            if r.url != url and r.healthy
            and self._h.get(r.url, _HEALTHY_SENTINEL).status != QUARANTINED
            for v in (getattr(r, attr, None),)
            if isinstance(v, (int, float))
        )
        if len(vals) < self.config.min_latency_peers:
            return None
        return float(statistics.median(vals))

    def _instant_score(self, replica, peers, h: ReplicaHealth,
                       error_level: float, now: float) -> float:
        cfg = self.config
        wd = getattr(replica, "watchdog", "ok")
        if wd == "stall_confirmed" or not replica.healthy:
            return 0.0
        score = 1.0
        if wd == "stall_suspected":
            score *= 0.3
        # latency outliers vs the fleet median — suppressed while the
        # replica's windows are post-reintroduction stale (see
        # HealthConfig.reintroduce_grace_s)
        for attr in ("ttft_p99_s", "itl_p99_s"):
            v = getattr(replica, attr, None)
            if not isinstance(v, (int, float)) or v <= 0:
                continue
            if self._window_is_stale(h, attr, v, now):
                continue
            med = self._peer_median(replica.url, peers, attr)
            if med is not None and med > 0:
                ratio = v / med
                if ratio >= cfg.latency_ratio_sick:
                    score *= 0.1
                elif ratio >= cfg.latency_ratio_degraded:
                    # linear slide from 1.0 at the degraded ratio down
                    # to 0.3 just under the sick ratio
                    span = cfg.latency_ratio_sick - cfg.latency_ratio_degraded
                    frac = (ratio - cfg.latency_ratio_degraded) / max(span, 1e-9)
                    score *= 1.0 - 0.7 * frac
        # queue-drain rate: a queue that is deep AND not draining while
        # the fleet's median queue is far smaller means admission is
        # landing on a replica that cannot retire it
        load = float(replica.queue_depth + replica.inflight)
        med_q = self._peer_median(replica.url, peers, "queue_depth")
        draining_backlog = (
            h.last_load is not None and load >= h.last_load and load > 0)
        if (med_q is not None and draining_backlog
                and load > cfg.queue_ratio_sick * (med_q + 1.0)):
            score *= 0.5
        h.last_load, h.last_load_at = load, now
        # error-rate penalty, floored at 0.4: served errors alone may
        # DEGRADE (weight-reduce) but never quarantine — the breaker
        # already owns served-error storms, and a load-shedding replica
        # is protecting itself, not gray-failing
        if error_level > 0:
            score *= max(1.0 / (1.0 + 0.25 * error_level), 0.4)
        return score

    def _window_is_stale(self, h: ReplicaHealth, attr: str, v: float,
                         now: float) -> bool:
        """Post-reintroduction staleness: a replica fresh out of
        quarantine reports p99 windows full of quarantine-era samples
        (it served nothing to displace them).  Those numbers are
        suspended — first for the grace period, then until the window
        visibly drops below the captured stale value.  A replica that is
        STILL sick re-quarantines through fresh evidence (note_stall,
        errors, watchdog), never through the stale window."""
        if h.reintroduced_at is None:
            return False
        if now - h.reintroduced_at >= self.config.stale_max_s:
            # blindness bound: resume scoring even without a visible
            # refresh (near-idle windows can stay stale indefinitely)
            h.stale_latency.clear()
            h.reintroduced_at = None
            return False
        # the ref is captured on the FIRST observation after
        # reintroduction — inside the grace period, while the window
        # still holds quarantine-era samples.  Capturing later (after
        # the window already refreshed) would make the healthy value the
        # "stale" ref and suppress latency scoring forever, including a
        # later genuine re-degradation (review finding).
        ref = h.stale_latency.get(attr)
        if ref is None:
            h.stale_latency[attr] = v
            return True
        if now - h.reintroduced_at < self.config.reintroduce_grace_s:
            return True
        if v >= self.config.stale_refresh_ratio * ref:
            return True
        # refreshed: resume normal scoring for this signal
        h.stale_latency.pop(attr, None)
        if not h.stale_latency:
            h.reintroduced_at = None
        return False

    def note_stall(self, url: str) -> None:
        """Client-observed stall evidence (a hedge-triggered migration
        off this replica): an immediate penalty ahead of the next poll,
        and a failed canary if one was riding the stalled stream."""
        h = self._h.get(url)
        if h is None:
            return
        h.score *= 0.5
        if h.canary_inflight:
            h.canary_inflight = False
            h.canary_successes = 0
        self._transition(url, h, self.clock.now())

    def note_bad_page(self, url: str) -> None:
        """Peer-fabric evidence channel (kvstore/peer.py,
        docs/kv_hierarchy.md): a KV page SERVED BY `url` failed digest
        verification on the fetching replica.  A lying peer is the gray
        failure at its purest — it answers 200, polls green, and hands
        out garbage — so the penalty is immediate and compounding: every
        verified-bad page halves the score (degrade, then quarantine on
        repeated evidence) and fails any in-flight canary.  setdefault,
        not get: bad-page evidence may arrive via a replica's /state
        peer block before this peer's own first health observation."""
        h = self._h.setdefault(url, ReplicaHealth())
        h.score *= 0.5
        if h.canary_inflight:
            h.canary_inflight = False
            h.canary_successes = 0
        self._transition(url, h, self.clock.now())

    # ---------------- transitions ----------------

    def _record(self, url: str, transition: str, now: float) -> None:
        self.transitions.append((round(now, 9), url, transition))
        del self.transitions[:-self.MAX_TRANSITIONS]
        record_quarantine_transition(transition)
        logger.warning("fleet-health: %s %s (score-driven)", url, transition)

    def _transition(self, url: str, h: ReplicaHealth, now: float,
                    hard_stall: bool = False) -> None:
        cfg = self.config
        if h.status == QUARANTINED:
            return  # exit is by canary proof only (record_canary)
        if hard_stall or h.score < cfg.quarantine_below:
            h.status = QUARANTINED
            h.quarantined_at = now
            h.canary_successes = 0
            h.canary_inflight = False
            # first canary one full interval from NOW: we just decided
            # the replica is sick — probing it immediately would hand a
            # user request straight back to the evidence
            h.last_canary_at = now
            self._record(url, "quarantine", now)
        elif h.status == HEALTHY and h.score < cfg.degraded_below:
            h.status = DEGRADED
            self._record(url, "degrade", now)
        elif h.status == DEGRADED and h.score >= cfg.degraded_below:
            h.status = HEALTHY
            self._record(url, "restore", now)

    # ---------------- canary re-probe ----------------

    def wants_canary(self, url: str, now: Optional[float] = None) -> bool:
        """True when this quarantined replica is due its single canary
        request (one per reprobe interval; a canary that never reported
        back re-arms after canary_timeout_s)."""
        h = self._h.get(url)
        if h is None or h.status != QUARANTINED:
            return False
        now = self.clock.now() if now is None else now
        if h.canary_inflight:
            if now - (h.last_canary_at or 0.0) >= self.config.canary_timeout_s:
                h.canary_inflight = False  # lost canary: re-arm
            else:
                return False
        if (h.last_canary_at is not None
                and now - h.last_canary_at < self.config.reprobe_interval_s):
            return False
        return True

    def canary_started(self, url: str, now: Optional[float] = None) -> None:
        h = self._h.get(url)
        if h is None:
            return
        h.canary_inflight = True
        h.last_canary_at = self.clock.now() if now is None else now

    def _canary_latency_sick(self, ttft_s: Optional[float],
                             tpot_s: Optional[float]) -> bool:
        """A canary that served 200 at gray-sick latency is NOT proof of
        health: judge its measured TTFT / per-token time against the
        stashed fleet medians (same sick ratio as window scoring).
        Measurements are optional — the sim's client reports none and
        relies on hedge/note_stall evidence to fail sick canaries."""
        ratio = self.config.latency_ratio_sick
        itl_med = self._fleet_medians.get("itl_p99_s")
        if (tpot_s is not None and itl_med is not None and itl_med > 0
                and tpot_s > ratio * itl_med):
            return True
        ttft_med = self._fleet_medians.get("ttft_p99_s")
        if (ttft_s is not None and ttft_med is not None and ttft_med > 0
                and ttft_s > ratio * ttft_med):
            return True
        return False

    def record_canary(self, url: str, ok: bool,
                      ttft_s: Optional[float] = None,
                      tpot_s: Optional[float] = None) -> None:
        """Canary outcome — for the request pick() actually handed out
        as the canary (picker.observe_canary; URL-level success signals
        deliberately do NOT land here, or a pre-quarantine stream
        completing would count as probe proof).  `heal_successes`
        consecutive OKs — served fast enough relative to the fleet when
        measurements are supplied — reintroduce the replica; any failure
        resets the streak."""
        h = self._h.get(url)
        if h is None or h.status != QUARANTINED or not h.canary_inflight:
            return
        h.canary_inflight = False
        if ok and self._canary_latency_sick(ttft_s, tpot_s):
            ok = False  # a 200 at gray-sick latency proves the sickness
        if not ok:
            h.canary_successes = 0
            return
        h.canary_successes += 1
        if h.canary_successes >= self.config.heal_successes:
            now = self.clock.now()
            h.status = HEALTHY
            h.score = max(h.score, self.config.degraded_below)
            h.reintroduced_at = now
            h.stale_latency = {}  # captured fresh after the grace window
            h.quarantined_at = None
            self._record(url, "reintroduce", now)

    # ---------------- queries ----------------

    def is_quarantined(self, url: str) -> bool:
        h = self._h.get(url)
        return h is not None and h.status == QUARANTINED

    def status(self, url: str) -> str:
        h = self._h.get(url)
        return h.status if h is not None else HEALTHY

    def score(self, url: str) -> float:
        h = self._h.get(url)
        return h.score if h is not None else 1.0

    def snapshot(self, url: str) -> dict:
        """The per-replica block the picker snapshot / EPP /state carry
        (replica identity deliberately lives HERE, not in Prometheus
        labels — the cardinality policy)."""
        h = self._h.get(url)
        if h is None:
            return {"score": 1.0, "status": HEALTHY}
        return {"score": round(h.score, 6), "status": h.status}

    def forget(self, url: str) -> None:
        """Recycled-address contract (picker.set_replicas): a fresh pod
        on a reused url starts healthy, not quarantined."""
        self._h.pop(url, None)

    def _export_gauges(self) -> None:
        scores = sorted(h.score for h in self._h.values())
        if not scores:
            return
        REPLICA_HEALTH_SCORE.labels(stat="min").set(scores[0])
        REPLICA_HEALTH_SCORE.labels(stat="max").set(scores[-1])
        mid = len(scores) // 2
        median = (scores[mid] if len(scores) % 2
                  else (scores[mid - 1] + scores[mid]) / 2.0)
        REPLICA_HEALTH_SCORE.labels(stat="median").set(median)


# status sentinel for _peer_median's dict lookup (avoids allocating a
# ReplicaHealth per missing peer just to read a default status)
_HEALTHY_SENTINEL = ReplicaHealth()
