"""Endpoint picker: scores decode replicas by queue depth and
prefix-cache affinity (port of kserve_tpu/scheduler/picker.py; it polls
on the port's standard-library HTTP client, not aiohttp).

Two affinity signals, combined:

1. **Advertised digests**: each replica's `/v1/internal/scheduler/state`
   carries its hottest prefix-cache page digests (engine.
   scheduler_state()).  A request with token ids is chained through the
   same blake2b digest (scheduler/prefix.py) and scored by the longest
   leading run present in a replica's set.
2. **Learned text affinity**: OpenAI requests carry text, and the picker
   has no tokenizer.  It chunk-hashes the prompt text and remembers which
   replica each chunk chain was routed to, so later prompts that share a
   byte prefix go to the same replica.

Score = prefix_hit_pages * prefix_weight - queue_depth * queue_weight
(with the resident, error, health and latency terms), ties broken by
free pages, then round-robin.  Unhealthy replicas (failed polls, a wedged
engine), open breakers, DRAINING / TERMINATING replicas and quarantined
ones (bar their canary) are left out; when none is left, pick returns
None and the EPP answers 503.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..protocol.http_client import AsyncHTTPClient, HTTPError
from ..resilience import MONOTONIC, BreakerRegistry, Clock
from .health import FleetHealth
from .latency import estimate_prompt_len
from .prefix import text_prefix_digests, token_prefix_digests

logger = logging.getLogger(__name__)

# the poll of one replica's state must answer within this
POLL_TIMEOUT_S = 2.0


@dataclass
class Replica:
    url: str  # base url, e.g. http://decode-0:8080
    healthy: bool = True
    queue_depth: int = 0
    free_pages: int = 0
    # replica lifecycle state from /v1/internal/scheduler/state
    # (kserve_tpu/lifecycle): DRAINING/TERMINATING backends are excluded
    # from picks — like open breakers — so a draining replica empties
    # instead of accumulating work it will only checkpoint away.  A fresh
    # replica on a recycled url starts READY (set_replicas churn contract).
    lifecycle: str = "READY"
    # per-model (page_size, digest set) — kept separate so a multi-model
    # replica never scores one model's prompt against another's cache
    models: Dict[str, tuple] = field(default_factory=dict)
    last_poll: float = 0.0
    consecutive_failures: int = 0
    # decaying count of recent HTTP-error responses (4xx/5xx through the
    # proxy): a load-shedding replica never trains the latency model, so
    # without this it would stay "cold", un-penalized, and WIN every pick
    error_ewma: float = 0.0
    last_error_t: float = 0.0
    # autoscaling signals carried through from /state (docs/autoscaling.md):
    # seated generations, lifetime shed count + live shedding flag, and the
    # replica's rolling TTFT/ITL p99 windows.  The EPP re-exports these in
    # its own /state so the autoscaler loop scrapes ONE endpoint.
    inflight: int = 0
    sheds_total: int = 0
    shedding: bool = False
    ttft_p99_s: Optional[float] = None
    itl_p99_s: Optional[float] = None
    # hierarchical prefix-store stats carried through from /state
    # (docs/kv_hierarchy.md): resident digest count + hit/miss/demotion/
    # page-in tallies per replica — the first cut of the global prefix
    # index (ROADMAP item 2).  Re-exported in the EPP /state fleet block.
    prefix_store: Optional[Dict] = None
    # engine watchdog state carried through from /state (the worst state
    # across a multi-model replica's engines): ok | stall_suspected |
    # stall_confirmed — the gray-failure signal fleet health scoring
    # quarantines on (scheduler/health.py, docs/resilience.md)
    watchdog: str = "ok"
    # cross-replica page fabric (docs/kv_hierarchy.md "Cross-replica
    # page serving"): the replica's persist-resident digest-set wire
    # (generation-stamped, bounded — kvstore/peer.py digest_set_wire),
    # re-served verbatim through the EPP snapshot so every replica can
    # feed its PeerPageIndex from ONE poll target; plus the parsed set
    # for the expected-prefix-hit scoring term
    peer_pages: Optional[Dict] = None
    peer_digest_set: frozenset = field(default_factory=frozenset)
    # last-seen per-peer bad-page counts from the replica's /state peer
    # block — the diff against these is the production evidence channel
    # into FleetHealth.note_bad_page (a replica that FETCHED a corrupt
    # page reports it; the EPP dings the SERVING peer's health)
    peer_bad_seen: Dict[str, int] = field(default_factory=dict)

    @property
    def digests(self) -> frozenset:
        out = set()
        for _, d in self.models.values():
            out |= d
        return frozenset(out)


class EndpointPicker:
    MAX_TEXT_AFFINITY = 8192  # learned text-chunk entries (LRU-bounded)

    def __init__(
        self,
        replica_urls: Sequence[str],
        poll_interval_s: float = 2.0,
        queue_weight: float = 1.0,
        prefix_weight: float = 4.0,
        unhealthy_after: int = 2,
        state_path: str = "/v1/internal/scheduler/state",
        latency_predictor=None,  # scheduler/latency.LatencyPredictor
        latency_weight: float = 0.0,  # score penalty per predicted TTFT sec
        error_weight: float = 2.0,  # score penalty per recent HTTP error
        breakers: Optional[BreakerRegistry] = None,  # resilience/breaker.py
        clock: Clock = MONOTONIC,  # error-decay/poll stamps (sim injects)
        health: Optional[FleetHealth] = None,  # scheduler/health.py
        health_weight: float = 4.0,  # score penalty per point of lost health
        resident_weight: float = 1.0,  # score per persist-resident page a
        # replica could page in WITHOUT prefilling (peer-fabric expected-
        # prefix-hit term; weaker than prefix_weight — HBM-hot beats
        # page-in-able, which beats re-prefill)
    ):
        # every time the picker reads (poll freshness, error decay) comes
        # from this injectable clock so the fleet simulator's routing is a
        # pure function of virtual time — real time would leak wall-clock
        # jitter into scores and break byte-identical reports
        self.clock = clock
        # gray-failure health layer (docs/resilience.md): always present —
        # with default thresholds it only bites on genuine outliers, and
        # quarantine (score-driven, canary-exited) stays DISTINCT from the
        # breaker (served-error-driven, timer-half-opened) below
        self.health = health if health is not None else FleetHealth(clock=clock)
        self.health_weight = health_weight
        self.latency_predictor = latency_predictor
        self.latency_weight = latency_weight
        self.error_weight = error_weight
        # per-replica circuit breakers: open = excluded from picks entirely
        # (the error_ewma penalty only down-weights; a tripped breaker must
        # hard-stop traffic so the backend gets silence to recover)
        self.breakers = breakers
        self.replicas: Dict[str, Replica] = {
            u.rstrip("/"): Replica(url=u.rstrip("/")) for u in replica_urls
        }
        self.poll_interval_s = poll_interval_s
        self.queue_weight = queue_weight
        self.prefix_weight = prefix_weight
        self.resident_weight = resident_weight
        self.unhealthy_after = unhealthy_after
        self.state_path = state_path
        # text-chunk digest -> replica url (LRU)
        self._text_affinity: "OrderedDict[bytes, str]" = OrderedDict()
        self._rr = 0
        self._poll_task: Optional[asyncio.Task] = None
        self._session = None

    # ---------------- replica state ----------------

    def set_replicas(self, urls: Sequence[str]) -> None:
        """Reconcile the replica set (EndpointSlice watch / static flag)."""
        urls = {u.rstrip("/") for u in urls}
        for u in list(self.replicas):
            if u not in urls:
                del self.replicas[u]
                if self.latency_predictor is not None:
                    # unbounded growth under pod churn, and a recycled
                    # ip:port must not inherit the old pod's fitted model
                    self.latency_predictor.forget(u)
                if self.breakers is not None:
                    # same churn contract for breaker state: a fresh pod on
                    # a recycled ip:port starts closed, not open
                    self.breakers.forget(u)
                # ...and for health: a recycled url must not inherit the
                # dead pod's quarantine
                self.health.forget(u)
        for u in urls:
            self.replicas.setdefault(u, Replica(url=u))

    def observe_state(self, url: str, state: dict) -> None:
        """Ingest one replica's /state payload (also the test seam)."""
        r = self.replicas.get(url.rstrip("/"))
        if r is None:
            return
        r.queue_depth = int(state.get("queue_depth", 0))
        r.free_pages = int(state.get("free_pages", 0))
        r.inflight = int(state.get("inflight", 0) or 0)
        shed = state.get("shed") or {}
        r.sheds_total = int(shed.get("count", 0) or 0)
        r.shedding = bool(shed.get("shedding"))
        tel = state.get("telemetry") or {}
        r.ttft_p99_s = tel.get("ttft_p99_s")
        r.itl_p99_s = tel.get("itl_p99_s")
        models: Dict[str, tuple] = {}
        wedged = False
        prefix_store: Optional[Dict] = None
        peer_pages: Optional[Dict] = None
        peer_bad: Dict[str, int] = {}
        wd_state = "ok"
        _WD_ORDER = {"ok": 0, "stall_suspected": 1, "stall_confirmed": 2}

        def merge_peer_pages(block):
            # highest generation wins (one wire per replica url in the
            # fleet index; in practice replicas run one persisting model)
            nonlocal peer_pages
            if not isinstance(block, dict):
                return
            if peer_pages is None or int(block.get("generation", 0)) > int(
                    peer_pages.get("generation", 0)):
                peer_pages = block

        def merge_peer(block):
            # sum per-peer bad-page counts across a replica's engines
            if not isinstance(block, dict):
                return
            bad = block.get("bad_pages")
            if not isinstance(bad, dict):
                return
            for peer_url, count in bad.items():
                try:
                    peer_bad[peer_url] = peer_bad.get(peer_url, 0) + int(count)
                except (TypeError, ValueError):
                    continue

        def merge_watchdog(block):
            # the worst engine's state wins on a multi-model replica: one
            # stalled engine makes the whole pod a gray backend
            nonlocal wd_state
            if not isinstance(block, dict):
                return
            s = str(block.get("state") or "ok")
            if _WD_ORDER.get(s, 0) > _WD_ORDER.get(wd_state, 0):
                wd_state = s

        def merge_prefix_store(block):
            nonlocal prefix_store
            if not isinstance(block, dict):
                return
            if prefix_store is None:
                prefix_store = dict(block)
                return
            # multi-model replica: counts sum; nested dicts merge by key
            for k, v in block.items():
                if isinstance(v, (int, float)):
                    prefix_store[k] = prefix_store.get(k, 0) + v
                elif isinstance(v, dict):
                    merged = dict(prefix_store.get(k) or {})
                    for kk, vv in v.items():
                        merged[kk] = merged.get(kk, 0) + vv
                    prefix_store[k] = merged

        for name, m in (state.get("models") or {}).items():
            models[name] = (
                int(m.get("page_size", 16)),
                frozenset(bytes.fromhex(d) for d in m.get("prefix_digests", ())),
            )
            wedged = wedged or bool(m.get("wedged"))
            merge_prefix_store(m.get("prefix_store"))
            merge_watchdog(m.get("watchdog"))
            merge_peer_pages(m.get("peer_pages"))
            merge_peer(m.get("peer"))
        # flat form (engine.scheduler_state() given directly, tests)
        if "prefix_digests" in state or "page_size" in state:
            models[""] = (
                int(state.get("page_size", 16)),
                frozenset(
                    bytes.fromhex(d) for d in state.get("prefix_digests", ())
                ),
            )
        wedged = wedged or bool(state.get("wedged"))
        merge_prefix_store(state.get("prefix_store"))
        merge_watchdog(state.get("watchdog"))
        merge_peer_pages(state.get("peer_pages"))
        merge_peer(state.get("peer"))
        r.prefix_store = prefix_store
        r.peer_pages = peer_pages
        if peer_pages is not None:
            try:
                r.peer_digest_set = frozenset(
                    bytes.fromhex(d) for d in peer_pages.get("digests", ()))
            except (TypeError, ValueError):
                r.peer_digest_set = frozenset()
        # bad-page evidence channel: each INCREMENT in a replica's
        # per-peer corrupt-page count is one verified observation that
        # the named peer served garbage — fold it into fleet health so
        # the lying peer's score drops (and its pick share with it).
        # Counter resets (replica restart) re-baseline without noting.
        for peer_url, count in peer_bad.items():
            seen = r.peer_bad_seen.get(peer_url, 0)
            for _ in range(max(count - seen, 0)):
                self.health.note_bad_page(peer_url.rstrip("/"))
            r.peer_bad_seen[peer_url] = count
        r.models = models
        r.healthy = not wedged
        r.watchdog = wd_state
        r.lifecycle = str(state.get("lifecycle") or "READY").upper()
        r.consecutive_failures = 0
        r.last_poll = self.clock.now()
        # gray-failure scoring: fold this poll's signals (latency-window
        # outliers vs the fleet, queue drain, watchdog state, recent
        # errors) into the replica's EWMA health score
        self.health.observe(r, self.replicas.values(),
                            error_level=self.decayed_errors(r))

    # recent-error half-life: a shedding replica is retried within ~30s of
    # its last error, not banished forever
    ERROR_DECAY_S = 30.0

    def decayed_errors(self, r: Replica) -> float:
        if r.error_ewma <= 0.0:
            return 0.0
        dt = max(self.clock.now() - r.last_error_t, 0.0)
        return r.error_ewma * math.exp(-dt / self.ERROR_DECAY_S)

    def observe_http_error(self, url: str) -> None:
        """A 4xx/5xx RESPONSE through the proxy (the replica is up but
        refusing/failing work — distinct from observe_failure's transport
        errors)."""
        r = self.replicas.get(url.rstrip("/"))
        if r is None:
            return
        r.error_ewma = self.decayed_errors(r) + 1.0
        r.last_error_t = self.clock.now()
        if self.breakers is not None:
            self.breakers.record_failure(r.url)
        self.health.record_canary(r.url, ok=False)

    def observe_success(self, url: str) -> None:
        """A 2xx served through the proxy: closes a half-open breaker and
        clears the transport-failure streak."""
        r = self.replicas.get(url.rstrip("/"))
        if r is None:
            return
        r.consecutive_failures = 0
        if self.breakers is not None:
            self.breakers.record_success(r.url)
        # deliberately NOT canary proof: a stream seated BEFORE the
        # quarantine completing would otherwise count as a probe result
        # — only observe_canary (attributed to the pick that was the
        # canary) can reintroduce

    def observe_failure(self, url: str) -> None:
        r = self.replicas.get(url.rstrip("/"))
        if r is None:
            return
        r.consecutive_failures += 1
        if r.consecutive_failures >= self.unhealthy_after:
            r.healthy = False
        if self.breakers is not None:
            self.breakers.record_failure(r.url)
        self.health.record_canary(r.url, ok=False)

    async def refresh_once(self) -> None:
        """Poll every replica's state at once (a 2 s timeout each)."""
        if self._session is None:
            self._session = AsyncHTTPClient(timeout_s=POLL_TIMEOUT_S)

        async def one(r: Replica):
            try:
                resp = await self._session.get(r.url + self.state_path)
                if resp.status != 200:
                    raise OSError(f"status {resp.status}")
                self.observe_state(r.url, json.loads(bytes(resp.body)))
            except (HTTPError, OSError, asyncio.TimeoutError, ValueError) as exc:
                logger.debug("epp poll %s failed: %s", r.url, exc)
                self.observe_failure(r.url)

        await asyncio.gather(*[one(r) for r in self.replicas.values()])

    async def start_polling(self) -> None:
        async def loop():
            while True:
                try:
                    await self.refresh_once()
                except Exception as exc:  # noqa: BLE001 — the poll loop
                    # must survive anything; dead polling means routing on
                    # frozen state forever
                    logger.warning("epp poll cycle failed: %s", exc)
                await asyncio.sleep(self.poll_interval_s)

        self._poll_task = asyncio.get_running_loop().create_task(loop())

    async def close(self) -> None:
        if self._poll_task is not None:
            self._poll_task.cancel()
            self._poll_task = None
        if self._session is not None:
            await self._session.aclose()
            self._session = None

    # ---------------- picking ----------------

    def _prefix_hits(
        self,
        r: Replica,
        prompt_ids: Optional[Sequence[int]],
        chains: Dict[int, List[bytes]],
    ) -> int:
        """Longest leading page run cached on `r`, scored per model so a
        multi-model replica's page sizes and digest sets never mix.
        `chains` memoizes the per-page-size digest chain across every
        replica/model of one pick() — blake2b over the whole prompt is
        O(prompt_len), so recomputing it per replica would make a pick
        O(replicas x models x prompt_len) on long prompts (ADVICE r4:
        setdefault always evaluated its default eagerly, defeating the
        cache it was meant to be)."""
        if not prompt_ids:
            return 0
        best = 0
        for page_size, digests in r.models.values():
            if not digests:
                continue
            if page_size not in chains:
                chains[page_size] = token_prefix_digests(
                    prompt_ids, page_size, for_lookup=True
                )
            hits = 0
            for key in chains[page_size]:
                if key not in digests:
                    break
                hits += 1
            best = max(best, hits)
        return best

    def _resident_hits(
        self,
        r: Replica,
        prompt_ids: Optional[Sequence[int]],
        chains: Dict[int, List[bytes]],
    ) -> int:
        """Expected-prefix-hit term for the peer fabric: the longest
        leading page run of this prompt that `r` holds PERSIST-resident
        (its advertised digest-set wire).  Those pages are one verified
        page-in from being HBM hits — cheaper than a re-prefill even
        when the HBM cache is cold, so routing leans toward the replica
        that already durably holds the prefix.  Shares the per-page-size
        chain memo with _prefix_hits."""
        if not prompt_ids or not r.peer_digest_set:
            return 0
        best = 0
        for page_size, _ in r.models.values():
            if page_size not in chains:
                chains[page_size] = token_prefix_digests(
                    prompt_ids, page_size, for_lookup=True
                )
            hits = 0
            for key in chains[page_size]:
                if key not in r.peer_digest_set:
                    break
                hits += 1
            best = max(best, hits)
        return best

    def _text_hits(self, r: Replica, text: Optional[str]) -> int:
        if not text:
            return 0
        hits = 0
        for key in text_prefix_digests(text):
            if self._text_affinity.get(key) != r.url:
                break
            hits += 1
        return hits

    def observe_canary(self, url: str, ok: bool,
                       ttft_s: Optional[float] = None,
                       tpot_s: Optional[float] = None) -> None:
        """Report the outcome of a canary pick (pick_ex returned
        is_canary=True).  Optional latency measurements let the health
        layer reject a 200-but-gray-slow probe (scheduler/health.py)."""
        self.health.record_canary(url, ok, ttft_s=ttft_s, tpot_s=tpot_s)

    def pick(
        self,
        prompt_ids: Optional[Sequence[int]] = None,
        prompt_text: Optional[str] = None,
    ) -> Optional[Replica]:
        """pick_ex without the canary marker (legacy callers).  A canary
        pick made through here never gets its outcome reported; the
        health layer re-arms it after canary_timeout_s."""
        return self.pick_ex(prompt_ids=prompt_ids, prompt_text=prompt_text)[0]

    def pick_ex(
        self,
        prompt_ids: Optional[Sequence[int]] = None,
        prompt_text: Optional[str] = None,
        allow_canary: bool = True,
    ) -> tuple:
        """(replica, is_canary).  Best replica for this request, or
        (None, False) when none is healthy.  `allow_canary=False` is for
        callers that cannot report the probe's outcome (the advisory
        /pick API): a canary whose result never comes back would burn
        one real request per interval on the sick replica for nothing.
        Replicas with an open circuit breaker — or a DRAINING/TERMINATING
        lifecycle state — are excluded from the pick (half-open replicas
        stay in as probe traffic); QUARANTINED replicas (gray-failure
        health, scheduler/health.py) are excluded too, except that one
        due for its periodic canary re-probe carries exactly one live
        request — the reintroduction path.  All-excluded falls through
        to None -> 503 upstream."""
        now = self.clock.now()
        candidates = [
            r for r in self.replicas.values()
            if r.healthy
            and r.lifecycle not in ("DRAINING", "TERMINATING")
            and (self.breakers is None or self.breakers.available(r.url))
        ]
        healthy = [r for r in candidates
                   if not self.health.is_quarantined(r.url)]
        # canary re-probe: at most one quarantined replica per reprobe
        # interval rides a real request.  With healthy peers it steals one
        # pick; with NONE it is the only recovery path (an all-quarantined
        # fleet must not deadlock into permanent 503s).
        if allow_canary:
            for r in candidates:
                if (self.health.is_quarantined(r.url)
                        and self.health.wants_canary(r.url, now)):
                    self.health.canary_started(r.url, now)
                    return r, True
        if not healthy:
            return None, False
        prompt_len = estimate_prompt_len(prompt_ids, prompt_text)
        scored = []
        chains: Dict[int, List[bytes]] = {}
        for i, r in enumerate(healthy):
            hits = max(
                self._prefix_hits(r, prompt_ids, chains),
                self._text_hits(r, prompt_text),
            )
            score = hits * self.prefix_weight - r.queue_depth * self.queue_weight
            if self.resident_weight > 0:
                score += self.resident_weight * self._resident_hits(
                    r, prompt_ids, chains)
            score -= self.error_weight * self.decayed_errors(r)
            # gray-degradation weight reduction: a DEGRADED replica sheds
            # pick share smoothly before quarantine hard-cuts it.  Gated
            # on status, not raw score: healthy replicas' score jitter
            # must not break the equal-score ties that round-robin a
            # same-instant burst across the fleet (queue depths are
            # stale within one poll interval — a continuous penalty
            # would aim the whole burst at a single replica)
            if self.health.status(r.url) != "healthy":
                score -= self.health_weight * (1.0 - self.health.score(r.url))
            if self.latency_predictor is not None and self.latency_weight > 0:
                # SLO-aware term: penalize replicas the online model expects
                # to be slow for THIS prompt at THEIR current depth; cold
                # replicas (predict -> None) stay un-penalized
                ttft = self.latency_predictor.predict_ttft(
                    r.url, prompt_len, r.queue_depth)
                if ttft is not None:
                    score -= self.latency_weight * ttft
            # free pages as a mild tiebreak, round-robin as the final one
            scored.append((score, r.free_pages, -((i - self._rr) % len(healthy)), r))
        scored.sort(key=lambda t: t[:3], reverse=True)
        best = scored[0][3]
        self._rr = (self._rr + 1) % max(len(healthy), 1)
        if prompt_text:
            self._learn_text(best.url, prompt_text)
        return best, False

    def _learn_text(self, url: str, text: str) -> None:
        for key in text_prefix_digests(text):
            self._text_affinity[key] = url
            self._text_affinity.move_to_end(key)
        while len(self._text_affinity) > self.MAX_TEXT_AFFINITY:
            self._text_affinity.popitem(last=False)

    def snapshot(self) -> List[dict]:
        return [
            {
                "url": r.url,
                "healthy": r.healthy,
                "lifecycle": r.lifecycle,
                "queue_depth": r.queue_depth,
                "inflight": r.inflight,
                "free_pages": r.free_pages,
                "digests": len(r.digests),
                "sheds_total": r.sheds_total,
                "shedding": r.shedding,
                "ttft_p99_s": r.ttft_p99_s,
                "itl_p99_s": r.itl_p99_s,
                "prefix_store": r.prefix_store,
                "peer_pages": r.peer_pages,
                "watchdog": r.watchdog,
                "health": self.health.snapshot(r.url),
                "breaker": (
                    self.breakers.state(r.url)
                    if self.breakers is not None else None
                ),
            }
            for r in self.replicas.values()
        ]
