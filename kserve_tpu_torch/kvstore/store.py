"""The hierarchical KV page store: the spill and prefix paths over one
host/disk tier pair, above the persistent prefix layer.

Port of kserve_tpu/kvstore/store.py.  The engine holds one when host
offload or the persistent layer is configured.  Two key namespaces
share the tiers:

- spill entries (request-id keys, consumed on get): a preempted lane's
  whole KV, injected back on resume;
- prefix entries (``px-<digest hex>`` keys, not consumed): single
  prefix-cache pages demoted from the device, readable any number of
  times (a page can be paged in again after every eviction).

The persistent layer (persist.py) takes prefix pages only: reused pages
are written through as digest-named files, which a new process indexes
at construction, and serves to peers (`read_peer_page`, whose digest
set `resident_digest_wire` advertises; kvstore/peer.py).  Tier events
are counted in `events` ((tier, event) -> n) and exported as
``kv_tier_events_total``.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..metrics import KV_TIER_EVENTS
from ..resilience import MONOTONIC, Clock
from .payload import Payload, payload_nbytes
from .peer import digest_set_wire, encode_page
from .persist import PersistentPrefixStore
from .tiers import DEFAULT_DISK_DIR, KVTierStore, TierConfig

logger = logging.getLogger(__name__)

_PX = "px-"  # the prefix entries' key namespace in the shared tiers


@dataclass
class KVStoreConfig:
    host_bytes: int = 0
    disk_bytes: int = 0
    disk_dir: str = DEFAULT_DISK_DIR
    policy: str = "lru"  # lru | arc
    persist_dir: Optional[str] = None  # content-addressed prefix files


@dataclass
class PrefixStoreStats:
    """The prefix path's accounting (the JAX engine exports it in its
    scheduler state)."""

    hits: int = 0  # longest_prefix_run queries that found >= 1 page
    misses: int = 0  # queries that found nothing below the device
    demotions: int = 0  # device prefix pages demoted into the tiers
    pageins: int = 0  # pages brought back to the device
    pagein_tokens: int = 0  # tokens those pages hold
    pagein_tokens_by_tier: Dict[str, int] = field(default_factory=dict)
    persist_writes: int = 0  # digest files written through
    corrupt: int = 0  # persistent entries that failed to read back
    drops: int = 0  # tier entries lost to pressure

    def as_dict(self) -> Dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "demotions": self.demotions,
            "pageins": self.pageins,
            "pagein_tokens": self.pagein_tokens,
            "pagein_tokens_by_tier": dict(self.pagein_tokens_by_tier),
            "persist_writes": self.persist_writes,
            "corrupt": self.corrupt,
            "drops": self.drops,
        }


class HierarchicalKVStore:
    """Thread contract: the engine loop makes every change except
    ``get_prefix`` and ``put_prefix`` of a write-through, which run on a
    worker thread (page-in reads and persist writes overlap decoding).
    One lock guards the tier and persist state and the counters; it is
    held for dict operations and at most one page file's I/O."""

    def __init__(self, config: KVStoreConfig, clock: Clock = MONOTONIC):
        self.config = config
        self.stats = PrefixStoreStats()
        self.events: Dict[Tuple[str, str], int] = {}
        self._lock = threading.RLock()
        self.tiers = KVTierStore(
            TierConfig(host_bytes=config.host_bytes,
                       disk_bytes=config.disk_bytes,
                       disk_dir=config.disk_dir, policy=config.policy),
            clock=clock, on_event=self._on_tier_event)
        self.persist: Optional[PersistentPrefixStore] = None
        if config.persist_dir:
            self.persist = PersistentPrefixStore(
                config.persist_dir, on_event=self._on_persist_event)
            if len(self.persist):
                logger.info("kv persistent prefix store indexed: %d digest(s) "
                            "under %s", len(self.persist), config.persist_dir)

    # ---------------- events / accounting ----------------

    def _count(self, tier: str, event: str, n: int = 1) -> None:
        with self._lock:
            self.events[(tier, event)] = self.events.get((tier, event), 0) + n
        KV_TIER_EVENTS.labels(tier=tier, event=event).inc(n)

    def _on_tier_event(self, tier: str, event: str) -> None:
        self._count(tier, event)
        if event == "drop":
            self.stats.drops += 1

    def _on_persist_event(self, tier: str, event: str) -> None:
        self._count(tier, event)
        if event == "store":
            self.stats.persist_writes += 1
        elif event == "corrupt":
            self.stats.corrupt += 1

    @property
    def host_used(self) -> int:
        return self.tiers.host_used

    @property
    def disk_used(self) -> int:
        return self.tiers.disk_used

    @property
    def spill_bytes(self) -> int:
        """Bytes of spill entries (preempted lanes' KV, not prefix pages)
        in the tiers: back to 0 once every spill was injected or
        discarded."""
        with self._lock:
            return sum(self.tiers.nbytes(k) for k in self.tiers.keys()
                       if not k.startswith(_PX))

    def resident_prefix_digests(self) -> int:
        """Digests resident anywhere below the device (tiers and
        persistent layer, counted once)."""
        with self._lock:
            tiered = {k for k in self.tiers.keys() if k.startswith(_PX)}
            if self.persist is not None:
                tiered |= {_PX + d.hex() for d in self.persist.digests()}
            return len(tiered)

    def stats_dict(self) -> Dict:
        out = self.stats.as_dict()
        out["resident_digests"] = self.resident_prefix_digests()
        out["persist_digests"] = (
            len(self.persist) if self.persist is not None else 0)
        return out

    # ---------------- spill API (the engine's preemption) ----------------

    def put(self, key: str, payload: Payload) -> bool:
        with self._lock:
            return self.tiers.put(key, payload)

    def get(self, key: str) -> Optional[Payload]:
        """Fetch and remove (a resume consumes its spill)."""
        with self._lock:
            return self.tiers.get(key, consume=True)

    def contains(self, key: str) -> bool:
        with self._lock:
            return self.tiers.contains(key)

    def discard(self, key: str) -> None:
        with self._lock:
            self.tiers.discard(key)

    def would_fit(self, nbytes: int) -> bool:
        return self.tiers.would_fit(nbytes)

    # ---------------- prefix API (digest-chained pages) ----------------

    @property
    def accepts_prefix_pages(self) -> bool:
        """Whether an evicted prefix page has anywhere to land."""
        return (self.config.host_bytes > 0 or self.config.disk_bytes > 0
                or self.persist is not None)

    def put_prefix(self, digest: bytes, payload: Payload,
                   persist: bool = True) -> bool:
        """Demote or write through one prefix page: into the tiers (host
        first, then disk) and, with `persist`, into the persistent layer
        as well.  False: it landed nowhere (its next use prefills it)."""
        stored = False
        key = _PX + digest.hex()
        with self._lock:
            if self.config.host_bytes > 0 or self.config.disk_bytes > 0:
                if self.tiers.put(key, payload):
                    stored = True
            if persist and self.persist is not None:
                if self.persist.store(digest, payload):
                    stored = True
        return stored

    def record_demotion(self, n_pages: int) -> None:
        with self._lock:
            self.stats.demotions += n_pages
            if n_pages:
                self._count("host", "demote", n_pages)

    def prefix_tier_of(self, digest: bytes) -> Optional[str]:
        with self._lock:
            tier = self.tiers.tier_of(_PX + digest.hex())
            if tier is not None:
                return tier
            if self.persist is not None and digest in self.persist:
                return "persist"
            return None

    def longest_prefix_run(self, digests: Sequence[bytes]
                           ) -> List[Tuple[bytes, str]]:
        """The longest leading run of `digests` resident below the device,
        as [(digest, tier)]; counts a hit or a miss for every non-empty
        query."""
        run: List[Tuple[bytes, str]] = []
        with self._lock:
            for digest in digests:
                tier = self.prefix_tier_of(digest)
                if tier is None:
                    break
                run.append((digest, tier))
            if digests:
                if run:
                    self.stats.hits += 1
                else:
                    self.stats.misses += 1
        return run

    def get_prefix(self, digest: bytes) -> Optional[Tuple[Payload, str]]:
        """One prefix page, not consumed: (payload, source tier), or None
        when it is gone or unreadable (the run ends there and the rest is
        prefilled)."""
        with self._lock:
            key = _PX + digest.hex()
            tier = self.tiers.tier_of(key)
            if tier is not None:
                payload = self.tiers.get(key, consume=False)
                if payload is not None:
                    return payload, tier
            if self.persist is not None:
                payload = self.persist.load(digest)
                if payload is not None:
                    return payload, "persist"
            return None

    def record_pagein(self, pages_by_tier: Dict[str, int],
                      tokens_by_tier: Dict[str, int]) -> None:
        with self._lock:
            for tier, n in pages_by_tier.items():
                if n:
                    self._count(tier, "pagein", n)
                self.stats.pageins += n
            for tier, t in tokens_by_tier.items():
                self.stats.pagein_tokens += t
                self.stats.pagein_tokens_by_tier[tier] = (
                    self.stats.pagein_tokens_by_tier.get(tier, 0) + t)

    # ---------------- the peer page fabric (kvstore/peer.py) ----------------

    def read_peer_page(self, digest: bytes) -> Optional[bytes]:
        """The wire form of one persisted page for the peer page server, or
        None when the digest is not in the persistent layer.  Only that
        layer is served: its files are the bytes the wire's trailer binds
        to the digest, and the only tier a peer's index learns of."""
        if self.persist is None:
            return None
        raw = self.persist.read_page_bytes(digest)
        if raw is None:
            return None
        return encode_page(digest, raw)

    def resident_digest_wire(self) -> Optional[Dict]:
        """The bounded, generation-stamped digest set this replica serves
        (its scheduler state's ``peer_pages``), or None without the
        persistent layer."""
        if self.persist is None:
            return None
        with self._lock:
            return digest_set_wire(self.persist.generation, self.persist.digests())

    def needs_persist(self, digests: Sequence[bytes]) -> List[bytes]:
        """The digests not yet in the persistent layer (persist on reuse:
        a prefix hit shows a page is worth keeping across restarts)."""
        if self.persist is None or not self.persist.writable:
            return []
        with self._lock:
            return [d for d in digests if d not in self.persist]

    def close(self) -> None:
        with self._lock:
            self.tiers.close()


__all__ = ["HierarchicalKVStore", "KVStoreConfig", "PrefixStoreStats",
           "payload_nbytes"]
