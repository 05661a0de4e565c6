"""Host-RAM and disk KV tiers with lru or arc eviction between them.

Port of kserve_tpu/kvstore/tiers.py.  The engine spills a preempted
lane's KV pages here and injects them back when it resumes; an entry the
store had to drop is prefilled again, so dropping costs time, never
correctness.  Entry stamps come from an injectable clock.

Payloads are dicts of CPU tensors (kvstore/payload.py), so an int8
cache's pages and scales are one payload.  Disk entries are `.npz` files
in a per-process directory under `disk_dir`; host-to-disk demotion is the
host tier's eviction, and a full disk drops the policy's coldest entry.

Policies:
- lru: strict recency (OrderedDict order, refreshed on touch).
- arc: T1 (seen once) and T2 (seen again) with ghost lists B1/B2 whose
  hits adapt T1's target share `p`.  For spill traffic it acts as LRU
  until lanes are resumed and spilled again, which it then protects over
  one-time spills.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import tempfile
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..resilience import MONOTONIC, Clock
from .payload import Payload, payload_arrays, payload_from_arrays, payload_nbytes

logger = logging.getLogger(__name__)

DEFAULT_DISK_DIR = os.path.join(tempfile.gettempdir(), "kserve-tpu-kv")


@dataclass
class TierConfig:
    host_bytes: int = 0
    disk_bytes: int = 0
    disk_dir: str = DEFAULT_DISK_DIR
    policy: str = "lru"  # lru | arc


@dataclass
class _Entry:
    nbytes: int
    tier: str  # "host" | "disk"
    payload: Optional[Payload] = None  # host tier
    path: Optional[str] = None  # disk tier
    hits: int = 0
    stored_at: float = 0.0  # from the injected clock


class _ARCState:
    """Ghost lists and adaptation of the arc policy (keys only)."""

    def __init__(self):
        self.t1: "OrderedDict[str, None]" = OrderedDict()  # seen once
        self.t2: "OrderedDict[str, None]" = OrderedDict()  # seen again
        self.b1: "OrderedDict[str, None]" = OrderedDict()  # ghosts of t1
        self.b2: "OrderedDict[str, None]" = OrderedDict()  # ghosts of t2
        self.p = 0.0  # target share of capacity for t1

    def on_insert(self, key: str) -> None:
        if key in self.b1:
            # a ghost hit in b1: recency wins, t1's share grows
            self.p = min(1.0, self.p + max(1.0 / max(len(self.b1), 1), 0.05))
            del self.b1[key]
            self.t2[key] = None
        elif key in self.b2:
            self.p = max(0.0, self.p - max(1.0 / max(len(self.b2), 1), 0.05))
            del self.b2[key]
            self.t2[key] = None
        elif key in self.t1:
            del self.t1[key]
            self.t2[key] = None
        elif key in self.t2:
            self.t2.move_to_end(key)
        else:
            self.t1[key] = None

    def on_touch(self, key: str) -> None:
        if key in self.t1:
            del self.t1[key]
            self.t2[key] = None
        elif key in self.t2:
            self.t2.move_to_end(key)

    def pick_victim(self, resident) -> Optional[str]:
        """The coldest resident key: from t1 while it exceeds its target
        share, else from t2 (LRU within each list)."""
        t1_resident = [k for k in self.t1 if k in resident]
        t2_resident = [k for k in self.t2 if k in resident]
        total = len(t1_resident) + len(t2_resident)
        if not total:
            return None
        want_t1 = self.p * total
        if t1_resident and (len(t1_resident) > want_t1 or not t2_resident):
            victim = t1_resident[0]
            del self.t1[victim]
            self.b1[victim] = None
            while len(self.b1) > 512:
                self.b1.popitem(last=False)
            return victim
        victim = t2_resident[0]
        del self.t2[victim]
        self.b2[victim] = None
        while len(self.b2) > 512:
            self.b2.popitem(last=False)
        return victim

    def forget(self, key: str) -> None:
        for lst in (self.t1, self.t2, self.b1, self.b2):
            lst.pop(key, None)


def _read_npz(path: str) -> Payload:
    with np.load(path) as data:
        return payload_from_arrays(data)


class KVTierStore:
    """The host/disk tier pair.  `on_event(tier, event)` (optional) sees
    demotions and pressure drops, which happen deep in the eviction
    cascade."""

    def __init__(self, config: TierConfig, clock: Clock = MONOTONIC,
                 on_event: Optional[Callable[[str, str], None]] = None):
        if config.policy not in ("lru", "arc"):
            raise ValueError(f"unknown eviction policy {config.policy!r}")
        self.config = config
        self.clock = clock
        self._on_event = on_event
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.host_used = 0
        self.disk_used = 0
        self._arc = _ARCState() if config.policy == "arc" else None
        self._dir: Optional[str] = None
        self.drops = 0  # entries lost to pressure (their resume re-prefills)

    # ---------------- internals ----------------

    def _event(self, tier: str, event: str) -> None:
        if self._on_event is not None:
            self._on_event(tier, event)

    def _ensure_dir(self) -> str:
        if self._dir is None:
            self._sweep_stale_dirs()
            path = os.path.join(
                self.config.disk_dir, f"kv-{os.getpid()}-{uuid.uuid4().hex[:8]}")
            os.makedirs(path, exist_ok=True)
            self._dir = path
        return self._dir

    def _sweep_stale_dirs(self) -> None:
        """Remove the spill directories of dead processes.  Only this
        process's accounting unlinks spill files, so a crashed server
        leaks its kv-<pid>-<rand> directory, and on a persistent volume
        those leaks would fill it.  A directory whose pid is alive (another
        engine on a shared volume, or this process) is left alone."""
        try:
            names = os.listdir(self.config.disk_dir)
        except OSError:
            return
        for name in names:
            m = re.fullmatch(r"kv-(\d+)-[0-9a-f]+", name)
            if not m:
                continue
            try:
                os.kill(int(m.group(1)), 0)
                continue  # alive
            except ProcessLookupError:
                pass
            except PermissionError:
                continue  # exists, owned by someone else: alive
            shutil.rmtree(os.path.join(self.config.disk_dir, name),
                          ignore_errors=True)

    def _pick_host_victim(self) -> Optional[str]:
        host = {k for k, e in self._entries.items() if e.tier == "host"}
        if not host:
            return None
        if self._arc is not None:
            victim = self._arc.pick_victim(host)
            if victim is not None:
                return victim
        for k in self._entries:  # insertion/touch order = LRU
            if k in host:
                return k
        return None

    def _demote_to_disk(self, key: str) -> bool:
        entry = self._entries[key]
        if self.config.disk_bytes <= 0:
            return False
        while self.disk_used + entry.nbytes > self.config.disk_bytes:
            disk_keys = [k for k, e in self._entries.items() if e.tier == "disk"]
            if not disk_keys:
                return False
            self._drop(disk_keys[0])
        path = os.path.join(self._ensure_dir(), f"{uuid.uuid4().hex}.npz")
        np.savez(path, **payload_arrays(entry.payload))
        entry.path = path
        entry.payload = None
        entry.tier = "disk"
        self.host_used -= entry.nbytes
        self.disk_used += entry.nbytes
        self._event("disk", "demote")
        return True

    def _drop(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._release(entry)
        if self._arc is not None:
            self._arc.forget(key)
        self.drops += 1
        self._event(entry.tier, "drop")
        logger.debug("kv tier store dropped %s under pressure", key)

    def _release(self, entry: _Entry) -> None:
        """Return an entry's bytes to its tier (and unlink its file)."""
        if entry.tier == "host":
            self.host_used -= entry.nbytes
            return
        self.disk_used -= entry.nbytes
        if entry.path:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    # ---------------- public API ----------------

    def put(self, key: str, payload: Payload) -> bool:
        """Store, host first.  False: it fits nowhere, and the caller
        recomputes on resume."""
        nbytes = payload_nbytes(payload)
        if key in self._entries:
            self.discard(key)
        if nbytes > max(self.config.host_bytes, self.config.disk_bytes):
            return False
        # make room on the host by demoting cold entries to disk
        while self.host_used + nbytes > self.config.host_bytes:
            victim = self._pick_host_victim()
            if victim is None:
                break
            if not self._demote_to_disk(victim):
                self._drop(victim)
        entry = _Entry(nbytes=nbytes, tier="host", payload=payload,
                       stored_at=self.clock.now())
        if self.host_used + nbytes <= self.config.host_bytes:
            self._entries[key] = entry
            self.host_used += nbytes
        elif self.config.disk_bytes > 0:
            self._entries[key] = entry
            self.host_used += nbytes
            if not self._demote_to_disk(key):
                self._entries.pop(key, None)
                self.host_used -= nbytes
                return False
        else:
            return False
        if self._arc is not None:
            self._arc.on_insert(key)
        return True

    def contains(self, key: str) -> bool:
        return key in self._entries

    def keys(self) -> list:
        return list(self._entries)

    def nbytes(self, key: str) -> int:
        entry = self._entries.get(key)
        return entry.nbytes if entry is not None else 0

    def tier_of(self, key: str) -> Optional[str]:
        entry = self._entries.get(key)
        return entry.tier if entry is not None else None

    def would_fit(self, nbytes: int) -> bool:
        """Upper bound, checked before the device gather: eviction can free
        everything else, but never more than a tier's budget."""
        return nbytes <= max(self.config.host_bytes, self.config.disk_bytes)

    def get(self, key: str, consume: bool = True) -> Optional[Payload]:
        """An entry's payload.  consume=True (a spill: the resume consumes
        it) removes the entry; consume=False (a prefix page, which may be
        paged in again after the next eviction from the device) keeps it
        and refreshes its recency."""
        if not consume:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.hits += 1
            self._entries.move_to_end(key)
            if self._arc is not None:
                self._arc.on_touch(key)
            if entry.tier == "host":
                return entry.payload
            try:
                return _read_npz(entry.path)
            except (OSError, ValueError, KeyError):
                logger.warning("kv disk tier read failed for %s", key)
                self._drop(key)
                return None
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        if self._arc is not None:
            self._arc.on_touch(key)
        if entry.tier == "host":
            self.host_used -= entry.nbytes
            return entry.payload
        self.disk_used -= entry.nbytes
        try:
            return _read_npz(entry.path)
        except (OSError, ValueError, KeyError):
            logger.warning("kv disk tier read failed for %s", key)
            return None
        finally:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    def discard(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        self._release(entry)
        if self._arc is not None:
            self._arc.forget(key)

    def close(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None
