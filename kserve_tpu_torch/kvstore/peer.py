"""Cross-replica KV page fabric: verified peer page-in.

Port of kserve_tpu/kvstore/peer.py.  A cache-cold replica need not
prefill a prefix that a peer already holds in its persistent store.  The
client half and the wire contract both halves share:

- ``encode_page`` / ``decode_page``: the self-verifying wire form of one
  page, byte-identical to the JAX package's.  The digest chain
  (scheduler/prefix.py) commits to the prefix's tokens and the page
  size; the trailer binds the requested digest to the exact payload
  bytes, so a tampered, truncated or mis-keyed page fails verification
  before it is adopted.
- ``decode_payload``: the verified file bytes as a payload.  They are the
  port's persist format 2 (kvstore/payload.py: bfloat16 as int16 bits
  with dtype tags); a JAX peer's format-1 page fails here, is counted
  like a corrupt one and reads as a miss, never adopted or misread.
- ``PeerPageIndex``: which peer holds which digests, fed by the bounded,
  generation-stamped digest-set wire form (``digest_set_wire``) that each
  replica's scheduler state carries under ``peer_pages``.
- ``PeerPageClient``: the fetch path over the port's HTTP client
  (protocol/http_client.py): per-peer retries under a hard per-fetch
  deadline on an injected clock, a breaker per peer URL, bounded
  concurrency and mandatory verification.  Every failure degrades to a
  miss: the engine prefills the page, so a peer fault costs time, never
  correctness.

The server half is ``GET /v1/internal/kv/pages/{digest}`` on the port's
REST server, which answers ``encode_page`` of a persisted entry's bytes.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..metrics import KV_PEER_FETCH_SECONDS, KV_PEER_FETCH_TOTAL
from ..protocol.http_client import AsyncHTTPClient, HTTPError, Response
from ..resilience import MONOTONIC, BreakerRegistry, Clock, RetryPolicy
from ..resilience.retry import parse_retry_after
from .payload import Payload, payload_from_arrays
from .persist import PERSIST_FORMAT

logger = logging.getLogger(__name__)

#: URL prefix of the page route (server and client)
PAGE_ROUTE = "/v1/internal/kv/pages"

#: the wire envelope's magic and version (the JAX package's: the envelope
#: is shared, the payload inside is each package's persist format)
MAGIC = b"KVPG"
WIRE_FORMAT = 1

_DIGEST_LEN = 16  # blake2b(digest_size=16): scheduler/prefix.py
_HEADER_LEN = len(MAGIC) + 2 + _DIGEST_LEN + 8  # magic, version, digest, length
_TRAILER_LEN = 16

#: the digest-set wire's bound (2,048 x 32 hex characters, ~64 KiB)
WIRE_MAX_DIGESTS = 2048

#: fetch outcomes (the kv_peer_fetch_total labels)
FETCH_OUTCOMES = ("hit", "miss", "corrupt", "timeout", "breaker_open")


class PageVerifyError(ValueError):
    """A peer's page failed verification: bad magic or version, another
    digest, a length skew, a checksum mismatch or a payload that does not
    parse.  The caller counts it, marks the peer and reads a miss."""


# ---------------------------------------------------------------- codec


def _trailer(digest: bytes, payload_bytes) -> bytes:
    h = hashlib.blake2b(digest, digest_size=_TRAILER_LEN)
    h.update(payload_bytes)
    return h.digest()


def encode_page(digest: bytes, payload_bytes: bytes) -> bytes:
    """One persisted page file's bytes, wrapped for the wire."""
    header = (MAGIC + WIRE_FORMAT.to_bytes(2, "big") + digest
              + len(payload_bytes).to_bytes(8, "big"))
    return header + payload_bytes + _trailer(digest, payload_bytes)


def decode_page(wire, expected_digest: bytes) -> memoryview:
    """Verify one wire page and return its payload file bytes (a view of
    `wire`).  Raises PageVerifyError on any discrepancy; the embedded
    digest must be the one the caller asked for, so a real page served
    under another key is refused like a flipped one."""
    wire = memoryview(wire)
    if len(wire) < _HEADER_LEN + _TRAILER_LEN:
        raise PageVerifyError(f"short wire page: {len(wire)} bytes")
    if wire[:len(MAGIC)] != MAGIC:
        raise PageVerifyError("bad magic")
    version = int.from_bytes(wire[len(MAGIC):len(MAGIC) + 2], "big")
    if version != WIRE_FORMAT:
        raise PageVerifyError(f"wire format skew: {version} != {WIRE_FORMAT}")
    off = len(MAGIC) + 2
    if wire[off:off + _DIGEST_LEN] != expected_digest:
        raise PageVerifyError("digest mismatch: page keyed for another prefix")
    off += _DIGEST_LEN
    length = int.from_bytes(wire[off:off + 8], "big")
    payload_bytes = wire[_HEADER_LEN:_HEADER_LEN + length]
    trailer = wire[_HEADER_LEN + length:]
    if len(payload_bytes) != length or len(trailer) != _TRAILER_LEN:
        raise PageVerifyError("truncated wire page")
    if trailer != _trailer(expected_digest, payload_bytes):
        raise PageVerifyError("checksum mismatch")
    return payload_bytes


def decode_payload(payload_bytes) -> Payload:
    """The verified file bytes as a payload of CPU tensors (the layout
    PersistentPrefixStore writes).  Bytes that passed the checksum but do
    not parse, or another persist format, are a PageVerifyError all the
    same: the serving store's entry was unusable before it was wrapped."""
    try:
        with np.load(io.BytesIO(payload_bytes)) as data:
            fmt = int(data["fmt"])
            if fmt != PERSIST_FORMAT:
                raise ValueError(f"persist format skew: {fmt} != {PERSIST_FORMAT}")
            return payload_from_arrays(data)
    except Exception as exc:  # noqa: BLE001 — np.load fails in many ways
        # (OSError, ValueError, BadZipFile, KeyError); each means the
        # same here: an unusable page, counted and read as a miss
        raise PageVerifyError(
            f"undecodable payload: {type(exc).__name__}: {exc}") from exc


# ----------------------------------------------------------- digest sets


def digest_set_wire(generation: int, digests: List[bytes],
                    cap: int = WIRE_MAX_DIGESTS) -> Dict:
    """The compact, generation-stamped summary of the digests a replica
    serves (its scheduler state's ``peer_pages``)."""
    ordered = sorted(digests)
    return {
        "generation": int(generation),
        "digests": [d.hex() for d in ordered[:cap]],
        "truncated": len(ordered) > cap,
    }


class PeerPageIndex:
    """digest -> the peers whose persistent stores hold it.  `update(url,
    wire)` takes one peer's digest-set wire; a set of a lower generation
    than the one held is stale and ignored."""

    def __init__(self) -> None:
        # url -> (generation, frozenset of digests)
        self._peers: Dict[str, Tuple[int, frozenset]] = {}

    def update(self, url: str, wire: Optional[Dict]) -> bool:
        """Take one peer's advertised set; False when it is ignored (a
        stale generation or a wire that does not parse)."""
        if not isinstance(wire, dict):
            return False
        try:
            generation = int(wire.get("generation", 0))
            digests = frozenset(bytes.fromhex(h) for h in wire.get("digests", ()))
        except (TypeError, ValueError):
            return False
        current = self._peers.get(url)
        if current is not None and generation < current[0]:
            return False
        self._peers[url] = (generation, digests)
        return True

    def forget(self, url: str) -> None:
        self._peers.pop(url, None)

    def peers_for(self, digest: bytes) -> List[str]:
        """The peers holding `digest`, in a deterministic order."""
        return sorted(url for url, (_, digests) in self._peers.items()
                      if digest in digests)

    def has(self, digest: bytes) -> bool:
        return any(digest in ds for _, ds in self._peers.values())

    def generation(self, url: str) -> Optional[int]:
        entry = self._peers.get(url)
        return entry[0] if entry is not None else None

    def snapshot(self) -> Dict[str, Dict]:
        return {url: {"generation": gen, "digests": len(digests)}
                for url, (gen, digests) in sorted(self._peers.items())}


# ---------------------------------------------------------------- client


class _FetchDeadline:
    """A fetch's hard cap on the injected clock, shaped like
    resilience.Deadline for RetryPolicy.next_delay."""

    def __init__(self, clock: Clock, budget_s: float):
        self._clock = clock
        self._t0 = clock.now()
        self._budget = budget_s

    def remaining(self) -> float:
        return self._budget - (self._clock.now() - self._t0)


class PeerPageClient:
    """Verified peer page fetches over the resilience primitives.  Every
    wait goes through the injected clock and the HTTP client's transport,
    so under a FakeClock and a handler transport nothing sleeps in real
    time.  Outcomes, as in the JAX package:

    - a corrupt page: counted, ``on_bad_page(peer)`` told, never retried
      against that peer, a miss;
    - a partition: retries, then a breaker failure; an open breaker skips
      the peer outright (local-only);
    - a slow peer: past the per-fetch deadline, a miss;
    - a 404: a clean miss (the index was stale), a breaker success."""

    def __init__(
        self,
        client: AsyncHTTPClient,
        *,
        index: Optional[PeerPageIndex] = None,
        self_url: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        breakers: Optional[BreakerRegistry] = None,
        max_concurrent: int = 4,
        fetch_deadline_s: float = 2.0,
        clock: Clock = MONOTONIC,
        on_bad_page: Optional[Callable[[str], None]] = None,
    ):
        self.client = client
        self.index = index if index is not None else PeerPageIndex()
        self.self_url = self_url
        self.retry = retry or RetryPolicy(
            max_attempts=3, base_backoff_s=0.05, max_backoff_s=0.5,
            retry_budget_s=fetch_deadline_s, seed=0)
        self.breakers = breakers or BreakerRegistry(clock=clock)
        self.fetch_deadline_s = fetch_deadline_s
        self.clock = clock
        self.on_bad_page = on_bad_page
        self._sem = asyncio.Semaphore(max_concurrent)
        # outcome counts (kv_peer_fetch_total) and bad pages per peer: the
        # scheduler state's `peer` block
        self.stats: Dict[str, int] = {k: 0 for k in FETCH_OUTCOMES}
        self.bad_pages: Dict[str, int] = {}

    def _outcome(self, outcome: str) -> None:
        self.stats[outcome] += 1
        KV_PEER_FETCH_TOTAL.labels(outcome=outcome).inc()

    def _note_bad(self, peer_url: str) -> None:
        self.bad_pages[peer_url] = self.bad_pages.get(peer_url, 0) + 1
        logger.warning("kv-peer-bad-page peer=%s: page failed verification, "
                       "degrading to miss", peer_url)
        if self.on_bad_page is not None:
            self.on_bad_page(peer_url)

    def snapshot(self) -> Dict:
        """The `peer` block of the engine's scheduler state."""
        return {
            "fetches": dict(sorted(self.stats.items())),
            "bad_pages": dict(sorted(self.bad_pages.items())),
            "breakers": dict(sorted(self.breakers.snapshot().items())),
            "index": self.index.snapshot(),
        }

    async def fetch_page(self, digest: bytes) -> Optional[Payload]:
        """One verified page from the first indexed peer that serves it
        (candidates in a fixed order), or None; never raises."""
        for peer_url in self.index.peers_for(digest):
            if self.self_url is not None and peer_url == self.self_url:
                continue
            payload = await self.fetch_from(peer_url, digest)
            if payload is not None:
                return payload
        return None

    async def fetch_from(self, peer_url: str, digest: bytes) -> Optional[Payload]:
        """One verified page from one peer, or None."""
        if not self.breakers.allow(peer_url):
            self._outcome("breaker_open")
            return None
        async with self._sem:
            return await self._fetch_locked(peer_url, digest)

    async def _fetch_locked(self, peer_url: str, digest: bytes) -> Optional[Payload]:
        started = self.clock.now()
        deadline = _FetchDeadline(self.clock, self.fetch_deadline_s)
        attempt = 0
        while True:
            attempt += 1
            response: Optional[Response] = None
            try:
                response = await self.client.get(
                    f"{peer_url}{PAGE_ROUTE}/{digest.hex()}")
            except HTTPError:
                pass  # partition, timeout, torn answer: maybe retried below
            if response is not None and deadline.remaining() <= 0.0:
                # a straggler: even a verifiable page this late is a miss,
                # so one slow peer cannot hold an admission back
                self.breakers.record_failure(peer_url)
                self._outcome("timeout")
                return None
            if response is not None and response.status == 404:
                self.breakers.record_success(peer_url)
                self._outcome("miss")
                return None
            if response is not None and response.status == 200:
                try:
                    payload = decode_payload(decode_page(response.body, digest))
                except PageVerifyError as exc:
                    # the lying peer: never retried
                    logger.warning("kv-peer-page-verify-failed peer=%s digest=%s "
                                   "error=%s", peer_url, digest.hex(), exc)
                    self.breakers.record_failure(peer_url)
                    self._note_bad(peer_url)
                    self._outcome("corrupt")
                    return None
                self.breakers.record_success(peer_url)
                self._outcome("hit")
                KV_PEER_FETCH_SECONDS.observe(self.clock.now() - started)
                return payload
            retry_after = None
            if response is not None:
                if not self.retry.retryable(response.status):
                    self.breakers.record_failure(peer_url)
                    self._outcome("timeout")
                    return None
                retry_after = parse_retry_after(response.headers.get("retry-after"))
            delay = self.retry.next_delay(
                attempt, retry_after=retry_after,
                elapsed=self.clock.now() - started, deadline=deadline)
            if delay is None or deadline.remaining() <= 0.0:
                self.breakers.record_failure(peer_url)
                self._outcome("timeout")
                return None
            await self.clock.sleep(delay)
