"""Deterministic fault injection: port of kserve_tpu/resilience/faults.py
(`FaultSpec`, `FaultPlan`, `ReplicaCrashError`, `FaultInjectingTransport`).

A `FaultPlan` is a seeded, ordered list of `FaultSpec`s.  A call site
asks `plan.decide(target)` with a stable target string; the plan matches
by substring, counts matching calls and decides whether to inject.  The
same plan and call sequence give the same faults.  The engine honours two
targets: "engine.fetch" (kinds `wedge`: the fetch blew the step deadline,
and `replica_crash`: the process died) and "engine.preempt" (kind
`preempt`: the newest decoding lane goes back to the queue).

`FaultInjectingTransport` honours a plan in front of an HTTP transport of
protocol/http_client.py (the JAX package's wraps httpx), for every HTTP
kind and the peer page fabric's three: ``peer_corrupt`` (a 200 whose body
has one byte flipped: only the page's digest verification catches it),
``peer_partition`` (the peer is unreachable) and ``peer_slow`` (it answers
``latency_s * skew`` late, on the plan's clock).  One agreed difference:
``partial_stream`` raises ReadError at once, since the port's transports
hand back whole bodies (httpx returns a 200 whose body read fails).
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from ..protocol.http_client import (
    ConnectError,
    ReadError,
    ReadTimeout,
    Response,
    Transport,
)
from .clock import MONOTONIC, Clock


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


class FaultInjectingTransport:
    """An HTTP transport (protocol/http_client.Transport) honouring a
    FaultPlan in front of a real one.

    `handler(method, url, headers, body) -> (status, payload)` serves the
    calls that pass through (a `bytes` payload becomes an octet-stream
    body, anything else a JSON one), or `inner` (another transport, e.g. a
    SocketTransport) does.  The target handed to the plan is the request's
    host (the whole URL when it has none) with `target_suffix` appended,
    so transports that share one plan keep their specs apart."""

    def __init__(self, plan: FaultPlan, handler: Optional[Callable] = None,
                 inner: Optional[Transport] = None, clock: Clock = MONOTONIC,
                 target_suffix: str = ""):
        self.plan = plan
        self.handler = handler
        self.inner = inner
        self.clock = clock
        self.target_suffix = target_suffix
        self.calls: List[str] = []  # every call's target, in order
        # flapping: injections per spec (odd = the down leg)
        self._flaps: Dict[int, int] = {}

    async def __call__(self, method: str, url: str, headers: Dict[str, str],
                       body) -> Response:
        target = (urlsplit(url).hostname or url) + self.target_suffix
        self.calls.append(target)
        spec = self.plan.decide(target)
        if spec is None:
            return await self._serve(method, url, headers, body, target)
        kind = spec.kind
        if kind == "latency":
            await self.clock.sleep(spec.latency_s)
        elif kind in ("clock_skew", "slow_decode", "peer_slow"):
            # slow, not dead: the latency scaled by the skew, then served
            await self.clock.sleep(spec.latency_s * spec.skew)
        elif kind == "flapping":
            n = self._flaps[id(spec)] = self._flaps.get(id(spec), 0) + 1
            if n % 2:
                raise ConnectError("injected flapping (down leg)")
            await self.clock.sleep(spec.latency_s * spec.skew)
        elif kind in ("wedged_fetch", "wedge"):
            raise ReadTimeout(f"injected {kind}")
        elif kind in ("connect_error", "peer_partition", "replica_crash"):
            raise ConnectError(f"injected {kind}")
        elif kind == "peer_corrupt":
            # the lying peer: the real answer with one byte flipped under a
            # confident 200
            response = await self._serve(method, url, headers, body, target)
            data = bytearray(response.body) or bytearray(b"\x00")
            data[len(data) // 2] ^= 0xFF
            return Response(200, {"content-type": "application/octet-stream",
                                  "content-length": str(len(data))}, data)
        elif kind == "partial_stream":
            raise ReadError("injected partial stream")
        elif kind == "http_status":
            headers_out = {"content-type": "application/json"}
            if spec.retry_after_s is not None:
                headers_out["retry-after"] = f"{spec.retry_after_s:g}"
            return Response(spec.status, headers_out, json.dumps(
                {"error": f"injected {spec.status}"}).encode())
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        return await self._serve(method, url, headers, body, target)

    async def _serve(self, method, url, headers, body, target) -> Response:
        """The pass-through leg (also the answer peer_corrupt flips)."""
        if self.inner is not None:
            return await self.inner(method, url, headers, body)
        if self.handler is None:
            return Response(200, {"content-type": "application/json"},
                            json.dumps({"ok": True, "target": target}).encode())
        status, payload = self.handler(method, url, headers, body)
        if isinstance(payload, (bytes, bytearray, memoryview)):
            return Response(status, {"content-type": "application/octet-stream"},
                            bytes(payload))
        return Response(status, {"content-type": "application/json"},
                        json.dumps(payload).encode())

    async def aclose(self) -> None:
        close = getattr(self.inner, "aclose", None)
        if close is not None:
            await close()
