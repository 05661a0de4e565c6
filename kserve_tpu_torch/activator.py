"""Scale-to-zero activator: the hold-and-replay gateway of the zero window
(port of kserve_tpu/activator.py, on the port's standard-library wire:
protocol/rest/http_server.py and protocol/http_client.py).

A request that arrives while the backend is down is parked on a bounded,
deadline-aware `HoldQueue` (autoscale/hold.py).  The first hold starts
exactly one wake for the whole cohort (`scale_up`, then readiness polls);
a hold that outlives its `x-request-deadline` budget answers **504**, an
arrival at a full queue **503 + Retry-After**, and a failed wake answers
504 to every parked request at once, then 503 + Retry-After for a short
poison window.  On release each request replays against the backend in
arrival order, its answer relayed chunk by chunk with no total timeout
(only the connect is bounded).  Request and response heads take
`CHECKPOINT_FIELD_SIZE_LIMIT`-sized fields, so a resume carrying
`x-generation-checkpoint` rides through the zero window like any other
request.  A warm request passes straight through with one hop; a connect
failure to a backend believed ready holds it again and replays it once.
A backend that keeps accepting in its zero window (an EPP in front of
the replicas answers 503 "no healthy replica") refuses no connect, so
whatever stops its last replica calls `scaled_to_zero()` (ROADMAP C21).

Routes: GET /activator/stats (the JAX keys); anything else is proxied.

In a cluster the wake is a replicas patch through the apiserver
(`deployment_scaler`); the EPP-signal autoscaler (autoscale/) owns the
count from there.  In tests and in chip_smoke.py it is a callback.

Usage: python -m kserve_tpu_torch.activator --backend URL [--port P]
       [--deployment NAME --master URL | --in-cluster]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
from typing import Awaitable, Callable, Dict, Optional, Tuple

from .autoscale.hold import HoldExpiredError, HoldOverflowError, HoldQueue
from .logging import configure_logging
from .metrics import GATEWAY_HOLDS
from .protocol.http_client import AsyncHTTPClient, ConnectError, HTTPError, ReadError
from .protocol.rest.http_server import HOP_HEADERS, HTTPServer
from .resilience import MONOTONIC, Clock, Deadline
from .resilience.deadline import DEADLINE_HEADER

logger = logging.getLogger(__name__)

# seconds a backend may take to accept the proxied connection (its answer
# then takes as long as the generation runs); the readiness probe's whole
# exchange gets PROBE_TIMEOUT_S
CONNECT_TIMEOUT_S = 10.0
PROBE_TIMEOUT_S = 2.0
STATS_PATH = "/activator/stats"

# a terminal answer of a hold: (status, JSON body, extra headers)
Terminal = Tuple[int, dict, Dict[str, str]]


class WakeFailedError(RuntimeError):
    """The backend never became ready inside the wake budget (-> 504 for
    every request parked behind the wake)."""


class Activator(HTTPServer):
    """The gateway in front of `backend_url`.  `start()` listens and returns
    the bound port (`port=0` picks a free one); `stop()` fails every hold
    and closes the server."""

    def __init__(
        self,
        backend_url: str,
        scale_up: Optional[Callable[[], Awaitable[None]]] = None,
        readiness_path: str = "/v2/health/ready",
        poll_interval: float = 0.25,
        wake_timeout: float = 120.0,
        port: int = 8012,
        max_holds: int = 512,
        hold_timeout_s: Optional[float] = None,  # None = wake_timeout
        clock: Clock = MONOTONIC,
    ):
        super().__init__("0.0.0.0", port)
        self.backend_url = backend_url.rstrip("/")
        self.scale_up = scale_up
        self.readiness_path = readiness_path
        self.poll_interval = poll_interval
        self.wake_timeout = wake_timeout
        self.clock = clock
        self.holds = HoldQueue(
            clock=clock,
            max_holds=max_holds,
            default_hold_s=(hold_timeout_s if hold_timeout_s is not None
                            else wake_timeout),
            retry_after_s=min(wake_timeout / 4, 10.0),
        )
        self._client: Optional[AsyncHTTPClient] = None
        self._probe: Optional[AsyncHTTPClient] = None
        self._wake_task: Optional[asyncio.Task] = None
        self._backend_ready = False
        # a failed wake poisons the cohort briefly: requests arriving just
        # after fail fast instead of parking behind a doomed wake and
        # firing redundant scale-ups
        self._wake_failed_until = 0.0
        self.stats = {"buffered": 0, "proxied": 0, "cold_start_s": None,
                      "held_now": 0, "replayed": 0, "expired": 0,
                      "overflow": 0, "wake_failed": 0}

    def _clients(self) -> Tuple[AsyncHTTPClient, AsyncHTTPClient]:
        """(proxy client, readiness-probe client), made on first use."""
        if self._client is None:
            self._client = AsyncHTTPClient(timeout_s=CONNECT_TIMEOUT_S)
            self._probe = AsyncHTTPClient(timeout_s=PROBE_TIMEOUT_S)
        return self._client, self._probe

    async def _backend_is_ready(self) -> bool:
        _, probe = self._clients()
        try:
            resp = await probe.get(self.backend_url + self.readiness_path)
        except (HTTPError, OSError, asyncio.TimeoutError):
            return False
        return resp.status == 200

    # ---------------- wake (one task per cohort) ----------------

    def _ensure_wake_task(self) -> None:
        """At most one wake runs at a time: N parked requests share it and
        must not fire N scale-ups."""
        if self._wake_task is None or self._wake_task.done():
            self._wake_task = asyncio.get_running_loop().create_task(self._wake())

    async def _wake(self) -> None:
        try:
            if await self._backend_is_ready():
                self._mark_ready()
                return
            t0 = self.clock.now()
            if self.scale_up is not None:
                await self.scale_up()
            deadline = t0 + self.wake_timeout
            while self.clock.now() < deadline:
                if await self._backend_is_ready():
                    self.stats["cold_start_s"] = round(self.clock.now() - t0, 3)
                    logger.info("activator: backend awake after %.2fs",
                                self.stats["cold_start_s"])
                    self._mark_ready()
                    return
                await self.clock.sleep(self.poll_interval)
            raise WakeFailedError(
                f"backend did not become ready within {self.wake_timeout}s")
        except Exception as exc:  # noqa: BLE001 — a wake failure must fail
            # the whole parked cohort loudly, whatever its type
            self._wake_failed_until = self.clock.now() + min(self.wake_timeout / 4, 10.0)
            failed = exc if isinstance(exc, WakeFailedError) else (
                WakeFailedError(f"backend wake failed: {exc}"))
            n = self.holds.fail_all(failed)
            logger.warning("activator: wake failed (%s); %d holds failed", exc, n)

    def scaled_to_zero(self) -> None:
        """The backend has no replica left: the next request is held and
        wakes it, as after a refused connect.  For a backend that accepts
        in its zero window, whose 503 the data path cannot tell from a
        replica's own."""
        self._backend_ready = False

    def _mark_ready(self) -> None:
        self._backend_ready = True
        released = self.holds.release_all()
        if released:
            logger.info("activator: replaying %d held requests", released)

    # ---------------- the data path ----------------

    async def _respond(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes, writer,
                       keep_alive: bool) -> None:
        if (method, path) == ("GET", STATS_PATH):
            return await self._send_json(writer, 200, self.stats, keep_alive)
        # the warm path trusts state, with no readiness probe per request
        # (it would add a round trip to each and read one slow probe as a
        # scale to zero); a connect failure below flips the state and goes
        # through one hold-and-replay cycle
        if not self._backend_ready:
            terminal = await self._hold(headers)
            if terminal is not None:
                return await self._send_json(writer, *terminal[:2], keep_alive, terminal[2])
        try:
            return await self._proxy(method, path, query, headers, body, writer,
                                     keep_alive)
        except (ConnectError, ReadError):
            # raised before the backend's head: nothing was written yet
            self._backend_ready = False
            terminal = await self._hold(headers)
            if terminal is not None:
                return await self._send_json(writer, *terminal[:2], keep_alive, terminal[2])
            return await self._proxy(method, path, query, headers, body, writer,
                                     keep_alive)

    async def _hold(self, headers: Dict[str, str]) -> Optional[Terminal]:
        """Park this request until the backend wakes.  None means
        "released: replay now"; otherwise the terminal answer (504
        expired, 503 overflow, 504 wake failed, 503 in the poison window)."""
        self.stats["buffered"] += 1
        if self.clock.now() < self._wake_failed_until:
            return (503, {"error": "backend wake recently failed; retry later"},
                    {"Retry-After": f"{self.holds.retry_after_s:g}"})
        deadline = Deadline.from_header(headers.get(DEADLINE_HEADER), self.clock)
        self._ensure_wake_task()
        if self._backend_ready:
            # the wake completed at once (the probe was already green):
            # holding now would park behind a release that already happened
            return None
        self.stats["held_now"] = self.holds.held + 1
        try:
            await self.holds.hold(deadline)
        except HoldExpiredError:
            self.stats["expired"] += 1
            GATEWAY_HOLDS.labels(outcome="expired").inc()
            return (504, {"error": "request deadline expired while held for "
                                   "scale-from-zero"}, {})
        except HoldOverflowError as exc:
            self.stats["overflow"] += 1
            GATEWAY_HOLDS.labels(outcome="overflow").inc()
            return (503, {"error": "hold queue full while scaled to zero"},
                    {"Retry-After": f"{exc.retry_after_s:g}"})
        except WakeFailedError as exc:
            self.stats["wake_failed"] += 1
            GATEWAY_HOLDS.labels(outcome="failed").inc()
            return (504, {"error": str(exc)}, {})
        finally:
            self.stats["held_now"] = self.holds.held
        self.stats["replayed"] += 1
        GATEWAY_HOLDS.labels(outcome="replayed").inc()
        return None

    async def _proxy(self, method: str, path: str, query: str,
                     headers: Dict[str, str], body: bytes, writer,
                     keep_alive: bool) -> None:
        """Forward to the backend and relay its answer as it arrives.
        ConnectError / ReadError from the connect and the head escape to
        `_respond` (nothing written yet); a cut after the head does not."""
        client, _ = self._clients()
        out_headers = {k: v for k, v in headers.items() if k not in HOP_HEADERS}
        url = self.backend_url + path + (f"?{query}" if query else "")
        upstream = await client.stream(method, url, out_headers, body)
        self.stats["proxied"] += 1
        try:
            await self._relay(upstream, writer, keep_alive)
        except (HTTPError, ConnectionError, asyncio.IncompleteReadError) as exc:
            logger.warning("activator: stream from %s cut: %s", self.backend_url, exc)
            raise ConnectionResetError(f"stream from {self.backend_url} cut") from exc

    async def stop(self) -> None:
        if self._wake_task is not None and not self._wake_task.done():
            self._wake_task.cancel()
        self.holds.fail_all(WakeFailedError("activator shutting down"))
        for client in (self._client, self._probe):
            if client is not None:
                await client.aclose()
        self._client = self._probe = None
        await super().stop()


def deployment_scaler(master: str, deployment: str, namespace: str,
                      token: Optional[str] = None,
                      in_cluster: bool = False):
    """A scale_up callback that patches a Deployment's replicas to >= 1
    through the apiserver (the in-cluster scale-from-zero trigger; the
    EPP-signal autoscaler owns the count from 1 upward and returns it to
    0 when idle)."""
    from .api.http_transport import HTTPCluster

    cluster = (HTTPCluster(master, token=token) if master
               else HTTPCluster("", in_cluster=in_cluster))

    async def scale_up():
        def _patch():
            dep = cluster.get("Deployment", deployment, namespace)
            if dep is None:
                raise RuntimeError(f"deployment {namespace}/{deployment} not found")
            if int(dep.get("spec", {}).get("replicas") or 0) < 1:
                dep["spec"]["replicas"] = 1
                cluster.apply(dep)

        await asyncio.to_thread(_patch)

    return scale_up


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="kserve-tpu-torch activator")
    parser.add_argument("--backend", required=True)
    parser.add_argument("--port", type=int, default=8012)
    parser.add_argument("--deployment", default=None,
                        help="Deployment to wake (with --master/--in-cluster)")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--master", default=None)
    parser.add_argument("--in-cluster", action="store_true")
    parser.add_argument("--readiness-path", default="/v2/health/ready")
    parser.add_argument("--wake-timeout", type=float, default=120.0)
    parser.add_argument("--max-holds", type=int, default=512,
                        help="bounded hold queue size (overflow -> 503)")
    parser.add_argument("--hold-timeout", type=float, default=None,
                        help="default hold budget for requests without an "
                             "x-request-deadline header (default: "
                             "--wake-timeout)")
    return parser


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    configure_logging()
    scale_up = None
    if args.deployment:
        scale_up = deployment_scaler(args.master, args.deployment, args.namespace,
                                     in_cluster=args.in_cluster)
    activator = Activator(
        args.backend, scale_up=scale_up, port=args.port,
        readiness_path=args.readiness_path, wake_timeout=args.wake_timeout,
        max_holds=args.max_holds, hold_timeout_s=args.hold_timeout,
    )

    async def run():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        port = await activator.start()
        logger.info("activator on :%d -> %s", port, args.backend)
        try:
            await stop.wait()
        finally:
            await activator.stop()

    asyncio.run(run())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
