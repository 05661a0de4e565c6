"""Autoscaler CLI: `python -m kserve_tpu_torch.autoscale` (port of
kserve_tpu/autoscale/__main__.py, the same flags and defaults).

It polls the EPP's `/state` for the `fleet` FleetSignals block (on the
port's standard-library HTTP client) and drives the workload
Deployment's replica count through the apiserver (api/http_transport.py).
The policy defaults are the JAX package's; each has its flag.

A loop failure logs and exits 1 (the pod restarts) rather than freezing
the fleet at its last size; a failed scrape of the EPP re-serves the last
good snapshot for up to `--stale-signals-s` before it counts as a
failure too.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Optional

from ..logging import configure_logging, logger
from ..protocol.http_client import AsyncHTTPClient, HTTPError
from .actuator import DeploymentActuator
from .loop import AutoscalerLoop
from .policy import (
    PredictiveConfig,
    PredictivePolicy,
    ReactiveConfig,
    ReactivePolicy,
)
from .signals import FleetSignals


class EPPSignalSource:
    """GET <epp>/state and rebuild `FleetSignals` from its `fleet` block.
    Keeps the last good snapshot across failed scrapes, but a snapshot
    older than `stale_s` raises: scaling the fleet on frozen signals
    forever is the failure this loop exists to prevent."""

    def __init__(self, epp_url: str, stale_s: float = 30.0):
        self.epp_url = epp_url.rstrip("/")
        self.stale_s = stale_s
        self._client: Optional[AsyncHTTPClient] = None
        self._last: Optional[FleetSignals] = None
        self._last_ok: Optional[float] = None

    async def __call__(self) -> FleetSignals:
        if self._client is None:
            self._client = AsyncHTTPClient(timeout_s=5.0)
        now = time.monotonic()
        try:
            resp = await self._client.get(self.epp_url + "/state")
            if resp.status != 200:
                raise OSError(f"EPP /state returned {resp.status}")
            fleet = json.loads(bytes(resp.body)).get("fleet")
            if not isinstance(fleet, dict):
                raise ValueError("EPP /state payload has no fleet block")
            self._last = FleetSignals.from_dict(fleet)
            self._last_ok = now
            return self._last
        except (HTTPError, OSError, ValueError, asyncio.TimeoutError) as exc:
            if (self._last is not None and self._last_ok is not None
                    and now - self._last_ok <= self.stale_s):
                logger.warning(
                    "autoscaler: EPP scrape failed (%s); re-serving "
                    "%.1fs-old signals", exc, now - self._last_ok)
                return self._last
            raise

    async def close(self) -> None:
        if self._client is not None:
            await self._client.aclose()
            self._client = None


def build_policy(args):
    reactive = ReactivePolicy(ReactiveConfig(
        queue_high_per_replica=args.queue_high,
        queue_low_per_replica=args.queue_low,
        shed_rate_up_per_s=args.shed_rate_up,
        ttft_p99_slo_s=args.ttft_slo,
        idle_to_zero_s=args.idle_to_zero,
        up_cooldown_s=args.up_cooldown,
        down_cooldown_s=args.down_cooldown,
    ))
    if args.policy == "reactive":
        return reactive
    return PredictivePolicy(reactive=reactive, config=PredictiveConfig())


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("kserve-tpu-torch-autoscaler")
    parser.add_argument("--epp-url", required=True,
                        help="EPP base url (its /state exports FleetSignals)")
    parser.add_argument("--deployment", required=True)
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--master", default="",
                        help="apiserver url (empty + --in-cluster = pod env)")
    parser.add_argument("--in-cluster", action="store_true")
    parser.add_argument("--policy", choices=("reactive", "predictive"),
                        default="predictive")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--max-replicas", type=int, default=4)
    parser.add_argument("--pods-per-replica", type=int, default=1,
                        help="pods per logical replica (slice groups); the "
                             "Deployment is patched in whole multiples")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument("--stale-signals-s", type=float, default=30.0)
    # reactive thresholds (the JAX package's defaults)
    parser.add_argument("--queue-high", type=float, default=6.0)
    parser.add_argument("--queue-low", type=float, default=1.0)
    parser.add_argument("--shed-rate-up", type=float, default=0.2)
    parser.add_argument("--ttft-slo", type=float, default=None)
    parser.add_argument("--idle-to-zero", type=float, default=30.0)
    parser.add_argument("--up-cooldown", type=float, default=5.0)
    parser.add_argument("--down-cooldown", type=float, default=30.0)
    return parser


async def serve(args) -> None:
    from ..api.http_transport import HTTPCluster

    cluster = (HTTPCluster(args.master) if args.master
               else HTTPCluster("", in_cluster=args.in_cluster))
    source = EPPSignalSource(args.epp_url, stale_s=args.stale_signals_s)
    loop = AutoscalerLoop(
        build_policy(args),
        source,
        DeploymentActuator(cluster, args.deployment, args.namespace,
                           pods_per_replica=args.pods_per_replica),
        interval_s=args.interval,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
    )
    logger.info(
        "autoscaler: %s policy driving %s/%s in [%d, %d] from %s",
        args.policy, args.namespace, args.deployment, args.min_replicas,
        args.max_replicas, args.epp_url)
    try:
        await loop.run()
    finally:
        await source.close()


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    configure_logging()
    try:
        asyncio.run(serve(args))
    except KeyboardInterrupt:
        return 0
    except Exception as exc:  # noqa: BLE001 — terminal: log + nonzero exit
        # a dead autoscaler must be loud (its pod restarts), never a
        # silent freeze at the last replica count
        logger.error("autoscaler loop failed: %s", exc)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
