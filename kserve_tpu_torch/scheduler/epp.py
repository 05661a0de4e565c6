"""EPP scheduler service: the endpoint picker in front of an
LLMInferenceService's replicas (port of kserve_tpu/scheduler/epp.py, on
the port's standard-library wire: protocol/rest/http_server.py and
protocol/http_client.py).

It fronts the replicas as a streaming reverse proxy, and offers `/pick`
to gateways that only need the routing decision.

Routes:
  GET  /healthz   liveness
  GET  /state     the picker's snapshot (per replica: load, affinity,
                  breaker, health) and the `fleet` block (FleetSignals);
                  `latency` with --strategy slo-aware, and `tracing` (the
                  span exporter's counts) when spans are exported
  POST /pick      {"prompt_ids": [...]} | {"prompt": "..."} | OpenAI
                  bodies -> {"endpoint": url, "queue_depth", "lifecycle"};
                  never a canary pick (the caller reports no outcome)
  *    /{tail}    the proxy: pick a replica, forward the request with hop
                  headers stripped and a child `traceparent`, and relay the
                  replica's status, headers and body piece by piece as they
                  arrive (SSE chunk by chunk); 503 "no healthy replica"
                  when none can be picked, 502 when the replica fails
                  before answering

With a tracer, each proxied request is an `epp.proxy` span (attribute
kserve.backend) below the EPP's own request span; the replica's request
span and its engine spans hang below it, so the whole hop is one trace.
After each answer the proxy reports to the breakers, the latency
predictor and the canary, as kserve_tpu/scheduler/epp.py:267-363 does.

Usage: python -m kserve_tpu_torch.scheduler.epp --replicas URL,URL
       [--strategy prefix-cache,queue-depth[,slo-aware]]
       [--poll-interval S] [--port P]
The replica set is static (--replicas); --pool-selector discovery needs
the Kubernetes API client, which the port does not have yet.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import time
from typing import Dict, Optional, Tuple

from ..autoscale.signals import ArrivalHistory, FleetSignals, RateTracker
from ..logging import configure_logging
from ..metrics import record_breaker_transition
from ..protocol.http_client import AsyncHTTPClient, HTTPError
from ..protocol.rest.http_server import HOP_HEADERS, HTTPServer
from ..resilience import BreakerRegistry, is_inference_path
from ..tracing import (
    SPAN_KIND_CLIENT,
    add_span_event,
    current_trace_context,
    get_tracer,
    propagate_headers,
    setup_tracing,
    shutdown_tracing,
    tracer_stats,
)
from .latency import LatencyPredictor, estimate_prompt_len
from .picker import EndpointPicker

logger = logging.getLogger(__name__)

# seconds a replica may take to accept the connection; its answer then
# takes as long as the generation runs (aiohttp's sock_connect=10, total=None)
CONNECT_TIMEOUT_S = 10.0
_LOCAL_ROUTES = {("GET", "/healthz"), ("GET", "/state"), ("POST", "/pick")}


def extract_affinity(payload: dict) -> tuple:
    """Best-effort (prompt_ids, prompt_text) of a request body across the
    protocols served (OpenAI chat and completions, /pick)."""
    prompt_ids = None
    text = None
    if isinstance(payload.get("prompt_ids"), list):
        prompt_ids = payload["prompt_ids"]
    p = payload.get("prompt")
    if isinstance(p, str):
        text = p
    elif isinstance(p, list) and p and isinstance(p[0], int):
        prompt_ids = p
    msgs = payload.get("messages")
    if isinstance(msgs, list):
        parts = []
        for m in msgs:
            c = m.get("content") if isinstance(m, dict) else None
            if isinstance(c, str):
                parts.append(c)
            elif isinstance(c, list):  # multimodal content blocks
                parts.extend(b.get("text", "") for b in c if isinstance(b, dict))
        text = "\x1e".join(parts)  # separator so role boundaries chunk apart
    return prompt_ids, text


class EPPServer(HTTPServer):
    """The picker's HTTP surface.  `client` is the AsyncHTTPClient the
    proxy forwards through (its transport must stream)."""

    def __init__(self, picker: EndpointPicker, host: str = "0.0.0.0",
                 port: int = 9002, client: Optional[AsyncHTTPClient] = None):
        super().__init__(host, port)
        self.picker = picker
        self._client = client or AsyncHTTPClient(timeout_s=CONNECT_TIMEOUT_S)
        # the arrival process is observable at the fleet's front door:
        # every proxied inference POST is recorded, and /state exports the
        # FleetSignals block an autoscaler reads
        self.arrivals = ArrivalHistory()
        # a floor on the shed-rate window: /state has more readers than
        # the autoscaler, and each read would re-baseline the delta
        self._shed_rate = RateTracker(min_interval_s=2.0)

    async def close(self) -> None:
        await self.picker.close()
        await self._client.aclose()

    def fleet_signals(self) -> FleetSignals:
        """The rolling FleetSignals snapshot (`fleet` in /state)."""
        now = self.picker.clock.now()
        states = self.picker.snapshot()
        sheds_total = sum(int(s.get("sheds_total", 0) or 0) for s in states)
        return FleetSignals.from_replica_states(
            states, now,
            arrival_rate_per_s=self.arrivals.rate(now),
            arrival_slope_per_s2=self.arrivals.slope(now),
            shed_rate_per_s=self._shed_rate.update(sheds_total, now),
        )

    def state(self) -> dict:
        out = {"replicas": self.picker.snapshot(),
               "fleet": self.fleet_signals().to_dict()}
        if self.picker.latency_predictor is not None:
            out["latency"] = self.picker.latency_predictor.snapshot()
        stats = tracer_stats()
        if stats is not None:
            out["tracing"] = stats
        return out

    def _route_template(self, method: str, path: str) -> Tuple[str, Optional[str]]:
        if (method, path) in _LOCAL_ROUTES:
            return path, None
        return "/{tail}", None

    @staticmethod
    def _affinity(method: str, body: bytes) -> tuple:
        if method != "POST":
            return None, None
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return None, None
        if not isinstance(payload, dict):
            return None, None
        return extract_affinity(payload)

    async def _respond(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes, writer,
                       keep_alive: bool) -> None:
        if (method, path) == ("GET", "/healthz"):
            return await self._send_json(writer, 200, {"ok": True}, keep_alive)
        if (method, path) == ("GET", "/state"):
            return await self._send_json(writer, 200, self.state(), keep_alive)
        if (method, path) == ("POST", "/pick"):
            return await self._pick(body, writer, keep_alive)
        return await self._proxy(method, path, query, headers, body, writer, keep_alive)

    async def _pick(self, body: bytes, writer, keep_alive: bool) -> None:
        ids, text = self._affinity("POST", body)
        # advisory only: the caller routes the request itself and reports
        # nothing back, so a canary here would feed the sick replica a real
        # request per interval for no proof
        replica, _ = self.picker.pick_ex(prompt_ids=ids, prompt_text=text,
                                         allow_canary=False)
        if replica is None:
            return await self._send_json(writer, 503, {"error": "no healthy replica"},
                                         keep_alive)
        await self._send_json(writer, 200, {"endpoint": replica.url,
                                            "queue_depth": replica.queue_depth,
                                            "lifecycle": replica.lifecycle}, keep_alive)

    async def _proxy(self, method: str, path: str, query: str,
                     headers: Dict[str, str], body: bytes, writer,
                     keep_alive: bool) -> None:
        if method == "POST" and is_inference_path(path):
            # recorded before picking, so a request that finds no replica
            # still counts as demand
            self.arrivals.record(self.picker.clock.now())
        ids, text = self._affinity(method, body)
        # is_canary: a quarantine re-probe rides this request, and its
        # outcome goes back to the health layer
        replica, is_canary = self.picker.pick_ex(prompt_ids=ids, prompt_text=text)
        if replica is None:
            return await self._send_json(writer, 503, {"error": "no healthy replica"},
                                         keep_alive)
        out_headers = {k: v for k, v in headers.items() if k not in HOP_HEADERS}
        # the replica's traceparent is a child of this request's context:
        # the EPP's span, the replica's and the engine's form one trace
        parent = current_trace_context()
        span_ctx = propagate_headers(out_headers, parent=parent)
        forward = self._forward(method, path, query, out_headers, body, writer,
                                keep_alive, replica, ids, text, is_canary)
        tracer = get_tracer()
        if tracer is None:
            return await forward
        with tracer.start_as_current_span(
                "epp.proxy", attributes={
                    "http.method": method, "http.target": path,
                    "trace_id": span_ctx.trace_id, "span_id": span_ctx.span_id,
                    "kserve.backend": replica.url},
                context=span_ctx,
                parent_span_id=parent.span_id if parent is not None else None,
                kind=SPAN_KIND_CLIENT):
            return await forward

    async def _forward(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes, writer,
                       keep_alive: bool, replica, ids, text,
                       is_canary: bool) -> None:
        url = replica.url + path + (f"?{query}" if query else "")
        # latency observation inputs, taken at pick time (the depth the
        # decision was made against)
        picked_depth = replica.queue_depth
        prompt_len = estimate_prompt_len(ids, text)
        t0 = time.monotonic()
        try:
            upstream = await self._client.stream(method, url, headers, body)
        except (HTTPError, OSError, asyncio.TimeoutError) as exc:
            # the replica never answered: a replica-side fault
            logger.warning("epp proxy to %s failed: %s", replica.url, exc)
            if is_canary:
                self.picker.observe_canary(replica.url, False)
            self.picker.observe_failure(replica.url)
            return await self._send_json(
                writer, 502, {"error": f"upstream {replica.url} failed"}, keep_alive)
        status = upstream.status
        try:
            first, chunks = await self._relay(upstream, writer, keep_alive)
        except (HTTPError, ConnectionError, asyncio.IncompleteReadError) as exc:
            # the head is sent: no second answer is possible, so the stream
            # is cut and the client sees the truncation.  Once headers flow
            # a failure is as likely the client going away as the replica,
            # so it does not count against the replica's breaker
            logger.warning("epp stream from %s cut: %s", replica.url, exc)
            if is_canary:
                self.picker.observe_canary(replica.url, False)
            raise ConnectionResetError(f"stream from {replica.url} cut") from exc
        ttft = first - t0 if first is not None else None
        if 200 <= status < 300:
            # a served 2xx closes a half-open breaker and clears the streak
            self.picker.observe_success(replica.url)
            if is_canary:
                # canary proof carries its measured latency: a 200 at
                # gray-sick speed does not reintroduce
                total_s = time.monotonic() - t0
                tpot = ((total_s - ttft) / (chunks - 1)
                        if ttft is not None and chunks > 1 else None)
                self.picker.observe_canary(replica.url, True, ttft_s=ttft, tpot_s=tpot)
        elif is_canary:
            self.picker.observe_canary(replica.url, False)
        if status == 429 or status >= 500:
            # replica-health statuses only: a client-fault 4xx would land on
            # any replica, and penalizing this one would rotate valid
            # traffic away from its cache-affine home
            self.picker.observe_http_error(replica.url)
        # train on successful generation requests only: fast 429s would
        # teach the model that a shedding replica is fast
        if (self.picker.latency_predictor is not None and 200 <= status < 300
                and ttft is not None and method == "POST" and (ids or text)):
            # streamed chunks stand for generated tokens (SSE sends one
            # event per token; a whole body is ~1 chunk: TTFT only)
            self.picker.latency_predictor.observe(
                replica.url, prompt_len, picked_depth, ttft, n_tokens=chunks,
                total_s=time.monotonic() - t0)


def build_picker(args) -> EndpointPicker:
    strategies = {s.strip() for s in args.strategy.split(",") if s.strip()}
    predictor = None
    latency_weight = 0.0
    if "slo-aware" in strategies:
        # the in-process online TTFT / TPOT model fed by the proxy path;
        # 1 s of predicted TTFT outweighs one prefix page at the default
        # prefix weight
        predictor = LatencyPredictor()
        latency_weight = 4.0

    def on_transition(backend: str, state: str) -> None:
        record_breaker_transition(backend, state)
        # a span event, not a label: the backend's identity belongs on the
        # trace that saw the transition
        add_span_event("breaker.transition", state=state, backend=backend)

    return EndpointPicker(
        replica_urls=[u for u in args.replicas.split(",") if u],
        poll_interval_s=args.poll_interval,
        queue_weight=1.0 if "queue-depth" in strategies else 0.0,
        prefix_weight=4.0 if "prefix-cache" in strategies else 0.0,
        latency_predictor=predictor,
        latency_weight=latency_weight,
        breakers=BreakerRegistry(on_transition=on_transition),
    )


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("kserve-tpu-torch-epp")
    parser.add_argument("--port", type=int, default=9002)
    parser.add_argument("--replicas", default="",
                        help="comma-separated replica base urls (static replica set)")
    parser.add_argument("--pool-selector", default="",
                        help="label selector for in-cluster endpoint discovery "
                             "(not available in this package yet)")
    parser.add_argument("--strategy", default="prefix-cache,queue-depth")
    parser.add_argument("--poll-interval", type=float, default=2.0)
    return parser


async def serve(args) -> None:
    """Poll the replicas and serve until SIGINT or SIGTERM."""
    picker = build_picker(args)
    server = EPPServer(picker, port=args.port)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await server.start()
    await picker.start_polling()
    logger.info("EPP scheduler listening on :%d over %d replica(s)", server.port,
                len(picker.replicas))
    try:
        await stop.wait()
    finally:
        await server.stop()
        await server.close()


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    if args.pool_selector:
        raise SystemExit(
            "--pool-selector: endpoint discovery needs the Kubernetes API "
            "client, which kserve_tpu_torch does not have yet (ROADMAP.md "
            "A12); pass the replicas with --replicas URL,URL")
    if not args.replicas:
        raise SystemExit("--replicas URL,URL is required")
    configure_logging()
    setup_tracing("kserve-tpu-torch-epp")
    try:
        asyncio.run(serve(args))
    finally:
        shutdown_tracing()


if __name__ == "__main__":
    main()
