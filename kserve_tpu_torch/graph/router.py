"""InferenceGraph router: a standalone HTTP service executing a graph spec
(port of kserve_tpu/graph/router.py, on the standard library: the card
machine has neither aiohttp nor httpx).

Node semantics (those of the JAX router and of KServe's cmd/router):
- Sequence: steps run in order; `data: $request` re-sends the original
  request, `$response` (the default after the first step) pipes the
  previous step's output; a step may name another graph node
  (`nodeName`) instead of a service.
- Splitter: one step chosen by weight, steps whose backend's breaker is
  open left out while another can be picked.
- Ensemble: all steps fan out concurrently; responses merged keyed by step
  name (or serviceName, or index); members that fail are named.
- Switch: the first step whose `condition` matches the request runs.
Conditions are `path.to.field==value` (or a bare path for existence)
against the JSON body.  A step with `dependency: Soft` that fails is
skipped (its output is None); any other failure fails the request.

Each step call runs under a per-backend circuit breaker and a RetryPolicy
(Retry-After aware, capped by the deadline); the `x-request-deadline`
budget is re-anchored at the router and every call carries what remains;
every call carries a child `traceparent` of the request's trace.  Client
failures map to gateway statuses naming the step: a timeout before the
request was sent 504 (retried), a timeout after it 504 (not retried: the
backend may be executing it), a refused connection 502, any other
transport failure 503.

Routes: POST / (the graph's answer, or {"error": ...} with its status;
400 for a body that is not JSON) and GET /healthz.

Usage: python -m kserve_tpu_torch.graph.router --graph-json '<spec>' --port 8080
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import random
import signal
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

from ..metrics import RETRY_ATTEMPTS, record_breaker_transition
from ..protocol.http_client import (
    AsyncHTTPClient,
    ConnectError,
    ConnectTimeout,
    HTTPError,
    ReadTimeout,
)
from ..protocol.rest.http_server import HTTPServer
from ..resilience import (
    DEADLINE_HEADER,
    MONOTONIC,
    BreakerRegistry,
    Clock,
    Deadline,
    RetryPolicy,
    parse_retry_after,
)
from ..tracing import propagate_headers

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = 60.0
# request headers a step call passes on
_FORWARDED = ("x-request-id", "authorization", "content-type")


class GraphExecutionError(Exception):
    def __init__(self, message: str, status: int = 500):
        super().__init__(message)
        self.status = status


def eval_condition(condition: str, payload: Any) -> bool:
    """`path.to.field==value` (or bare `path` for existence) against JSON."""
    if not condition:
        return True
    if "==" in condition:
        path, _, expected = condition.partition("==")
    else:
        path, expected = condition, None
    node = payload
    for part in path.strip().split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                return False
        else:
            return False
    if expected is None:
        return True
    expected = expected.strip()
    if isinstance(node, bool):
        return str(node).lower() == expected.lower()
    if isinstance(node, (int, float)):
        try:
            return float(node) == float(expected)
        except ValueError:
            return False
    return str(node) == expected.strip('"')


class GraphRouter(HTTPServer):
    """Executes `graph_spec` ({"nodes": {name: node}, "timeout": s}) from
    its "root" node; serves it on `host:port` once started.  `client` is
    an AsyncHTTPClient (a test's handler transport), `clock` the seam for
    breakers and backoff."""

    def __init__(self, graph_spec: dict, timeout: float = DEFAULT_TIMEOUT,
                 retries: int = 1, client: Optional[AsyncHTTPClient] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 breakers: Optional[BreakerRegistry] = None,
                 clock: Clock = MONOTONIC, host: str = "0.0.0.0", port: int = 8080):
        super().__init__(host, port)
        self.nodes: Dict[str, dict] = graph_spec["nodes"]
        self.timeout = graph_spec.get("timeout") or timeout
        self.retries = retries
        self.clock = clock
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=retries + 1, base_backoff_s=0.05, max_backoff_s=1.0)
        self.breakers = breakers if breakers is not None else BreakerRegistry(
            clock=clock, on_transition=record_breaker_transition)
        self._client = client or AsyncHTTPClient(timeout_s=self.timeout)

    async def close(self) -> None:
        await self._client.aclose()

    @staticmethod
    def _backend_key(url: str) -> str:
        return urlsplit(url).netloc or url

    def _step_url(self, step: dict) -> str:
        if step.get("serviceUrl"):
            return step["serviceUrl"]
        if step.get("serviceName"):
            # an InferenceService's predictor: the V1 predict path
            model = step.get("name") or step["serviceName"]
            return f"http://{step['serviceName']}/v1/models/{model}:predict"
        raise GraphExecutionError(f"step has neither serviceUrl nor serviceName: {step}")

    async def _call_step(self, step: dict, payload: Any, headers: Dict[str, str],
                         deadline: Optional[Deadline] = None) -> Any:
        """One step call under the breaker and the retry policy."""
        if step.get("nodeName"):
            return await self.execute_node(step["nodeName"], payload, headers,
                                           deadline=deadline)
        url = self._step_url(step)
        name = step.get("name") or url
        backend = self._backend_key(url)
        soft = step.get("dependency") == "Soft"
        started = self.clock.now()
        attempt = 0
        last_exc: Optional[GraphExecutionError] = None
        while True:
            if deadline is not None and deadline.expired:
                last_exc = GraphExecutionError(
                    f"step {name}: request deadline exceeded", status=504)
                break
            if not self.breakers.allow(backend):
                last_exc = GraphExecutionError(
                    f"step {name}: circuit open for backend {backend}", status=503)
                break
            attempt += 1
            retry_after = None
            retryable = True
            try:
                send_headers = dict(headers)
                if deadline is not None:
                    send_headers[DEADLINE_HEADER] = deadline.to_header()
                # each step call is a child hop of the graph request's trace
                propagate_headers(send_headers)
                response = await self._client.post(url, json=payload,
                                                   headers=send_headers)
                if response.status == 200:
                    self.breakers.record_success(backend)
                    return json.loads(bytes(response.body))
                # 429 (shedding) and 5xx mark the backend's health; a 4xx
                # would fail the same anywhere and must not trip it
                if response.status == 429 or response.status >= 500:
                    self.breakers.record_failure(backend)
                retry_after = parse_retry_after(response.headers.get("retry-after"))
                retryable = self.retry_policy.retryable(response.status)
                last_exc = GraphExecutionError(
                    f"step {name} returned {response.status}: {response.text()[:200]}",
                    status=response.status)
            except ConnectTimeout as e:
                # the request never reached the backend: a replay cannot
                # duplicate work
                self.breakers.record_failure(backend)
                last_exc = GraphExecutionError(f"step {name} timed out: {e}", status=504)
            except ReadTimeout as e:
                # the backend may be executing the request: a replay would
                # duplicate (expensive) inference
                self.breakers.record_failure(backend)
                retryable = False
                last_exc = GraphExecutionError(f"step {name} timed out: {e}", status=504)
            except ConnectError as e:
                self.breakers.record_failure(backend)
                last_exc = GraphExecutionError(f"step {name} connect failed: {e}",
                                               status=502)
            except HTTPError as e:
                self.breakers.record_failure(backend)
                last_exc = GraphExecutionError(f"step {name} call failed: {e}", status=503)
            if soft or not retryable:
                break
            delay = self.retry_policy.next_delay(
                attempt, retry_after=retry_after, elapsed=self.clock.now() - started,
                deadline=deadline)
            if delay is None:
                break
            RETRY_ATTEMPTS.labels(component="graph").inc()
            await self.clock.sleep(delay)
        if soft:
            logger.warning("soft-dependency step failed, continuing: %s", last_exc)
            return None
        raise last_exc

    def _splitter_candidates(self, steps: list) -> list:
        """Steps of positive weight whose backend's breaker is not open
        (`available`, which takes no half-open probe); all steps when none
        is left, so the pick fails fast with an accurate 503 'circuit
        open' instead of a 422."""
        viable = [
            s for s in steps
            if s.get("weight", 0) > 0
            and (s.get("nodeName")
                 or self.breakers.available(self._backend_key(self._step_url(s))))
        ]
        return viable if viable else steps

    async def execute_node(self, node_name: str, payload: Any, headers: Dict[str, str],
                           deadline: Optional[Deadline] = None) -> Any:
        node = self.nodes.get(node_name)
        if node is None:
            raise GraphExecutionError(f"graph node {node_name!r} not found", status=404)
        if deadline is not None and deadline.expired:
            raise GraphExecutionError(f"node {node_name}: request deadline exceeded",
                                      status=504)
        router_type = node["routerType"]
        steps = node.get("steps", [])
        if router_type == "Sequence":
            request_payload = payload
            current = payload
            for step in steps:
                data = step.get("data", "$request" if step is steps[0] else "$response")
                step_input = request_payload if data == "$request" else current
                result = await self._call_step(step, step_input, headers, deadline)
                if result is not None:
                    current = result
            return current
        if router_type == "Splitter":
            candidates = self._splitter_candidates(steps)
            total = sum(s.get("weight", 0) for s in candidates)
            if total <= 0:
                raise GraphExecutionError("splitter steps need positive weights", 422)
            pick = random.uniform(0, total)
            acc = 0.0
            chosen = candidates[-1]
            for s in candidates:
                acc += s.get("weight", 0)
                if pick <= acc:
                    chosen = s
                    break
            return await self._call_step(chosen, payload, headers, deadline)
        if router_type == "Ensemble":
            results = await asyncio.gather(
                *[self._call_step(s, payload, headers, deadline) for s in steps],
                return_exceptions=True)
            merged: Dict[str, Any] = {}
            failed: list = []  # (member key, GraphExecutionError)
            for i, (step, result) in enumerate(zip(steps, results)):
                key = step.get("name") or step.get("serviceName") or str(i)
                if isinstance(result, GraphExecutionError):
                    failed.append((key, result))
                    continue
                if isinstance(result, BaseException):
                    raise result
                merged[key] = result
            if failed:
                members = ", ".join(k for k, _ in failed)
                first = failed[0][1]
                raise GraphExecutionError(
                    f"ensemble member(s) [{members}] failed: {first}", status=first.status)
            return merged
        if router_type == "Switch":
            for step in steps:
                if eval_condition(step.get("condition", ""), payload):
                    return await self._call_step(step, payload, headers, deadline)
            raise GraphExecutionError("no switch branch matched the request", status=404)
        raise GraphExecutionError(f"unknown routerType {router_type!r}", status=422)

    # ---------------- http surface ----------------

    async def _respond(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes, writer,
                       keep_alive: bool) -> None:
        if path == "/healthz":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, {"status": "ok"}, keep_alive)
        if path != "/":
            return await self._send_json(writer, 404, {"error": f"no route for {path}"},
                                         keep_alive)
        self._expect(method, "POST")
        try:
            payload = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return await self._send_json(writer, 400, {"error": "invalid JSON body"},
                                         keep_alive)
        forwarded = {k: v for k, v in headers.items() if k in _FORWARDED}
        # the deadline budget is re-anchored here and decremented per hop;
        # the request's trace context is bound by the wire (request_scope)
        deadline = Deadline.from_header(headers.get(DEADLINE_HEADER), clock=self.clock)
        try:
            result = await self.execute_node("root", payload, forwarded, deadline)
        except GraphExecutionError as e:
            return await self._send_json(writer, e.status, {"error": str(e)}, keep_alive)
        await self._send_json(writer, 200, result, keep_alive)


async def serve(router: GraphRouter) -> None:
    """Serve until SIGINT or SIGTERM."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await router.start()
    try:
        await stop.wait()
    finally:
        await router.stop()
        await router.close()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--graph-json", required=True)
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT)
    args = parser.parse_args(argv)
    router = GraphRouter(json.loads(args.graph_json), timeout=args.timeout,
                         port=args.port)
    asyncio.run(serve(router))


if __name__ == "__main__":
    main()
