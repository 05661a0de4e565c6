"""The asynchronous REST inference client that transformers and SDK users
call (port of kserve_tpu/inference_client.py:36-312, `RESTConfig` and
`InferenceRESTClient`), on protocol/http_client.AsyncHTTPClient: the card
machine has no httpx.

`infer` posts V1 (`/v1/models/{m}:predict`) or V2 (`/v2/models/{m}/infer`,
JSON or the binary-tensor form) bodies; `explain` posts `:explain`; the
three health reads GET `/`, `/v2/health/{live,ready}` and the model's
readiness.  POSTs go through one retry loop (`_post_with_retries`): a
failure before the request was sent (ConnectError, ConnectTimeout) and a
429 or 503 answer are retried under a RetryPolicy that honours
Retry-After and never outlasts the propagated deadline; each attempt
carries the remaining deadline and a child `traceparent` of the same
trace with a fresh span id; a 503 carrying a generation checkpoint (in
its header or its body) has the next attempt carry it, so a drained
generation resumes where the retry lands.

Left out against the JAX client: httpx's http2, TLS and auth settings
(the port's transport speaks plain HTTP/1.1) and a per-call timeout (the
transport's `timeout` bounds every exchange); the gRPC client is still to
port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Union

from .errors import InferenceError, InvalidInput
from .infer_type import InferRequest, InferResponse
from .lifecycle import CHECKPOINT_HEADER, CHECKPOINT_HEADER_MAX_BYTES, GenerationCheckpoint
from .metrics import RETRY_ATTEMPTS
from .model import PredictorProtocol
from .protocol.http_client import (
    AsyncHTTPClient,
    ConnectError,
    ConnectTimeout,
    Response,
    SocketTransport,
    Transport,
)
from .resilience import (
    DEADLINE_HEADER,
    MONOTONIC,
    Clock,
    RetryPolicy,
    current_deadline,
    parse_retry_after,
)
from .tracing import TRACEPARENT_HEADER, current_trace_context, propagate_headers


@dataclass
class RESTConfig:
    # a Transport callable (a test's handler, a FaultInjectingTransport);
    # None: a SocketTransport bounded by `timeout`
    transport: Optional[Transport] = None
    protocol: Union[str, PredictorProtocol] = "v1"
    retries: int = 3
    timeout: float = 60
    # the policy of connect-failure and 429/503 retries (None: built from
    # `retries`); `clock` is the seam for backoff without real sleeps
    retry_policy: Optional[RetryPolicy] = None
    clock: Optional[Clock] = None

    def __post_init__(self):
        if isinstance(self.protocol, PredictorProtocol):
            self.protocol = self.protocol.value


def _json(response: Response):
    return json.loads(bytes(response.body))


class InferenceRESTClient:
    def __init__(self, config: Optional[RESTConfig] = None):
        self._config = config or RESTConfig()
        # 429 and 503 are answers given before any work; a 502 or 504 may
        # come from a backend mid-inference, which a replay would repeat
        self._retry_policy = self._config.retry_policy or RetryPolicy(
            max_attempts=self._config.retries + 1,
            retryable_statuses=frozenset({429, 503}),
        )
        self._clock = self._config.clock or MONOTONIC
        transport = self._config.transport
        if transport is None:
            transport = SocketTransport(self._config.timeout)
        self._client = AsyncHTTPClient(transport)

    async def _post_with_retries(self, url: str, *, content: bytes = b"",
                                 json_body=None, headers=None) -> Response:
        """POST under the retry policy (the module docstring's rules)."""
        started = self._clock.now()
        attempt = 0
        # one trace across every attempt: each gets a fresh child span id
        # under the same parent (the bound request's context, or a root
        # minted once here when this client is the first hop)
        trace_parent = current_trace_context()
        while True:
            deadline = current_deadline()
            if deadline is not None and deadline.expired:
                raise InferenceError("request deadline exceeded before send", status="504")
            attempt += 1
            retry_after = None
            failure: Optional[Exception] = None
            response: Optional[Response] = None
            try:
                send_headers = dict(headers or {})
                if deadline is not None:
                    send_headers.setdefault(DEADLINE_HEADER, deadline.to_header())
                if TRACEPARENT_HEADER not in {k.lower() for k in send_headers}:
                    trace_parent = propagate_headers(send_headers, parent=trace_parent)
                response = await self._client.post(
                    url, json=json_body, body=content, headers=send_headers)
                if not self._retry_policy.retryable(response.status):
                    return response
                retry_after = parse_retry_after(response.headers.get("retry-after"))
                checkpoint = (response.headers.get(CHECKPOINT_HEADER.lower())
                              or self._checkpoint_from_body(response))
                if checkpoint and len(checkpoint) <= CHECKPOINT_HEADER_MAX_BYTES:
                    # a draining replica's checkpoint rides the retry, so
                    # the generation resumes where the retry lands; an
                    # oversized one is dropped (a restart from the prompt
                    # beats a retry the server refuses)
                    headers = dict(headers or {})
                    headers[CHECKPOINT_HEADER] = checkpoint
            except (ConnectError, ConnectTimeout) as e:
                # before the request was sent: a replay duplicates nothing
                failure = e
            delay = self._retry_policy.next_delay(
                attempt, retry_after=retry_after,
                elapsed=self._clock.now() - started, deadline=current_deadline())
            if delay is None:
                if failure is not None:
                    raise failure
                return response
            RETRY_ATTEMPTS.labels(component="rest").inc()
            await self._clock.sleep(delay)

    @staticmethod
    def _checkpoint_from_body(response: Response) -> Optional[str]:
        """The header form of a 503 body's `checkpoint` object, or None."""
        try:
            return GenerationCheckpoint.from_dict(_json(response)["checkpoint"]).to_header()
        except (ValueError, TypeError, KeyError):
            return None

    async def _get_with_retries(self, url: str, headers=None) -> Response:
        """GET with connect-phase retries only; any status is returned."""
        started = self._clock.now()
        attempt = 0
        while True:
            attempt += 1
            try:
                return await self._client.get(url, headers=headers)
            except (ConnectError, ConnectTimeout):
                delay = self._retry_policy.next_delay(
                    attempt, elapsed=self._clock.now() - started,
                    deadline=current_deadline())
                if delay is None:
                    raise
                RETRY_ATTEMPTS.labels(component="rest").inc()
                await self._clock.sleep(delay)

    def _is_v2(self) -> bool:
        return self._config.protocol in (PredictorProtocol.REST_V2.value,
                                         PredictorProtocol.GRPC_V2.value)

    async def infer(self, base_url: str, data: Union[Dict, InferRequest],
                    headers: Optional[Dict[str, str]] = None,
                    model_name: Optional[str] = None,
                    response_headers: Optional[Dict[str, str]] = None,
                    is_graph_endpoint: bool = False) -> Union[Dict, InferResponse]:
        url = self._construct_url(base_url, model_name, verb="infer")
        headers = dict(headers or {})
        if isinstance(data, InferRequest):
            body, json_length = data.to_rest()
            if json_length is not None:
                headers["inference-header-content-length"] = str(json_length)
                headers["content-type"] = "application/octet-stream"
                response = await self._post_with_retries(url, content=body,
                                                         headers=headers)
            else:
                response = await self._post_with_retries(url, json_body=body,
                                                         headers=headers)
        else:
            response = await self._post_with_retries(url, json_body=data, headers=headers)
        if response_headers is not None:
            response_headers.update(response.headers)
        return self._decode_response(response, is_graph_endpoint)

    async def explain(self, base_url: str, data: Union[Dict, InferRequest],
                      headers: Optional[Dict[str, str]] = None,
                      model_name: Optional[str] = None) -> Dict:
        if ":explain" in base_url:
            url = base_url
        else:
            url = self._construct_url(base_url, model_name, verb="explain")
        body = data.to_rest()[0] if isinstance(data, InferRequest) else data
        response = await self._post_with_retries(url, json_body=body, headers=headers)
        return self._decode_response(response, False)

    def _construct_url(self, base_url: str, model_name: Optional[str], verb: str) -> str:
        base = str(base_url)
        if "://" not in base:
            base = "http://" + base
        if "/v1/models" in base or "/v2/models" in base:
            return base
        base = base.rstrip("/")
        if self._is_v2():
            if model_name is None:
                raise InvalidInput("model_name is required for v2 urls")
            return f"{base}/v2/models/{model_name}/{verb}"
        if model_name is None:
            raise InvalidInput("model_name is required for v1 urls")
        return f"{base}/v1/models/{model_name}:{'predict' if verb == 'infer' else verb}"

    def _decode_response(self, response: Response, is_graph_endpoint: bool):
        if response.status != 200:
            try:
                message = _json(response).get("error", response.text())
            except (ValueError, AttributeError):
                # a body that is not a JSON object: its text
                message = response.text()
            raise InferenceError(f"HTTP {response.status}: {message}",
                                 status=str(response.status))
        json_length = response.headers.get("inference-header-content-length")
        if json_length is not None:
            return InferResponse.from_bytes(bytes(response.body), int(json_length))
        body = _json(response)
        if not is_graph_endpoint and self._is_v2() and "outputs" in body:
            return InferResponse.from_dict(body)
        return body

    @staticmethod
    def _raise_for_status(response: Response) -> None:
        if response.status >= 400:
            raise InferenceError(f"HTTP {response.status}: {response.text()[:200]}",
                                 status=str(response.status))

    async def is_server_ready(self, base_url: str, headers=None) -> bool:
        response = await self._get_with_retries(self._health_url(base_url, "ready"),
                                                headers=headers)
        self._raise_for_status(response)
        return _json(response).get("ready", False)

    async def is_server_live(self, base_url: str, headers=None) -> bool:
        if self._is_v2():
            response = await self._get_with_retries(self._health_url(base_url, "live"),
                                                    headers=headers)
            self._raise_for_status(response)
            return _json(response).get("live", False)
        response = await self._get_with_retries(str(base_url).rstrip("/") + "/",
                                                headers=headers)
        self._raise_for_status(response)
        return _json(response).get("status") == "alive"

    async def is_model_ready(self, base_url: str, model_name: str, headers=None) -> bool:
        base = str(base_url).rstrip("/")
        if self._is_v2():
            url = f"{base}/v2/models/{model_name}/ready"
        else:
            url = f"{base}/v1/models/{model_name}"
        response = await self._get_with_retries(url, headers=headers)
        if response.status == 503:
            return False
        self._raise_for_status(response)
        return _json(response).get("ready", False)

    def _health_url(self, base_url: str, verb: str) -> str:
        base = str(base_url).rstrip("/")
        return f"{base}/v2/health/{verb}" if self._is_v2() else f"{base}/"

    async def close(self) -> None:
        await self._client.aclose()
