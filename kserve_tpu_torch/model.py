"""Model lifecycle and request flow (port of kserve_tpu/model.py).

`Model` is the user-facing base class: subclass it, override `load()` and
`predict()` (and optionally `preprocess` / `postprocess` / `explain`), and
serve it with a `ModelServer`.  `__call__` runs the stages in turn, each
timed into its `request_*_seconds` histogram.  A model with a
`predictor_config.predictor_host` is a transformer: its default `predict`
forwards to `/v1/models/{name}:predict` or `/v2/models/{name}/infer` of
that host, and `explain` to `:explain`, through the REST inference client
(inference_client.py), passing on `x-request-id` and `x-b3-traceid` and
sending a CloudEvents body as JSON (kserve_tpu/model.py:215-262).  One
without a host raises as the JAX package's does ("Could not find
predictor_host."); the gRPC protocol is not served yet.
"""

from __future__ import annotations

import inspect
import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, Optional, Union

from .errors import InvalidInput
from .infer_type import InferRequest, InferResponse
from .metrics import (
    EXPLAIN_HIST_TIME,
    POST_HIST_TIME,
    PRE_HIST_TIME,
    PREDICT_HIST_TIME,
    get_labels,
)

trace_logger = logging.getLogger("kserve_tpu_torch.trace")


class InferenceVerb(Enum):
    EXPLAIN = 1
    PREDICT = 2


class PredictorProtocol(Enum):
    REST_V1 = "v1"
    REST_V2 = "v2"
    GRPC_V2 = "grpc-v2"


def get_latency_ms(start: float, end: float) -> float:
    return round((end - start) * 1000, 9)


@dataclass
class PredictorConfig:
    """Where (and how) a transformer forwards to its predictor."""

    predictor_host: str = ""
    predictor_protocol: str = PredictorProtocol.REST_V1.value
    predictor_use_ssl: bool = False
    predictor_request_timeout_seconds: int = 600
    predictor_request_retries: int = 0
    predictor_health_check: bool = False
    extra_headers: Dict[str, str] = field(default_factory=dict)


class BaseModel:
    """Minimal lifecycle every servable object implements."""

    def __init__(self, name: str):
        self.name = name
        self.ready: bool = False

    async def healthy(self) -> bool:
        """Liveness beyond `ready`: engine models override it to reflect the
        health of their background loop."""
        return self.ready

    async def live(self) -> bool:
        """Process liveness: False means the pod should be restarted."""
        return True

    def load(self) -> bool:
        """Load weights or artifacts; set and return `self.ready`."""
        self.ready = True
        return self.ready

    def stop(self) -> None:
        """Hook called when the server shuts down."""

    def start_engine(self) -> None:
        """Engine models override this to start their background loop inside
        the server's event loop."""


class Model(BaseModel):
    def __init__(self, name: str, predictor_config: Optional[PredictorConfig] = None):
        super().__init__(name)
        self.predictor_config = predictor_config
        self._rest_client = None

    @property
    def predictor_host(self) -> str:
        return self.predictor_config.predictor_host if self.predictor_config else ""

    @property
    def protocol(self) -> str:
        return (
            self.predictor_config.predictor_protocol
            if self.predictor_config
            else PredictorProtocol.REST_V1.value
        )

    # ---------- request pipeline ----------

    async def __call__(
        self,
        body: Union[Dict, bytes, InferRequest],
        verb: InferenceVerb = InferenceVerb.PREDICT,
        headers: Optional[Dict[str, str]] = None,
        response_headers: Optional[Dict[str, str]] = None,
    ):
        request_id = headers.get("x-request-id", "N.A.") if headers else "N.A."
        labels = get_labels(self.name)

        t0 = time.perf_counter()
        payload = await _maybe_await(self.preprocess(body, headers))
        t1 = time.perf_counter()
        PRE_HIST_TIME.labels(**labels).observe(t1 - t0)
        payload = self.validate(payload)

        if verb == InferenceVerb.EXPLAIN:
            t2 = time.perf_counter()
            response = await _maybe_await(self.explain(payload, headers))
            t3 = time.perf_counter()
            EXPLAIN_HIST_TIME.labels(**labels).observe(t3 - t2)
            trace_logger.info(
                "requestId: %s, preprocess_ms: %s, explain_ms: %s",
                request_id, get_latency_ms(t0, t1), get_latency_ms(t2, t3))
        else:
            t2 = time.perf_counter()
            response = await _maybe_await(
                _call_with_optional_headers(self.predict, payload, headers, response_headers))
            t3 = time.perf_counter()
            PREDICT_HIST_TIME.labels(**labels).observe(t3 - t2)
            response = await _maybe_await(
                _call_with_optional_headers(
                    self.postprocess, response, headers, response_headers))
            t4 = time.perf_counter()
            POST_HIST_TIME.labels(**labels).observe(t4 - t3)
            trace_logger.info(
                "requestId: %s, preprocess_ms: %s, predict_ms: %s, postprocess_ms: %s",
                request_id, get_latency_ms(t0, t1), get_latency_ms(t2, t3),
                get_latency_ms(t3, t4))
        return response

    def validate(self, payload):
        if isinstance(payload, (InferRequest, InferResponse)):
            return payload
        if isinstance(payload, dict):
            if self.protocol == PredictorProtocol.REST_V1.value:
                if "instances" in payload and not isinstance(payload["instances"], list):
                    raise InvalidInput('Expected "instances" to be a list')
            elif "inputs" in payload and not isinstance(payload["inputs"], list):
                raise InvalidInput('Expected "inputs" to be a list')
        return payload

    # ---------- stages (override points) ----------

    async def preprocess(self, payload, headers: Optional[Dict[str, str]] = None):
        return payload

    async def predict(self, payload, headers: Optional[Dict[str, str]] = None,
                      response_headers=None):
        """Default behaviour: transformer mode (forward to predictor_host)."""
        self._require_forwarding()
        predict_headers = dict(self.predictor_config.extra_headers)
        if headers:
            for h in ("x-request-id", "x-b3-traceid"):
                if h in headers:
                    predict_headers[h] = headers[h]
            if headers.get("content-type", "").startswith("application/cloudevents+json"):
                predict_headers["content-type"] = "application/json"
        return await self._client().infer(
            self._predict_url(), data=payload, headers=predict_headers,
            model_name=self.name)

    async def explain(self, payload, headers: Optional[Dict[str, str]] = None):
        self._require_forwarding()
        return await self._client().explain(self._explain_url(), data=payload,
                                            headers=headers)

    async def postprocess(self, result, headers: Optional[Dict[str, str]] = None,
                          response_headers=None):
        return result

    # ---------- transformer forwarding ----------

    def _require_forwarding(self) -> None:
        if not self.predictor_host:
            raise NotImplementedError("Could not find predictor_host.")
        if self.protocol == PredictorProtocol.GRPC_V2.value:
            raise NotImplementedError(
                "forwarding over gRPC is not supported yet; use v1 or v2")

    def _client(self):
        from .inference_client import InferenceRESTClient, RESTConfig

        if self._rest_client is None:
            self._rest_client = InferenceRESTClient(RESTConfig(
                protocol=self.protocol,
                timeout=self.predictor_config.predictor_request_timeout_seconds,
                retries=self.predictor_config.predictor_request_retries))
        return self._rest_client

    def _base_url(self) -> str:
        if self.predictor_config.predictor_use_ssl:
            raise NotImplementedError("forwarding over TLS is not supported")
        return f"http://{self.predictor_config.predictor_host}"

    def _predict_url(self) -> str:
        if self.protocol == PredictorProtocol.REST_V1.value:
            return f"{self._base_url()}/v1/models/{self.name}:predict"
        return f"{self._base_url()}/v2/models/{self.name}/infer"

    def _explain_url(self) -> str:
        return f"{self._base_url()}/v1/models/{self.name}:explain"

    def get_input_types(self) -> list:
        return []

    def get_output_types(self) -> list:
        return []


async def _maybe_await(value):
    if inspect.isawaitable(value):
        return await value
    return value


def _call_with_optional_headers(fn: Callable, payload, headers, response_headers):
    """Call a stage fn, passing response_headers only if its signature takes
    it, so that simple user overrides (payload, headers) keep working."""
    try:
        sig = inspect.signature(fn)
        if "response_headers" in sig.parameters:
            return fn(payload, headers, response_headers=response_headers)
    except (ValueError, TypeError):
        pass
    return fn(payload, headers)
