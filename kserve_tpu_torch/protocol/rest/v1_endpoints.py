"""The V1 (TFServing-style) REST head (port of
kserve_tpu/protocol/rest/v1_endpoints.py).

Routes: GET /v1/models, GET /v1/models/{name}, POST
/v1/models/{name}:predict, POST /v1/models/{name}:explain.

Each handler takes the lower-cased request headers, the body and the
path's captures, and returns (status, body, headers): a JSON-able body, or
bytes whose content type is the "content-type" entry of the headers.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING

from ...infer_type import InferResponse

if TYPE_CHECKING:
    from ..dataplane import DataPlane

_NAME = r"([^/]+)"


class V1Endpoints:
    def __init__(self, dataplane: "DataPlane"):
        self.dataplane = dataplane
        # (method, path pattern, handler), tried in order
        self.routes = [
            ("GET", re.compile(r"/v1/models"), self.models),
            ("POST", re.compile(rf"/v1/models/{_NAME}:predict"), self.predict),
            ("POST", re.compile(rf"/v1/models/{_NAME}:explain"), self.explain),
            ("GET", re.compile(rf"/v1/models/{_NAME}"), self.model_ready),
        ]

    async def models(self, headers, body):
        return 200, {"models": list(self.dataplane.model_registry.get_models())}, {}

    async def model_ready(self, headers, body, model_name: str):
        ready = await self.dataplane.model_ready(model_name)
        return 200, {"name": model_name, "ready": ready}, {}

    async def predict(self, headers, body, model_name: str):
        return await self._call(self.dataplane.infer, headers, body, model_name)

    async def explain(self, headers, body, model_name: str):
        return await self._call(self.dataplane.explain, headers, body, model_name)

    async def _call(self, verb, headers, body: bytes, model_name: str):
        decoded, attributes = self.dataplane.decode(body, headers)
        response_headers: dict = {}
        response, _ = await verb(model_name, decoded, headers, response_headers)
        encoded, extra_headers = self.dataplane.encode(
            model_name, response, headers, attributes)
        response_headers.update(extra_headers)
        response_headers.pop("content-length", None)
        if isinstance(encoded, (bytes, bytearray)):
            response_headers.setdefault("content-type", "application/octet-stream")
            return 200, bytes(encoded), response_headers
        if isinstance(encoded, InferResponse):
            encoded, _ = encoded.to_rest()
        return 200, encoded, response_headers
