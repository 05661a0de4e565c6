"""The V2 / Open Inference Protocol REST head, with the binary-tensor
extension (Inference-Header-Content-Length) and the repository extension
(load and unload) (port of kserve_tpu/protocol/rest/v2_endpoints.py).

Routes: GET /v2, GET /v2/models/{name}, GET /v2/models/{name}/ready, POST
/v2/models/{name}[/versions/{version}]/infer, POST
/v2/repository/models/{name}/load and /unload.  The health routes
(/v2/health/live and /ready) are the server's, which gates them on the
replica's lifecycle.  Handlers return (status, body, headers) as in
v1_endpoints.py.
"""

from __future__ import annotations

import re
from typing import TYPE_CHECKING, Optional

from ...errors import InvalidInput
from ...infer_type import InferRequest, InferResponse

if TYPE_CHECKING:
    from ..dataplane import DataPlane
    from ..model_repository_extension import ModelRepositoryExtension

_NAME = r"([^/]+)"


class V2Endpoints:
    def __init__(self, dataplane: "DataPlane",
                 model_repository_extension: "ModelRepositoryExtension"):
        self.dataplane = dataplane
        self.model_repository_extension = model_repository_extension
        # (method, path pattern, handler), tried in order
        self.routes = [
            ("GET", re.compile(r"/v2"), self.metadata),
            ("GET", re.compile(rf"/v2/models/{_NAME}"), self.model_metadata),
            ("GET", re.compile(rf"/v2/models/{_NAME}/ready"), self.model_ready),
            ("POST", re.compile(rf"/v2/models/{_NAME}/infer"), self.infer),
            ("POST", re.compile(rf"/v2/models/{_NAME}/versions/{_NAME}/infer"),
             self.infer),
            ("POST", re.compile(rf"/v2/repository/models/{_NAME}/load"), self.load),
            ("POST", re.compile(rf"/v2/repository/models/{_NAME}/unload"), self.unload),
        ]

    async def metadata(self, headers, body):
        return 200, self.dataplane.metadata(), {}

    async def model_metadata(self, headers, body, model_name: str):
        return 200, await self.dataplane.model_metadata(model_name), {}

    async def model_ready(self, headers, body, model_name: str):
        ready = await self.dataplane.model_ready(model_name)
        return (200 if ready else 503), {"name": model_name, "ready": ready}, {}

    async def infer(self, headers, body: bytes, model_name: str,
                    model_version: Optional[str] = None):
        json_length: Optional[int] = None
        if "inference-header-content-length" in headers:
            try:
                json_length = int(headers["inference-header-content-length"])
            except ValueError:
                raise InvalidInput("Inference-Header-Content-Length must be an integer")
        infer_request, _ = self.dataplane.decode(
            body, headers, json_length=json_length, model_name=model_name)
        if isinstance(infer_request, dict):
            infer_request = InferRequest.from_dict(infer_request, model_name=model_name)
        if model_version:
            infer_request.model_version = model_version
        response_headers: dict = {}
        response, _ = await self.dataplane.infer(
            model_name, infer_request, headers, response_headers)
        if isinstance(response, InferResponse):
            res, res_json_length = response.to_rest(infer_request.request_outputs)
        else:
            res, res_json_length = response, None
        response_headers.pop("content-length", None)
        if res_json_length is not None:
            response_headers["inference-header-content-length"] = str(res_json_length)
            response_headers["content-type"] = "application/octet-stream"
            return 200, res, response_headers
        response_headers["content-type"] = "application/json"
        return 200, res, response_headers

    async def load(self, headers, body, model_name: str):
        await self.model_repository_extension.load(model_name)
        return 200, {"name": model_name, "load": True}, {}

    async def unload(self, headers, body, model_name: str):
        await self.model_repository_extension.unload(model_name)
        return 200, {"name": model_name, "unload": True}, {}
