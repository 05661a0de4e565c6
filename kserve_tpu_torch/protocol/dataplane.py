"""Protocol-agnostic data plane: decode -> dispatch -> encode (port of
kserve_tpu/protocol/dataplane.py).

The V1 and V2 REST heads funnel through `DataPlane`, which owns server and
model health, request decoding (V2 JSON, the V2 binary-tensor extension,
structured and binary CloudEvents), model dispatch and response encoding.
A registered handle that is not a `BaseModel` (a generative model) counts
by its `healthy()` / `live()` where it has them, else by its `ready` flag.
"""

from __future__ import annotations

import json
import uuid
from typing import Dict, Optional, Tuple, Union

from ..errors import InvalidInput, ModelNotFound, ModelNotReady
from ..infer_type import InferRequest, InferResponse
from ..model import InferenceVerb
from ..model_repository import ModelRepository

SERVER_NAME = "kserve-tpu"
SERVER_VERSION = "0.1.0"

_CE_REQUIRED = ("ce-specversion", "ce-source", "ce-type", "ce-id")


def _is_binary_cloudevent(headers: Optional[Dict[str, str]]) -> bool:
    if not headers:
        return False
    lower = {k.lower(): v for k, v in headers.items()}
    return all(h in lower for h in _CE_REQUIRED)


def _is_structured_cloudevent(body: dict) -> bool:
    return (
        isinstance(body, dict)
        and "time" in body
        and "type" in body
        and "source" in body
        and "id" in body
        and "specversion" in body
        and "data" in body
    )


class DataPlane:
    """Core dispatch layer shared by all protocol heads."""

    def __init__(self, model_registry: ModelRepository):
        self._model_registry = model_registry
        self._server_name = SERVER_NAME
        self._server_version = SERVER_VERSION

    @property
    def model_registry(self) -> ModelRepository:
        return self._model_registry

    def get_model_from_registry(self, name: str):
        model = self._model_registry.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        return model

    async def get_model(self, name: str):
        """Resolve a model; raises ModelNotFound / ModelNotReady."""
        model = self._model_registry.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        if not await self._model_registry.is_model_ready(name):
            raise ModelNotReady(name)
        return model

    # ---------- health & metadata ----------

    async def live(self) -> Dict[str, str]:
        """'alive' unless some model reports its background loop wedged —
        liveness is the restart signal, so a wedged engine must surface
        here, not just in readiness."""
        for model in self._model_registry.get_models().values():
            live = getattr(model, "live", None)
            if live is not None and not await live():
                return {"status": "wedged"}
        return {"status": "alive"}

    async def ready(self) -> bool:
        """Server readiness: every registered model healthy (empty registry is
        ready so the pod can come up before models stream in)."""
        for model in self._model_registry.get_models().values():
            healthy = getattr(model, "healthy", None)
            ok = await healthy() if healthy is not None else getattr(model, "ready", True)
            if not ok:
                return False
        return True

    async def model_ready(self, model_name: str) -> bool:
        if self._model_registry.get_model(model_name) is None:
            raise ModelNotFound(model_name)
        return await self._model_registry.is_model_ready(model_name)

    def metadata(self) -> Dict:
        return {
            "name": self._server_name,
            "version": self._server_version,
            "extensions": ["model_repository_extension"],
        }

    async def model_metadata(self, model_name: str) -> Dict:
        model = self.get_model_from_registry(model_name)
        input_types = model.get_input_types() if hasattr(model, "get_input_types") else []
        output_types = model.get_output_types() if hasattr(model, "get_output_types") else []
        return {
            "name": model_name,
            "platform": "",
            "inputs": input_types,
            "outputs": output_types,
        }

    # ---------- decode / encode ----------

    def decode(
        self,
        body: Union[bytes, dict, InferRequest],
        headers: Optional[Dict[str, str]] = None,
        json_length: Optional[int] = None,
        model_name: Optional[str] = None,
    ) -> Tuple[Union[dict, InferRequest], Dict]:
        """bytes/dict -> (InferRequest | raw dict, attributes).  Handles the
        V2 binary-tensor extension and CloudEvents."""
        attributes: Dict = {}
        if isinstance(body, InferRequest):
            return body, attributes
        if json_length is not None and isinstance(body, (bytes, bytearray)):
            return (
                InferRequest.from_bytes(bytes(body), json_length, model_name or ""),
                attributes,
            )
        if isinstance(body, (bytes, bytearray)):
            if _is_binary_cloudevent(headers):
                lower = {k.lower(): v for k, v in (headers or {}).items()}
                attributes = {
                    k[3:]: v for k, v in lower.items() if k.startswith("ce-")
                }
                try:
                    decoded = json.loads(body) if body else {}
                except json.JSONDecodeError as e:
                    raise InvalidInput(f"Failed to decode binary cloudevent data: {e}")
                return decoded, attributes
            try:
                body = json.loads(body) if body else {}
            except json.JSONDecodeError as e:
                raise InvalidInput(f"Unrecognized request format: {e}")
        if isinstance(body, dict) and _is_structured_cloudevent(body):
            attributes = {k: v for k, v in body.items() if k != "data"}
            body = body["data"]
            if isinstance(body, str):
                try:
                    body = json.loads(body)
                except json.JSONDecodeError as e:
                    raise InvalidInput(f"Failed to decode cloudevent data: {e}")
        if isinstance(body, dict) and "inputs" in body and "instances" not in body:
            return InferRequest.from_dict(body, model_name=model_name), attributes
        return body, attributes

    def encode(
        self,
        model_name: str,
        response: Union[dict, InferResponse],
        headers: Optional[Dict[str, str]] = None,
        req_attributes: Optional[Dict] = None,
    ) -> Tuple[Union[dict, bytes], Dict[str, str]]:
        """Model output -> (body, response headers).  CloudEvent requests get
        CloudEvent responses; InferResponse encodes to V2 JSON or binary."""
        response_headers: Dict[str, str] = {}
        if isinstance(response, InferResponse):
            res, json_length = response.to_rest()
            if json_length is not None:
                response_headers["inference-header-content-length"] = str(json_length)
                response_headers["content-type"] = "application/octet-stream"
            return res, response_headers
        if _is_binary_cloudevent(headers) or (req_attributes and "specversion" in req_attributes):
            attrs = req_attributes or {}
            response_headers = {
                "ce-specversion": str(attrs.get("specversion", "1.0")),
                "ce-id": str(uuid.uuid4()),
                "ce-source": f"io.kserve.inference.{model_name}",
                "ce-type": "io.kserve.inference.response",
                "content-type": "application/json",
            }
            return response, response_headers
        return response, response_headers

    # ---------- dispatch ----------

    async def infer(
        self,
        model_name: str,
        request: Union[bytes, dict, InferRequest],
        headers: Optional[Dict[str, str]] = None,
        response_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[Union[dict, InferResponse], Dict]:
        model = await self.get_model(model_name)
        response = await model(
            request,
            verb=InferenceVerb.PREDICT,
            headers=headers,
            response_headers=response_headers,
        )
        return response, headers or {}

    async def explain(
        self,
        model_name: str,
        request: Union[bytes, dict, InferRequest],
        headers: Optional[Dict[str, str]] = None,
        response_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[Union[dict, InferResponse], Dict]:
        model = await self.get_model(model_name)
        response = await model(
            request,
            verb=InferenceVerb.EXPLAIN,
            headers=headers,
            response_headers=response_headers,
        )
        return response, headers or {}
