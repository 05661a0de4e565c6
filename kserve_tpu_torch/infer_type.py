"""Protocol-agnostic inference request/response tensor types (port of
kserve_tpu/infer_type.py).

`InferInput` / `RequestedOutput` / `InferRequest` / `InferResponse` are the
in-memory form that the V1 JSON, V2 JSON and V2 binary-tensor heads encode
to and decode from.  The gRPC forms come with the port's gRPC head.
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .errors import InvalidInput
from .utils.numpy_codec import (
    deserialize_bytes_tensor,
    from_np_dtype,
    serialize_byte_tensor,
    to_np_dtype,
)

Parameters = Dict[str, Union[str, bool, int, float]]


def _flatten_data(datatype: str, array: np.ndarray) -> list:
    flat = array.flatten()
    if datatype == "BYTES":
        out = []
        for el in flat:
            if isinstance(el, bytes):
                try:
                    out.append(el.decode("utf-8"))
                except UnicodeDecodeError:
                    out.append(list(el))
            else:
                out.append(str(el))
        return out
    return flat.tolist()


class InferInput:
    """One named input tensor."""

    def __init__(
        self,
        name: str,
        shape: List[int],
        datatype: str,
        data: Union[List, np.ndarray, None] = None,
        parameters: Optional[Parameters] = None,
    ):
        self._name = name
        self._shape = list(shape)
        self._datatype = datatype.upper()
        self._parameters = dict(parameters or {})
        self._data: Optional[list] = None
        self._raw_data: Optional[bytes] = None
        if isinstance(data, np.ndarray):
            self.set_data_from_numpy(data, binary_data=False)
        elif data is not None:
            self._data = data

    @property
    def name(self) -> str:
        return self._name

    @property
    def shape(self) -> List[int]:
        return self._shape

    @shape.setter
    def shape(self, shape: List[int]):
        self._shape = list(shape)

    @property
    def datatype(self) -> str:
        return self._datatype

    @property
    def parameters(self) -> Parameters:
        return self._parameters

    @parameters.setter
    def parameters(self, params: Parameters):
        self._parameters = dict(params or {})

    @property
    def data(self) -> Optional[list]:
        return self._data

    @data.setter
    def data(self, data: list):
        self._data = data

    @property
    def raw_data(self) -> Optional[bytes]:
        return self._raw_data

    def set_data_from_numpy(self, input_tensor: np.ndarray, binary_data: bool = True) -> None:
        """Attach tensor data; `binary_data` selects the V2 binary extension
        wire form (raw bytes + binary_data_size parameter) over inline JSON."""
        if not isinstance(input_tensor, np.ndarray):
            raise InvalidInput("input tensor must be a numpy array")
        dtype = from_np_dtype(input_tensor.dtype)
        if dtype is None:
            raise InvalidInput(f"unsupported numpy dtype {input_tensor.dtype}")
        self._datatype = dtype
        self._shape = list(input_tensor.shape)
        if binary_data:
            self._data = None
            if dtype == "BYTES":
                self._raw_data = serialize_byte_tensor(input_tensor)
            else:
                self._raw_data = np.ascontiguousarray(input_tensor).tobytes()
            self._parameters["binary_data_size"] = len(self._raw_data)
        else:
            self._raw_data = None
            self._parameters.pop("binary_data_size", None)
            self._data = _flatten_data(dtype, input_tensor)

    def as_numpy(self) -> np.ndarray:
        """Materialize as numpy in the declared shape."""
        dtype = to_np_dtype(self._datatype)
        if dtype is None:
            raise InvalidInput(f"invalid datatype {self._datatype} in input {self._name}")
        if self._raw_data is not None:
            if self._datatype == "BYTES":
                arr = deserialize_bytes_tensor(self._raw_data)
            else:
                arr = np.frombuffer(self._raw_data, dtype=dtype)
            return arr.reshape(self._shape)
        if self._data is None:
            raise InvalidInput(f"input {self._name} has no data")
        if self._datatype == "BYTES":
            encoded = [
                el.encode("utf-8") if isinstance(el, str) else (bytes(el) if isinstance(el, list) else el)
                for el in _iter_flat(self._data)
            ]
            return np.array(encoded, dtype=object).reshape(self._shape)
        return np.asarray(self._data, dtype=dtype).reshape(self._shape)

    def as_string(self) -> List[str]:
        if self._datatype != "BYTES":
            raise InvalidInput(f"input {self._name} datatype is {self._datatype}, not BYTES")
        arr = self.as_numpy().flatten()
        return [el.decode("utf-8") if isinstance(el, bytes) else str(el) for el in arr]

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "name": self._name,
            "shape": self._shape,
            "datatype": self._datatype,
        }
        if self._parameters:
            d["parameters"] = self._parameters
        if self._raw_data is None:
            d["data"] = self._data
        return d

    def __eq__(self, other) -> bool:
        if not isinstance(other, InferInput):
            return NotImplemented
        if (self._name, self._datatype) != (other._name, other._datatype):
            return False
        if list(self._shape) != list(other._shape):
            return False
        try:
            return np.array_equal(self.as_numpy(), other.as_numpy())
        except InvalidInput:
            return self._data == other._data and self._raw_data == other._raw_data

    def __repr__(self) -> str:
        return (
            f"InferInput(name={self._name!r}, shape={self._shape}, "
            f"datatype={self._datatype!r})"
        )


def _iter_flat(data):
    if isinstance(data, (list, tuple)):
        for el in data:
            yield from _iter_flat(el)
    else:
        yield data


class RequestedOutput:
    """Client request for a specific named output (V2 `outputs` entry)."""

    def __init__(self, name: str, parameters: Optional[Parameters] = None):
        self.name = name
        self.parameters = dict(parameters or {})

    @property
    def binary_data(self) -> Optional[bool]:
        v = self.parameters.get("binary_data")
        return bool(v) if v is not None else None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"name": self.name}
        if self.parameters:
            d["parameters"] = self.parameters
        return d

    def __eq__(self, other) -> bool:
        if not isinstance(other, RequestedOutput):
            return NotImplemented
        return self.name == other.name and self.parameters == other.parameters

    def __repr__(self) -> str:
        return f"RequestedOutput(name={self.name!r})"


class InferRequest:
    """Protocol-agnostic inference request."""

    def __init__(
        self,
        model_name: str,
        infer_inputs: List[InferInput],
        request_id: Optional[str] = None,
        raw_inputs: Optional[List[bytes]] = None,
        from_grpc: bool = False,
        parameters: Optional[Parameters] = None,
        request_outputs: Optional[List[RequestedOutput]] = None,
        model_version: Optional[str] = None,
    ):
        self.model_name = model_name
        self.model_version = model_version
        self.id = request_id or str(uuid.uuid4())
        self.inputs = infer_inputs
        self.parameters = dict(parameters or {})
        self.from_grpc = from_grpc
        self.request_outputs = request_outputs
        if raw_inputs:
            if len(raw_inputs) != len(infer_inputs):
                raise InvalidInput("raw_input_contents count does not match inputs count")
            for i, raw in enumerate(raw_inputs):
                infer_inputs[i]._raw_data = raw

    # ---------- constructors ----------

    @classmethod
    def from_dict(cls, body: dict, model_name: Optional[str] = None) -> "InferRequest":
        """Build from a V2 JSON body (already parsed)."""
        if "inputs" not in body or not isinstance(body["inputs"], list):
            raise InvalidInput("missing 'inputs' in v2 inference request")
        inputs = []
        for entry in body["inputs"]:
            try:
                inputs.append(
                    InferInput(
                        name=entry["name"],
                        shape=entry["shape"],
                        datatype=entry["datatype"],
                        data=entry.get("data"),
                        parameters=entry.get("parameters"),
                    )
                )
            except KeyError as e:
                raise InvalidInput(f"input tensor missing required field {e}")
        outputs = None
        if body.get("outputs"):
            outputs = [
                RequestedOutput(name=o["name"], parameters=o.get("parameters"))
                for o in body["outputs"]
            ]
        return cls(
            model_name=model_name or body.get("model_name", ""),
            request_id=body.get("id"),
            infer_inputs=inputs,
            parameters=body.get("parameters"),
            request_outputs=outputs,
        )

    @classmethod
    def from_bytes(cls, req_bytes: bytes, json_length: int, model_name: str) -> "InferRequest":
        """Build from a V2 REST body carrying the binary tensor extension:
        `json_length` bytes of JSON header followed by raw tensor data."""
        import json

        if json_length > len(req_bytes):
            raise InvalidInput("Inference-Header-Content-Length exceeds body size")
        try:
            header = json.loads(req_bytes[:json_length])
        except json.JSONDecodeError as e:
            raise InvalidInput(f"unrecognized request format: {e}")
        req = cls.from_dict(header, model_name=model_name)
        offset = json_length
        blob = req_bytes
        for inp in req.inputs:
            size = inp.parameters.get("binary_data_size") if inp.parameters else None
            if size is None:
                continue
            size = int(size)
            if offset + size > len(blob):
                raise InvalidInput(f"binary data for input {inp.name} is truncated")
            inp._raw_data = blob[offset : offset + size]
            inp._data = None
            offset += size
        return req

    # ---------- encoders ----------

    def to_rest(self) -> Tuple[Union[bytes, dict], Optional[int]]:
        """Encode to (body, json_length). json_length is None for pure-JSON
        bodies; set when any input uses the binary extension."""
        import json

        infer_inputs = []
        raw_parts: List[bytes] = []
        for inp in self.inputs:
            d = inp.to_dict()
            if inp.raw_data is not None:
                d.pop("data", None)
                d.setdefault("parameters", inp.parameters)
                raw_parts.append(inp.raw_data)
            else:
                if inp.datatype == "FP16":
                    raise InvalidInput(
                        f"FP16 input {inp.name} must use binary_data (no JSON form)"
                    )
            infer_inputs.append(d)
        body: Dict[str, Any] = {"id": self.id, "inputs": infer_inputs}
        if self.model_name:
            body["model_name"] = self.model_name
        if self.parameters:
            body["parameters"] = self.parameters
        if self.request_outputs:
            body["outputs"] = [o.to_dict() for o in self.request_outputs]
        if raw_parts:
            header = json.dumps(body).encode("utf-8")
            return header + b"".join(raw_parts), len(header)
        return body, None

    def as_dataframe(self):
        """Columns from named inputs (pandas optional)."""
        import pandas as pd

        cols = {}
        for inp in self.inputs:
            arr = inp.as_numpy()
            if inp.datatype == "BYTES":
                arr = np.array(
                    [el.decode("utf-8") if isinstance(el, bytes) else el for el in arr.flatten()]
                ).reshape(arr.shape)
            cols[inp.name] = arr.flatten() if arr.ndim <= 1 else list(arr)
        return pd.DataFrame(cols)

    def get_input_by_name(self, name: str) -> Optional[InferInput]:
        for inp in self.inputs:
            if inp.name == name:
                return inp
        return None

    def __eq__(self, other) -> bool:
        if not isinstance(other, InferRequest):
            return NotImplemented
        return (
            self.model_name == other.model_name
            and self.id == other.id
            and self.inputs == other.inputs
            and self.parameters == other.parameters
        )

    def __repr__(self) -> str:
        return f"InferRequest(model_name={self.model_name!r}, id={self.id!r}, inputs={self.inputs})"


class InferOutput(InferInput):
    """A named output tensor; wire-identical to InferInput."""


class InferResponse:
    """Protocol-agnostic inference response."""

    def __init__(
        self,
        response_id: str,
        model_name: str,
        infer_outputs: List[InferOutput],
        model_version: Optional[str] = None,
        raw_outputs: Optional[List[bytes]] = None,
        from_grpc: bool = False,
        parameters: Optional[Parameters] = None,
    ):
        self.id = response_id
        self.model_name = model_name
        self.model_version = model_version
        self.outputs = infer_outputs
        self.parameters = dict(parameters or {})
        self.from_grpc = from_grpc
        if raw_outputs:
            for i, raw in enumerate(raw_outputs):
                infer_outputs[i]._raw_data = raw

    @classmethod
    def from_dict(cls, body: dict) -> "InferResponse":
        outputs = [
            InferOutput(
                name=o["name"],
                shape=o["shape"],
                datatype=o["datatype"],
                data=o.get("data"),
                parameters=o.get("parameters"),
            )
            for o in body.get("outputs", [])
        ]
        return cls(
            response_id=body.get("id", ""),
            model_name=body.get("model_name", ""),
            model_version=body.get("model_version"),
            infer_outputs=outputs,
            parameters=body.get("parameters"),
        )

    @classmethod
    def from_bytes(cls, res_bytes: bytes, json_length: int) -> "InferResponse":
        import json

        header = json.loads(res_bytes[:json_length])
        res = cls.from_dict(header)
        offset = json_length
        for out in res.outputs:
            size = out.parameters.get("binary_data_size") if out.parameters else None
            if size is None:
                continue
            size = int(size)
            out._raw_data = res_bytes[offset : offset + size]
            out._data = None
            offset += size
        return res

    def to_rest(self, requested_outputs: Optional[List[RequestedOutput]] = None):
        """Encode to (body, json_length). Outputs marked binary_data (via the
        requested outputs or their own raw form) use the binary extension."""
        import json

        binary_names = set()
        drop_binary = set()
        for ro in requested_outputs or []:
            if ro.binary_data:
                binary_names.add(ro.name)
            elif ro.binary_data is False:
                drop_binary.add(ro.name)
        entries = []
        raw_parts: List[bytes] = []
        for out in self.outputs:
            wants_binary = out.name in binary_names or (
                out.raw_data is not None and out.name not in drop_binary
            )
            d = out.to_dict()
            if wants_binary:
                if out.raw_data is None:
                    arr = out.as_numpy()
                    if out.datatype == "BYTES":
                        raw = serialize_byte_tensor(arr)
                    else:
                        raw = np.ascontiguousarray(arr).tobytes()
                    out._raw_data = raw
                d.pop("data", None)
                params = dict(d.get("parameters") or {})
                params["binary_data_size"] = len(out.raw_data)
                d["parameters"] = params
                raw_parts.append(out.raw_data)
            else:
                if out.raw_data is not None:
                    arr = out.as_numpy()
                    d["data"] = _flatten_data(out.datatype, arr)
                d.get("parameters", {}).pop("binary_data_size", None)
                if "parameters" in d and not d["parameters"]:
                    del d["parameters"]
            entries.append(d)
        body: Dict[str, Any] = {
            "id": self.id,
            "model_name": self.model_name,
            "outputs": entries,
        }
        if self.model_version:
            body["model_version"] = self.model_version
        if self.parameters:
            body["parameters"] = self.parameters
        if raw_parts:
            header = json.dumps(body).encode("utf-8")
            return header + b"".join(raw_parts), len(header)
        return body, None

    def get_output_by_name(self, name: str) -> Optional[InferOutput]:
        for out in self.outputs:
            if out.name == name:
                return out
        return None

    def __eq__(self, other) -> bool:
        if not isinstance(other, InferResponse):
            return NotImplemented
        return (
            self.model_name == other.model_name
            and self.id == other.id
            and self.outputs == other.outputs
        )

    def __repr__(self) -> str:
        return (
            f"InferResponse(model_name={self.model_name!r}, id={self.id!r}, "
            f"outputs={self.outputs})"
        )
