"""Payload <-> numpy helpers shared by the predictive runtimes (port of
kserve_tpu/utils/inference.py)."""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from ..errors import InvalidInput
from ..infer_type import InferOutput, InferRequest, InferResponse


def single_input_matrix(instances, model_name: str) -> np.ndarray:
    """Predictive runtimes take exactly one input tensor; 400 otherwise."""
    if isinstance(instances, list):
        raise InvalidInput(
            f"model {model_name} expects a single input tensor, got "
            f"{len(instances)} named inputs"
        )
    try:
        return np.asarray(instances)
    except (ValueError, TypeError) as e:
        raise InvalidInput(f"malformed instances for model {model_name}: {e}")


def validate_feature_count(instances: np.ndarray, n_features: int, model_name: str) -> None:
    """400 (not a shape error deep in the model) when the input width does
    not match."""
    if n_features and instances.ndim >= 2 and instances.shape[-1] != n_features:
        raise InvalidInput(
            f"model {model_name} expects {n_features} features, got {instances.shape[-1]}"
        )


def get_predict_input(payload: Union[Dict, InferRequest]) -> Union[np.ndarray, List[np.ndarray]]:
    """Extract the model input matrix from a V1 dict or V2 InferRequest."""
    if isinstance(payload, InferRequest):
        if len(payload.inputs) == 1:
            return payload.inputs[0].as_numpy()
        return [inp.as_numpy() for inp in payload.inputs]
    if isinstance(payload, dict):
        instances = payload.get("instances", payload.get("inputs"))
        if instances is None:
            raise InvalidInput('Expected "instances" in request body')
        if (
            isinstance(instances, list)
            and len(instances) > 0
            and isinstance(instances[0], dict)
        ):
            # column-style records -> 2-D array in key order of first record
            keys = list(instances[0].keys())
            try:
                return np.asarray([[row[k] for k in keys] for row in instances])
            except (KeyError, TypeError) as e:
                raise InvalidInput(f"inconsistent record keys in instances: {e}")
        return np.asarray(instances)
    raise InvalidInput(f"unsupported payload type {type(payload).__name__}")


def get_predict_response(
    payload: Union[Dict, InferRequest],
    result: Union[np.ndarray, List],
    model_name: str,
) -> Union[Dict, InferResponse]:
    """Wrap a numpy result in the same protocol family the request used."""
    result = np.asarray(result)
    if isinstance(payload, InferRequest):
        output = InferOutput(
            name="output-0",
            shape=list(result.shape),
            datatype=_np_to_datatype(result),
        )
        binary = any(inp.raw_data is not None for inp in payload.inputs)
        output.set_data_from_numpy(result, binary_data=binary or payload.from_grpc)
        return InferResponse(
            response_id=payload.id,
            model_name=model_name,
            infer_outputs=[output],
        )
    return {"predictions": result.tolist()}


def _np_to_datatype(arr: np.ndarray) -> str:
    from .numpy_codec import from_np_dtype

    dt = from_np_dtype(arr.dtype)
    if dt is None:
        raise InvalidInput(f"unsupported result dtype {arr.dtype}")
    return dt
