"""Open Inference Protocol tensor <-> numpy codec (port of
kserve_tpu/utils/numpy_codec.py).

The V2 datatype table, plus BF16 where `ml_dtypes` imports (as in the JAX
codec; the card machine has no ml_dtypes, so there BF16 is unknown, as it
is to the JAX codec on such a machine).  ml_dtypes is looked up when BF16
is first asked for, never when this module is imported.  BYTES tensors use
the binary wire format: each element a little-endian uint32 length, then
its bytes.
"""

from __future__ import annotations

import struct
from functools import lru_cache
from typing import List, Optional

import numpy as np

# OIP datatype name -> numpy dtype
_DTYPE_TABLE = {
    "BOOL": np.dtype(np.bool_),
    "UINT8": np.dtype(np.uint8),
    "UINT16": np.dtype(np.uint16),
    "UINT32": np.dtype(np.uint32),
    "UINT64": np.dtype(np.uint64),
    "INT8": np.dtype(np.int8),
    "INT16": np.dtype(np.int16),
    "INT32": np.dtype(np.int32),
    "INT64": np.dtype(np.int64),
    "FP16": np.dtype(np.float16),
    "FP32": np.dtype(np.float32),
    "FP64": np.dtype(np.float64),
}

_REVERSE_TABLE = {v: k for k, v in _DTYPE_TABLE.items()}


@lru_cache(maxsize=1)
def _bf16() -> Optional[np.dtype]:
    """numpy's bfloat16 dtype where ml_dtypes imports, else None."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def to_np_dtype(datatype: str) -> Optional[np.dtype]:
    """OIP datatype string -> numpy dtype (BYTES -> object dtype)."""
    if datatype == "BYTES":
        return np.dtype(object)
    if datatype == "BF16":
        return _bf16()
    return _DTYPE_TABLE.get(datatype)


def from_np_dtype(dtype: np.dtype) -> Optional[str]:
    """numpy dtype -> OIP datatype string."""
    dtype = np.dtype(dtype)
    if dtype.kind in ("S", "U", "O"):
        return "BYTES"
    if dtype.name == "bfloat16" and dtype == _bf16():
        return "BF16"
    return _REVERSE_TABLE.get(dtype)


def serialize_byte_tensor(tensor: np.ndarray) -> bytes:
    """Flatten a BYTES tensor (object/str/bytes ndarray) to the OIP binary
    format, elements in C order."""
    if tensor.size == 0:
        return b""
    flat = np.ascontiguousarray(tensor).flatten()
    out = bytearray()
    for el in flat:
        if isinstance(el, bytes):
            raw = el
        elif isinstance(el, str):
            raw = el.encode("utf-8")
        elif isinstance(el, (np.bytes_,)):
            raw = bytes(el)
        else:
            raw = str(el).encode("utf-8")
        out += struct.pack("<I", len(raw))
        out += raw
    return bytes(out)


def deserialize_bytes_tensor(encoded: bytes) -> np.ndarray:
    """Inverse of serialize_byte_tensor -> 1-D object ndarray of bytes."""
    items: List[bytes] = []
    offset = 0
    n = len(encoded)
    while offset < n:
        if offset + 4 > n:
            raise ValueError("malformed BYTES tensor: truncated length prefix")
        (length,) = struct.unpack_from("<I", encoded, offset)
        offset += 4
        if offset + length > n:
            raise ValueError("malformed BYTES tensor: truncated element")
        items.append(encoded[offset : offset + length])
        offset += length
    return np.array(items, dtype=object)
