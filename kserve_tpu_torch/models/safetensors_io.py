"""safetensors files on the standard library and torch (no `safetensors`
package, which the card machine does not have).

Format: an 8-byte little-endian header length N, N bytes of JSON header
({name: {"dtype", "shape", "data_offsets": [begin, end]}}, plus an
optional "__metadata__" of strings), then the tensors' bytes, row-major
and little-endian, at the offsets (relative to the end of the header).

`iter_tensors` memory-maps a shard and yields its tensors one at a time,
each copied out of the map into its own host buffer, so a caller that
places each tensor on the device before taking the next stages one
tensor of host memory at a time.  bfloat16 goes straight from bytes to a
torch.bfloat16 tensor (numpy has no bfloat16 without ml_dtypes).
`save_file` writes the same format.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
from typing import Dict, Iterator, List, Tuple

import torch

# safetensors dtype names this reader takes, and back
DTYPES: Dict[str, torch.dtype] = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I8": torch.int8,
    "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}

# a header larger than this is not a checkpoint (safetensors' own limit)
MAX_HEADER_BYTES = 100 << 20


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


def _check_little_endian() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors I/O needs a little-endian host")


def read_header(path: str) -> Tuple[int, Dict[str, dict]]:
    """(data start offset, {name: {"dtype", "shape", "data_offsets"}}) of
    a safetensors file (its "__metadata__" skipped), every range checked:
    inside the file's data, the size its dtype and shape give, and no two
    overlapping.  Raises SafetensorsError on a malformed file and
    NotImplementedError on a dtype this reader does not take."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER_BYTES or 8 + n > size:
            raise SafetensorsError(
                f"{path}: header length {n} exceeds the file ({size} bytes)")
        head = f.read(n)
    try:
        header = json.loads(head.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise SafetensorsError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    start = 8 + n
    data_len = size - start
    spans: List[Tuple[int, int, str]] = []
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = (
                info["dtype"], info["shape"], info["data_offsets"])
        except (KeyError, TypeError, ValueError):
            raise SafetensorsError(
                f"{path}: tensor {name!r} has a malformed entry {info!r}") from None
        if dtype not in DTYPES:
            raise NotImplementedError(
                f"{path}: tensor {name!r} has dtype {dtype!r}; supported: "
                f"{sorted(DTYPES)}")
        if (not isinstance(begin, int) or not isinstance(end, int)
                or not 0 <= begin <= end <= data_len):
            raise SafetensorsError(
                f"{path}: tensor {name!r} spans [{begin}, {end}) outside the "
                f"{data_len} data bytes")
        if not all(isinstance(d, int) and d >= 0 for d in shape):
            raise SafetensorsError(f"{path}: tensor {name!r} has shape {shape!r}")
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=DTYPES[dtype]).element_size()
        if end - begin != numel * itemsize:
            raise SafetensorsError(
                f"{path}: tensor {name!r} holds {end - begin} bytes, its "
                f"{dtype} {shape} needs {numel * itemsize}")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end0, a), (begin1, _, b) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise SafetensorsError(f"{path}: tensors {a!r} and {b!r} overlap")
    return start, header


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every tensor of a shard, in name order, as
    `safetensors.safe_open(...).keys()` lists them.  Each tensor owns a
    copy of its bytes, so it outlives the file's map."""
    _check_little_endian()
    start, header = read_header(path)
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        try:
            for name in sorted(header):
                info = header[name]
                dtype = DTYPES[info["dtype"]]
                begin, end = info["data_offsets"]
                if end == begin:
                    yield name, torch.empty(info["shape"], dtype=dtype)
                    continue
                with view[start + begin:start + end] as part:
                    buf = bytearray(part)  # the one copy out of the map
                yield name, torch.frombuffer(buf, dtype=dtype).reshape(info["shape"])
        finally:
            view.release()


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` ({name: tensor}, any device, F32/F16/BF16/I8/I32/
    I64) as one safetensors file, in name order, the header padded with
    spaces to a multiple of 8 bytes."""
    _check_little_endian()
    header: Dict[str, object] = {}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise NotImplementedError(
                f"tensor {name!r} has dtype {t.dtype}; supported: "
                f"{sorted(_NAMES.values())}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
