"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a quiet fall back."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def upload(x, device: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Host data (numpy, a list, or a tensor) as a `dtype` tensor on
    `device`.  To a CUDA device the copy goes from pinned memory with
    non_blocking=True: a copy from pageable memory synchronizes the stream
    and would wait for every launch already queued."""
    if torch.is_tensor(x):
        t = x
    else:
        t = torch.as_tensor(np.asarray(x))
    t = t.to(dtype)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as a torch.device, defaulting to "cuda".  Raises when CUDA
    is asked for (or defaulted to) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
