"""Device selection for the port's entry points: CUDA unless the caller
asks for the CPU, and never a quiet fall back."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device` as a torch.device, defaulting to "cuda".  Raises when CUDA
    is asked for (or defaulted to) and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
