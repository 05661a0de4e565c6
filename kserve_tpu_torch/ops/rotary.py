"""Rotary position embeddings (half-rotation layout, Llama/NeoX style), with
the HF `rope_scaling` variants "llama3" and "linear".

Port of kserve_tpu/ops/rotary.py.  `rope_cos_sin` is split out so a
forward computes the phases once and every layer reuses them."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
    device=None,
) -> torch.Tensor:
    """[head_dim/2] inverse frequencies, with optional HF rope_scaling."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if not rope_scaling:
        return inv_freq
    rope_type = rope_scaling.get("rope_type") or rope_scaling.get("type") or "default"
    if rope_type == "default":
        return inv_freq
    if rope_type == "linear":
        return inv_freq / float(rope_scaling["factor"])
    if rope_type == "llama3":
        factor = float(rope_scaling["factor"])
        low = float(rope_scaling["low_freq_factor"])
        high = float(rope_scaling["high_freq_factor"])
        orig_ctx = float(rope_scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / inv_freq
        smooth = torch.clamp((orig_ctx / wavelen - low) / (high - low), 0.0, 1.0)
        return (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    raise ValueError(
        f"unsupported rope_scaling type {rope_type!r}; supported: "
        "default, linear, llama3"
    )


def rope_cos_sin(
    positions: torch.Tensor,  # [...] int
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin phases [..., 1, D/2] for `positions` (f32)."""
    inv_freq = rope_frequencies(head_dim, theta, rope_scaling, positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply precomputed phases to x [..., H, D]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # [..., H, D]
    positions: torch.Tensor,  # [...] int
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
) -> torch.Tensor:
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta, rope_scaling)
    return rotate(x, cos, sin)
