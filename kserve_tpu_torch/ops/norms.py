"""Normalization ops (RMSNorm, LayerNorm): f32 accumulation, output in the
input dtype.

Port of kserve_tpu/ops/norms.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def rms_norm_plus_one(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: multiplies by (1 + weight), with the product
    taken in f32 before the cast."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with the biased variance: (x - mean) * rsqrt(var + eps)
    * weight + bias, in f32 (kserve_tpu/ops/norms.py:27-33)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    normed = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)
