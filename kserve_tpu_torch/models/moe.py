"""Sparse Mixture-of-Experts MLP (Mixtral-style) in PyTorch.

Port of kserve_tpu/models/moe.py: a top-k softmax router over SwiGLU
experts stacked as [n_experts, ...] tensors (`w_gate`/`w_up` [E, h, f],
`w_down` [E, f, h], `router` [h, E], the JAX package's layout).  The
compute is the reference's dense-masked form: every expert runs over
every token, one batched product per projection over the expert axis,
and the outputs are combined by routing weight (zero for the experts a
token did not select).  The products are plain `torch` products (XLA
einsums in the JAX package, no Pallas kernel).  Sharding the experts
(expert parallelism) is not ported.

The numerics follow the reference step by step: the router logits are
`x @ router` in the model dtype, then cast to float32; top-k keeps the
lower expert index first on ties (as jax.lax.top_k); the softmax over the
k selected logits is float32; the combine weights are cast to the
experts' dtype before the weighted sum; the activation is silu whatever
the model's hidden_act.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F


@dataclass
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    hidden_size: int = 64
    intermediate_size: int = 128


def init_moe_params(config: MoEConfig, generator: torch.Generator, device,
                    scale: float = 0.02,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """N(0, scale) router and expert stacks drawn on `device` from
    `generator` (in the order router, w_gate, w_up, w_down)."""
    E, h, f = config.n_experts, config.hidden_size, config.intermediate_size

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    return {"router": dense(h, E), "w_gate": dense(E, h, f),
            "w_up": dense(E, h, f), "w_down": dense(E, f, h)}


def router_logits(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """[N, E] float32 router logits of x [N, h], rounded to the model
    dtype first (moe.py:52)."""
    return (x @ params["router"]).float()


def combine_weights(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """[N, E] float32 routing weights: the softmax over each token's top_k
    logits at the selected experts, 0 elsewhere.  A stable descending
    sort keeps the lower index first among equal logits, as
    jax.lax.top_k does (torch.topk promises no order on ties)."""
    top, selected = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(top[:, :top_k], dim=-1)
    return torch.zeros_like(logits).scatter_(-1, selected[:, :top_k], weights)


def expert_outputs(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """[E, N, h]: every expert's SwiGLU over every token of x [N, h]."""
    gate = F.silu(torch.matmul(x, params["w_gate"]))
    up = torch.matmul(x, params["w_up"])
    return torch.matmul(gate * up, params["w_down"])


def combine(expert_out: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[N, h]: sum over experts of expert_out [E, N, h] by weights [N, E],
    cast to the experts' dtype first (moe.py:62), as one batched product
    per token."""
    w = weights.to(expert_out.dtype).unsqueeze(1)  # [N, 1, E]
    return torch.bmm(w, expert_out.transpose(0, 1)).squeeze(1)


def moe_mlp(params: Dict[str, Any], x: torch.Tensor,
            config: MoEConfig) -> torch.Tensor:
    """x [..., h] -> [..., h].  Dense-masked top-k routing (moe.py:48-64)."""
    flat = x.reshape(-1, x.shape[-1])
    weights = combine_weights(router_logits(params, flat), config.top_k)
    out = combine(expert_outputs(params, flat), weights)
    return out.to(x.dtype).reshape(x.shape)
