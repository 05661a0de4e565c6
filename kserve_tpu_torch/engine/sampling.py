"""Batched token sampling on the device.

Port of kserve_tpu/engine/sampling.py: per-lane parameters travel as a
struct of tensors (`SamplingState`), so one call serves any mix of greedy,
temperature, top-k, top-p and min-p lanes.  The mask steps are the JAX
package's, factored into `masked_logits` so they can be compared exactly.

Random draws: an unseeded lane draws from the caller's batch
`torch.Generator`; a seeded lane draws from its own generator seeded by
(seed, tokens generated so far), so its stream does not depend on its
batch position or neighbours.  The bits are not JAX's threefry bits: a
seeded stream differs between this port and the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


@dataclass
class SamplingParams:
    """Host-side per-request sampling config."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    min_p: float = 0.0
    max_tokens: int = 16
    min_tokens: int = 0
    ignore_eos: bool = False
    stop: Optional[List[str]] = None
    seed: Optional[int] = None


@dataclass
class SamplingState:
    """Struct of [B] tensors on the device, plus the host copies the
    sampler needs to pick generators without a device sync."""

    temperature: torch.Tensor  # [B] f32 (0 => greedy)
    top_p: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int64 (0 => off)
    min_p: torch.Tensor  # [B] f32
    seeds: List[int]  # host: -1 => draw from the batch generator
    all_greedy: bool  # host: no lane draws at all

    @staticmethod
    def from_params(params_list: Sequence[SamplingParams], device="cpu") -> "SamplingState":
        def t(values, dtype):
            return torch.tensor(values, dtype=dtype, device=device)

        return SamplingState(
            temperature=t([p.temperature for p in params_list], torch.float32),
            top_p=t([p.top_p for p in params_list], torch.float32),
            top_k=t([p.top_k for p in params_list], torch.int64),
            min_p=t([p.min_p for p in params_list], torch.float32),
            seeds=[p.seed if p.seed is not None else -1 for p in params_list],
            all_greedy=all(p.temperature <= 0.0 for p in params_list),
        )


def masked_logits(logits: torch.Tensor, state: SamplingState) -> torch.Tensor:
    """Temperature-scaled logits with top-k, then top-p, then min-p masked
    to -inf: the mask steps of the JAX sample_tokens, in its order."""
    V = logits.shape[-1]
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=logits.device)
    temp = torch.clamp(state.temperature, min=1e-6)[:, None]
    scaled = logits / temp

    # top-k: mask logits below the k-th largest (k == 0 disables)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth_idx = torch.clamp(torch.clamp(state.top_k, 0, V) - 1, 0, V - 1)
    kth_val = torch.gather(sorted_desc, 1, kth_idx[:, None])
    topk_mask = (state.top_k > 0)[:, None] & (scaled < kth_val)
    scaled = torch.where(topk_mask, neg_inf, scaled)

    # top-p (nucleus): keep the smallest sorted prefix with mass >= p
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    cutoff_count = (cumprobs - probs_sorted < state.top_p[:, None]).sum(dim=-1)
    cutoff_idx = torch.clamp(cutoff_count - 1, 0, V - 1)
    cutoff_val = torch.gather(sorted_desc, 1, cutoff_idx[:, None])
    topp_mask = (state.top_p < 1.0)[:, None] & (scaled < cutoff_val)
    scaled = torch.where(topp_mask, neg_inf, scaled)

    # min-p: drop tokens with prob < min_p * max_prob
    probs = torch.softmax(scaled, dim=-1)
    max_prob = probs.max(dim=-1, keepdim=True).values
    minp_mask = (state.min_p > 0.0)[:, None] & (probs < state.min_p[:, None] * max_prob)
    return torch.where(minp_mask, neg_inf, scaled)


def _row_generator(seed: int, counter: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(counter)) % (1 << 63))
    return gen


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    state: SamplingState,
    generator: Optional[torch.Generator] = None,
    counters: Optional[Sequence[int]] = None,  # host [B]: tokens generated so far
) -> torch.Tensor:
    """[B] int32 sampled token ids; temperature <= 0 rows are greedy.
    Sampling is Gumbel-max in its exponential form: argmax(p / E) with
    E ~ Exp(1) per token."""
    greedy = torch.argmax(logits, dim=-1)
    if state.all_greedy:
        return greedy.to(torch.int32)
    probs = torch.softmax(masked_logits(logits, state), dim=-1)
    noise = torch.empty_like(probs).exponential_(generator=generator)
    for i, seed in enumerate(state.seeds):
        if seed >= 0:
            counter = 0 if counters is None else counters[i]
            noise[i].exponential_(
                generator=_row_generator(seed, counter, logits.device))
    sampled = torch.argmax(probs / noise, dim=-1)
    return torch.where(state.temperature <= 0.0, greedy, sampled).to(torch.int32)
