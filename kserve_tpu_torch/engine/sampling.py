"""Batched token sampling on the device.

Port of kserve_tpu/engine/sampling.py: per-lane parameters travel as a
struct of tensors (`SamplingState`), so one call serves any mix of greedy,
temperature, top-k, top-p and min-p lanes.  The mask steps are the JAX
package's, factored into `masked_logits` so they can be compared exactly.
`apply_penalties` and `compute_logprobs` are the legacy decode programs'
sampling penalties and OpenAI logprobs (engine/compiled.py).

Random draws are Gumbel-max, argmax(scaled + g) as in
`jax.random.categorical`.  An unseeded lane takes its noise from the
caller's batch `torch.Generator`.  A seeded lane takes it from JAX's own
stream: `fold_in(PRNGKey(seed), counter)` with `counter` the tokens the
lane has generated so far, then threefry2x32 bits (the partitionable
layout, `jax_threefry_partitionable=True`) into `_uniform(minval=tiny)`
and `-log(-log(u))`, bit for bit as JAX 0.9 computes them
(jax/_src/prng.py, jax/_src/random.py).  So a seeded stream is the JAX
package's, in any batch position.  Seeds and counters are device tensors:
no host value of a counter is needed, which lets speculative decoding
advance them on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..device import resolve_device, upload


@dataclass
class SamplingParams:
    """Host-side per-request sampling config."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    max_tokens: int = 16
    min_tokens: int = 0
    ignore_eos: bool = False
    stop: Optional[List[str]] = None
    seed: Optional[int] = None
    logprobs: Optional[int] = None  # top alternatives per token (0 = none)

    @property
    def has_penalties(self) -> bool:
        """Whether this request needs the penalized decode programs (which
        carry a [B, V] count array; the others skip it)."""
        return (self.repetition_penalty != 1.0
                or self.frequency_penalty != 0.0
                or self.presence_penalty != 0.0)


@dataclass
class SamplingState:
    """Struct of [B] tensors on the device, plus the host facts the
    sampler needs without a device sync: which rows are seeded (their
    indices are uploaded once, with the state) and whether any row draws."""

    temperature: torch.Tensor  # [B] f32 (0 => greedy)
    top_p: torch.Tensor  # [B] f32
    top_k: torch.Tensor  # [B] int64 (0 => off)
    min_p: torch.Tensor  # [B] f32
    seed: torch.Tensor  # [B] int64 (-1 => draw from the batch generator)
    repetition_penalty: torch.Tensor  # [B] f32 (1.0 => off)
    frequency_penalty: torch.Tensor  # [B] f32 (0.0 => off)
    presence_penalty: torch.Tensor  # [B] f32 (0.0 => off)
    seeded_rows: Optional[torch.Tensor]  # [n] int64 rows with seed >= 0, or None
    all_greedy: bool  # host: no lane draws at all

    @staticmethod
    def from_params(params_list: Sequence[SamplingParams],
                    device=None) -> "SamplingState":
        """The batch's sampling state on `device` (default CUDA; raises
        without a card)."""
        device = resolve_device(device)
        seeds = [p.seed if p.seed is not None else -1 for p in params_list]
        rows = [i for i, s in enumerate(seeds) if s >= 0]

        def t(values, dtype):
            return upload(values, device, dtype)

        return SamplingState(
            temperature=t([p.temperature for p in params_list], torch.float32),
            top_p=t([p.top_p for p in params_list], torch.float32),
            top_k=t([p.top_k for p in params_list], torch.int64),
            min_p=t([p.min_p for p in params_list], torch.float32),
            seed=t(seeds, torch.int64),
            repetition_penalty=t([p.repetition_penalty for p in params_list],
                                 torch.float32),
            frequency_penalty=t([p.frequency_penalty for p in params_list],
                                torch.float32),
            presence_penalty=t([p.presence_penalty for p in params_list],
                               torch.float32),
            seeded_rows=t(rows, torch.int64) if rows else None,
            all_greedy=all(p.temperature <= 0.0 for p in params_list),
        )

    def repeat_rows(self, n: int) -> "SamplingState":
        """Each row repeated n times in place (row i -> rows i*n .. i*n+n-1):
        the per-position state of speculative verify slices."""

        def rep(x: torch.Tensor) -> torch.Tensor:
            return x[:, None].expand(-1, n).reshape(-1)

        rows = self.seeded_rows
        if rows is not None:
            rows = (rows[:, None] * n + torch.arange(n, device=rows.device)).reshape(-1)
        return SamplingState(
            temperature=rep(self.temperature), top_p=rep(self.top_p),
            top_k=rep(self.top_k), min_p=rep(self.min_p), seed=rep(self.seed),
            repetition_penalty=rep(self.repetition_penalty),
            frequency_penalty=rep(self.frequency_penalty),
            presence_penalty=rep(self.presence_penalty),
            seeded_rows=rows, all_greedy=self.all_greedy)


def masked_logits(logits: torch.Tensor, state: SamplingState) -> torch.Tensor:
    """Temperature-scaled logits with top-k, then top-p, then min-p masked
    to -inf: the mask steps of the JAX sample_tokens, in its order."""
    V = logits.shape[-1]
    neg_inf = float("-inf")  # a Python scalar: no host-to-device copy
    temp = torch.clamp(state.temperature, min=1e-6)[:, None]
    scaled = logits / temp

    # top-k: mask logits below the k-th largest (k == 0 disables)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth_idx = torch.clamp(torch.clamp(state.top_k, 0, V) - 1, 0, V - 1)
    kth_val = torch.gather(sorted_desc, 1, kth_idx[:, None])
    topk_mask = (state.top_k > 0)[:, None] & (scaled < kth_val)
    scaled = scaled.masked_fill(topk_mask, neg_inf)

    # top-p (nucleus): keep the smallest sorted prefix with mass >= p
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cumprobs = torch.cumsum(probs_sorted, dim=-1)
    cutoff_count = (cumprobs - probs_sorted < state.top_p[:, None]).sum(dim=-1)
    cutoff_idx = torch.clamp(cutoff_count - 1, 0, V - 1)
    cutoff_val = torch.gather(sorted_desc, 1, cutoff_idx[:, None])
    topp_mask = (state.top_p < 1.0)[:, None] & (scaled < cutoff_val)
    scaled = scaled.masked_fill(topp_mask, neg_inf)

    # min-p: drop tokens with prob < min_p * max_prob
    probs = torch.softmax(scaled, dim=-1)
    max_prob = probs.max(dim=-1, keepdim=True).values
    minp_mask = (state.min_p > 0.0)[:, None] & (probs < state.min_p[:, None] * max_prob)
    return scaled.masked_fill(minp_mask, neg_inf)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of jax/_src/prng.py on int64
    tensors holding uint32 values; broadcasts.  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def seeded_keys(seed: torch.Tensor, counter: torch.Tensor):
    """[n] keys `fold_in(PRNGKey(seed), counter)` as two int64 word tensors."""
    seed = seed.to(torch.int64)
    zero = torch.zeros_like(seed)
    return threefry2x32((seed >> 32) & _M32, seed & _M32, zero,
                        counter.to(torch.int64) & _M32)


def uniform_bits(k1: torch.Tensor, k2: torch.Tensor, V: int) -> torch.Tensor:
    """[n, V] 32-bit random words of keys (k1, k2) [n]: JAX's partitionable
    `random_bits(key, 32, (V,))`, threefry of the (0, i) counters, xor'ed."""
    idx = torch.arange(V, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(idx), idx)
    return b1 ^ b2


def seeded_uniform(seed: torch.Tensor, counter: torch.Tensor, V: int) -> torch.Tensor:
    """[n, V] f32 uniforms in [tiny, 1) of `jax.random.uniform(fold_in(
    PRNGKey(seed), counter), (V,), minval=tiny)`: the top 23 bits of each
    word as the mantissa of a float in [1, 2), minus 1."""
    bits = uniform_bits(*seeded_keys(seed, counter), V)
    one_bits = (bits >> 9) | 0x3F800000
    u = one_bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp(u * (1.0 - tiny) + tiny, min=tiny)


def seeded_gumbel(seed: torch.Tensor, counter: torch.Tensor, V: int) -> torch.Tensor:
    """[n, V] f32 noise of `jax.random.gumbel(fold_in(PRNGKey(seed),
    counter), (V,))` in its default mode "low"."""
    return -torch.log(-torch.log(seeded_uniform(seed, counter, V)))


def sample_tokens(
    logits: torch.Tensor,  # [B, V] f32
    state: SamplingState,
    generator: Optional[torch.Generator] = None,
    counters: Optional[torch.Tensor] = None,  # [B] tokens generated so far
) -> torch.Tensor:
    """[B] int32 sampled token ids; temperature <= 0 rows are greedy.
    Sampling is Gumbel-max: argmax(masked scaled logits + Gumbel noise)."""
    greedy = torch.argmax(logits, dim=-1)
    if state.all_greedy:
        return greedy.to(torch.int32)
    scaled = masked_logits(logits, state)
    noise = -torch.log(torch.empty_like(scaled).exponential_(generator=generator))
    rows = state.seeded_rows
    if rows is not None:
        counter = (torch.zeros_like(rows) if counters is None
                   else counters.to(rows.device)[rows])
        noise[rows] = seeded_gumbel(state.seed[rows], counter, scaled.shape[-1])
    sampled = torch.argmax(scaled + noise, dim=-1)
    return torch.where(state.temperature <= 0.0, greedy, sampled).to(torch.int32)


def compute_logprobs(
    logits: torch.Tensor,  # [B, V] f32, post-penalty, pre-temperature
    sampled: torch.Tensor,  # [B] sampled token ids
    k: int,  # top alternatives per row (EngineConfig.max_logprobs)
):
    """(lp [B], top_vals [B, k], top_ids [B, k] int32) for the OpenAI
    logprobs surfaces: the log-softmax of the post-penalty logits before
    temperature and the sampling filters, the sampled token's value and
    the k largest (kserve_tpu/engine/sampling.py:162-178).  Ties in the
    top k may be ordered otherwise than lax.top_k orders them."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.gather(logp, 1, sampled.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(logp, k, dim=-1)
    return lp, top_vals, top_ids.to(torch.int32)


def apply_penalties(
    logits: torch.Tensor,  # [B, V]
    output_counts: torch.Tensor,  # [B, V] int32 counts of generated tokens
    repetition_penalty: torch.Tensor,  # [B]
    frequency_penalty: torch.Tensor,  # [B]
    presence_penalty: torch.Tensor,  # [B]
    prompt_mask: Optional[torch.Tensor] = None,  # [B, V] bool in-prompt tokens
) -> torch.Tensor:
    """vLLM's penalty semantics (kserve_tpu/engine/sampling.py:181-199):
    the repetition penalty applies to tokens seen in the prompt or the
    output, dividing a positive logit and multiplying a negative one;
    frequency and presence penalties apply to generated tokens only.  A
    row with the default penalties comes back bit for bit."""
    seen_out = output_counts > 0
    seen_rep = seen_out if prompt_mask is None else (seen_out | prompt_mask)
    rp = repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen_rep, penalized, logits)
    logits = logits - frequency_penalty[:, None] * output_counts
    return logits - presence_penalty[:, None] * seen_out.to(logits.dtype)
