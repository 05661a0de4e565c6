"""The engine's device program: the unified ragged `mixed` step.

Port of kserve_tpu/engine/compiled.py:_make_mixed (:465-529).  Where the
JAX package jits one program and runs its decode loop as a `lax.scan`,
this is a plain function whose loop is a Python loop: PyTorch runs
eagerly, and every per-step control value (positions, which lanes are
live, the sampling counters) follows from the host-side plan alone, so
they are all computed and uploaded before the first launch and the loop
enqueues device work without waiting on the device.  KV pages are updated
in place.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models import llama
from .sampling import SamplingState, sample_tokens


def make_mixed(model_config: llama.LlamaConfig, engine_config):
    """The `mixed` step for this model and engine configuration.

    Step 0 runs llama.forward_ragged over the packed buffer (prompt chunks
    and decode lanes in one causal-masked attention) and samples one token
    per lane.  The remaining steps_per_sync-1 steps decode every lane the
    plan marked `joins`, while it has page capacity; lanes mid-chunk sit
    out.  A resumed lane's first decode token comes from `scan_tok0` (>= 0)
    instead of the step-0 sample.  Returns [steps, B] int32 tokens (on the
    pages' device) and the pages."""
    steps = engine_config.steps_per_sync
    page_size = engine_config.page_size

    def mixed(params, q_tokens, token_seq, token_pos, q_start, q_len,
              kv_start, last_idx, kv_pages: List[torch.Tensor], page_table,
              joins, scan_tok0, scan_pos0, step0_emits, capacity, counters,
              state: SamplingState, rng: torch.Generator):
        device = kv_pages[0].device

        def dev(x, dtype=torch.int32):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        # host bookkeeping of the decode loop: positions advance and
        # counters count only on live steps, independent of the tokens
        joins_h = np.asarray(joins, bool)
        capacity_h = np.asarray(capacity, np.int64)
        pos_h = np.asarray(scan_pos0, np.int64).copy()
        counters_h = np.asarray(counters, np.int64).copy()
        step_counters = [counters_h.copy()]
        counters_h += np.asarray(step0_emits, np.int64)
        step_pos, step_live = [], []
        for _ in range(steps - 1):
            live = joins_h & (pos_h < capacity_h)
            step_pos.append(pos_h.copy())
            step_live.append(live)
            step_counters.append(counters_h.copy())
            pos_h += live
            counters_h += live
        table = dev(page_table)
        if steps > 1:
            pos_dev = dev(np.stack(step_pos))
            live_dev = dev(np.stack(step_live), torch.bool)

        logits, kv_pages = llama.forward_ragged(
            params, model_config, dev(q_tokens), dev(token_seq),
            dev(token_pos), dev(q_start), dev(q_len), dev(kv_start),
            kv_pages, table, page_size, dev(last_idx))
        sampled0 = sample_tokens(logits, state, rng, step_counters[0])
        tok0 = dev(scan_tok0)
        tokens = torch.where(tok0 >= 0, tok0, sampled0)
        out = [sampled0]
        for s in range(steps - 1):
            live = live_dev[s]
            logits, kv_pages = llama.decode_step(
                params, model_config, tokens, pos_dev[s], kv_pages, table,
                live, page_size)
            nxt = sample_tokens(logits, state, rng, step_counters[s + 1])
            tokens = torch.where(live, nxt, tokens)
            out.append(tokens)
        return torch.stack(out), kv_pages

    return mixed
