"""The engine's device programs: the unified ragged `mixed` step, the
speculative `mixed_decode` step, the legacy program set, and the page
gather and injects (`gather_pages`, `inject`, `inject_q`) of the KV tiers.

Ports of kserve_tpu/engine/compiled.py:_make_mixed (:465-529),
:_make_mixed_decode (:531-697) and the legacy programs (`LegacyPrograms`:
:_make_prefill, :_make_decode and its logprob and penalized forms,
:_prefill_chunk and :_make_sample_first, :294-447 and :699) and
:_inject/:_inject_q (:420-446).  Where the JAX package jits a program and
runs its loop as a `lax.scan`, these are plain functions whose loop is a
Python loop: PyTorch runs eagerly.  Neither loop waits on the device: in
`mixed` every per-step control value (positions, which lanes are live,
the sampling counters) follows from the host-side plan alone and is
uploaded before the first launch; in `mixed_decode` they depend on how
many drafts the device accepted, so they stay device tensors from round
to round.  Host data goes up through pinned memory without a stream
sync (device.upload).  KV pages and the draft table are updated in place.
A layer's cache is its pages or, with int8 KV, (int8 pages, scales): the
programs only hand it on (the counterpart of the JAX package's `_kv_pin`
tuple branch, compiled.py:189-215).  Every program that runs the model
takes `adapter_ids`, one LoRA adapter id per lane or prompt row (-1 = the
base model; None = every lane on the base model), and hands it to the
model (kserve_tpu/engine/compiled.py:296, :358, :448, :487, :585).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import upload
from ..models import llama
from ..ops.attention import dense_stride_for
from ..ops.paged_attention_cuda import RAGGED_BQ
from .kvcache import KVLayer, layer_pages
from .sampling import (
    SamplingState,
    apply_penalties,
    compute_logprobs,
    sample_tokens,
)


def gather_pages(kv_pages: List[KVLayer], ids) -> dict:
    """Enqueue a gather of whole pages into new tensors on the cache's
    device, in the tier payload layout: {"kv": [L, P, 2, n_kv, ps, d]} of
    a plain cache, {"kv_q", "kv_s"} (int8 pages, f32 scales) of an int8
    one.  Nothing waits on the device (kserve_tpu/engine/engine.py:923,
    `_gather_pages_device`)."""
    idx = upload(ids, layer_pages(kv_pages[0]).device, torch.int64)
    if isinstance(kv_pages[0], tuple):
        return {
            "kv_q": torch.stack([p.index_select(0, idx) for p, _ in kv_pages]),
            "kv_s": torch.stack([s.index_select(0, idx) for _, s in kv_pages]),
        }
    return {"kv": torch.stack([layer.index_select(0, idx) for layer in kv_pages])}


def inject(kv_pages: List[KVLayer], kv_data, ids) -> List[KVLayer]:
    """Write whole pages into a plain cache in place: kv_data [L, P, 2,
    n_kv, ps, d] (host or device) lands at page ids [P] of every layer.
    Padded ids point at the null page 0 with zero data, whose contents are
    never read unmasked.  A host payload goes up through pinned memory
    without a stream sync, so the writes are only enqueued (port of
    kserve_tpu/engine/compiled.py:420, an XLA scatter there)."""
    device = layer_pages(kv_pages[0]).device
    idx = upload(ids, device, torch.int64)
    data = upload(kv_data, device, kv_pages[0].dtype)
    for i, layer in enumerate(kv_pages):
        layer.index_copy_(0, idx, data[i])
    return kv_pages


def inject_q(kv_pages: List[KVLayer], q, s, ids) -> List[KVLayer]:
    """The int8 cache's inject: int8 pages q [L, P, 2, n_kv, ps, d] and
    their f32 row scales s [L, P, 2, n_kv, ps] land together at page ids
    [P] of every layer, in place (kserve_tpu/engine/compiled.py:435)."""
    device = layer_pages(kv_pages[0]).device
    idx = upload(ids, device, torch.int64)
    q_dev = upload(q, device, torch.int8)
    s_dev = upload(s, device, torch.float32)
    for i, (pages, scales) in enumerate(kv_pages):
        pages.index_copy_(0, idx, q_dev[i])
        scales.index_copy_(0, idx, s_dev[i])
    return kv_pages


def _on(adapter_ids, device: torch.device) -> Optional[torch.Tensor]:
    """Host adapter ids as an int32 tensor on `device` (None stays None)."""
    return None if adapter_ids is None else upload(adapter_ids, device)


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
              kv_start, last_idx, kv_pages: List[KVLayer], page_table,
              joins, scan_tok0, scan_pos0, step0_emits, capacity, counters,
              state: SamplingState, rng: torch.Generator, adapter_ids=None):
        device = layer_pages(kv_pages[0]).device

        def dev(x, dtype=torch.int32):
            return upload(x, device, dtype)

        adapters = _on(adapter_ids, device)

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
        counters_dev = dev(np.stack(step_counters))
        if steps > 1:
            pos_dev = dev(np.stack(step_pos))
            live_dev = dev(np.stack(step_live), torch.bool)

        logits, kv_pages = llama.forward_ragged(
            params, model_config, dev(q_tokens), dev(token_seq),
            dev(token_pos), dev(q_start), dev(q_len), dev(kv_start),
            kv_pages, table, page_size, dev(last_idx), adapter_ids=adapters)
        sampled0 = sample_tokens(logits, state, rng, counters_dev[0])
        tok0 = dev(scan_tok0)
        tokens = torch.where(tok0 >= 0, tok0, sampled0)
        out = [sampled0]
        for s in range(steps - 1):
            live = live_dev[s]
            logits, kv_pages = llama.decode_step(
                params, model_config, tokens, pos_dev[s], kv_pages, table,
                live, page_size, adapter_ids=adapters)
            nxt = sample_tokens(logits, state, rng, counters_dev[s + 1])
            tokens = torch.where(live, nxt, tokens)
            out.append(tokens)
        return torch.stack(out), kv_pages

    return mixed


def make_mixed_decode(model_config: llama.LlamaConfig, engine_config,
                      k_drafts: int, align: int):
    """The `mixed_decode` step: dense decode packing plus self-drafting
    speculative verify, for K = k_drafts drafts per lane per round.

    Every round, each live lane packs a (K+1)-token slice (its last
    accepted token plus K drafts walked out of its row of the bigram
    `draft_table`; an unseen bigram drafts the token itself) at the static
    stride `sp = dense_stride_for(K+1, align)`, writes the slice's KV, runs
    forward_ragged once and samples a target token at every slice
    position, with the row counter `cnt + j` (so seeded rows draw what
    sequential decode draws).  The lane emits its longest accepted prefix
    plus the bonus token and advances position and counter by as many;
    rejected drafts' KV sits past the causal horizon and is overwritten by
    the next slice.  The accepted chain's bigrams are learned into the
    table.  A lane runs a round only when its pages cover the whole K+1
    write window.  K = 0 is dense-packed plain decode.

    `align` is the kernel block (RAGGED_BQ on the card, 1 for the plain
    CPU version): a stride below RAGGED_BQ routes attention to the
    dense-stride kernel.  The draft table is [B+1, V] int32 (-1 = unseen);
    row B is a dump row that masked-out bigram writes land in, so the
    learning scatter needs no data-dependent indexing (None when K = 0).

    Returns ([rounds, B, K+1] int32 target samples, [rounds, B] int32 emit
    counts, pages, the table, and the (token, pos, counter) device carry a
    chained dispatch starts from)."""
    Kp = k_drafts + 1
    rounds = engine_config.steps_per_sync
    page_size = engine_config.page_size
    sp = dense_stride_for(Kp, align)
    dense_stride = sp if (align > 1 and sp < RAGGED_BQ) else None

    def mixed_decode(params, tokens, pos, kv_pages: List[KVLayer],
                     page_table, live, capacity, counters,
                     draft_table: Optional[torch.Tensor],
                     state: SamplingState, rng: torch.Generator,
                     adapter_ids=None):
        device = layer_pages(kv_pages[0]).device

        def dev(x, dtype=torch.int32):
            return upload(x, device, dtype)

        adapters = _on(adapter_ids, device)

        tok, p, cnt = dev(tokens), dev(pos), dev(counters)
        table = dev(page_table)
        live_d, cap = dev(live, torch.bool), dev(capacity)
        B = tok.shape[0]
        T = B * sp
        lane_ix = torch.arange(B, device=device)
        rows = torch.arange(T, device=device)
        lane_of = rows // sp  # [T] lane of each packed row
        off = (rows % sp).to(torch.int32)  # offset within the lane's stride
        in_slice = off < Kp  # rows past K+1 are stride padding
        q_start = (lane_ix * sp).to(torch.int32)
        j = torch.arange(Kp, device=device)
        # packed indices of the real slice rows, (lane, offset) order
        logits_at = (lane_ix[:, None] * sp + j[None, :]).reshape(-1)
        row_state = state.repeat_rows(Kp)
        pad = torch.zeros((B, sp - Kp), dtype=torch.int32, device=device)
        minus1 = torch.full((T,), -1, dtype=torch.int32, device=device)
        pair_lane = lane_ix[:, None].expand(B, Kp)
        later = j[None, :] > j[:, None]  # [Kp, Kp]: j' after j
        toks_out, n_out = [], []
        for _ in range(rounds):
            ok = live_d & (p + Kp <= cap)
            drafts = []
            prev = tok
            for _ in range(k_drafts):
                nxt = draft_table[lane_ix, prev.long()]
                nxt = torch.where(nxt >= 0, nxt, prev)
                drafts.append(nxt)
                prev = nxt
            slice_toks = torch.stack([tok] + drafts, dim=1)  # [B, Kp]
            q_tokens = torch.cat([slice_toks, pad], dim=1).reshape(T)
            token_seq = torch.where(ok[lane_of] & in_slice,
                                    lane_of.to(torch.int32), minus1)
            token_pos = p[lane_of] + off
            q_len = torch.where(ok, Kp, 0).to(torch.int32)
            logits, kv_pages = llama.forward_ragged(
                params, model_config, q_tokens, token_seq, token_pos,
                q_start, q_len, p, kv_pages, table, page_size, q_start,
                logits_at=logits_at, dense_stride=dense_stride,
                adapter_ids=adapters)  # [B*Kp, V]
            row_counters = (cnt[:, None] + j[None, :]).reshape(-1)
            sampled = sample_tokens(logits, row_state, rng,
                                    row_counters).reshape(B, Kp)
            if k_drafts > 0:
                match = slice_toks[:, 1:] == sampled[:, :-1]
                acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            else:
                acc = torch.zeros_like(lane_ix)
            n_emit = torch.where(ok, acc + 1, 0).to(torch.int32)
            new_tok = torch.where(ok, sampled[lane_ix, acc], tok)
            if k_drafts > 0:
                # learn the accepted chain's bigrams chain[j] -> chain[j+1];
                # of two pairs with one source the later one wins (as the
                # JAX scatter's in-order updates), and every masked pair
                # goes to the dump row B
                chain = torch.cat([tok[:, None], sampled], dim=1)  # [B, Kp+1]
                srcs, dsts = chain[:, :-1], chain[:, 1:]
                pair_ok = ok[:, None] & (j[None, :] <= acc[:, None])
                overwritten = ((srcs[:, :, None] == srcs[:, None, :])
                               & pair_ok[:, None, :] & later[None]).any(dim=2)
                at = torch.where(pair_ok & ~overwritten, pair_lane, B)
                draft_table[at.reshape(-1), srcs.reshape(-1).long()] = (
                    dsts.reshape(-1))
            p = p + n_emit
            cnt = cnt + n_emit
            tok = new_tok
            toks_out.append(sampled)
            n_out.append(n_emit)
        return (torch.stack(toks_out), torch.stack(n_out), kv_pages,
                draft_table, (tok, p, cnt))

    return mixed_decode


class LegacyPrograms:
    """The legacy program set under the JAX package's names: the batched
    `prefill` (and `prefill_lp`), `prefill_chunk`, `sample_first` (and
    `sample_first_lp`), and `decode`, `decode_lp`, `decode_penalized`,
    `decode_penalized_lp`.  The engine runs them for the whole engine when
    its batch does not fit one ragged buffer, and for an iteration in
    which a lane asks for logprobs or sampling penalties, which `mixed`
    does not compute.  A program is built the first time `get` asks for
    it, so an engine that never serves such lanes never builds the top-k
    or the [B, V] count scatter (`built` lists what was).

    Attention: `prefill` and `prefill_chunk` run the plain PyTorch prefill
    attention (XLA code in the JAX package); `decode*` run
    llama.decode_step, so the decode kernel on the card.  Host inputs go
    up through pinned memory without a stream sync; the decode loop's
    positions, live lanes and counters follow from the host plan alone,
    as in `mixed`, so no program waits on the device."""

    NAMES = ("prefill", "prefill_lp", "prefill_chunk", "sample_first",
             "sample_first_lp", "decode", "decode_lp", "decode_penalized",
             "decode_penalized_lp")

    def __init__(self, model_config: llama.LlamaConfig, engine_config):
        self.model_config = model_config
        self.config = engine_config
        self._programs = {}

    @property
    def built(self) -> List[str]:
        return sorted(self._programs)

    def get(self, name: str):
        fn = self._programs.get(name)
        if fn is None:
            if name not in self.NAMES:
                raise KeyError(f"no legacy program {name!r}")
            lp = name.endswith("_lp")
            base = name[:-3] if lp else name
            if base == "prefill":
                fn = self._make_prefill(lp)
            elif base == "prefill_chunk":
                fn = self._make_prefill_chunk()
            elif base == "sample_first":
                fn = self._make_sample_first(lp)
            else:
                fn = self._make_decode(base == "decode_penalized", lp)
            self._programs[name] = fn
        return fn

    def _first_token(self, logits, state: SamplingState, rng, in_prompt,
                     with_logprobs: bool):
        """The first token of each row from its prompt's last logits: the
        repetition penalty counts the prompt's tokens as seen (frequency
        and presence have no output yet), then seeded rows draw with
        counter 0.  Rows with the default penalties are bit for bit the
        unpenalized math."""
        logits = apply_penalties(
            logits, torch.zeros(logits.shape, dtype=torch.int32,
                                device=logits.device),
            state.repetition_penalty, state.frequency_penalty,
            state.presence_penalty, in_prompt)
        first = sample_tokens(logits, state, rng)
        if with_logprobs:
            return first, compute_logprobs(logits, first,
                                           self.config.max_logprobs)
        return first

    def _make_prefill(self, with_logprobs: bool):
        """prefill(params, tokens [Bp, T], valid_len [Bp], pages, page_ids
        [Bp, W], state, rng[, adapter_ids [Bp]]) -> (first [Bp] int32[, (lp, top_vals,
        top_ids)], pages): whole prompts through llama.prefill, the
        in-prompt mask of the first token's repetition penalty made on the
        device (compiled.py:294-341)."""
        mc, ps = self.model_config, self.config.page_size

        def prefill(params, tokens, valid_len, kv_pages: List[KVLayer],
                    page_ids, state: SamplingState, rng: torch.Generator,
                    adapter_ids=None):
            device = layer_pages(kv_pages[0]).device
            tok, valid = upload(tokens, device), upload(valid_len, device)
            logits, kv_pages = llama.prefill(
                params, mc, tok, valid, kv_pages, upload(page_ids, device), ps,
                adapter_ids=_on(adapter_ids, device))
            Bp, T = tok.shape
            pos_valid = (torch.arange(T, dtype=torch.int32, device=device)[None, :]
                         < valid[:, None])
            in_prompt = torch.zeros(
                (Bp, logits.shape[-1]), dtype=torch.int32, device=device
            ).scatter_reduce_(1, tok.long(), pos_valid.to(torch.int32),
                              reduce="amax").bool()
            out = self._first_token(logits, state, rng, in_prompt,
                                    with_logprobs)
            if with_logprobs:
                return out[0], out[1], kv_pages
            return out, kv_pages

        return prefill

    def _make_prefill_chunk(self):
        """prefill_chunk(params, tokens [B, C], chunk_start [B], valid_len
        [B], pages, page_ids [B, W][, adapter_ids [B]]) -> ([B, V] f32
        logits at each chunk's last valid token, pages) (compiled.py:447)."""
        mc, ps = self.model_config, self.config.page_size

        def prefill_chunk(params, tokens, chunk_start, valid_len,
                          kv_pages: List[KVLayer], page_ids, adapter_ids=None):
            device = layer_pages(kv_pages[0]).device
            return llama.prefill_chunk(
                params, mc, upload(tokens, device), upload(chunk_start, device),
                upload(valid_len, device), kv_pages, upload(page_ids, device),
                ps, adapter_ids=_on(adapter_ids, device))

        return prefill_chunk

    def _make_sample_first(self, with_logprobs: bool):
        """sample_first(logits [B, V], state, rng, in_prompt [B, V] bool) ->
        first [B] int32 (or (first, (lp, top_vals, top_ids))): the first
        token after a chunked prefill, with the batched prefill's penalty
        semantics (compiled.py:699)."""

        def sample_first(logits, state: SamplingState, rng: torch.Generator,
                         in_prompt):
            return self._first_token(
                logits, state, rng, upload(in_prompt, logits.device, torch.bool),
                with_logprobs)

        return sample_first

    def _make_decode(self, with_penalties: bool, with_logprobs: bool):
        """decode(params, tokens [B], pos [B], pages, page_table [B, W],
        active [B], capacity [B], counters [B], state, rng[, prompt_mask
        [B, V] bool, counts [B, V] int32][, adapter_ids=[B]]) -> (out,
        pages[, counts]):
        steps_per_sync steps of llama.decode_step (compiled.py:343-418).

        A lane steps while active and below its page capacity; past it
        the lane holds its token and position and writes to the null page.
        Seeded lanes draw with counter `counters + live steps so far`.
        `out` is [steps, B] int32 tokens, or with logprobs (tokens, lp
        [steps, B], top_vals and top_ids [steps, B, max_logprobs]).  The
        penalized form penalizes each step's logits with the device counts
        and the prompt mask, and adds `live` at each sampled token to the
        counts, in place.  `tokens` may be the device tokens of a chained
        dispatch; every other input is host data."""
        mc, steps = self.model_config, self.config.steps_per_sync
        ps, k_lp = self.config.page_size, self.config.max_logprobs

        def decode(params, tokens, pos, kv_pages: List[KVLayer], page_table,
                   active, capacity, counters, state: SamplingState,
                   rng: torch.Generator, prompt_mask=None, counts=None,
                   adapter_ids=None):
            device = layer_pages(kv_pages[0]).device
            adapters = _on(adapter_ids, device)
            pos_h = np.asarray(pos, np.int64).copy()
            cnt_h = np.asarray(counters, np.int64).copy()
            active_h = np.asarray(active, bool)
            cap_h = np.asarray(capacity, np.int64)
            step_pos, step_live, step_cnt = [], [], []
            for _ in range(steps):
                live = active_h & (pos_h < cap_h)
                step_pos.append(pos_h.copy())
                step_live.append(live)
                step_cnt.append(cnt_h.copy())
                pos_h += live
                cnt_h += live
            pos_d = upload(np.stack(step_pos), device)
            live_d = upload(np.stack(step_live), device, torch.bool)
            cnt_d = upload(np.stack(step_cnt), device)
            table = upload(page_table, device)
            tok = tokens if torch.is_tensor(tokens) else upload(tokens, device)
            toks, lps, tvs, tis = [], [], [], []
            for s in range(steps):
                live = live_d[s]
                logits, kv_pages = llama.decode_step(
                    params, mc, tok, pos_d[s], kv_pages, table, live, ps,
                    adapter_ids=adapters)
                if with_penalties:
                    logits = apply_penalties(
                        logits, counts, state.repetition_penalty,
                        state.frequency_penalty, state.presence_penalty,
                        prompt_mask)
                nxt = sample_tokens(logits, state, rng, cnt_d[s])
                tok = torch.where(live, nxt, tok)
                if with_logprobs:
                    lp, tv, ti = compute_logprobs(logits, tok, k_lp)
                    lps.append(lp)
                    tvs.append(tv)
                    tis.append(ti)
                if with_penalties:
                    counts.scatter_add_(1, tok.long()[:, None],
                                        live.to(counts.dtype)[:, None])
                toks.append(tok)
            out = torch.stack(toks)
            if with_logprobs:
                out = (out, torch.stack(lps), torch.stack(tvs), torch.stack(tis))
            if with_penalties:
                return out, kv_pages, counts
            return out, kv_pages

        return decode
