"""Continuous-batching LLM engine on PyTorch.

Port of the unified-ragged serving path of kserve_tpu/engine/engine.py:

- fixed decode slots; every waiting request seats as a prefilling slot and
  its prompt chunks ride the next `mixed` steps (engine/compiled.py), in
  the same packed buffer as the decode lanes' next tokens
- paged KV on the device (engine/kvcache.py), pages grown as lanes advance
- sampling on the device (engine/sampling.py), per-lane params as tensors
- each request owns an asyncio queue fed by the run loop
- with `spec_decode_k` set, pure-decode steps run the dense speculative
  `mixed_decode` program instead, chained depth 2 (`_step_dense`)
- with `kv_quant="int8"` each layer's cache is (int8 pages, f32 row
  scales) and every attention over it runs the kernels' int8 instances;
  activations stay in the model dtype
- a cache too small for every lane preempts (`_grow_and_preempt`): a
  prefilling slot first, else the newest decoding lane but the oldest,
  which goes back to the front of the queue and, once re-admitted,
  re-prefills its prompt plus all but its last generated token through
  the ordinary ragged chunks and resumes decoding where it stopped; the
  client's stream only pauses
- the legacy programs (compiled.LegacyPrograms: batched `prefill`,
  `prefill_chunk`, `sample_first`, the `decode` family) serve two
  routes, as in the JAX engine: the whole engine when its batch does not
  fit one packed buffer (`resolve_use_mixed`: above 128 slots at the
  default buckets on the card) or `use_ragged=False`, admitting through
  `_admit_batch` and stepping through `_advance_prefills` and
  `_decode_once`; and one iteration of the mixed engine in which a
  seated lane asks for logprobs or sampling penalties
  (`_needs_legacy_step`), which `mixed` does not compute.  Legacy decode
  dispatches chain depth 2 on the device tokens of the one in flight.

The device calls and the fetches of their tokens run in worker threads
(`asyncio.to_thread`), so the event loop keeps answering health probes and
new requests while a step computes.  Every launch goes to one CUDA stream,
so a finished lane's pages are freed at once even while a chained
dispatch that still writes them is in flight (the JAX engine defers such
frees): a later owner's writes land after the stale ones, and it reads no
position it has not written.

Not ported yet: the prefix cache, KV tiers and persistence (so a
preempted lane always recomputes its KV: no spill to host memory and no
re-inject, for bf16 or int8 caches), injected KV (`inject`, `inject_q`),
the peer page fabric, data/tensor/pipeline/sequence parallelism, P/D
disaggregation, drain/checkpoint/resume, the watchdog, metrics and the
AOT cache.  Admission waits for free pages.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import AsyncIterator, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, upload
from ..models import llama
from ..ops.attention import dense_stride_for
from ..ops.paged_attention_cuda import RAGGED_BQ
from .compiled import LegacyPrograms, make_mixed, make_mixed_decode
from .kvcache import (
    KVCacheConfig,
    PageAllocator,
    init_kv_pages,
    init_kv_scales,
    pages_needed,
)
from .sampling import SamplingParams, SamplingState
from .tokenizer import BaseTokenizer, IncrementalDetokenizer
from .types import EngineConfig, GenerationOutput, _QueuedRequest, _Slot

logger = logging.getLogger(__name__)


def resolve_use_mixed(config: EngineConfig, align: int) -> bool:
    """Whether the engine runs the unified ragged `mixed` program
    (kserve_tpu/engine/engine.py:499-515).  A pure-decode step packs
    every lane in one buffer of slices aligned to `align` (the CUDA
    ragged kernel's block on the card, 1 for the plain version), so the
    largest prefill bucket must cover max_batch_size x align.  use_ragged
    None takes mixed where it fits and the legacy programs elsewhere;
    True where it does not fit raises; False is the legacy programs."""
    mixed_ok = config.max_batch_size * align <= config.prefill_buckets[-1]
    if config.use_ragged and not mixed_ok:
        raise NotImplementedError(
            "use_ragged=True requires max_batch_size (x the kernel's block "
            "alignment) <= the largest prefill bucket; set use_ragged="
            "None/False for this batch")
    return mixed_ok if config.use_ragged is None else bool(config.use_ragged)


class LLMEngine:
    """Drive with `await engine.start()`, submit with `generate()`."""

    def __init__(
        self,
        model_config: llama.LlamaConfig,
        engine_config: EngineConfig,
        tokenizer: BaseTokenizer,
        params: Optional[dict] = None,
        rng_seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        if engine_config.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"unknown kv_quant {engine_config.kv_quant!r}; supported: none, int8"
            )
        unsupported = {
            "weight_quant": engine_config.weight_quant != "none",
            "tp": engine_config.tp != 1,
            "dp": engine_config.dp != 1,
            "sp": engine_config.sp != 1,
            "pp": engine_config.pp != 1,
        }
        bad = sorted(k for k, v in unsupported.items() if v)
        if bad:
            raise NotImplementedError(
                f"the PyTorch engine does not support {bad} yet")
        if tokenizer is not None and tokenizer.vocab_size > model_config.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds model "
                f"vocab ({model_config.vocab_size})")
        if self.device.type == "cuda" and engine_config.dtype != model_config.dtype:
            # with kv_quant=int8 the pages are int8 and `dtype` names the
            # activations the kernels take alongside them
            raise ValueError(
                f"the CUDA kernels read KV pages in the activation dtype: "
                f"kv dtype {engine_config.dtype} != model dtype "
                f"{model_config.dtype}")
        self.model_config = model_config
        self.config = engine_config
        self.tokenizer = tokenizer
        t0 = time.perf_counter()
        if params is None:
            params = llama.init_params(model_config, seed=1, device=self.device)
        self.params = params
        self.cache_config = KVCacheConfig(
            n_layers=model_config.n_layers,
            n_kv_heads=model_config.n_kv_heads,
            head_dim=model_config.head_dim,
            page_size=engine_config.page_size,
            num_pages=engine_config.num_pages,
            max_pages_per_seq=engine_config.max_pages_per_seq,
            dtype=engine_config.dtype,
        )
        if engine_config.kv_quant == "int8":
            # (int8 pages, f32 row scales) per layer (kserve_tpu/engine/
            # engine.py:355-366): half the bytes of a bf16 cache
            pages = init_kv_pages(
                dataclasses.replace(self.cache_config, dtype="int8"), self.device)
            self.kv_pages = list(zip(
                pages, init_kv_scales(self.cache_config, self.device)))
        else:
            self.kv_pages = init_kv_pages(self.cache_config, self.device)
        self.allocator = PageAllocator(engine_config.num_pages)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.startup_seconds = time.perf_counter() - t0
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(rng_seed)
        # slices start at multiples of the CUDA ragged kernel's block (one
        # lane per block); the plain CPU version packs densely
        self._ragged_align = RAGGED_BQ if self.device.type == "cuda" else 1
        self._use_mixed = resolve_use_mixed(engine_config, self._ragged_align)
        self._mixed = make_mixed(model_config, engine_config)
        self._legacy = LegacyPrograms(model_config, engine_config)
        # speculative decoding (kserve_tpu/engine/engine.py:516-571)
        spec_k = engine_config.spec_decode_k
        if spec_k is not None:
            if spec_k < 0:
                raise ValueError(f"spec_decode_k must be >= 0, got {spec_k}")
            if not self._use_mixed:
                raise NotImplementedError(
                    "spec_decode_k requires the unified ragged (mixed) path; "
                    "it does not compose with use_ragged=False or a batch "
                    "above the largest prefill bucket")
            stride = dense_stride_for(spec_k + 1, self._ragged_align)
            if (self._ragged_align > 1
                    and (engine_config.max_batch_size * stride)
                    % self._ragged_align):
                raise ValueError(
                    "spec_decode_k on the kernel path needs max_batch_size * "
                    f"padded-slice stride ({engine_config.max_batch_size}*"
                    f"{stride}) to be a multiple of the "
                    f"{self._ragged_align}-token block")
        self._spec_k = spec_k
        self._mixed_decode = (
            None if spec_k is None else make_mixed_decode(
                model_config, engine_config, spec_k, self._ragged_align))
        # worst-case per-lane advance of one dispatch: every round accepts
        # all K drafts plus the bonus token
        self._max_step_advance = engine_config.steps_per_sync * ((spec_k or 0) + 1)
        # hard per-lane kv ceiling: a lane within K tokens of it can never
        # fit another (K+1)-token slice, so _step_mixed hands such batches
        # to the plain mixed path
        self._dense_lane_cap = engine_config.max_model_len
        # [B+1, V] bigram draft table on the device (-1 = unseen; row B is
        # the program's dump row) and the rows whose occupant changed since
        # it was last seeded (None = every row)
        self._draft_table: Optional[torch.Tensor] = None
        self._draft_dirty: Optional[set] = None
        # the penalized decode programs' device [B, V] output counts and
        # prompt masks, and the rows whose occupant changed since they
        # were last built (None = every row)
        self._penalty_counts: Optional[torch.Tensor] = None
        self._penalty_prompt: Optional[torch.Tensor] = None
        self._penalty_dirty_rows: Optional[set] = None
        # a batched prefill's (slot index, request, pages, seq) while it
        # runs: in no slot and out of the queue, so a crash or a cancel
        # must find them here
        self._admitting: List[tuple] = []
        self._cancelled_admissions: set = set()
        self.spec_stats = {"drafted": 0, "accepted": 0, "rejected": 0}
        self._slots: List[_Slot] = [
            _Slot() for _ in range(engine_config.max_batch_size)]
        self._waiting: List[_QueuedRequest] = []
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.steps = 0  # mixed dispatches so far
        self.dense_steps = 0  # mixed_decode dispatches so far
        self.chained_dispatches = 0  # of those, launched behind another
        self.preemption_count = 0  # slots sent back to the queue
        self._admission_seq = 0  # seating order of decoding lanes
        # legacy program -> dispatches so far
        self.legacy_dispatches = {name: 0 for name in LegacyPrograms.NAMES}

    # ---------------- public API ----------------

    async def start(self):
        if self._task is None:
            self._task = asyncio.create_task(self._run_loop())
            logger.info(
                "LLM engine started on %s: slots=%d pages=%d page_size=%d",
                self.device, self.config.max_batch_size,
                self.config.num_pages, self.config.page_size)

    async def stop(self):
        self._stopped = True
        self._wake.set()
        self._fail_waiting(RuntimeError("engine stopped"))
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=30)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._task.cancel()
            self._task = None
        self._fail_waiting(RuntimeError("engine stopped"))
        for slot in self._slots:
            if slot.request_id is not None:
                slot.queue.put_nowait(RuntimeError("engine stopped"))
                self.allocator.free(slot.pages)
                slot.reset()

    def generate(self, prompt_ids: List[int],
                 params: SamplingParams) -> AsyncIterator[GenerationOutput]:
        """Submit a request; yields one GenerationOutput per emitted token.
        Validation runs here, before the stream starts."""
        if not prompt_ids:
            raise ValueError("empty prompt")
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        if len(prompt_ids) + params.max_tokens > self.config.max_model_len:
            raise ValueError(
                f"prompt+max_tokens exceeds max_model_len {self.config.max_model_len}")
        if max(prompt_ids) >= self.model_config.vocab_size or min(prompt_ids) < 0:
            raise ValueError("prompt token id outside the model vocabulary")
        if self._stopped:
            raise RuntimeError("engine is stopped")
        req = _QueuedRequest(f"req-{time.monotonic_ns()}", list(prompt_ids),
                             params, asyncio.Queue())
        return self._submit_and_stream(req)

    async def _submit_and_stream(self, req: _QueuedRequest):
        self._waiting.append(req)
        self._wake.set()
        try:
            while True:
                out = await req.queue.get()
                if isinstance(out, Exception):
                    raise out
                yield out
                if out.finished:
                    return
        finally:
            # client went away: release the slot and pages
            self.cancel(req.request_id)

    def cancel(self, request_id: str) -> None:
        self._waiting = [r for r in self._waiting if r.request_id != request_id]
        if any(req.request_id == request_id for _, req, _, _ in self._admitting):
            self._cancelled_admissions.add(request_id)
        for slot in self._slots:
            if slot.request_id == request_id:
                self.allocator.free(slot.pages)
                slot.reset()
                self._wake.set()

    def _fail_waiting(self, exc: Exception) -> None:
        pending, self._waiting = self._waiting, []
        for req in pending:
            req.queue.put_nowait(exc)

    # ---------------- run loop ----------------

    async def _run_loop(self):
        try:
            while not self._stopped:
                did_work = False
                while self._waiting and self._free_slot_index() is not None:
                    if self._use_mixed:
                        admitted = self._admit_prefilling(self._waiting[0])
                    else:
                        admitted = await self._admit_batch()
                    if not admitted:
                        break
                    did_work = True
                step = self._step_mixed if self._use_mixed else self._step_legacy
                if await step():
                    did_work = True
                if not did_work:
                    self._wake.clear()
                    await self._wake.wait()
                else:
                    await asyncio.sleep(0)
        except Exception as e:  # noqa: BLE001 — engine death must reach every stream
            logger.exception("engine loop crashed")
            for slot in self._slots:
                if slot.request_id is not None:
                    slot.queue.put_nowait(e)
                    self.allocator.free(slot.pages)
                    slot.reset()
            self._fail_waiting(e)
            # requests a failed _admit_batch took from the queue but never
            # seated
            for _, req, pages, _ in self._admitting:
                self.allocator.free(pages)
                req.queue.put_nowait(e)
            self._admitting = []

    def _free_slot_index(self) -> Optional[int]:
        for i, slot in enumerate(self._slots):
            if slot.request_id is None:
                return i
        return None

    def _bucket_for(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if n <= b:
                return b
        return self.config.prefill_buckets[-1]

    def _admit_prefilling(self, req: _QueuedRequest) -> bool:
        """Seat the head of the queue as a prefilling slot once its pages
        (plus decode headroom for a long prompt or a resume) are free.  A
        preempted request re-prefills its prompt plus all but its last
        generated token (kserve_tpu/engine/engine.py:2272-2273)."""
        idx = self._free_slot_index()
        if idx is None:
            return False
        ps = self.config.page_size
        total = req.kv_len
        need = pages_needed(total + 1, ps)
        if need > self.config.max_pages_per_seq:
            self._waiting.remove(req)
            req.queue.put_nowait(ValueError(
                f"prompt needs {need} pages > max_pages_per_seq "
                f"{self.config.max_pages_per_seq}"))
            return True
        required = self._admission_pages(
            req, need, headroom=total > self.config.prefill_buckets[-1])
        if not self.allocator.can_allocate(required):
            return False
        pages = self.allocator.allocate(need)
        self._waiting.remove(req)
        slot = self._slots[idx]
        slot.request_id = req.request_id
        slot.pages = pages
        slot.queue = req.queue
        seq = req.prompt_ids
        if req.resume is not None:
            seq = req.prompt_ids + req.resume["generated"][:-1]
        slot.prefilling = {"req": req, "seq": seq, "done": 0, "logits": None}
        return True

    def _admission_pages(self, req: _QueuedRequest, need: int,
                         headroom: bool = False) -> int:
        """Pages that must be free to admit `req` into `need` pages: a
        resume, or a prompt of many chunks before its first token
        (`headroom`), also keeps a couple of dispatches of decode headroom,
        since a cache that starves at once would only bounce the work back
        out (kserve_tpu/engine/engine.py:2439)."""
        if req.resume is None and not headroom:
            return need
        extra = pages_needed(2 * self.config.steps_per_sync, self.config.page_size)
        return min(need + extra, self.config.num_pages - 1)

    def _ensure_pages_at(self, slot: _Slot, base: int, extra: int) -> None:
        needed = min(pages_needed(base + extra, self.config.page_size),
                     self.config.max_pages_per_seq)
        while len(slot.pages) < needed and self.allocator.can_allocate(1):
            slot.pages.extend(self.allocator.allocate(1))

    def _grow_and_preempt(self) -> None:
        """Before an unchained dispatch (nothing is in flight): grow every
        decoding lane's pages toward the dispatch's worst-case advance.
        While a lane is starved (no page for its next token), free pages:
        preempt a prefilling slot first (it has emitted nothing), else the
        newest decoding lane other than the oldest, which therefore always
        finishes.  Only the oldest lane left alone and starved, one that
        exceeds the whole cache by itself, is truncated ("length").  Port
        of kserve_tpu/engine/engine.py:2563-2641 without its prefix-cache
        eviction and host spill, which the port lacks; every lane can be
        preempted (its `_can_preempt` is always true), so the JAX branch
        where starved lanes pause for want of a victim cannot arise."""
        ps = self.config.page_size
        while True:
            active = [s for s in self._slots
                      if s.request_id is not None and s.prefilling is None]
            starved = []
            for slot in active:
                if slot.pos >= self.config.max_model_len:
                    continue  # finished as "length" in _prepare_chunk
                grow = min(self._max_step_advance,
                           self.config.max_model_len - slot.pos)
                self._ensure_pages_at(slot, slot.pos, grow)
                if len(slot.pages) * ps <= slot.pos:
                    starved.append(slot)
            if not starved:
                return
            prefilling = [s for s in self._slots
                          if s.request_id is not None and s.prefilling is not None]
            if prefilling:
                self._preempt_prefilling(prefilling[-1])
                continue
            oldest = min(active, key=lambda s: s.admitted_at)
            candidates = [s for s in active if s is not oldest]
            if candidates:
                self._preempt(max(candidates, key=lambda s: s.admitted_at))
                continue
            logger.warning("KV cache smaller than one sequence: truncating "
                           "%d lane(s)", len(starved))
            for slot in starved:
                self._finish(slot, "length")

    def _preempt_prefilling(self, slot: _Slot) -> None:
        """Requeue a prefilling slot's request at the front and free its
        pages: it has emitted nothing, so only its chunks are lost."""
        req = slot.prefilling["req"]
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
        self._waiting.insert(0, req)
        self.preemption_count += 1
        logger.info("preempted prefilling request %s", req.request_id)

    def _preempt(self, slot: _Slot) -> None:
        """Requeue a decoding slot at the front of the queue and free its
        pages; its resume state re-prefills prompt + generated[:-1] when it
        is admitted again.  Nothing is emitted: the client's stream only
        pauses (kserve_tpu/engine/engine.py:2665, its recompute branch)."""
        req = _QueuedRequest(slot.request_id, slot.prompt_ids, slot.params,
                             slot.queue)
        req.resume = {
            "generated": slot.generated,
            "detok": slot.detok,
            "stop_texts": slot.stop_texts,
            "pos": slot.pos,  # the device KV covers positions 0 .. pos-1
            "admitted_at": slot.admitted_at,
        }
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
        self._waiting.insert(0, req)
        self.preemption_count += 1
        logger.info("preempted request %s at position %d", req.request_id,
                    req.resume["pos"])

    def _prepare_chunk(self, prev: Optional[dict] = None) -> Optional[dict]:
        """Host-side state of a dispatch's decode lanes (port of
        kserve_tpu/engine/engine.py:2742-2826).  Unchained (`prev` None),
        pages grow first and may preempt.  Chained behind the in-flight
        legacy decode `prev`, a lane starts where prev leaves it, its
        position advanced by min(steps, prev's capacity) without reading
        prev's tokens, and pages grow best-effort with no preemption.  A
        seeded lane's counter is the tokens it has generated, pos -
        prompt_len + 1.  A penalized dispatch brings the device penalty
        state up to date first."""
        B = self.config.max_batch_size
        ps = self.config.page_size
        steps = self.config.steps_per_sync
        if prev is None:
            self._grow_and_preempt()
        tokens = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        capacity = np.zeros((B,), np.int32)
        counters = np.zeros((B,), np.int32)
        params_list = [SamplingParams()] * B
        for i, slot in enumerate(self._slots):
            if slot.request_id is None or slot.prefilling is not None:
                continue
            if prev is not None:
                if not prev["active"][i]:
                    continue
                base = min(int(prev["pos"][i]) + steps, int(prev["capacity"][i]))
            else:
                base = slot.pos
                tokens[i] = slot.generated[-1]
            grow = min(self._max_step_advance, self.config.max_model_len - base)
            if grow <= 0:
                if prev is None:
                    self._finish(slot, "length")  # at max_model_len
                continue
            if prev is not None:
                self._ensure_pages_at(slot, base, grow)
            if len(slot.pages) * ps <= base:
                continue  # no capacity this step
            pos[i] = base
            active[i] = True
            capacity[i] = len(slot.pages) * ps
            counters[i] = base - slot.prompt_len + 1
            params_list[i] = slot.params
        if not active.any():
            return None
        lanes = [p for i, p in enumerate(params_list) if active[i]]
        penalized = any(p.has_penalties for p in lanes)
        if penalized:
            self._refresh_penalty_state()
        return {"tokens": tokens, "pos": pos, "active": active,
                "capacity": capacity, "counters": counters,
                "page_table": self._page_table(active),
                "params": params_list, "penalized": penalized,
                "want_logprobs": any(p.logprobs is not None for p in lanes)}

    async def _step_mixed(self) -> bool:
        """One engine step: every prefilling slot contributes its next
        prompt chunk and every decode lane its next token, in one packed
        `mixed` dispatch; an iteration with a seated lane that asks for
        logprobs or penalties runs the legacy programs instead."""
        if self._needs_legacy_step():
            return await self._step_legacy()
        meta = self._prepare_chunk()
        prefilling = [(i, s) for i, s in enumerate(self._slots)
                      if s.request_id is not None and s.prefilling is not None]
        if meta is None and not prefilling:
            return False
        if self._mixed_decode is not None and not prefilling and self._dense_fits(meta):
            await self._step_dense(meta)
            return True
        plan = self._plan_ragged(meta, prefilling)
        chunk_np = await asyncio.to_thread(self._dispatch, plan)
        self.steps += 1
        self._route_mixed(plan, chunk_np)
        return True

    def _dispatch(self, plan: dict) -> np.ndarray:
        """Run one mixed step and fetch its tokens (worker thread)."""
        with torch.inference_mode():
            out, self.kv_pages = self._mixed(
                self.params, plan["q_tokens"], plan["token_seq"],
                plan["token_pos"], plan["q_start"], plan["q_len"],
                plan["kv_start"], plan["last_idx"], self.kv_pages,
                plan["page_table"], plan["joins"], plan["scan_tok0"],
                plan["scan_pos0"], plan["step0_emits"], plan["capacity"],
                plan["counters"], plan["state"], self._rng)
            return out.cpu().numpy()

    def _plan_ragged(self, meta: Optional[dict], prefilling) -> dict:
        """Pack this step's ragged buffer (host side): decode lanes first,
        one token each, then each prefilling slot's next chunk, within one
        largest-prefill-bucket token budget.  Slices start at multiples of
        the kernel block.  Returns the packed arrays plus per-lane routing
        windows."""
        B = self.config.max_batch_size
        ps = self.config.page_size
        steps = self.config.steps_per_sync
        align = self._ragged_align
        budget = self.config.prefill_buckets[-1]

        def aligned(n: int) -> int:
            return -(-n // align) * align

        q_start = np.zeros((B,), np.int32)
        q_len = np.zeros((B,), np.int32)
        kv_start = np.zeros((B,), np.int32)
        last_idx = np.zeros((B,), np.int32)
        joins = np.zeros((B,), bool)
        scan_tok0 = np.full((B,), -1, np.int32)
        scan_pos0 = np.zeros((B,), np.int32)
        step0_emits = np.zeros((B,), np.int32)
        capacity = np.zeros((B,), np.int32)
        counters = np.zeros((B,), np.int32)
        params_list = [SamplingParams() for _ in range(B)]
        tok_list: List[int] = []
        seq_list: List[int] = []
        pos_list: List[int] = []
        consume: Dict[int, tuple] = {}  # lane -> (first row, n rows)
        chunks: List[tuple] = []  # (lane, chunk len, final?)
        offset = 0
        n_decode = 0

        def place(lane: int, tokens: List[int], positions: List[int]):
            nonlocal offset, budget
            n = len(tokens)
            pad = aligned(n) - n
            tok_list.extend(tokens + [0] * pad)
            seq_list.extend([lane] * n + [-1] * pad)
            pos_list.extend(positions + [0] * pad)
            q_start[lane] = offset
            q_len[lane] = n
            last_idx[lane] = offset + n - 1
            offset += aligned(n)
            budget -= aligned(n)

        if meta is not None:
            for i, slot in enumerate(self._slots):
                if not meta["active"][i]:
                    continue
                pos = int(meta["pos"][i])
                cap = int(meta["capacity"][i])
                place(i, [int(meta["tokens"][i])], [pos])
                kv_start[i] = pos
                joins[i] = True
                scan_pos0[i] = pos + 1
                step0_emits[i] = 1
                capacity[i] = cap
                counters[i] = int(meta["counters"][i])
                params_list[i] = slot.params
                consume[i] = (0, min(steps, cap - pos))
                n_decode += 1

        n_prefill_tokens = 0
        for i, slot in prefilling:
            pf = slot.prefilling
            req = pf["req"]
            seq, done = pf["seq"], pf["done"]
            total = len(seq)
            n = min(total - done, budget)
            if n <= 0:
                continue  # out of token budget; this lane rides next step
            place(i, list(seq[done:done + n]), list(range(done, done + n)))
            kv_start[i] = done
            cap = len(slot.pages) * ps
            capacity[i] = cap
            params_list[i] = req.params
            final = done + n >= total
            if final and req.resume is not None:
                # a re-prefill's step-0 sample is dropped: the decode loop
                # goes on from the last generated token at its position,
                # with the sampling counter where the lane stopped
                gen = req.resume["generated"]
                joins[i] = True
                scan_tok0[i] = gen[-1]
                scan_pos0[i] = req.resume["pos"]
                counters[i] = len(gen)
                consume[i] = (1, max(0, min(steps - 1, cap - req.resume["pos"])))
            elif final:
                joins[i] = True
                scan_pos0[i] = total
                step0_emits[i] = 1
                # row 0 (the first token) is emitted at seating; the
                # consume window covers the decode loop only
                consume[i] = (1, max(0, min(steps - 1, cap - total)))
            else:
                consume[i] = (0, 0)
            chunks.append((i, n, final))
            n_prefill_tokens += n

        T = aligned(self._bucket_for(max(offset, 1)))
        pad = T - offset
        tok_list.extend([0] * pad)
        seq_list.extend([-1] * pad)
        pos_list.extend([0] * pad)
        page_table = self._page_table(
            [s.request_id is not None for s in self._slots])
        return {
            "q_tokens": np.asarray(tok_list, np.int32),
            "token_seq": np.asarray(seq_list, np.int32),
            "token_pos": np.asarray(pos_list, np.int32),
            "q_start": q_start,
            "q_len": q_len,
            "kv_start": kv_start,
            "last_idx": last_idx,
            "page_table": page_table,
            "joins": joins,
            "scan_tok0": scan_tok0,
            "scan_pos0": scan_pos0,
            "step0_emits": step0_emits,
            "capacity": capacity,
            "counters": counters,
            "state": SamplingState.from_params(params_list, self.device),
            "consume": consume,
            "chunks": chunks,
            "prefill_tokens": n_prefill_tokens,
            "decode_tokens": n_decode,
        }

    def _route_mixed(self, plan: dict, chunk_np: np.ndarray) -> None:
        """Consume one dispatch's [steps, B] tokens: advance chunk cursors,
        seat lanes whose prompt completed (a fresh one emits its first
        token, a resumed one its stream state and nothing), then stream
        each lane's decode window.  Lanes cancelled while the step ran are
        seen as empty and their tokens dropped."""
        for i, n, final in plan["chunks"]:
            slot = self._slots[i]
            if slot.request_id is None or slot.prefilling is None:
                continue
            pf = slot.prefilling
            pf["done"] += n
            if final:
                self._complete_prefilling(slot, pf["req"], int(chunk_np[0, i]))
        for i in sorted(plan["consume"]):
            first_row, n_rows = plan["consume"][i]
            slot = self._slots[i]
            for s in range(first_row, first_row + n_rows):
                if slot.request_id is None:
                    break  # finished or cancelled: drop the tail
                token = int(chunk_np[s, i])
                slot.pos += 1
                slot.generated.append(token)
                self._emit(slot, token)

    # ---------------- legacy programs ----------------
    # Port of kserve_tpu/engine/engine.py:1990-2437 (admission and chunked
    # prefill) and :2742-3100 (decode), without the prefix cache, tiers,
    # injected KV and sp.

    def _needs_legacy_step(self) -> bool:
        """Whether a seated lane (prefilling or decoding) asks for logprobs
        or sampling penalties, which `mixed` does not compute: the
        iteration then runs the legacy programs (kserve_tpu/engine/
        engine.py:3087-3100)."""
        for s in self._slots:
            if s.request_id is None:
                continue
            p = s.prefilling["req"].params if s.prefilling is not None else s.params
            if p.has_penalties or p.logprobs is not None:
                return True
        return False

    async def _step_legacy(self) -> bool:
        """One legacy iteration: a chunk of every prefilling slot, then a
        decode dispatch (and its chain) of every seated lane."""
        did = await self._advance_prefills()
        if any(s.request_id is not None and s.prefilling is None
               for s in self._slots):
            await self._decode_once()
            did = True
        return did

    async def _admit_batch(self) -> bool:
        """Prefill up to `prefill_batch` waiting requests in one `prefill`
        call, the batch padded to a power of two and the prompts to the
        bucket of the longest; False when none can be admitted (no slot or
        no pages).  A prompt longer than the largest bucket is admitted
        alone as a prefilling slot (`_admit_chunked`).  A resumed request
        re-prefills prompt + generated[:-1] and its sample is discarded."""
        ps = self.config.page_size
        admitted: List[tuple] = []  # (slot index, request, pages, seq)
        self._admitting = admitted
        free = [i for i, s in enumerate(self._slots) if s.request_id is None]
        while (self._waiting and free
               and len(admitted) < self.config.prefill_batch):
            req = self._waiting[0]
            if req.kv_len > self.config.prefill_buckets[-1]:
                if admitted:
                    break  # run the batch first
                self._admitting = []
                return self._admit_chunked(req)
            need = pages_needed(req.kv_len + 1, ps)
            if not self.allocator.can_allocate(self._admission_pages(req, need)):
                break
            pages = self.allocator.allocate(need)
            self._waiting.pop(0)
            seq = req.prompt_ids
            if req.resume is not None:
                seq = req.prompt_ids + req.resume["generated"][:-1]
            admitted.append((free.pop(0), req, pages, seq))
        if not admitted:
            return False
        bucket = self._bucket_for(max(len(seq) for *_, seq in admitted))
        Bp = 1
        while Bp < len(admitted):
            Bp *= 2
        tokens = np.zeros((Bp, bucket), np.int32)
        valid = np.zeros((Bp,), np.int32)
        page_ids = np.zeros((Bp, self.config.max_pages_per_seq), np.int32)
        params_list = [SamplingParams()] * Bp
        for j, (_, req, pages, seq) in enumerate(admitted):
            tokens[j, :len(seq)] = seq
            valid[j] = len(seq)
            page_ids[j, :len(pages)] = pages
            params_list[j] = req.params
        # the logprob variant only when a fresh row asked for logprobs
        name = "prefill_lp" if any(
            req.resume is None and req.params.logprobs is not None
            for _, req, _, _ in admitted) else "prefill"
        first, lp = await asyncio.to_thread(
            self._run_prefill, name, tokens, valid, page_ids, params_list)
        self.legacy_dispatches[name] += 1
        for j, (idx, req, pages, _) in enumerate(admitted):
            if req.request_id in self._cancelled_admissions:
                self.allocator.free(pages)  # its client went away meanwhile
                continue
            slot = self._slots[idx]
            slot.request_id, slot.pages, slot.queue = req.request_id, pages, req.queue
            self._complete_prefilling(slot, req, int(first[j]),
                                      self._lp_for(req.params, lp, j))
        self._admitting = []
        self._cancelled_admissions.clear()
        return True

    def _admit_chunked(self, req: _QueuedRequest) -> bool:
        """Admit one prompt longer than the largest bucket as a prefilling
        slot, whose chunks `_advance_prefills` runs through prefill_chunk
        (kserve_tpu/engine/engine.py:2241)."""
        return self._admit_prefilling(req)

    def _run_prefill(self, name: str, tokens, valid, page_ids, params_list):
        """One batched prefill call and the fetch of its first tokens and
        logprobs (worker thread)."""
        with torch.inference_mode():
            state = SamplingState.from_params(params_list, self.device)
            out = self._legacy.get(name)(self.params, tokens, valid,
                                         self.kv_pages, page_ids, state,
                                         self._rng)
            self.kv_pages = out[-1]
            lp = None
            if name == "prefill_lp":
                lp = tuple(t.cpu().numpy() for t in out[1])
            return out[0].cpu().numpy(), lp

    async def _advance_prefills(self) -> bool:
        """One chunk of every prefilling slot through prefill_chunk; a slot
        whose prompt is then in the cache is seated, sampling its first
        token (kserve_tpu/engine/engine.py:2330-2391)."""
        progressed = False
        ps = self.config.page_size
        for slot in list(self._slots):
            pf = slot.prefilling
            if slot.request_id is None or pf is None:
                continue
            seq, done = pf["seq"], pf["done"]
            if done < len(seq):
                n = min(self.config.prefill_buckets[-1], len(seq) - done)
                tokens = np.zeros((1, self._bucket_for(n)), np.int32)
                tokens[0, :n] = seq[done:done + n]
                # the table covers this chunk's writes; the history gather
                # reads it masked by the history length
                width = self.config.page_bucket(pages_needed(done + n, ps))
                page_ids = np.zeros((1, width), np.int32)
                owned = slot.pages[:width]
                page_ids[0, :len(owned)] = owned
                logits = await asyncio.to_thread(
                    self._run_prefill_chunk, tokens, done, n, page_ids)
                self.legacy_dispatches["prefill_chunk"] += 1
                progressed = True
                if slot.prefilling is not pf:
                    continue  # cancelled while the chunk ran
                pf["logits"], pf["done"] = logits, done + n
            if pf["done"] >= len(seq):
                await self._finish_prefilling(slot, pf)
                progressed = True
        return progressed

    def _run_prefill_chunk(self, tokens, done: int, n: int, page_ids):
        """One prefill_chunk call (worker thread): its last logits."""
        with torch.inference_mode():
            logits, self.kv_pages = self._legacy.get("prefill_chunk")(
                self.params, tokens, [done], [n], self.kv_pages, page_ids)
            return logits

    async def _finish_prefilling(self, slot: _Slot, pf: dict) -> None:
        """Seat a slot whose chunks are all in the cache: a fresh request
        samples its first token from the last chunk's logits through
        sample_first (the prompt counted as seen by the repetition
        penalty), a resumed one seats without one."""
        req = pf["req"]
        if req.resume is None:
            V = self.model_config.vocab_size
            in_prompt = np.zeros((1, V), bool)
            in_prompt[0, np.asarray(pf["seq"], np.int64)] = True
            name = ("sample_first" if req.params.logprobs is None
                    else "sample_first_lp")
            first, lp = await asyncio.to_thread(
                self._run_sample_first, name, pf["logits"], req.params, in_prompt)
            self.legacy_dispatches[name] += 1
            if slot.prefilling is not pf:
                return  # cancelled meanwhile
            self._complete_prefilling(slot, req, first,
                                      self._lp_for(req.params, lp, 0))
        else:
            self._complete_prefilling(slot, req, None)

    def _run_sample_first(self, name: str, logits, params: SamplingParams,
                          in_prompt):
        """One sample_first call and its fetch (worker thread)."""
        with torch.inference_mode():
            state = SamplingState.from_params([params], self.device)
            out = self._legacy.get(name)(logits, state, self._rng, in_prompt)
            if name == "sample_first":
                return int(out.cpu()[0]), None
            return int(out[0].cpu()[0]), tuple(t.cpu().numpy() for t in out[1])

    @staticmethod
    def _lp_for(params: SamplingParams, lp, j: int, s: Optional[int] = None):
        """(logprob, top logprobs) of row j (at step s) of a program's
        (lp, top_vals, top_ids) host arrays, cut to the request's k;
        (None, None) when it did not ask or the dispatch computed none
        (kserve_tpu/engine/engine.py:2176)."""
        if lp is None or params.logprobs is None:
            return None, None
        lps, tv, ti = lp
        if s is not None:
            lps, tv, ti = lps[s], tv[s], ti[s]
        k = min(int(params.logprobs), tv.shape[-1])
        return float(lps[j]), [(int(ti[j, i]), float(tv[j, i])) for i in range(k)]

    def _refresh_penalty_state(self) -> None:
        """Bring the device [B, V] output counts and prompt masks up to
        date: rows whose occupant changed are rebuilt from the host's
        prompt and generated tokens (every row after a full
        invalidation); a resident lane's row keeps what the penalized
        programs counted on the device, also while it was skipped for
        capacity (kserve_tpu/engine/engine.py:2828-2864)."""
        V = self.model_config.vocab_size
        B = self.config.max_batch_size

        def rows(idx):
            counts = np.zeros((len(idx), V), np.int32)
            prompt = np.zeros((len(idx), V), bool)
            for r, i in enumerate(idx):
                slot = self._slots[i]
                if slot.request_id is not None and slot.prefilling is None:
                    np.add.at(counts[r], slot.generated, 1)
                    prompt[r, slot.prompt_ids] = True
            return (upload(counts, self.device),
                    upload(prompt, self.device, torch.bool))

        if self._penalty_counts is None or self._penalty_dirty_rows is None:
            self._penalty_counts, self._penalty_prompt = rows(range(B))
        elif self._penalty_dirty_rows:
            idx = sorted(self._penalty_dirty_rows)
            at = upload(idx, self.device, torch.int64)
            self._penalty_counts[at], self._penalty_prompt[at] = rows(idx)
        self._penalty_dirty_rows = set()

    def _mark_penalty_dirty(self, slot_index: Optional[int]) -> None:
        """A row's occupant changed (None: every row is stale): its penalty
        state and its draft-table row are rebuilt before they are next
        used (kserve_tpu/engine/engine.py:2866-2879)."""
        if slot_index is None:
            self._penalty_dirty_rows = None
            self._draft_dirty = None
            return
        if self._penalty_dirty_rows is not None:
            self._penalty_dirty_rows.add(slot_index)
        if self._draft_dirty is not None:
            self._draft_dirty.add(slot_index)

    def _dispatch_chunk(self, meta: dict, tokens_dev=None) -> dict:
        """Enqueue one legacy decode dispatch (worker thread) and the host
        copies of its outputs: `decode`, with `_penalized` when a lane has
        penalties and `_lp` when one asked for logprobs.  `tokens_dev`
        chains it on the in-flight dispatch's device tokens."""
        name = ("decode_penalized" if meta["penalized"] else "decode") + (
            "_lp" if meta["want_logprobs"] else "")
        with torch.inference_mode():
            state = SamplingState.from_params(meta["params"], self.device)
            args = (self.params,
                    meta["tokens"] if tokens_dev is None else tokens_dev,
                    meta["pos"], self.kv_pages, meta["page_table"],
                    meta["active"], meta["capacity"], meta["counters"], state,
                    self._rng)
            fn = self._legacy.get(name)
            if meta["penalized"]:
                out, self.kv_pages, self._penalty_counts = fn(
                    *args, self._penalty_prompt, self._penalty_counts)
            else:
                out, self.kv_pages = fn(*args)
            outs = out if isinstance(out, tuple) else (out,)
            return {"name": name, "tokens": outs[0], **self._copy_to_host(outs)}

    async def _launch_chunk(self, meta: dict, prev: Optional[dict] = None) -> dict:
        """Dispatch a legacy decode (chained on `prev`'s device tokens) and
        record it."""
        tokens_dev = None if prev is None else prev["tokens"][-1]
        chunk = await asyncio.to_thread(self._dispatch_chunk, meta, tokens_dev)
        self.legacy_dispatches[chunk["name"]] += 1
        if not meta["penalized"] and self._penalty_counts is not None:
            # lanes advanced without the device counts: every row is stale
            self._mark_penalty_dirty(None)
        if self._spec_k:
            # nor did the draft table learn these tokens
            self._draft_dirty = None
        return chunk

    async def _route_chunk(self, meta: dict, chunk: dict) -> bool:
        """Stream a finished decode dispatch's tokens (and logprobs): each
        active lane emits min(steps, capacity - pos) tokens, dropping the
        tail after a finish.  True when a lane finished (a chained
        dispatch then has stale lanes)."""
        host = await asyncio.to_thread(self._wait_host, chunk)
        toks, lp = host[0], (host[1:] if len(host) > 1 else None)
        steps = self.config.steps_per_sync
        finished_any = False
        for i, slot in enumerate(self._slots):
            if slot.request_id is None or not meta["active"][i]:
                continue
            for s in range(min(steps, int(meta["capacity"][i]) - int(meta["pos"][i]))):
                if slot.request_id is None:
                    break  # finished mid-dispatch: drop the tail
                token = int(toks[s, i])
                slot.pos += 1
                slot.generated.append(token)
                self._emit(slot, token, *self._lp_for(slot.params, lp, i, s))
            if slot.request_id is None:
                finished_any = True
            elif slot.pos >= self.config.max_model_len:
                self._finish(slot, "length")
                finished_any = True
        return finished_any

    async def _decode_once(self) -> None:
        """Legacy decode with a depth-2 pipeline: dispatch N+1, chained on
        N's device tokens, is enqueued before N's tokens are routed, so the
        host's routing overlaps the device (kserve_tpu/engine/engine.py:
        3032-3085).  It chains only while admission cannot proceed, no
        prompt is prefilling, no lane surely finishes inside N, and N is
        not penalized (its counts must be exact at each dispatch)."""
        meta = self._prepare_chunk()
        if meta is None:
            return
        chunk = await self._launch_chunk(meta)
        steps = self.config.steps_per_sync
        while True:
            meta2 = chunk2 = None
            admission_blocked = (not self._waiting
                                 or self._free_slot_index() is None)
            prefill_pending = any(s.prefilling is not None for s in self._slots)
            predictable_finish = any(
                s.request_id is not None and meta["active"][i]
                and len(s.generated) + steps >= s.params.max_tokens
                for i, s in enumerate(self._slots))
            if (admission_blocked and not prefill_pending
                    and not predictable_finish and not meta["penalized"]
                    and not self._stopped):
                meta2 = self._prepare_chunk(prev=meta)
            if meta2 is not None:
                chunk2 = await self._launch_chunk(meta2, prev=chunk)
            finished_any = await self._route_chunk(meta, chunk)
            await asyncio.sleep(0)  # flush streams while N+1 runs
            if chunk2 is None:
                break
            meta, chunk = meta2, chunk2
            if (finished_any or self._stopped
                    or (self._waiting and self._free_slot_index() is not None)):
                # stale lanes, or admission can proceed: drain and re-plan
                await self._route_chunk(meta, chunk)
                break

    # ---------------- dense / speculative decode stepping ----------------
    # Port of kserve_tpu/engine/engine.py:3386-3623.  Unlike the JAX engine
    # this one frees a finished lane's pages at once even while a chained
    # dispatch that still writes them is in flight: every dispatch runs on
    # one CUDA stream, so a later owner's writes land after the stale ones
    # and it reads no position it has not written.

    def _dense_fits(self, meta: dict) -> bool:
        """Whether a pure-decode step can run the dense program: every
        decode lane has room for a full (K+1)-token slice, below its hard
        ceiling (a lane within K tokens of max_model_len steps on the plain
        mixed path for its last stretch, token-identical) and within the
        pages it holds now.  The second test is this port's: a lane with
        pages for its next token but not for a whole slice is not starved,
        so no preemption frees pages for it; it steps on the mixed path
        (token-identical) up to its last page, where _grow_and_preempt
        finds it starved, instead of sitting out every dense round."""
        kp = self._spec_k + 1
        for i, slot in enumerate(self._slots):
            if slot.request_id is None or not meta["active"][i]:
                continue
            if (slot.pos + kp > self._dense_lane_cap
                    or meta["capacity"][i] < slot.pos + kp):
                return False
        return True

    def _page_table(self, live) -> np.ndarray:
        """[B, bucketed width] page table of the `live` lanes (other rows 0)."""
        B = self.config.max_batch_size
        width = self.config.page_bucket(max(
            [len(s.pages) for i, s in enumerate(self._slots) if live[i]] or [1]))
        table = np.zeros((B, width), np.int32)
        for i, slot in enumerate(self._slots):
            if live[i] and slot.pages:
                table[i, : len(slot.pages)] = slot.pages
        return table

    def _refresh_draft_table(self) -> None:
        """Re-seed the draft table's rows whose occupant changed from that
        occupant's prompt + generated bigrams (a later occurrence wins);
        rows that stayed resident keep what the device learned."""
        if not self._spec_k:
            return  # K = 0 drafts nothing and has no table
        V = self.model_config.vocab_size
        B = self.config.max_batch_size

        def row_data(i: int) -> np.ndarray:
            row = np.full((V,), -1, np.int32)
            slot = self._slots[i] if i < B else None
            if slot is not None and slot.request_id is not None and slot.prefilling is None:
                seq = np.asarray(slot.prompt_ids + slot.generated, np.int64)
                if seq.shape[0] >= 2:
                    row[seq[:-1]] = seq[1:]
            return row

        if self._draft_table is None or self._draft_dirty is None:
            self._draft_table = upload(
                np.stack([row_data(i) for i in range(B + 1)]), self.device)
        elif self._draft_dirty:
            idx = sorted(self._draft_dirty)
            self._draft_table[upload(idx, self.device, torch.int64)] = upload(
                np.stack([row_data(i) for i in idx]), self.device)
        self._draft_dirty = set()

    def _plan_dense(self, meta: dict) -> dict:
        """Host inputs of one unchained mixed_decode dispatch."""
        self._refresh_draft_table()
        live = meta["active"].copy()
        return {
            "tokens": meta["tokens"], "pos": meta["pos"], "live": live,
            "capacity": meta["capacity"], "counters": meta["counters"],
            "page_table": meta["page_table"],
            "state": SamplingState.from_params(
                [s.params if live[i] else SamplingParams()
                 for i, s in enumerate(self._slots)], self.device),
            "rids": [s.request_id for s in self._slots],
        }

    def _plan_dense_chained(self, prev: dict) -> Optional[dict]:
        """A dispatch chained on the in-flight one: tokens, positions and
        counters come from its device carry; the host refreshes what it
        owns, page capacity (grown toward two in-flight dispatches) and
        the page table.  None drains the pipeline instead."""
        B = self.config.max_batch_size
        adv = self._max_step_advance
        kp = self._spec_k + 1
        live = prev["live"].copy()
        capacity = np.zeros((B,), np.int32)
        for i, slot in enumerate(self._slots):
            if not live[i]:
                continue
            if slot.request_id != prev["rids"][i]:
                live[i] = False
                continue
            if slot.pos + adv + kp > self._dense_lane_cap:
                # the in-flight dispatch may carry this lane to where no
                # further slice fits its ceiling: the unchained re-plan
                # hands it to the mixed path
                return None
            grow = min(2 * adv, self.config.max_model_len - slot.pos)
            if grow > 0:
                self._ensure_pages_at(slot, slot.pos, grow)
            capacity[i] = len(slot.pages) * self.config.page_size
        if not live.any():
            return None
        return {**prev, "live": live, "capacity": capacity,
                "page_table": self._page_table(live)}

    def _dispatch_dense(self, plan: dict, chain: Optional[dict] = None) -> dict:
        """Enqueue one mixed_decode dispatch (worker thread), then the
        copies of its outputs into pinned host buffers and an event after
        them, before any later dispatch is enqueued.  `chain` is the
        in-flight dispatch whose device (token, pos, counter) carry this
        one starts from."""
        with torch.inference_mode():
            if chain is not None:
                tok, pos, cnt = chain["carry"]
            else:
                tok, pos, cnt = plan["tokens"], plan["pos"], plan["counters"]
            toks, n_emit, self.kv_pages, self._draft_table, carry = (
                self._mixed_decode(
                    self.params, tok, pos, self.kv_pages, plan["page_table"],
                    plan["live"], plan["capacity"], cnt, self._draft_table,
                    plan["state"], self._rng))
            return {"carry": carry, **self._copy_to_host((toks, n_emit))}

    def _copy_to_host(self, tensors) -> dict:
        """Copies of a dispatch's outputs into pinned host buffers and an
        event after them, enqueued before any later dispatch: {"host",
        "event"} for `_wait_host`.  On the CPU the outputs are the host
        buffers."""
        if self.device.type != "cuda":
            return {"host": tuple(tensors), "event": None}
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        event = torch.cuda.Event()
        event.record()
        return {"host": tuple(host), "event": event}

    @staticmethod
    def _wait_host(chunk: dict):
        """The host copies of `_copy_to_host` as numpy arrays, once they
        landed (worker thread)."""
        if chunk["event"] is not None:
            chunk["event"].synchronize()
        return tuple(t.numpy() for t in chunk["host"])

    async def _route_dense(self, plan: dict, chunk: dict):
        """Consume one mixed_decode dispatch: per round, each live lane
        emits its accepted drafts plus the bonus token (none when the
        round was skipped for capacity).  A lane whose request went away
        while the dispatch ran is discarded whole.  Returns (any lane
        finished, any token routed)."""
        toks_np, n_np = await asyncio.to_thread(self._wait_host, chunk)
        k = self._spec_k
        routed = drafted = accepted = 0
        finished_any = False
        for i, slot in enumerate(self._slots):
            if not plan["live"][i]:
                continue
            if slot.request_id is None or slot.request_id != plan["rids"][i]:
                finished_any = True
                continue
            for r in range(toks_np.shape[0]):
                n = int(n_np[r, i])
                if n <= 0:
                    continue
                emitted = 0
                for j in range(n):
                    token = int(toks_np[r, i, j])
                    slot.pos += 1
                    slot.generated.append(token)
                    self._emit(slot, token)
                    routed += 1
                    emitted += 1
                    if slot.request_id is None:
                        break  # finished at this token: drop the tail
                # all emitted tokens but the round's bonus sample are
                # accepted drafts (a finish mid-round consumed drafts only)
                drafted += k
                accepted += min(emitted, n - 1)
                if slot.request_id is None:
                    finished_any = True
                    break
            if slot.request_id is not None and slot.pos >= self.config.max_model_len:
                self._finish(slot, "length")
                finished_any = True
        if k > 0:
            self.spec_stats["drafted"] += drafted
            self.spec_stats["accepted"] += accepted
            self.spec_stats["rejected"] += drafted - accepted
        return finished_any, routed > 0

    async def _step_dense(self, meta: dict) -> None:
        """Dense speculative decode with a depth-2 pipeline: dispatch N+1,
        chained on N's device carry, is enqueued before N's tokens are
        routed, so routing N overlaps N+1 on the device."""
        plan = self._plan_dense(meta)
        chunk = await asyncio.to_thread(self._dispatch_dense, plan)
        self.dense_steps += 1
        while True:
            plan2 = chunk2 = None
            admission_blocked = (not self._waiting
                                 or self._free_slot_index() is None)
            # a lane that surely finishes inside the in-flight dispatch
            # drains the pipeline anyway: do not chain a discarded dispatch
            predictable_finish = any(
                s.request_id is not None and plan["live"][i]
                and len(s.generated) + self._max_step_advance >= s.params.max_tokens
                for i, s in enumerate(self._slots))
            if admission_blocked and not predictable_finish and not self._stopped:
                plan2 = self._plan_dense_chained(plan)
            if plan2 is not None:
                chunk2 = await asyncio.to_thread(self._dispatch_dense, plan2, chunk)
                self.dense_steps += 1
                self.chained_dispatches += 1
            finished_any, routed_any = await self._route_dense(plan, chunk)
            await asyncio.sleep(0)  # flush streams while N+1 runs
            if chunk2 is None:
                break
            plan, chunk = plan2, chunk2
            if (finished_any or not routed_any or self._stopped
                    or (self._waiting and self._free_slot_index() is not None)):
                # stale lanes, admission can proceed, or every round was
                # skipped for capacity: drain the pipeline and re-plan
                await self._route_dense(plan, chunk)
                break

    def _seat_fresh(self, slot: _Slot, req: _QueuedRequest, first_token: int) -> None:
        slot.prefilling = None
        slot.prompt_ids = req.prompt_ids
        slot.prompt_len = len(req.prompt_ids)
        slot.pos = len(req.prompt_ids)  # position of the token decoded next
        slot.generated = [first_token]
        slot.params = req.params
        slot.detok = IncrementalDetokenizer(self.tokenizer)
        slot.stop_texts = list(req.params.stop or [])
        self._admission_seq += 1
        slot.admitted_at = self._admission_seq
        self._mark_penalty_dirty(self._slots.index(slot))

    def _seat_resumed(self, slot: _Slot, req: _QueuedRequest) -> None:
        """Seat a re-prefilled request with the stream state it had when it
        was preempted, its seating order included (so the oldest lane stays
        the oldest).  Port of kserve_tpu/engine/engine.py:2451."""
        r = req.resume
        slot.prefilling = None
        slot.prompt_ids = req.prompt_ids
        slot.prompt_len = len(req.prompt_ids)
        slot.pos = r["pos"]
        slot.generated = r["generated"]
        slot.params = req.params
        slot.detok = r["detok"]
        slot.stop_texts = r["stop_texts"]
        slot.admitted_at = r["admitted_at"]
        self._mark_penalty_dirty(self._slots.index(slot))

    def _complete_prefilling(self, slot: _Slot, req: _QueuedRequest,
                             first_token: Optional[int],
                             lp: tuple = (None, None)) -> None:
        """A prefilling slot's prompt is in the cache: seat it, and a fresh
        request emits its first token.  Shared by the mixed route (the
        token is the dispatch's step-0 sample) and the legacy chunk loop
        (sample_first's), so the two cannot drift (kserve_tpu/engine/
        engine.py:2393)."""
        if req.resume is not None:
            self._seat_resumed(slot, req)
            return
        self._seat_fresh(slot, req, first_token)
        self._emit(slot, first_token, *lp)

    def _emit(self, slot: _Slot, token: int, logprob: Optional[float] = None,
              top_logprobs: Optional[list] = None) -> None:
        """Stream one token (with its logprobs, when asked for); apply stop
        conditions."""
        n_gen = len(slot.generated)
        params = slot.params
        finish_reason = None
        is_eos = (
            token == self.tokenizer.eos_token_id
            and not params.ignore_eos
            and n_gen > params.min_tokens
        )
        delta = "" if is_eos else slot.detok.push(token)
        text = slot.detok.text
        if is_eos:
            finish_reason = "stop"
        elif n_gen >= params.max_tokens:
            finish_reason = "length"
        else:
            for stop in slot.stop_texts:
                if stop and stop in text:
                    cut = text.index(stop)
                    delta = delta[: max(0, len(delta) - (len(text) - cut))]
                    finish_reason = "stop"
                    break
        slot.queue.put_nowait(GenerationOutput(
            token_id=token,
            text_delta=delta,
            finished=finish_reason is not None,
            finish_reason=finish_reason,
            num_generated=n_gen,
            logprob=logprob,
            top_logprobs=top_logprobs,
        ))
        if finish_reason is not None:
            self.allocator.free(slot.pages)
            self._mark_penalty_dirty(self._slots.index(slot))
            slot.reset()
            self._wake.set()

    def _finish(self, slot: _Slot, reason: str) -> None:
        slot.queue.put_nowait(GenerationOutput(
            token_id=-1,
            text_delta="",
            finished=True,
            finish_reason=reason,
            num_generated=len(slot.generated),
        ))
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
