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
- the prefix cache (engine/prefix_cache.py, on unless `prefix_cache=
  False`): admission looks up the prompt's page-aligned digest chain,
  shares the cached pages and prefills only the tail (a mixed lane's
  first chunk starts at `kv_start` = the cached tokens; a legacy batch
  with a hit row runs the batched `prefill_chunk` with per-row starts and
  `sample_first`); prompt pages are registered chunk by chunk; cold
  cached pages are evicted before admission fails or a lane is
  preempted
- the KV hierarchy (kvstore/, `kv_offload="host"` or `kv_persist_dir`):
  a preempted lane's pages spill to host RAM (and disk) and are injected
  back on resume (compiled.inject / inject_q) instead of re-prefilled;
  evicted prefix pages demote into the same tiers, and a later prompt
  with that prefix pages them back in before it is admitted (a worker
  thread reads the tiers, one inject writes the pages); a prefix that is
  hit again is written through to the persistent layer, which a
  restarted engine pages in from
- int8 weights (`weight_quant="int8"`, models/quant.py): random weights
  are drawn int8, passed-in ones quantized at construction
  (kserve_tpu/engine/engine.py:207-222)
- multi-adapter LoRA (`lora_adapters={name: PEFT dir}`, models/lora.py):
  every adapter's stacks ride the layers, and a request names one
  (`generate(..., adapter=name)`; None is the base model), which becomes
  a per-lane id (-1: base) that every program takes, so base and adapter
  lanes of any mix share each dispatch.  LoRA KV is adapter-specific: an adapter request
  neither looks up nor registers prefix pages (so it pages nothing in
  and persists nothing); a checkpoint carries the adapter's name and a
  resume resolves it (kserve_tpu/engine/engine.py:223-310, :1367-1433)

The device calls and the fetches of their tokens run on one worker
thread (`_fetch_async`, under the step deadline), so the event loop keeps
answering health probes and new requests while a step computes; a drain
or a cancel may therefore release a slot while its dispatch is being
enqueued, and the dispatch's route drops that slot's tokens.  Every
launch goes to one CUDA stream
(the device's default stream, whichever thread enqueues it), so a finished
lane's pages are freed at once even while a chained dispatch that still
writes them is in flight (the JAX engine defers such frees): a later
owner's writes, an inject included, land after the stale ones, and it
reads no position it has not written.  That holds because pages are
allocated only by the run loop between dispatches, never while a worker
thread is still enqueueing one: a page-in reads and packs its pages on a
worker thread, and the run loop allocates them, enqueues their inject and
only then adopts them (`_land_page_ins`).  A persist write-through
enqueues its gather when the prefix is hit and only reads it back on a
worker thread.

Every request carries a RequestTimeline (observability/timeline.py),
stamped from the engine's clock where the JAX engine stamps it: received
at submit, admitted, prefill start and end, each emitted token, and its
terminal state (finished, cancelled, error).  The `TimelineRecorder`
behind `telemetry_snapshot()` (GET /admin/telemetry) keeps the finished
ones and the step and prefill-chunk durations; metrics.py exports the
same to GET /metrics.

Lifecycle and operations (kserve_tpu/engine/engine.py:1257-1360,
:1362-1423, :1660-1886, :1960-1977):

- `generate` takes a request id and reads the propagated request
  deadline (resilience/deadline.py): an expired one is refused at once,
  and a queued request whose deadline dies before it is seated gets
  DeadlineExceededError (`_drop_expired_waiting`); a draining or stopped
  engine refuses new work with ReplicaDrainingError
- `drain(deadline)` stops admission, lets seated work run until the
  budget expires, then snapshots every queued and seated request into a
  portable GenerationCheckpoint (lifecycle/checkpoint.py) raised into its
  stream as GenerationPreempted; `resume_generation(checkpoint)` admits
  one from any replica (or from the JAX package) through the preemption
  resume: a re-prefill of prompt + generated[:-1], then decoding from the
  next token, the detokenizer replayed
- every device call (a dispatch and the fetch of its tokens) runs on one
  daemon worker under `step_deadline_s`; one that outlasts it marks the
  engine `wedged` (liveness red).  On CUDA `start()` loads the kernel
  library and drives one warm-up generation (`aot_warmup`) before the
  engine is ready (the `compile` startup phase), so no served dispatch
  waits for nvcc or for the lazy loading of a process's first dispatch
- the gray-failure watchdog (engine/watchdog.py, `watchdog=True`) reads
  the progress stamps and, on a confirmed stall, self-drains with reason
  "stall"; `scheduler_state()` is the endpoint picker's view of the
  engine

Prefill/decode disaggregation (kserve_tpu/engine/engine.py:1435-1626,
:2470-2548):

- prefill side: `prefill_detached` queues a prompt; the run loop, between
  dispatches, micro-batches up to `prefill_batch` queued prompts into one
  legacy `prefill` call on the device worker, gathers each row's pages
  to the host there (under the step deadline: the engine's largest
  device-to-host copy) and frees them once the copy has landed.  int8
  KV, logprobs and a prompt over max_prefill_len are refused
- decode side: `generate_injected` admits a prompt whose KV and first
  token came from a prefill peer (`kv_data`, `first_token`): admission
  injects the pages, seats the lane at len(prompt) and emits the peer's
  first token as a seated lane's first sample.  Its checks (length, int8
  KV, the expected shape) run before the stream starts, so a skewed peer
  fails its request and not the run loop; a preempted injected lane
  re-prefills as any other

The cross-replica page fabric (kvstore/peer.py; kserve_tpu/engine/
engine.py:873-902, :1064-1186): with a PeerPageClient attached
(`set_peer_client`), a page-in's search goes on past the local tiers into
digests a peer advertises; those pages are fetched and verified one by
one (the run truncated at the first failure), landed like tier pages and
written through to the local tiers and the persistent layer afterwards.
`read_peer_page` serves this engine's persisted pages to peers, and
`scheduler_state()` carries `peer_pages` (the digest set served) and
`peer` (fetch outcomes, bad pages per peer, breakers).

Not ported yet: frees deferred while a chained dispatch is in flight (not
needed on one stream, above), data/tensor/pipeline/sequence/expert
parallelism and the AOT cache.  An MoE model (models/moe.py) runs on
every route; LoRA over it is refused, as in the JAX engine.
Admission waits for free pages.
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
from ..lifecycle import GenerationCheckpoint, GenerationPreempted, ReplicaDrainingError
from ..metrics import (
    DEADLINE_REJECTED,
    ENGINE_BATCH_OCCUPANCY,
    ENGINE_KV_PAGES_FREE,
    ENGINE_PREEMPTIONS,
    ENGINE_PREFILL_CHUNK_DURATION,
    ENGINE_QUEUE_DEPTH,
    ENGINE_STEP_DURATION,
    ENGINE_WEDGED,
    GENERATED_TOKENS,
    GENERATION_CHECKPOINTS,
    GENERATION_RESUMES,
    KV_PAGEIN_SECONDS,
    KV_PREFIX_HIT_TOKENS,
    PROMPT_TOKENS,
    SPEC_TOKENS,
    TOKENS_SALVAGED,
    observe_request_timeline,
    observe_startup_phase,
)
from ..models import llama
from ..models.lora import stack_adapters
from ..models.quant import is_quantized, quantize_params
from ..observability import RequestTimeline, TimelineRecorder, emit_timeline_spans
from ..resilience import (
    MONOTONIC,
    Deadline,
    DeadlineExceededError,
    ReplicaCrashError,
    current_deadline,
)
from ..tracing import current_trace_context, get_tracer
from ..ops.attention import dense_stride_for
from ..ops.paged_attention_cuda import RAGGED_BQ
from ..kvstore import HierarchicalKVStore, KVStoreConfig, payload_nbytes
from .compiled import (
    LegacyPrograms,
    gather_pages,
    inject,
    inject_q,
    make_mixed,
    make_mixed_decode,
)
from .kvcache import (
    KVCacheConfig,
    PageAllocator,
    init_kv_pages,
    init_kv_scales,
    pages_needed,
)
from .prefix_cache import PrefixCache
from .sampling import SamplingParams, SamplingState
from .tokenizer import BaseTokenizer, IncrementalDetokenizer
from .types import (
    EngineConfig,
    EngineWedgedError,
    GenerationOutput,
    _DeadlineFetcher,
    _QueuedRequest,
    _Slot,
)
from .watchdog import EngineWatchdog, WatchdogConfig

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
        metrics_label: str = "engine",
        weights_seconds: float = 0.0,
        checkpoint_label: Optional[str] = None,
        clock=None,
        lora_adapters: Optional[Dict[str, str]] = None,
    ):
        """`params`: the model's parameters on `device` (None draws seeded
        random ones; with weight_quant="int8" plain ones are quantized).
        `lora_adapters` maps adapter names to HF PEFT directories, loaded
        onto the device and selected per request by name.  `metrics_label`
        is the model_name label of the engine's metrics; `weights_seconds`
        is the time the caller spent reading and placing `params`, counted
        into the startup phases.
        `checkpoint_label` names the weights in the checkpoints this
        engine writes, and only a checkpoint with that name (or none)
        resumes here (default: `metrics_label`; the server passes the
        served model's name).  `clock` stamps timelines, deadlines and the
        watchdog (resilience.Clock; real monotonic time by default)."""
        self._construct_t0 = time.perf_counter()
        self.device = resolve_device(device)
        if engine_config.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"unknown kv_quant {engine_config.kv_quant!r}; supported: none, int8"
            )
        if engine_config.kv_offload not in ("none", "host"):
            raise ValueError(
                f"unknown kv_offload {engine_config.kv_offload!r}; supported: "
                "none, host")
        # own copy: prefix_cache=None resolves below, and resolving it in
        # the caller's dataclass would make a reused config look set
        engine_config = dataclasses.replace(engine_config)
        if engine_config.prefix_cache is None:
            engine_config.prefix_cache = True
        if engine_config.weight_quant not in ("none", "int8"):
            raise ValueError(f"weight_quant={engine_config.weight_quant!r}")
        unsupported = {
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
            params = llama.init_params(model_config, seed=1, device=self.device,
                                       weight_quant=engine_config.weight_quant)
        elif engine_config.weight_quant == "int8" and not any(
                is_quantized(v) for v in params["layers"][0].values()):
            params = quantize_params(params, model_config)
        # multi-adapter LoRA (kserve_tpu/engine/engine.py:223-238, :293-310):
        # per-layer stacks [n_adapters, ...] on the device beside the
        # weights; a per-lane id selects one at run time
        self.adapter_ids: Dict[str, int] = {}
        if lora_adapters:
            if getattr(model_config, "n_experts", 0) > 0:
                raise NotImplementedError("LoRA over MoE layers is not supported yet")
            self.adapter_ids, stacks = stack_adapters(
                lora_adapters, model_config.n_layers, dtype=model_config.dtype,
                device=self.device)
            # new layer dicts: the caller's parameters stay as they were
            params = dict(params, layers=[
                dict(layer, lora=stack) if stack else dict(layer)
                for layer, stack in zip(params["layers"], stacks)])
            logger.info("LoRA adapters loaded: %s", sorted(self.adapter_ids))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.params = params
        # kserve_tpu/engine/engine.py:311-313, :733-747: exported at start()
        self._weights_external_s = weights_seconds
        self.startup_phases = {
            "weights": time.perf_counter() - t0 + weights_seconds}
        self._mlabel = metrics_label
        self._ckpt_label = checkpoint_label or metrics_label
        # every timeline stamp, deadline and watchdog reading goes through
        # this clock
        self._clock = clock or MONOTONIC
        # finished timelines and rolling percentile windows behind
        # telemetry_snapshot()
        self.telemetry = TimelineRecorder()
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
        # the KV hierarchy (kvstore/): host/disk tiers take preempted lanes'
        # spills and demoted prefix pages; the persistent layer keeps
        # reused prefix pages across restarts
        self._kv_store: Optional[HierarchicalKVStore] = None
        if engine_config.kv_offload == "host" or engine_config.kv_persist_dir:
            self._kv_store = HierarchicalKVStore(KVStoreConfig(
                host_bytes=int(engine_config.kv_offload_gib * (1 << 30)),
                disk_bytes=int(engine_config.kv_offload_disk_gib * (1 << 30)),
                disk_dir=engine_config.kv_offload_dir,
                policy=engine_config.kv_offload_policy,
                persist_dir=engine_config.kv_persist_dir))
        # page-in and persist write-through tasks (cancelled on stop) and
        # the digests being persisted now
        self._pagein_tasks: set = set()
        self._persisting: set = set()
        # page-ins read and packed, waiting for the run loop to allocate,
        # inject and adopt them: (request, entries, packed payload, t0)
        self._pageins_ready: List[tuple] = []
        # chained (depth-2) dispatch in flight: prefix demotion is skipped
        # meanwhile, as in the JAX engine (its gather would wait for it)
        self._pipeline_busy = False
        # chained page key -> page, LRU-evicted under pressure, holding one
        # allocator reference per page; evictions demote into the tiers
        self._prefix_cache = PrefixCache(
            engine_config.page_size, engine_config.prefix_cache,
            self.allocator, demote_cb=self._demote_prefix_pages)
        # spills of preempted lanes and their resumes by inject
        self.kv_tier_counts = {"spills": 0, "spilled_bytes": 0,
                               "resume_injects": 0, "injected_bytes": 0}
        self.pagein_seconds: List[float] = []  # host wall of each page-in
        # the cross-replica page fabric's client (set_peer_client)
        self._peer_client = None
        # P/D prefill side: queued detached prefills (prompt, params,
        # future, adapter id) and the batch the run loop is running
        self._detached_queue: List[tuple] = []
        self._detached_inflight: List[tuple] = []
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
        # lifecycle: once draining, admission is refused and drain()
        # checkpoints what its budget cannot finish
        self._draining = False
        self.resume_count = 0
        self.checkpointed_count = 0
        # device calls run on one daemon worker under step_deadline_s; a
        # call that outlasts it flips `wedged` (liveness)
        self._fetcher = _DeadlineFetcher()
        self._wedged = False
        # fault seams (resilience/faults.py): "engine.fetch" (wedge,
        # replica_crash) and "engine.preempt" (preempt)
        self.fault_plan = None
        # the gray-failure watchdog; the server hooks on_stall_confirmed
        # to flip its ReplicaLifecycle
        self._watchdog: Optional[EngineWatchdog] = None
        self.on_stall_confirmed = None
        if engine_config.watchdog:
            self._watchdog = EngineWatchdog(
                WatchdogConfig(
                    interval_s=engine_config.watchdog_interval_s,
                    suspect_after_s=engine_config.watchdog_suspect_s,
                    confirm_after_s=engine_config.watchdog_confirm_s,
                    task_stall_s=engine_config.watchdog_task_stall_s,
                    salvage_grace_s=engine_config.watchdog_salvage_grace_s,
                ),
                clock=self._clock,
                busy=self._has_live_work,
                on_confirmed=self._stall_confirmed,
                tasks=lambda: self._pagein_tasks,
            )

    # ---------------- public API ----------------

    async def start(self):
        if self._task is None:
            first = "ready" not in self.startup_phases
            t0 = time.perf_counter()
            if self.device.type == "cuda" and first:
                # build (or load) the kernel library now, before ready: a
                # cold nvcc build inside the first served dispatch would
                # blow the step deadline and read as a stall
                from ..ops._build import load_library

                await asyncio.to_thread(load_library)
                self.startup_phases["compile"] = time.perf_counter() - t0
            self._task = asyncio.create_task(self._run_loop())
            warmup = self.config.aot_warmup
            if warmup is None:
                warmup = self.device.type == "cuda"
            if warmup and first and not self._stopped:
                await self._aot_warmup()
                self.startup_phases["compile"] = time.perf_counter() - t0
            if first:
                self.startup_phases["ready"] = (
                    time.perf_counter() - self._construct_t0
                    + self._weights_external_s)
                for phase, seconds in self.startup_phases.items():
                    observe_startup_phase(self._mlabel, phase, seconds)
            if self._watchdog is not None:
                # a start is forward motion: the stall window opens here,
                # not at construction (the kernel build sits in between)
                self._watchdog.note_progress()
                self._watchdog.start()
            logger.info(
                "LLM engine started on %s: slots=%d pages=%d page_size=%d",
                self.device, self.config.max_batch_size,
                self.config.num_pages, self.config.page_size)

    async def _aot_warmup(self):
        """Drive one tiny greedy generation through the serving loop before
        the engine reports ready (kserve_tpu/engine/engine.py:703-731), so
        the kernels its dispatches reach are loaded ahead of the first
        real request.  One generation, not one per prefill bucket: the
        port compiles no program per shape.  Prompt and output stay inside
        one page, so the prefix cache keeps nothing of it; its timelines
        and dispatch counters are not traffic and start again at zero (the
        Prometheus series keep its observations, as in the JAX engine)."""
        params = SamplingParams(
            max_tokens=min(4, max(1, self.config.steps_per_sync)),
            temperature=0.0, ignore_eos=True)
        n = max(1, min(4, self.config.page_size - params.max_tokens - 1))
        try:
            async for _ in self.generate([1] * n, params, request_id="aot-warmup"):
                pass
        except Exception:  # noqa: BLE001 — warmup is an optimization; a
            # failure here must surface in the logs, not block serving
            logger.exception("aot warmup failed")
        self.telemetry = TimelineRecorder()
        self.steps = self.dense_steps = self.chained_dispatches = 0
        self.legacy_dispatches = dict.fromkeys(self.legacy_dispatches, 0)
        self.spec_stats = dict.fromkeys(self.spec_stats, 0)

    async def stop(self):
        self._stopped = True
        self.stop_watchdog()
        self._wake.set()
        self._fail_waiting(RuntimeError("engine stopped"))
        # the prefill role's waiters would otherwise hang until their
        # client gives up (kserve_tpu/engine/engine.py:759-769)
        self._fail_detached(RuntimeError("engine stopped"))
        if self._task is not None:
            try:
                await asyncio.wait_for(self._task, timeout=30)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                self._task.cancel()
            self._task = None
        self._fail_waiting(RuntimeError("engine stopped"))
        self._fail_detached(RuntimeError("engine stopped"))
        for slot in self._slots:
            if slot.request_id is not None:
                slot.queue.put_nowait(RuntimeError("engine stopped"))
                self._record_terminal(slot.timeline, "error")
                self.allocator.free(slot.pages)
                slot.reset()
        # page-in and persist tasks wait on worker threads: cancel them so
        # none wakes into a stopped engine
        for task in list(self._pagein_tasks):
            task.cancel()
        self._pagein_tasks.clear()
        self._pageins_ready.clear()
        if self._kv_store is not None:
            self._kv_store.close()
        self._fetcher.close()

    def generate(self, prompt_ids: List[int], params: SamplingParams,
                 request_id: Optional[str] = None,
                 adapter: Optional[str] = None) -> AsyncIterator[GenerationOutput]:
        """Submit a request; yields one GenerationOutput per emitted token.
        `adapter` names a loaded LoRA adapter (None = the base model).
        Validation runs here, before the stream starts: a draining or
        stopped engine raises ReplicaDrainingError, an expired propagated
        deadline DeadlineExceededError, an unknown adapter ValueError
        (kserve_tpu/engine/engine.py:1362)."""
        if not prompt_ids:
            raise ValueError("empty prompt")
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        if len(prompt_ids) + params.max_tokens > self.config.max_model_len:
            raise ValueError(
                f"prompt+max_tokens exceeds max_model_len {self.config.max_model_len}")
        if max(prompt_ids) >= self.model_config.vocab_size or min(prompt_ids) < 0:
            raise ValueError("prompt token id outside the model vocabulary")
        self._check_accepting()
        deadline = self._admission_deadline()
        rid = request_id or f"req-{time.monotonic_ns()}"
        req = _QueuedRequest(rid, list(prompt_ids), params, asyncio.Queue(),
                             timeline=self._new_timeline(rid, len(prompt_ids)),
                             deadline=deadline,
                             adapter_id=self._resolve_adapter(adapter))
        return self._submit_and_stream(req)

    # ---------------- prefill/decode disaggregation ----------------
    # Port of kserve_tpu/engine/engine.py:1435-1626.

    def generate_injected(self, prompt_ids: List[int], params: SamplingParams,
                          kv_data, first_token: int,
                          request_id: Optional[str] = None,
                          adapter: Optional[str] = None
                          ) -> AsyncIterator[GenerationOutput]:
        """P/D, decode side: admit a request whose prompt KV (`kv_data`
        [L, P, 2, n_kv, ps, d], a CPU tensor or a numpy array, as
        prefill_detached returns it) and first sampled token came from a
        prefill-role server.  Its pages are injected into this engine's
        cache and decoding starts at len(prompt_ids).  Validation runs
        here, before the stream starts: a version-skewed peer's KV fails
        this request, never the run loop."""
        if not prompt_ids:
            raise ValueError("empty prompt")
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        if len(prompt_ids) + params.max_tokens > self.config.max_model_len:
            raise ValueError(
                f"prompt+max_tokens exceeds max_model_len {self.config.max_model_len}")
        if self.config.kv_quant != "none":
            raise NotImplementedError(
                "KV injection over a quantized cache is not supported yet")
        vocab = self.model_config.vocab_size
        if (max(prompt_ids) >= vocab or min(prompt_ids) < 0
                or not 0 <= int(first_token) < vocab):
            raise ValueError("prompt or first token outside the model vocabulary")
        if not torch.is_tensor(kv_data):
            kv_data = torch.from_numpy(np.ascontiguousarray(kv_data))
        cc = self.cache_config
        expect = (cc.n_layers, pages_needed(len(prompt_ids), cc.page_size), 2,
                  cc.n_kv_heads, cc.page_size, cc.head_dim)
        if tuple(kv_data.shape) != expect or not kv_data.is_floating_point():
            raise ValueError(
                f"injected KV shape {tuple(kv_data.shape)} ({kv_data.dtype}) "
                f"incompatible with this engine's cache (expected {expect}); "
                "prefill peer and decode server must share model + page_size "
                "configuration")
        self._check_accepting()
        deadline = self._admission_deadline()
        rid = request_id or f"req-{time.monotonic_ns()}"
        req = _QueuedRequest(rid, list(prompt_ids), params, asyncio.Queue(),
                             timeline=self._new_timeline(rid, len(prompt_ids)),
                             deadline=deadline,
                             adapter_id=self._resolve_adapter(adapter),
                             kv_data=kv_data, first_token=int(first_token))
        return self._submit_and_stream(req)

    async def prefill_detached(self, prompt_ids: List[int], params: SamplingParams,
                               adapter: Optional[str] = None):
        """P/D, prefill side: the prompt's first sampled token and its KV
        pages on the host, (first_token, kv [L, P, 2, n_kv, ps, d] CPU
        tensor in the cache dtype); its device pages are free again when
        this returns.  Concurrent callers are micro-batched by the run
        loop, up to `prefill_batch` prompts per legacy `prefill` call.
        Refused: an int8 cache (NotImplementedError), logprobs (the wire
        carries none) and a prompt over max_prefill_len (ValueError)."""
        if self.config.kv_quant != "none":
            raise NotImplementedError(
                "detached prefill (P/D transfer) over a quantized KV cache is "
                "not supported yet")
        if params.logprobs is not None:
            raise ValueError(
                "logprobs is not supported with prefill/decode disaggregation")
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n > self.config.max_prefill_len:
            raise ValueError(f"prompt length {n} exceeds max_prefill_len "
                             f"{self.config.max_prefill_len}")
        if max(prompt_ids) >= self.model_config.vocab_size or min(prompt_ids) < 0:
            raise ValueError("prompt token id outside the model vocabulary")
        adapter_id = self._resolve_adapter(adapter)
        self._check_accepting()
        if not self.running:
            raise RuntimeError("engine is not started: detached prefills run "
                               "in its loop")
        fut = asyncio.get_running_loop().create_future()
        self._detached_queue.append((list(prompt_ids), params, fut, adapter_id))
        self._wake.set()
        return await fut

    def _fail_detached(self, exc: Exception) -> None:
        """Fail every queued and running detached prefill's waiter."""
        pending = self._detached_queue + self._detached_inflight
        self._detached_queue, self._detached_inflight = [], []
        for _, _, fut, _ in pending:
            if not fut.done():
                fut.set_exception(exc)

    async def _run_detached(self) -> None:
        """Run loop, between dispatches: one legacy `prefill` call over up
        to `prefill_batch` queued detached prompts (their pages allocated
        here, as admission allocates), then each row's pages gathered and
        copied to the host on the device worker, then freed
        (kserve_tpu/engine/engine.py:1578-1636)."""
        batch = self._detached_queue[:self.config.prefill_batch]
        del self._detached_queue[:len(batch)]
        ps = self.config.page_size
        runnable = []
        for prompt_ids, params, fut, adapter_id in batch:
            if fut.done():
                continue  # its caller went away
            n_pages = pages_needed(len(prompt_ids), ps)
            if not self._prefix_cache.ensure_allocatable(n_pages):
                fut.set_exception(MemoryError(
                    "KV pages exhausted for detached prefill"))
                continue
            runnable.append((prompt_ids, params, fut, adapter_id,
                             self.allocator.allocate(n_pages)))
        if not runnable:
            return
        self._detached_inflight = [r[:4] for r in runnable]
        try:
            bucket = self._bucket_for(max(len(r[0]) for r in runnable))
            Bp = 1
            while Bp < len(runnable):
                Bp *= 2
            tokens = np.zeros((Bp, bucket), np.int32)
            valid = np.zeros((Bp,), np.int32)
            page_ids = np.zeros((Bp, self.config.max_pages_per_seq), np.int32)
            adapters = np.full((Bp,), -1, np.int32)
            params_list = [SamplingParams()] * Bp
            for j, (prompt_ids, params, _, adapter_id, pages) in enumerate(runnable):
                tokens[j, :len(prompt_ids)] = prompt_ids
                valid[j] = len(prompt_ids)
                page_ids[j, :len(pages)] = pages
                adapters[j] = adapter_id
                params_list[j] = params
            first, _ = await self._fetch_async(
                self._run_prefill, "prefill", tokens, valid, page_ids,
                params_list, adapters)
            self.legacy_dispatches["prefill"] += 1
            kvs = await self._fetch_async(
                self._extract_detached, [r[4] for r in runnable])
            for j, (_, _, fut, _, _) in enumerate(runnable):
                if not fut.done():
                    fut.set_result((int(first[j]), kvs[j]))
        except Exception as e:  # noqa: BLE001 — fail these waiters, not the engine
            for _, _, fut, _, _ in runnable:
                if not fut.done():
                    fut.set_exception(e)
            if isinstance(e, (EngineWedgedError, ReplicaCrashError)):
                raise  # the device is gone: as a dispatch's would, it ends the loop
        finally:
            self._detached_inflight = []
            for *_, pages in runnable:
                self.allocator.free(pages)

    def _extract_detached(self, page_lists: List[List[int]]) -> List[torch.Tensor]:
        """Worker thread: each row's pages as a contiguous CPU tensor [L,
        P, 2, n_kv, ps, d] (the copies wait for the prefill)."""
        with torch.inference_mode():
            return [gather_pages(self.kv_pages, pages)["kv"].cpu()
                    for pages in page_lists]

    def _resolve_adapter(self, adapter: Optional[str]) -> int:
        """A LoRA adapter's name -> its stack row; None -> -1, the base
        model (kserve_tpu/engine/engine.py:1425)."""
        if adapter is None:
            return -1
        if adapter not in self.adapter_ids:
            raise ValueError(
                f"unknown LoRA adapter {adapter!r}; loaded: "
                f"{sorted(self.adapter_ids) or 'none'}")
        return self.adapter_ids[adapter]

    def _adapter_name(self, adapter_id: int) -> Optional[str]:
        """A stack row's adapter name, which a checkpoint carries (None for
        the base model; kserve_tpu/engine/engine.py:1666)."""
        for name, i in self.adapter_ids.items():
            if i == adapter_id:
                return name
        return None

    def _check_accepting(self) -> None:
        """A draining or stopped engine refuses new work at once (503 +
        Retry-After upstream) instead of queueing it into a replica that
        is going away."""
        if self._stopped or self._draining:
            raise ReplicaDrainingError(
                "engine is " + ("stopped" if self._stopped else "draining")
                + "; retry another replica")

    def _admission_deadline(self) -> Optional[Deadline]:
        """The propagated request deadline (a contextvar the REST server
        binds), checked here so that a dead budget is refused before any
        queue slot or prefill is committed."""
        deadline = current_deadline()
        if deadline is not None and deadline.expired:
            DEADLINE_REJECTED.labels(component="engine").inc()
            raise DeadlineExceededError(
                "request deadline expired before engine admission")
        return deadline

    def _new_timeline(self, rid: str, n_prompt: int) -> RequestTimeline:
        """A request's timeline, stamped received now, with the caller's
        trace context so that its engine spans join the request's trace
        (kserve_tpu/engine/engine.py:1391-1399)."""
        tl = RequestTimeline(rid, model_name=self._mlabel,
                             trace=current_trace_context())
        tl.n_prompt_tokens = n_prompt
        tl.mark_received(self._clock.now())
        return tl

    async def _submit_and_stream(self, req: _QueuedRequest):
        # again at enqueue time: the first __anext__ may come after a
        # drain's last flush of the queue, and nothing would flush it again
        self._check_accepting()
        self._waiting.append(req)
        self._set_queue_gauge()
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
        kept = []
        for r in self._waiting:
            if r.request_id != request_id:
                kept.append(r)
            else:
                self._discard_resume_kv(r)
                self._record_terminal(r.timeline, "cancelled")
        self._waiting = kept
        self._set_queue_gauge()
        if any(req.request_id == request_id for _, req, *_ in self._admitting):
            self._cancelled_admissions.add(request_id)
        for slot in self._slots:
            if slot.request_id == request_id:
                # the client went away mid-generation: terminal for
                # telemetry although nothing more was sent
                self._record_terminal(slot.timeline, "cancelled")
                self.allocator.free(slot.pages)
                slot.reset()
                self._wake.set()

    def _fail_waiting(self, exc: Exception) -> None:
        pending, self._waiting = self._waiting, []
        for req in pending:
            self._discard_resume_kv(req)
            req.queue.put_nowait(exc)
            self._record_terminal(req.timeline, "error")
        self._set_queue_gauge()

    def _discard_resume_kv(self, req: _QueuedRequest) -> None:
        """Release a queued request's spilled KV from the tier store."""
        if (req.resume is not None and req.resume["kv"] is not None
                and self._kv_store is not None):
            self._kv_store.discard(req.resume["kv"])
            req.resume["kv"] = None

    @property
    def prefix_cache_hits(self) -> int:
        """Pages reused through the prefix cache."""
        return self._prefix_cache.hits

    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self._waiting)

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    @property
    def wedged(self) -> bool:
        """True once a device call outlasted the step deadline; liveness
        reads it so the pod restarts."""
        return self._wedged

    @property
    def draining(self) -> bool:
        return self._draining

    def scheduler_state(self, max_digests: int = 512) -> dict:
        """The endpoint picker's view of this engine (kserve_tpu/engine/
        engine.py:829-887): load, free pages, the hottest prefix digests
        (hex, most recently used last), latency windows, and the spec,
        watchdog and prefix-store blocks where they apply; with the
        persistent layer `peer_pages`, the digest set this replica serves
        to peers, and with a peer client attached `peer`, its fetch
        outcomes, bad pages per peer, breakers and index."""
        state = {
            "queue_depth": self.queue_depth,
            "inflight": sum(1 for s in self._slots if s.request_id is not None),
            "free_pages": self.allocator.free_pages,
            "page_size": self.config.page_size,
            "running": self.running,
            "wedged": self._wedged,
            "prefix_digests": self._prefix_cache.hottest_digests(max_digests),
            "telemetry": self.telemetry.signal_windows(),
        }
        if self._spec_k is not None and self._spec_k > 0:
            state["spec"] = dict(self.spec_stats)
        if self._watchdog is not None:
            state["watchdog"] = self._watchdog.snapshot()
        stats = self.prefix_store_stats()
        if stats is not None:
            state["prefix_store"] = stats
            # a key of its own: the picker's merge of prefix_store blocks
            # sums numbers and would mangle a digest list
            wire = self._kv_store.resident_digest_wire()
            if wire is not None:
                state["peer_pages"] = wire
        if self._peer_client is not None:
            state["peer"] = self._peer_client.snapshot()
        return state

    # ---------------- the cross-replica page fabric ----------------

    def set_peer_client(self, client) -> None:
        """Attach a kvstore.PeerPageClient: a page-in then searches past
        the local tiers into the digests peers advertise, and fetches and
        verifies those pages (kserve_tpu/engine/engine.py:891-895)."""
        self._peer_client = client

    def read_peer_page(self, digest: bytes) -> Optional[bytes]:
        """One persisted page in its wire form for the REST page server,
        or None.  A store read alone: it never touches the run loop."""
        if self._kv_store is None:
            return None
        return self._kv_store.read_peer_page(digest)

    # ---------------- telemetry ----------------
    # Port of kserve_tpu/engine/engine.py:1206-1255.

    def telemetry_snapshot(self) -> dict:
        """Rolling latency percentiles and recent request timelines (the
        GET /admin/telemetry payload of one model)."""
        snap = self.telemetry.snapshot()
        snap["queue_depth"] = self.queue_depth
        snap["prefix_cache_hits"] = self.prefix_cache_hits
        snap["preemptions"] = self.preemption_count
        return snap

    def _record_terminal(self, tl: Optional[RequestTimeline],
                         reason: Optional[str]) -> None:
        """A timeline reached a terminal state: stamp it, feed the
        recorder and, for a finished generation, the request histograms,
        and emit its engine spans when a tracer is configured.  Once per
        timeline, whichever teardown path comes first."""
        if tl is None or tl.recorded:
            return
        tl.recorded = True
        tl.mark_finished(self._clock.now(), reason)
        self.telemetry.observe(tl)
        if reason in ("stop", "length"):
            observe_request_timeline(self._mlabel, tl)
        tracer = get_tracer()
        if tracer is not None:
            try:
                emit_timeline_spans(tracer, tl, self._wall_ns)
            except Exception:  # noqa: BLE001 — telemetry must never kill the loop
                logger.exception("engine span emission failed")

    def _wall_ns(self, t: float) -> int:
        """Wall-clock nanoseconds of the engine clock's time `t`."""
        return time.time_ns() - int((self._clock.now() - t) * 1e9)

    def _set_queue_gauge(self) -> None:
        ENGINE_QUEUE_DEPTH.labels(model_name=self._mlabel).set(len(self._waiting))

    def _set_occupancy_gauges(self) -> None:
        active = sum(1 for s in self._slots
                     if s.request_id is not None and s.prefilling is None)
        ENGINE_BATCH_OCCUPANCY.labels(model_name=self._mlabel).set(active)
        ENGINE_KV_PAGES_FREE.labels(model_name=self._mlabel).set(
            self.allocator.free_pages)

    def _record_step(self, dispatched_at: float) -> float:
        """One dispatch's wall time, enqueue to fetched tokens: the decode
        step series.  Returns it."""
        step_s = self._clock.now() - dispatched_at
        ENGINE_STEP_DURATION.labels(model_name=self._mlabel).observe(step_s)
        self.telemetry.record_step(step_s)
        return step_s

    def _record_prefill_chunk(self, seconds: float) -> None:
        ENGINE_PREFILL_CHUNK_DURATION.labels(model_name=self._mlabel).observe(seconds)
        self.telemetry.record_prefill_chunk(seconds)

    @property
    def _offload_bytes(self) -> int:
        """Bytes parked in the host and disk tiers: back to 0 once every
        spill was injected or discarded and no prefix page is demoted."""
        if self._kv_store is None:
            return 0
        return int(self._kv_store.host_used + self._kv_store.disk_used)

    def prefix_store_stats(self) -> Optional[dict]:
        """The KV hierarchy's prefix-path counters (the JAX engine's
        scheduler_state()["prefix_store"]), or None without a store."""
        if self._kv_store is None:
            return None
        stats = self._kv_store.stats_dict()
        stats["adopted_hit_tokens"] = (
            self._prefix_cache.adopted_hits * self.config.page_size)
        return stats

    # ---------------- lifecycle: drain and resumable generation ----------------
    # Port of kserve_tpu/engine/engine.py:1660-1886.

    def _checkpoint(self, request_id, prompt_ids, generated, params,
                    adapter_id, deadline, reason) -> GenerationCheckpoint:
        ckpt = GenerationCheckpoint.capture(
            request_id=request_id, prompt_ids=prompt_ids, generated=generated,
            params=params, adapter=self._adapter_name(adapter_id),
            model_name=self._ckpt_label, deadline=deadline, reason=reason)
        self.checkpointed_count += 1
        GENERATION_CHECKPOINTS.labels(model_name=self._mlabel, reason=reason).inc()
        return ckpt

    def _checkpoint_slot(self, slot: _Slot, reason: str) -> GenerationCheckpoint:
        """Snapshot a seated slot.  A slot still prefilling has emitted
        nothing new: its checkpoint carries the prompt and what an earlier
        resume had generated, so resuming costs one prefill."""
        if slot.prefilling is not None:
            req = slot.prefilling["req"]
            generated = req.resume["generated"] if req.resume is not None else []
            return self._checkpoint(req.request_id, req.prompt_ids, generated,
                                    req.params, req.adapter_id, req.deadline,
                                    reason)
        return self._checkpoint(slot.request_id, slot.prompt_ids, slot.generated,
                                slot.params, slot.adapter_id, slot.deadline,
                                reason)

    def _evict_slot(self, slot: _Slot, exc: Exception) -> None:
        """Raise `exc` into the slot's stream and release the slot, as
        cancel() does: a dispatch in flight writes the freed pages before
        any later owner's (one stream), and its route drops the tokens of
        a slot whose request went away."""
        slot.queue.put_nowait(exc)
        if slot.timeline is not None:
            if isinstance(exc, GenerationPreempted):
                slot.timeline.add_event(self._clock.now(), "checkpoint")
                self._record_terminal(slot.timeline, "preempted")
            else:
                self._record_terminal(slot.timeline, "error")
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()

    def _checkpoint_waiting(self, reason: str,
                            out: List[GenerationCheckpoint]) -> None:
        """Checkpoint every queued request (fresh arrivals and preempted
        lanes alike) and raise GenerationPreempted into its stream; a
        spilled resume's KV is released (a resume elsewhere re-prefills)."""
        pending, self._waiting = self._waiting, []
        for req in pending:
            self._discard_resume_kv(req)
            generated = list(req.resume["generated"]) if req.resume is not None else []
            ckpt = self._checkpoint(req.request_id, req.prompt_ids, generated,
                                    req.params, req.adapter_id, req.deadline,
                                    reason)
            out.append(ckpt)
            req.queue.put_nowait(GenerationPreempted(ckpt))
            if req.timeline is not None:
                req.timeline.add_event(self._clock.now(), "checkpoint", reason=reason)
                self._record_terminal(req.timeline, "preempted")
        self._set_queue_gauge()

    async def drain(self, deadline: Optional[Deadline] = None, clock=None,
                    poll_s: float = 0.01,
                    reason: str = "drain") -> List[GenerationCheckpoint]:
        """Graceful drain (SIGTERM, POST /admin/drain): stop admitting, let
        seated generations run until `deadline` (the replica's drain budget)
        expires, then snapshot what is left into portable checkpoints,
        raised into each stream as GenerationPreempted.  Queued requests
        are checkpointed at once.  `clock` paces the polls (a FakeClock
        makes the wait virtual); a second signal expires `deadline` in
        place, which the next poll sees.  `reason` labels the checkpoints
        ("drain", or "stall" for the watchdog's self-drain).  Returns the
        checkpoints, newest last (kserve_tpu/engine/engine.py:1741)."""
        self._draining = True
        clk = clock or MONOTONIC
        checkpoints: List[GenerationCheckpoint] = []
        while True:
            # lanes preempted under KV pressure during the drain land back
            # in the queue: each pass checkpoints them instead of re-seating
            self._checkpoint_waiting(reason, checkpoints)
            active = [s for s in self._slots if s.request_id is not None]
            # a legacy batch being prefilled seats its rows when the call
            # returns: wait for them rather than leave them running
            if not active and not self._admitting:
                break
            if active and deadline is not None and deadline.expired:
                for slot in active:
                    ckpt = self._checkpoint_slot(slot, reason)
                    checkpoints.append(ckpt)
                    self._evict_slot(slot, GenerationPreempted(ckpt))
                self._wake.set()
                if not self._admitting:
                    break
            await clk.sleep(poll_s)
        if checkpoints:
            logger.info("drain: %d generation(s) checkpointed (%d tokens salvaged)",
                        len(checkpoints),
                        sum(c.tokens_salvaged for c in checkpoints))
        return checkpoints

    def resume_generation(self, checkpoint: GenerationCheckpoint,
                          request_id: Optional[str] = None
                          ) -> AsyncIterator[GenerationOutput]:
        """Admit a generation checkpointed on another replica (or by the
        JAX package).  It rides the preemption resume: a prefill of prompt
        + generated[:-1] writes the KV, the detokenizer is replayed to the
        checkpoint, and decoding goes on from the last generated token, so
        the spliced stream repeats and drops nothing.  Validation runs
        here, before the stream starts (kserve_tpu/engine/engine.py:1787)."""
        if checkpoint.model_name and checkpoint.model_name != self._ckpt_label:
            raise ValueError(
                f"checkpoint was captured on model {checkpoint.model_name!r} "
                f"but this engine serves {self._ckpt_label!r}; resume "
                "requires identical weights")
        # a header's checkpoint is untrusted: normalize it here, so that a
        # bad value fails this request and not the shared run loop
        checkpoint.validate(self.model_config.vocab_size)
        params = checkpoint.sampling_params()
        prompt_ids = list(checkpoint.prompt_ids)
        if len(prompt_ids) + params.max_tokens > self.config.max_model_len:
            raise ValueError(
                f"prompt+max_tokens exceeds max_model_len {self.config.max_model_len}")
        # max_tokens is the whole budget (tokens before the drain count),
        # so with the bound above this also caps prompt + generated
        if len(checkpoint.generated) >= params.max_tokens:
            raise ValueError(
                f"checkpoint already holds {len(checkpoint.generated)} "
                f"generated tokens with max_tokens={params.max_tokens}; "
                "nothing left to resume")
        self._check_accepting()
        # the budget is the lesser of the snapshot's remainder (anchored on
        # this engine's clock) and the retry's own propagated deadline
        deadline = self._admission_deadline()
        if checkpoint.deadline_remaining_s is not None:
            if checkpoint.deadline_remaining_s <= 0:
                DEADLINE_REJECTED.labels(component="engine").inc()
                raise DeadlineExceededError(
                    "checkpoint deadline budget exhausted before resume")
            snapshot = Deadline.after(checkpoint.deadline_remaining_s, self._clock)
            if deadline is None or snapshot.remaining() < deadline.remaining():
                deadline = snapshot
        # the adapter it was generated under, by name (resuming on other
        # weights would splice another model's continuation)
        adapter_id = self._resolve_adapter(checkpoint.adapter)
        generated = [int(t) for t in checkpoint.generated]
        # unique even when the same checkpoint is replayed twice: cancel()
        # tears down every slot of an id, so two resumes sharing one would
        # have the first to finish evict its sibling
        if request_id is not None:
            rid = request_id
        elif checkpoint.request_id:
            rid = f"{checkpoint.request_id}~r{time.monotonic_ns()}"
        else:
            rid = f"req-{time.monotonic_ns()}"
        tl = self._new_timeline(rid, len(prompt_ids))
        tl.add_event(self._clock.now(), "resume", tokens_salvaged=len(generated))
        req = _QueuedRequest(rid, prompt_ids, params, asyncio.Queue(),
                             timeline=tl, deadline=deadline, adapter_id=adapter_id)
        if generated:
            # the continuation's text deltas pick up where the drained
            # replica's stream stopped
            detok = IncrementalDetokenizer(self.tokenizer)
            for t in generated:
                detok.push(t)
            self._admission_seq += 1
            req.resume = {
                "generated": generated,
                "detok": detok,
                "stop_texts": list(params.stop or []),
                "pos": len(prompt_ids) + len(generated) - 1,
                "admitted_at": self._admission_seq,
                "kv": None,  # across replicas: always re-prefill
            }
        self.resume_count += 1
        GENERATION_RESUMES.labels(model_name=self._mlabel).inc()
        TOKENS_SALVAGED.labels(model_name=self._mlabel).inc(len(generated))
        return self._submit_and_stream(req)

    def _drop_expired_waiting(self) -> None:
        """Fail queued requests whose propagated deadline expired before a
        slot freed (504 at the protocol layer); a spilled resume's KV goes
        back to the tier store (kserve_tpu/engine/engine.py:1960)."""
        kept: List[_QueuedRequest] = []
        for req in self._waiting:
            if req.deadline is None or not req.deadline.expired:
                kept.append(req)
                continue
            self._discard_resume_kv(req)
            DEADLINE_REJECTED.labels(component="engine").inc()
            req.queue.put_nowait(DeadlineExceededError(
                f"request {req.request_id} deadline expired while queued"))
            self._record_terminal(req.timeline, "error")
        if len(kept) != len(self._waiting):
            self._waiting = kept
            self._set_queue_gauge()

    # ---------------- the watchdog and the step deadline ----------------
    # Port of kserve_tpu/engine/engine.py:1257-1360.

    def _has_live_work(self) -> bool:
        """The watchdog's busy probe: seated or queued work."""
        return bool(self._waiting or self._detached_queue) or any(
            s.request_id is not None for s in self._slots)

    def _note_progress(self) -> None:
        if self._watchdog is not None:
            self._watchdog.note_progress()

    def stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()

    def _stall_confirmed(self, reason: str) -> None:
        """The watchdog confirmed a stall: tell the server (readiness) and
        self-drain with checkpoints, so each stream can resume on a healthy
        replica instead of hanging until its client gives up."""
        if self.on_stall_confirmed is not None:
            try:
                self.on_stall_confirmed(reason)
            except Exception:  # noqa: BLE001 — the salvage drain must still run
                logger.exception("on_stall_confirmed hook failed")
        # tracked for stop(), but not stamped for the watchdog's task
        # reaper: it must never cancel its own salvage drain
        task = asyncio.get_running_loop().create_task(self._stall_self_drain())
        self._pagein_tasks.add(task)
        task.add_done_callback(self._pagein_tasks.discard)

    async def _stall_self_drain(self) -> None:
        deadline = Deadline.after(self.config.watchdog_salvage_grace_s, self._clock)
        try:
            checkpoints = await self.drain(deadline=deadline, clock=self._clock,
                                           reason="stall")
            logger.error("watchdog self-drain complete: %d generation(s) "
                         "checkpointed for migration", len(checkpoints))
        except Exception:  # noqa: BLE001 — the stall state is already exported
            logger.exception("watchdog self-drain failed")

    def _fetch_fault_check(self) -> None:
        """The "engine.fetch" fault seam, shared by both fetch paths."""
        if self.fault_plan is not None:
            spec = self.fault_plan.decide("engine.fetch")
            if spec is not None and spec.kind == "wedge":
                raise self._wedge("injected wedge (fault plan)")
            if spec is not None and spec.kind == "replica_crash":
                raise ReplicaCrashError("injected replica crash (fault plan)")

    def _wedge(self, msg: str) -> EngineWedgedError:
        self._wedged = True
        ENGINE_WEDGED.labels(model_name=self._mlabel).set(1)
        return EngineWedgedError(msg)

    def _fetch_timeout(self) -> EngineWedgedError:
        return self._wedge(
            f"device call exceeded step_deadline_s={self.config.step_deadline_s}s"
            " — device wedged?")

    def _fetch(self, fn):
        """Run device call `fn` (a gather and its read back) on the worker
        and wait for it here, under the step deadline (the spill and the
        demotion, whose pages are reused once this returns)."""
        self._fetch_fault_check()
        try:
            return self._fetcher.fetch(fn, self.config.step_deadline_s)
        except TimeoutError:
            raise self._fetch_timeout() from None

    async def _fetch_async(self, fn, *args):
        """Run device call `fn(*args)` (a dispatch, the fetch of its tokens)
        on the worker under the step deadline; the event loop keeps
        answering probes, /admin/drain and admission meanwhile."""
        self._fetch_fault_check()
        wd = self._watchdog
        if wd is not None:
            wd.fetch_started()
        try:
            return await self._fetcher.fetch_async(
                lambda: fn(*args), self.config.step_deadline_s)
        except TimeoutError:
            raise self._fetch_timeout() from None
        finally:
            if wd is not None:
                wd.fetch_done()

    # ---------------- run loop ----------------

    async def _run_loop(self):
        try:
            while not self._stopped:
                did_work = self._land_page_ins()
                if self._detached_queue:
                    await self._run_detached()
                    did_work = True
                # a queued request whose budget died is failed before it
                # costs a prefill
                self._drop_expired_waiting()
                # paused while draining: the queue belongs to drain()'s
                # checkpoints, not to a replica that is going away
                while (not self._draining and self._waiting
                       and self._free_slot_index() is not None):
                    if self._use_mixed:
                        admitted = self._admit_mixed()
                    else:
                        admitted = await self._admit_batch()
                    if not admitted:
                        break
                    did_work = True
                step = self._step_mixed if self._use_mixed else self._step_legacy
                if await step():
                    did_work = True
                self._set_occupancy_gauges()
                if did_work:
                    self._note_progress()
                if not did_work and not self._pageins_ready:
                    self._wake.clear()
                    await self._wake.wait()
                else:
                    await asyncio.sleep(0)
        except Exception as e:  # noqa: BLE001 — engine death must reach every stream
            logger.exception("engine loop crashed")
            self._pipeline_busy = False
            for slot in self._slots:
                if slot.request_id is not None:
                    slot.queue.put_nowait(e)
                    self._record_terminal(slot.timeline, "error")
                    self.allocator.free(slot.pages)
                    slot.reset()
            self._fail_waiting(e)
            self._fail_detached(e)
            # requests a failed _admit_batch took from the queue but never
            # seated
            for _, req, pages, *_ in self._admitting:
                self.allocator.free(pages)
                req.queue.put_nowait(e)
                self._record_terminal(req.timeline, "error")
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

    def _admit_mixed(self) -> bool:
        """Admission on the mixed route: a resume whose KV is in the tier
        store takes the inject path, everything else seats as a
        prefilling slot (kserve_tpu/engine/engine.py:2228)."""
        req = self._waiting[0]
        if req.kv_data is not None or (
                req.resume is not None and req.resume["kv"] is not None):
            return self._admit_injected(req)
        return self._admit_prefilling(req)

    def _admit_prefilling(self, req: _QueuedRequest,
                          hits: Optional[List[int]] = None,
                          keys: Optional[List[bytes]] = None) -> bool:
        """Seat a request as a prefilling slot once its pages (plus decode
        headroom for a long tail or a resume) are free.  Its cached prefix
        pages (`hits`, looked up here unless the caller did) are shared
        and its chunks start after them; a prefix resident in the tiers
        is paged in first (the request is held meanwhile).  An adapter
        request's KV is its adapter's: it shares no cached pages.  A
        preempted request re-prefills its prompt plus all but its last
        generated token (kserve_tpu/engine/engine.py:2250-2328)."""
        idx = self._free_slot_index()
        if idx is None:
            return False
        ps = self.config.page_size
        total = req.kv_len
        need = pages_needed(total + 1, ps)
        if need > self.config.max_pages_per_seq:
            self._waiting.remove(req)
            self._set_queue_gauge()
            req.queue.put_nowait(ValueError(
                f"prompt needs {need} pages > max_pages_per_seq "
                f"{self.config.max_pages_per_seq}"))
            self._record_terminal(req.timeline, "error")
            return True
        seq = req.prompt_ids
        if req.resume is not None:
            seq = req.prompt_ids + req.resume["generated"][:-1]
        if hits is None:
            if req.adapter_id < 0:
                hits, keys = self._prefix_cache.lookup_run(seq)
                if self._maybe_page_in(req, keys, len(hits)):
                    return False  # tier pages uploading; retried on wake
            else:
                hits, keys = [], []
        cached = list(hits)
        # take this request's reference before eviction runs: eviction may
        # drop these pages from the cache, but a live reference keeps them
        # off the free list
        self.allocator.share(cached)
        fresh = need - len(cached)
        headroom = total - len(cached) * ps > self.config.prefill_buckets[-1]
        if not self._prefix_cache.ensure_allocatable(
                self._admission_pages(req, fresh, headroom=headroom)):
            self.allocator.free(cached)
            return False
        pages = cached + self.allocator.allocate(fresh)
        self._waiting.remove(req)
        self._set_queue_gauge()
        if req.timeline is not None:
            req.timeline.mark_admitted(self._clock.now())
        self._count_prefix_hits(keys or [], cached)
        slot = self._slots[idx]
        slot.request_id = req.request_id
        slot.pages = pages
        slot.queue = req.queue
        slot.timeline = req.timeline
        slot.prefilling = {"req": req, "seq": seq, "done": len(cached) * ps,
                           "logits": None}
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
        finishes.  Cold prefix-cache pages are evicted before anything is
        preempted.  Only the oldest lane left alone and starved, one that
        exceeds the whole cache by itself, is truncated ("length").  Port
        of kserve_tpu/engine/engine.py:2563-2641; every lane can be
        preempted (its `_can_preempt` is always true), so the JAX branch
        where starved lanes pause for want of a victim cannot arise."""
        ps = self.config.page_size
        # the "engine.preempt" fault seam: requeue the newest decoding lane
        if self.fault_plan is not None:
            spec = self.fault_plan.decide("engine.preempt")
            if spec is not None and spec.kind == "preempt":
                victims = [s for s in self._slots
                           if s.request_id is not None and s.prefilling is None]
                if victims:
                    self._preempt(max(victims, key=lambda s: s.admitted_at))
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
            # cold cached pages go before anything is preempted
            if self._prefix_cache.ensure_allocatable(1):
                continue
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
                if self._draining:
                    # a drain checkpoints it instead of a "length" that
                    # would not be true: a healthy replica finishes it
                    ckpt = self._checkpoint_slot(slot, "preempt")
                    self._evict_slot(slot, GenerationPreempted(ckpt))
                else:
                    self._finish(slot, "length")

    def _preempt_prefilling(self, slot: _Slot) -> None:
        """Requeue a prefilling slot's request at the front and free its
        pages: it has emitted nothing, so only its chunks are lost."""
        req = slot.prefilling["req"]
        if req.timeline is not None:
            req.timeline.add_event(self._clock.now(), "preempt", phase="prefill")
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
        self._waiting.insert(0, req)
        self._set_queue_gauge()
        self.preemption_count += 1
        ENGINE_PREEMPTIONS.labels(model_name=self._mlabel).inc()
        logger.info("preempted prefilling request %s", req.request_id)

    def _preempt(self, slot: _Slot) -> None:
        """Requeue a decoding slot at the front of the queue and free its
        pages.  With a tier store that can hold them, its KV pages spill
        there (a synchronous gather and fetch) and are injected back on
        resume; otherwise its resume state re-prefills prompt +
        generated[:-1].  Nothing is emitted: the client's stream only
        pauses (kserve_tpu/engine/engine.py:2665-2726)."""
        pos = slot.pos  # the device KV covers positions 0 .. pos-1
        n_pages = pages_needed(pos, self.config.page_size)
        kv_key = None
        # no spill mid-drain: the drain checkpoints the requeued request
        # and a resume elsewhere re-prefills
        if (self._kv_store is not None and not self._draining
                and self._kv_store.would_fit(n_pages * self._page_bytes())):
            payload = self._fetch_pages(slot.pages[:n_pages])
            if self._kv_store.put(slot.request_id, payload):
                kv_key = slot.request_id
                self.kv_tier_counts["spills"] += 1
                self.kv_tier_counts["spilled_bytes"] += payload_nbytes(payload)
        req = _QueuedRequest(slot.request_id, slot.prompt_ids, slot.params,
                             slot.queue, timeline=slot.timeline,
                             deadline=slot.deadline, adapter_id=slot.adapter_id)
        if slot.timeline is not None:
            slot.timeline.add_event(self._clock.now(), "preempt", pos=pos,
                                    spilled=kv_key is not None)
        req.resume = {
            "generated": slot.generated,
            "detok": slot.detok,
            "stop_texts": slot.stop_texts,
            "pos": pos,
            "admitted_at": slot.admitted_at,
            # the spill's key in the tier store (None: re-prefill)
            "kv": kv_key,
        }
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
        self._waiting.insert(0, req)
        self._set_queue_gauge()
        self.preemption_count += 1
        ENGINE_PREEMPTIONS.labels(model_name=self._mlabel).inc()
        logger.info("preempted request %s at position %d (%s)", req.request_id,
                    pos, "KV spilled to the tier store" if kv_key is not None
                    else "will re-prefill")

    # ---------------- the KV hierarchy ----------------
    # Port of kserve_tpu/engine/engine.py:905-1205 (spill bytes, the page
    # gather `_gather_pages_device`, here compiled.gather_pages, demotion,
    # hit counting, persist on reuse, page-in) and :2470-2548 (resume by
    # inject), without the peer leg of the page-in.

    def _page_bytes(self) -> int:
        """Device bytes of one page over every layer (pages and scales)."""
        return sum(t[0].numel() * t.element_size()
                   for layer in self.kv_pages
                   for t in (layer if isinstance(layer, tuple) else (layer,)))

    def _fetch_pages(self, page_ids: List[int]) -> Dict[str, torch.Tensor]:
        """Gather pages and read them back to the host (waits for the
        device): the preemption spill and the prefix demotion, whose
        pages are reused once the call returns."""
        return self._fetch(lambda: {
            name: t.cpu()
            for name, t in gather_pages(self.kv_pages, page_ids).items()})

    def _inject_payload(self, payload: Dict[str, torch.Tensor],
                        page_ids: List[int]) -> None:
        """Enqueue the writes of a payload's pages into `page_ids`."""
        if "kv_q" in payload:
            inject_q(self.kv_pages, payload["kv_q"], payload["kv_s"], page_ids)
        else:
            inject(self.kv_pages, payload["kv"], page_ids)

    def _demote_prefix_pages(self, evicted: List[tuple]) -> None:
        """The prefix cache's eviction seam: gather the evicted pages (one
        gather and a synchronous fetch: the allocator reuses them once
        this returns) and demote them into the host/disk tiers under their
        digest keys.  Tiers only: the persistent layer takes reused pages
        alone, so one-time prompts never grow it.  Digests already
        resident below the device skip the gather.  Skipped while a
        chained dispatch is in flight (the fetch would wait for it): those
        pages drop, which costs a prefill, never correctness."""
        store = self._kv_store
        if (store is None or not store.accepts_prefix_pages
                or self._pipeline_busy or self._stopped):
            return
        pairs = [(k, p) for k, p in evicted if store.prefix_tier_of(k) is None]
        if not pairs:
            return
        fetched = self._fetch_pages([p for _, p in pairs])
        for i, (key, _) in enumerate(pairs):
            # a copy, not a view: a view would keep the whole gather alive
            # while the tier accounts for one page of it
            store.put_prefix(key, {name: t[:, i:i + 1].clone()
                                   for name, t in fetched.items()},
                             persist=False)
        store.record_demotion(len(pairs))

    def _count_prefix_hits(self, keys: List[bytes], hits: List[int]) -> None:
        """An admission served `hits` pages from the prefix cache: count
        them (adopted ones too, once per admission) and write a reused
        prefix through to the persistent layer."""
        if not hits:
            return
        self._prefix_cache.hits += len(hits)
        if keys:
            self._prefix_cache.count_adopted_hits(keys[:len(hits)])
        KV_PREFIX_HIT_TOKENS.labels(model_name=self._mlabel, tier="hbm").inc(
            len(hits) * self.config.page_size)
        if self._kv_store is not None and keys:
            self._maybe_persist_prefix(keys[:len(hits)], hits)

    def _track_task(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        # the watchdog cancels a tracked task alive past its budget
        task._wd_started_s = self._clock.now()
        self._pagein_tasks.add(task)
        task.add_done_callback(self._pagein_tasks.discard)

    def _maybe_persist_prefix(self, keys: List[bytes], pages: List[int]) -> None:
        """Persist on reuse: the gather of the hit pages not yet persisted
        is enqueued now, while the pages are live and referenced; the read
        back and the file writes run on a worker thread."""
        if self._stopped:
            return
        need = [k for k in self._kv_store.needs_persist(keys)
                if k not in self._persisting]
        if not need:
            return
        page_of = dict(zip(keys, pages))
        dev = gather_pages(self.kv_pages, [page_of[k] for k in need])
        self._persisting.update(need)
        self._track_task(self._persist_pages(need, dev))

    async def _persist_pages(self, keys: List[bytes],
                             dev: Dict[str, torch.Tensor]) -> None:
        store = self._kv_store

        def write():
            fetched = {name: t.cpu() for name, t in dev.items()}
            for i, key in enumerate(keys):
                store.put_prefix(key, {name: t[:, i:i + 1].clone()
                                       for name, t in fetched.items()})

        try:
            await asyncio.to_thread(write)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — persistence is an optimization:
            # the pages stay on the device and serving goes on
            logger.exception("prefix persist write-through failed")
        finally:
            for key in keys:
                self._persisting.discard(key)

    def _maybe_page_in(self, req: _QueuedRequest, keys: List[bytes],
                       n_hbm: int) -> bool:
        """When a request's digest chain goes on past its cached run into
        pages resident in the tiers, or advertised by a peer, start an
        asynchronous page-in (a worker thread reads them, the peer client
        fetches and verifies them, one inject writes them, the cache
        adopts them) and hold the request; decoding goes on meanwhile,
        and the retried admission prefills only what is still uncached.
        True: a page-in is pending, do not seat the request yet."""
        if req.pagein == "pending":
            return True
        if (req.pagein == "done" or self._kv_store is None
                or self._stopped or len(keys) <= n_hbm):
            return False
        run = self._kv_store.longest_prefix_run(keys[n_hbm:])
        # the peer leg: the run goes on into digests another replica
        # advertises; peer entries only ever extend the local run's tail
        peer = self._peer_client
        if peer is not None:
            for digest in keys[n_hbm + len(run):]:
                if not any(u != peer.self_url for u in peer.index.peers_for(digest)):
                    break
                run.append((digest, "peer"))
        # room for the pages may come from evicting colder cached pages
        # (which demote in turn); a cache full of hotter pages vetoes it
        if not run or not self._prefix_cache.ensure_allocatable(len(run)):
            req.pagein = "done"  # every retry of this admission is O(1)
            return False
        req.pagein = "pending"
        self._track_task(self._page_in(req, run))
        return True

    async def _page_in(self, req: _QueuedRequest, run: List[tuple]) -> None:
        """Read one tier-resident prefix run back for the device: the tier
        and file reads and the packing run on a worker thread, and the
        packed run waits in `_pageins_ready` for the run loop to land it.
        This task allocates nothing: it runs while a dispatch may still be
        enqueued from a worker thread, and pages a cancel() freed meanwhile
        would be handed to the inject before that dispatch's stale writes."""
        store = self._kv_store
        t0 = time.perf_counter()
        landing = False
        try:
            # the local head reads on a worker thread, the peer tail is
            # fetched over the verified fabric
            n_local = sum(1 for _, tier in run if tier != "peer")
            digests = [d for d, _ in run[:n_local]]
            peer_digests = [d for d, _ in run[n_local:]]

            def read():
                out = []
                for digest in digests:
                    got = store.get_prefix(digest)
                    if got is None:
                        break  # dropped or corrupt meanwhile: truncate
                    out.append(got)
                return out

            payloads = await asyncio.to_thread(read)
            if self._stopped:
                return
            entries = [(digest, payload, tier)
                       for digest, (payload, tier) in zip(digests, payloads)
                       if not self._prefix_cache.contains_key(digest)]
            # a truncated local run leaves the peer tail extending nothing
            # verified: it is dropped; otherwise fetched page by page, the
            # run truncated at the first failure (kserve_tpu/engine/
            # engine.py:1129-1146)
            if (peer_digests and self._peer_client is not None
                    and len(payloads) == len(digests)):
                for digest in peer_digests:
                    if self._stopped or self._draining:
                        return
                    if self._prefix_cache.contains_key(digest):
                        continue
                    payload = await self._peer_client.fetch_page(digest)
                    if payload is None:
                        break  # verification, partition or deadline
                    entries.append((digest, payload, "peer"))
            if self._stopped or not entries:
                return

            def pack():
                names = entries[0][1].keys()
                out = {n: torch.cat([p[n] for _, p, _ in entries], dim=1)
                       for n in names}
                if self.device.type == "cuda":
                    out = {n: t.pin_memory() for n, t in out.items()}
                return out

            packed = await asyncio.to_thread(pack)
            if self._stopped:
                return
            self._pageins_ready.append((req, entries, packed, t0))
            landing = True
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — page-in is an optimization: the
            # held request prefills its whole tail instead
            logger.exception("prefix page-in failed")
        finally:
            if not landing:
                req.pagein = "done"
            self._wake.set()

    def _land_page_ins(self) -> bool:
        """Run loop, between dispatches: allocate the pages of every page-in
        whose reads finished, enqueue their inject (no wait on the device)
        and only then adopt them into the cache, so the held requests'
        retried admissions hit them.  True when one was landed."""
        ready, self._pageins_ready = self._pageins_ready, []
        ps = self.config.page_size
        for req, entries, packed, t0 in ready:
            req.pagein = "done"
            if not self.allocator.can_allocate(len(entries)):
                continue
            pages = self.allocator.allocate(len(entries))
            try:
                self._inject_payload(packed, pages)
            except Exception:  # noqa: BLE001 — as in _page_in
                self.allocator.free(pages)
                logger.exception("prefix page-in failed")
                continue
            # the cache takes over the new pages' references
            self._prefix_cache.adopt(
                [(digest, page) for (digest, _, _), page in zip(entries, pages)])
            pages_by_tier: Dict[str, int] = {}
            for _, _, tier in entries:
                pages_by_tier[tier] = pages_by_tier.get(tier, 0) + 1
            tokens_by_tier = {t: c * ps for t, c in pages_by_tier.items()}
            self._kv_store.record_pagein(pages_by_tier, tokens_by_tier)
            for tier, tokens in tokens_by_tier.items():
                KV_PREFIX_HIT_TOKENS.labels(model_name=self._mlabel,
                                            tier=tier).inc(tokens)
            seconds = time.perf_counter() - t0
            self.pagein_seconds.append(seconds)
            KV_PAGEIN_SECONDS.labels(model_name=self._mlabel).observe(seconds)
            from_peer = [(d, p) for d, p, tier in entries if tier == "peer"]
            if from_peer:
                # a peer's page becomes local (tiers and persistent layer),
                # so the next use does not cross the fabric and this replica
                # advertises it in turn; off the run loop, after the landing
                self._track_task(self._write_through(from_peer))
        return bool(ready)

    async def _write_through(self, pages: List[tuple]) -> None:
        """Write verified peer pages [(digest, payload)] through to the
        local tiers and the persistent layer, on a worker thread."""
        store = self._kv_store

        def write():
            for digest, payload in pages:
                store.put_prefix(digest, payload)

        try:
            await asyncio.to_thread(write)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — an optimization: the pages
            # stay on the device
            logger.exception("peer page write-through failed")

    def _admit_injected(self, req: _QueuedRequest) -> bool:
        """Admit a request whose KV is already on the host (kserve_tpu/
        engine/engine.py:2470-2548): a P/D transfer from a prefill peer
        (seated at len(prompt), emitting the peer's first token) or a
        preempted request's spill in the tier store (seated with its
        stream state, emitting nothing).  A spill the store dropped under
        pressure falls back to the re-prefill path (returns True:
        progress; the next pass takes that path).  The inject stands for
        the request's prefill in its timeline."""
        idx = self._free_slot_index()
        if idx is None:
            return False
        need = pages_needed(req.kv_len + 1, self.config.page_size)
        if need > self.config.max_pages_per_seq:
            return False
        if not self._prefix_cache.ensure_allocatable(
                self._admission_pages(req, need)):
            return False
        if req.resume is not None:
            # get() consumes the spill: only after the capacity checks, so
            # a request that has to wait keeps it
            payload = (self._kv_store.get(req.resume["kv"])
                       if self._kv_store is not None else None)
            if payload is None:
                req.resume["kv"] = None
                return True
        else:
            payload = {"kv": req.kv_data}
        pages = self.allocator.allocate(need)
        self._waiting.remove(req)
        self._set_queue_gauge()
        if req.timeline is not None:
            req.timeline.mark_admitted(self._clock.now())
            req.timeline.mark_prefill_start(self._clock.now())
        entry = (idx, req, pages, None)
        self._admitting.append(entry)
        n_kv = next(iter(payload.values())).shape[1]
        self._inject_payload(payload, pages[:n_kv])
        if req.timeline is not None:
            req.timeline.mark_prefill_end(self._clock.now())
        slot = self._slots[idx]
        slot.request_id, slot.pages, slot.queue = req.request_id, pages, req.queue
        self._admitting.remove(entry)
        if req.resume is not None:
            self.kv_tier_counts["resume_injects"] += 1
            self.kv_tier_counts["injected_bytes"] += payload_nbytes(payload)
            self._seat_resumed(slot, req)
            return True
        # the host KV is in the cache's queue now: drop this reference
        req.kv_data = None
        PROMPT_TOKENS.labels(model_name=self._mlabel).inc(len(req.prompt_ids))
        self._seat_fresh(slot, req, req.first_token)
        self._emit(slot, req.first_token)
        return True

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
        adapters = np.full((B,), -1, np.int32)
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
            adapters[i] = slot.adapter_id
            params_list[i] = slot.params
        if not active.any():
            return None
        lanes = [p for i, p in enumerate(params_list) if active[i]]
        penalized = any(p.has_penalties for p in lanes)
        if penalized:
            self._refresh_penalty_state()
        return {"tokens": tokens, "pos": pos, "active": active,
                "capacity": capacity, "counters": counters, "adapters": adapters,
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
        dispatched_at = self._clock.now()
        chunk_np = await self._fetch_async(self._dispatch, plan)
        self.steps += 1
        self._route_mixed(plan, chunk_np, dispatched_at)
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
                plan["counters"], plan["state"], self._rng, plan["adapters"])
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
        adapters = np.full((B,), -1, np.int32)
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
                adapters[i] = slot.adapter_id
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
            adapters[i] = req.adapter_id
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
            "adapters": adapters,
            "state": SamplingState.from_params(params_list, self.device),
            "consume": consume,
            "chunks": chunks,
            "prefill_tokens": n_prefill_tokens,
            "decode_tokens": n_decode,
        }

    def _route_mixed(self, plan: dict, chunk_np: np.ndarray,
                     dispatched_at: float) -> None:
        """Consume one dispatch's [steps, B] tokens: advance chunk cursors
        (registering the prompt pages a fresh prompt's chunk completed),
        seat lanes whose prompt completed (a fresh one emits its first
        token, a resumed one its stream state and nothing), then stream
        each lane's decode window.  Lanes cancelled while the step ran are
        seen as empty and their tokens dropped."""
        now = self._clock.now()
        step_s = self._record_step(dispatched_at)
        if plan["chunks"] and plan["decode_tokens"] == 0:
            # a dispatch with decode lanes is dominated by its decode loop:
            # only one without them times a prefill chunk (the JAX rule)
            self._record_prefill_chunk(step_s)
        for i, n, final in plan["chunks"]:
            slot = self._slots[i]
            if slot.request_id is None or slot.prefilling is None:
                continue
            pf = slot.prefilling
            pf["done"] += n
            tl = pf["req"].timeline
            if tl is not None:
                tl.mark_prefill_start(dispatched_at)
                tl.mark_prefill_end(now)
            if pf["req"].resume is None and pf["req"].adapter_id < 0:
                self._register_chunk(slot, pf)
            if final:
                self._complete_prefilling(slot, pf["req"], int(chunk_np[0, i]))
        routed = 0
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
                routed += 1
        GENERATED_TOKENS.labels(model_name=self._mlabel).inc(routed)
        if routed or plan["chunks"]:
            self._note_progress()

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
        """Prefill up to `prefill_batch` waiting requests in one call, the
        batch padded to a power of two and the rows to the bucket of the
        longest tail; False when none can be admitted (no slot or no
        pages).  A row with prefix-cache hits prefills only its uncached
        tail: a batch with such a row runs the batched `prefill_chunk`
        with per-row starts, then `sample_first` (the in-prompt mask from
        the whole sequence), a cold batch the fused `prefill`.  A resume
        with spilled KV is injected (`_admit_injected`), a tail longer
        than the largest bucket is admitted alone as a prefilling slot
        (`_admit_chunked`), and a prefix resident in the tiers is paged in
        first.  A resumed request re-prefills prompt + generated[:-1] and
        its sample is discarded (kserve_tpu/engine/engine.py:1990-2175)."""
        ps = self.config.page_size
        chunk_cap = self.config.prefill_buckets[-1]
        # (slot index, request, pages, seq, cached pages)
        admitted: List[tuple] = []
        self._admitting = admitted
        free = [i for i, s in enumerate(self._slots) if s.request_id is None]
        while (self._waiting and free
               and len(admitted) < self.config.prefill_batch):
            req = self._waiting[0]
            if req.kv_data is not None or (
                    req.resume is not None and req.resume["kv"] is not None):
                if admitted:
                    break  # run the batch first
                self._admitting = []
                return self._admit_injected(req)
            seq = req.prompt_ids
            if req.resume is not None:
                seq = req.prompt_ids + req.resume["generated"][:-1]
            # LoRA KV is adapter-specific: only base requests share pages
            hits, pkeys = [], []
            if req.adapter_id < 0:
                hits, pkeys = self._prefix_cache.lookup_run(seq)
            if self._maybe_page_in(req, pkeys, len(hits)):
                # its prefix is uploading; hold it and run what we have
                if admitted:
                    break
                self._admitting = []
                return False
            if req.kv_len - len(hits) * ps > chunk_cap:
                if admitted:
                    break  # run the batch first
                self._admitting = []
                return self._admit_chunked(req, hits, pkeys)
            need = pages_needed(req.kv_len + 1, ps)
            # pin the hits before eviction can free them
            self.allocator.share(hits)
            if not self._prefix_cache.ensure_allocatable(
                    self._admission_pages(req, need - len(hits))):
                self.allocator.free(hits)
                break
            pages = list(hits) + self.allocator.allocate(need - len(hits))
            self._waiting.pop(0)
            self._set_queue_gauge()
            if req.timeline is not None:
                req.timeline.mark_admitted(self._clock.now())
            self._count_prefix_hits(pkeys, hits)
            admitted.append((free.pop(0), req, pages, seq, len(hits)))
        if not admitted:
            return False
        bucket = self._bucket_for(max(len(seq) - c * ps
                                      for *_, seq, c in admitted))
        Bp = 1
        while Bp < len(admitted):
            Bp *= 2
        cold = all(c == 0 for *_, c in admitted)
        width = (self.config.max_pages_per_seq if cold else
                 self.config.page_bucket(max(len(p) for _, _, p, _, _ in admitted)))
        tokens = np.zeros((Bp, bucket), np.int32)
        valid = np.zeros((Bp,), np.int32)
        chunk_start = np.zeros((Bp,), np.int32)
        page_ids = np.zeros((Bp, width), np.int32)
        in_prompt = None if cold else np.zeros(
            (Bp, self.model_config.vocab_size), bool)
        params_list = [SamplingParams()] * Bp
        adapters = np.full((Bp,), -1, np.int32)
        for j, (_, req, pages, seq, c) in enumerate(admitted):
            tail = seq[c * ps:]
            tokens[j, :len(tail)] = tail
            valid[j] = len(tail)
            chunk_start[j] = c * ps
            page_ids[j, :len(pages)] = pages
            params_list[j] = req.params
            adapters[j] = req.adapter_id
            if in_prompt is not None:
                in_prompt[j, np.asarray(seq, np.int64)] = True
        # the logprob variant only when a fresh row asked for logprobs
        want_lp = any(req.resume is None and req.params.logprobs is not None
                      for _, req, *_ in admitted)
        prefill_t0 = self._clock.now()
        if cold:
            name = "prefill_lp" if want_lp else "prefill"
            first, lp = await self._fetch_async(
                self._run_prefill, name, tokens, valid, page_ids, params_list,
                adapters)
            self.legacy_dispatches[name] += 1
        else:
            name = "sample_first_lp" if want_lp else "sample_first"
            first, lp = await self._fetch_async(
                self._run_prefill_hits, name, tokens, chunk_start, valid,
                page_ids, params_list, in_prompt, adapters)
            self.legacy_dispatches["prefill_chunk"] += 1
            self.legacy_dispatches[name] += 1
        prefill_t1 = self._clock.now()
        self._record_prefill_chunk(prefill_t1 - prefill_t0)
        for j, (idx, req, pages, _, _) in enumerate(admitted):
            if req.timeline is not None:
                req.timeline.mark_prefill_start(prefill_t0)
                req.timeline.mark_prefill_end(prefill_t1)
            if req.request_id in self._cancelled_admissions:
                self.allocator.free(pages)  # its client went away meanwhile
                self._record_terminal(req.timeline, "cancelled")
                continue
            slot = self._slots[idx]
            slot.request_id, slot.pages, slot.queue = req.request_id, pages, req.queue
            if req.resume is not None:
                self._seat_resumed(slot, req)  # the sample is discarded
                continue
            # registered before the first token is emitted, which may
            # finish the request and free its pages
            if req.adapter_id < 0:
                self._prefix_cache.register(req.prompt_ids, pages)
            self._complete_prefilling(slot, req, int(first[j]),
                                      self._lp_for(req.params, lp, j))
        self._admitting = []
        self._cancelled_admissions.clear()
        return True

    def _admit_chunked(self, req: _QueuedRequest,
                       hits: Optional[List[int]] = None,
                       keys: Optional[List[bytes]] = None) -> bool:
        """Admit one request whose tail is longer than the largest bucket
        as a prefilling slot, whose chunks `_advance_prefills` runs through
        prefill_chunk (kserve_tpu/engine/engine.py:2241)."""
        return self._admit_prefilling(req, hits, keys)

    def _run_prefill(self, name: str, tokens, valid, page_ids, params_list,
                     adapters):
        """One batched prefill call and the fetch of its first tokens and
        logprobs (worker thread)."""
        with torch.inference_mode():
            state = SamplingState.from_params(params_list, self.device)
            out = self._legacy.get(name)(self.params, tokens, valid,
                                         self.kv_pages, page_ids, state,
                                         self._rng, adapters)
            self.kv_pages = out[-1]
            lp = None
            if name == "prefill_lp":
                lp = tuple(t.cpu().numpy() for t in out[1])
            return out[0].cpu().numpy(), lp

    def _run_prefill_hits(self, name: str, tokens, chunk_start, valid,
                          page_ids, params_list, in_prompt, adapters):
        """A batch with prefix hits (worker thread): one batched
        prefill_chunk over the rows' tails, then sample_first(_lp) of its
        logits, and the fetch of the first tokens and logprobs."""
        with torch.inference_mode():
            logits, self.kv_pages = self._legacy.get("prefill_chunk")(
                self.params, tokens, chunk_start, valid, self.kv_pages, page_ids,
                adapters)
            state = SamplingState.from_params(params_list, self.device)
            out = self._legacy.get(name)(logits, state, self._rng, in_prompt)
            if name == "sample_first":
                return out.cpu().numpy(), None
            return out[0].cpu().numpy(), tuple(t.cpu().numpy() for t in out[1])

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
                chunk_t0 = self._clock.now()
                tl = pf["req"].timeline
                if tl is not None:
                    tl.mark_prefill_start(chunk_t0)
                logits = await self._fetch_async(
                    self._run_prefill_chunk, tokens, done, n, page_ids,
                    pf["req"].adapter_id)
                self.legacy_dispatches["prefill_chunk"] += 1
                chunk_t1 = self._clock.now()
                self._record_prefill_chunk(chunk_t1 - chunk_t0)
                if tl is not None:
                    tl.mark_prefill_end(chunk_t1)
                progressed = True
                if slot.prefilling is not pf:
                    continue  # cancelled while the chunk ran
                pf["logits"], pf["done"] = logits, done + n
                if pf["req"].resume is None and pf["req"].adapter_id < 0:
                    self._register_chunk(slot, pf)
            if pf["done"] >= len(seq):
                await self._finish_prefilling(slot, pf)
                progressed = True
        return progressed

    def _run_prefill_chunk(self, tokens, done: int, n: int, page_ids,
                           adapter_id: int):
        """One prefill_chunk call (worker thread): its last logits."""
        with torch.inference_mode():
            logits, self.kv_pages = self._legacy.get("prefill_chunk")(
                self.params, tokens, [done], [n], self.kv_pages, page_ids,
                [adapter_id])
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
            first, lp = await self._fetch_async(
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
                    *args, self._penalty_prompt, self._penalty_counts,
                    adapter_ids=meta["adapters"])
            else:
                out, self.kv_pages = fn(*args, adapter_ids=meta["adapters"])
            outs = out if isinstance(out, tuple) else (out,)
            return {"name": name, "tokens": outs[0], **self._copy_to_host(outs)}

    async def _launch_chunk(self, meta: dict, prev: Optional[dict] = None) -> dict:
        """Dispatch a legacy decode (chained on `prev`'s device tokens) and
        record it."""
        tokens_dev = None if prev is None else prev["tokens"][-1]
        meta["_dispatched_at"] = self._clock.now()
        chunk = await self._fetch_async(self._dispatch_chunk, meta, tokens_dev)
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
        host = await self._fetch_async(self._wait_host, chunk)
        self._record_step(meta["_dispatched_at"])
        toks, lp = host[0], (host[1:] if len(host) > 1 else None)
        steps = self.config.steps_per_sync
        finished_any = False
        routed = 0
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
                routed += 1
            if slot.request_id is None:
                finished_any = True
            elif slot.pos >= self.config.max_model_len:
                self._finish(slot, "length")
                finished_any = True
        GENERATED_TOKENS.labels(model_name=self._mlabel).inc(routed)
        if routed or finished_any:
            # a depth-2 chain can run long without returning to the loop
            self._note_progress()
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
                    and not (self._stopped or self._draining)):
                meta2 = self._prepare_chunk(prev=meta)
            if meta2 is not None:
                chunk2 = await self._launch_chunk(meta2, prev=chunk)
                self._pipeline_busy = True
            finished_any = await self._route_chunk(meta, chunk)
            await asyncio.sleep(0)  # flush streams while N+1 runs
            if chunk2 is None:
                break
            meta, chunk = meta2, chunk2
            if (finished_any or self._stopped or self._draining
                    or (self._waiting and self._free_slot_index() is not None)):
                # stale lanes, or admission can proceed: drain and re-plan
                self._pipeline_busy = False
                await self._route_chunk(meta, chunk)
                break
        self._pipeline_busy = False

    # ---------------- dense / speculative decode stepping ----------------
    # Port of kserve_tpu/engine/engine.py:3386-3623.  Unlike the JAX engine
    # this one frees a finished lane's pages at once even while a chained
    # dispatch that still writes them is in flight: every dispatch runs on
    # one CUDA stream and pages are allocated only by the run loop between
    # dispatches, so a later owner's writes land after the stale ones and
    # it reads no position it has not written.

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
            "adapters": meta["adapters"], "page_table": meta["page_table"],
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
                    plan["state"], self._rng, plan["adapters"]))
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
        toks_np, n_np = await self._fetch_async(self._wait_host, chunk)
        self._record_step(plan["_dispatched_at"])
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
        GENERATED_TOKENS.labels(model_name=self._mlabel).inc(routed)
        if k > 0:
            spec = SPEC_TOKENS
            spec.labels(model_name=self._mlabel, outcome="drafted").inc(drafted)
            spec.labels(model_name=self._mlabel, outcome="accepted").inc(accepted)
            spec.labels(model_name=self._mlabel,
                        outcome="rejected").inc(drafted - accepted)
            self.spec_stats["drafted"] += drafted
            self.spec_stats["accepted"] += accepted
            self.spec_stats["rejected"] += drafted - accepted
        if routed or finished_any:
            self._note_progress()
        return finished_any, routed > 0

    async def _step_dense(self, meta: dict) -> None:
        """Dense speculative decode with a depth-2 pipeline: dispatch N+1,
        chained on N's device carry, is enqueued before N's tokens are
        routed, so routing N overlaps N+1 on the device."""
        plan = self._plan_dense(meta)
        plan["_dispatched_at"] = self._clock.now()
        chunk = await self._fetch_async(self._dispatch_dense, plan)
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
            if (admission_blocked and not predictable_finish
                    and not (self._stopped or self._draining)):
                plan2 = self._plan_dense_chained(plan)
            if plan2 is not None:
                plan2["_dispatched_at"] = self._clock.now()
                chunk2 = await self._fetch_async(self._dispatch_dense, plan2, chunk)
                self.dense_steps += 1
                self.chained_dispatches += 1
                self._pipeline_busy = True
            finished_any, routed_any = await self._route_dense(plan, chunk)
            await asyncio.sleep(0)  # flush streams while N+1 runs
            if chunk2 is None:
                break
            plan, chunk = plan2, chunk2
            if (finished_any or not routed_any or self._stopped or self._draining
                    or (self._waiting and self._free_slot_index() is not None)):
                # stale lanes, admission can proceed, or every round was
                # skipped for capacity: drain the pipeline and re-plan
                self._pipeline_busy = False
                await self._route_dense(plan, chunk)
                break
        self._pipeline_busy = False

    def _seat_fresh(self, slot: _Slot, req: _QueuedRequest, first_token: int) -> None:
        slot.prefilling = None
        slot.prompt_ids = req.prompt_ids
        slot.prompt_len = len(req.prompt_ids)
        slot.pos = len(req.prompt_ids)  # position of the token decoded next
        slot.generated = [first_token]
        slot.params = req.params
        slot.detok = IncrementalDetokenizer(self.tokenizer)
        slot.stop_texts = list(req.params.stop or [])
        slot.timeline = req.timeline
        slot.deadline = req.deadline
        slot.adapter_id = req.adapter_id
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
        slot.timeline = req.timeline
        slot.deadline = req.deadline
        slot.adapter_id = req.adapter_id
        self._mark_penalty_dirty(self._slots.index(slot))

    def _register_chunk(self, slot: _Slot, pf: dict) -> None:
        """Register the prompt pages a fresh prompt's chunks have filled
        so far, from the first one not yet registered (kserve_tpu/engine/
        engine.py:2370-2382, :3355-3362)."""
        req = pf["req"]
        covered = min(pf["done"], len(req.prompt_ids))
        self._prefix_cache.register(req.prompt_ids[:covered], slot.pages,
                                    start_page=pf.get("registered", 0))
        pf["registered"] = covered // self.config.page_size

    def _complete_prefilling(self, slot: _Slot, req: _QueuedRequest,
                             first_token: Optional[int],
                             lp: tuple = (None, None)) -> None:
        """A prefilling slot's prompt is in the cache: seat it, and a fresh
        request emits its first token.  Shared by the mixed route (the
        token is the dispatch's step-0 sample) and the legacy chunk loop
        (sample_first's), so the two cannot drift (kserve_tpu/engine/
        engine.py:2393).  A resumed base request registers its prompt's
        pages here, once (a fresh one registered them chunk by chunk)."""
        if req.resume is not None:
            if req.adapter_id < 0:
                self._prefix_cache.register(req.prompt_ids, slot.pages)
            self._seat_resumed(slot, req)
            return
        PROMPT_TOKENS.labels(model_name=self._mlabel).inc(len(req.prompt_ids))
        self._seat_fresh(slot, req, first_token)
        self._emit(slot, first_token, *lp)

    def _emit(self, slot: _Slot, token: int, logprob: Optional[float] = None,
              top_logprobs: Optional[list] = None) -> None:
        """Stream one token (with its logprobs, when asked for); apply stop
        conditions."""
        if slot.timeline is not None:
            slot.timeline.mark_token(self._clock.now())
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
            cumulative_text=text,
            logprob=logprob,
            top_logprobs=top_logprobs,
        ))
        if finish_reason is not None:
            self._record_terminal(slot.timeline, finish_reason)
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
            cumulative_text=slot.detok.text,
        ))
        self._record_terminal(slot.timeline, reason)
        self.allocator.free(slot.pages)
        self._mark_penalty_dirty(self._slots.index(slot))
        slot.reset()
