"""Engine runtime types: configuration, the output record, slot and
queue bookkeeping, and the deadline-guarded device fetcher.

Port of kserve_tpu/engine/types.py (EngineConfig :36 with the fields the
port uses, the step deadline :44 and the watchdog knobs :181-186 among
them, spec_decode_k_from_env :210, EngineWedgedError :235, the fetcher
_DeadlineFetcher :240, GenerationOutput :317 with its logprobs, _Slot
:331 with its deadline and LoRA adapter id, _QueuedRequest :359 with its
deadline, its adapter id, its `resume` state, its `pagein` state, its
`timeline` and `kv_len`).  The knobs the port does not run yet
(tp/dp/sp/pp) are kept so a configuration asking for them is rejected at
engine construction instead of silently ignored.
"""

from __future__ import annotations

import asyncio
import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..kvstore.tiers import DEFAULT_DISK_DIR

logger = logging.getLogger(__name__)


@dataclass
class EngineConfig:
    max_batch_size: int = 8
    page_size: int = 16
    num_pages: int = 2048
    # wedge detection: a device call (a dispatch and the fetch of its
    # tokens) that outlasts this marks the engine wedged, and /v2/health/
    # live goes red so the pod restarts instead of hanging.  On CUDA the
    # kernel library is loaded before the engine reports ready, so no
    # served call includes an nvcc build.
    step_deadline_s: float = 300.0
    max_pages_per_seq: int = 128
    max_prefill_len: int = 1024
    prefill_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    dtype: str = "bfloat16"  # KV cache dtype
    # decode steps run per dispatch (the `mixed` loop); streaming
    # granularity is this many tokens
    steps_per_sync: int = 8
    # speculative decoding: K draft tokens per lane verified per round of
    # the dense `mixed_decode` program (0 = dense packing alone; None = off)
    spec_decode_k: Optional[int] = None
    # int8 KV (kvcache.py): pages int8 with per-row f32 scales, half the
    # bytes of a bf16 cache; `dtype` then names the activations
    kv_quant: str = "none"  # none | int8
    # legacy programs (engine/compiled.py): prompts per batched `prefill`
    # call, and the top-k width of every logprobs program (the most
    # alternatives a request may ask for)
    prefill_batch: int = 8
    max_logprobs: int = 20
    # the unified ragged `mixed` program: None = use it when the batch
    # fits one packed buffer (max_batch_size x the kernel block <= the
    # largest prefill bucket), else the legacy programs for the whole
    # engine; True = require it (raises where it does not fit); False =
    # the legacy programs always.  Under the mixed program an iteration
    # with a lane that asks for logprobs or penalties still runs the
    # legacy programs.
    use_ragged: Optional[bool] = None
    # prefix cache (engine/prefix_cache.py): full prompt pages are kept
    # (refcounted, LRU-evicted under pressure) and shared by later
    # requests with the same page-aligned prefix, which prefill only their
    # uncached tail.  None = on (the engine resolves it on its own copy)
    prefix_cache: Optional[bool] = None
    # KV tiers (kvstore/): "none" re-prefills a preempted lane on resume;
    # "host" spills its KV pages to host RAM (kv_offload_gib) over an
    # optional disk tier (kv_offload_disk_gib > 0, files under
    # kv_offload_dir) with lru/arc eviction between them, and injects
    # them back on resume.  The same tiers take evicted prefix pages.
    # An entry dropped under pressure is prefilled again.
    kv_offload: str = "none"  # none | host
    kv_offload_gib: float = 0.0
    kv_offload_disk_gib: float = 0.0
    kv_offload_dir: str = DEFAULT_DISK_DIR
    kv_offload_policy: str = "lru"  # lru | arc
    # persistent prefix store (kvstore/persist.py): reused prefix pages
    # are written as digest-named files here, and a restarted engine pages
    # them back in on first use.  None = off ($KSERVE_TPU_KV_PERSIST in
    # the server)
    kv_persist_dir: Optional[str] = None
    # gray-failure watchdog (engine/watchdog.py): seated or queued work
    # with no forward motion past suspect + confirm flips readiness and
    # self-drains with checkpoints.  Off by default ($KSERVE_TPU_WATCHDOG
    # in the server)
    watchdog: bool = False
    watchdog_interval_s: float = 0.5
    watchdog_suspect_s: float = 5.0
    watchdog_confirm_s: float = 5.0
    watchdog_task_stall_s: float = 30.0
    watchdog_salvage_grace_s: float = 0.0
    # "int8": int8 linears with f32 per-channel scales (models/quant.py)
    weight_quant: str = "none"
    # drive one tiny generation through the serving loop in start(),
    # BEFORE the engine reports ready: the first dispatch of a process
    # loads torch's and cuBLAS's kernels lazily (seconds on the card),
    # which would otherwise land in the first served request and read as
    # a stall to the watchdog.  None = auto (on when the engine runs on
    # CUDA); the JAX package's knob, whose auto follows its AOT cache
    aot_warmup: Optional[bool] = None
    # not run by this port yet: any other value is rejected
    tp: int = 1
    dp: int = 1
    sp: int = 1
    pp: int = 1

    def __post_init__(self):
        # buckets must reach max_prefill_len or long prompts would overflow
        buckets = sorted(
            {b for b in self.prefill_buckets if b <= self.max_prefill_len}
            | {self.max_prefill_len}
        )
        self.prefill_buckets = tuple(buckets)

    @property
    def max_model_len(self) -> int:
        return self.max_pages_per_seq * self.page_size

    def page_bucket(self, n_pages: int) -> int:
        """Page-table width bucket (pow2): attention only gathers as many
        pages as the longest active sequence owns."""
        b = 8
        while b < n_pages:
            b *= 2
        return min(b, self.max_pages_per_seq)


def spec_decode_k_from_env() -> Optional[int]:
    """$KSERVE_TPU_SPEC_DECODE_K -> EngineConfig.spec_decode_k: unset or
    empty = off (None); an integer >= 0 enables speculative decoding with
    that K.  A malformed value is logged and ignored rather than crash the
    server on a typo."""
    raw = os.environ.get("KSERVE_TPU_SPEC_DECODE_K", "").strip()
    if not raw:
        return None
    try:
        k = int(raw)
    except ValueError:
        k = -1
    if k < 0:
        logger.warning("ignoring malformed KSERVE_TPU_SPEC_DECODE_K=%r (want "
                       "an integer >= 0)", raw)
        return None
    return k


class EngineWedgedError(RuntimeError):
    """A device call outlasted step_deadline_s: the device is taken to be
    wedged, and liveness fails until the pod restarts."""


class _LoopNotify:
    """threading.Event-shaped completion signal for fetch_async: the
    worker's set() is marshalled onto the event loop."""

    __slots__ = ("_loop", "_event")

    def __init__(self, loop: asyncio.AbstractEventLoop, event: asyncio.Event):
        self._loop = loop
        self._event = event

    def set(self) -> None:
        try:
            self._loop.call_soon_threadsafe(self._event.set)
        except RuntimeError:
            pass  # the loop closed during shutdown; nobody waits


class _DeadlineFetcher:
    """One daemon worker thread that runs the engine's device calls (a
    dispatch and the fetch of its tokens) under a deadline.  A CUDA
    synchronize cannot be cancelled, so a call that times out leaves the
    worker stuck, and every later call waits behind it and times out too;
    the thread is a daemon so that it never blocks interpreter exit.  The
    event loop only awaits an asyncio event, so probes, /admin/drain and
    admission answer while a call computes."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-fetch")
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done = item
            try:
                box.append(("ok", fn()))
            except BaseException as exc:  # noqa: BLE001 — relayed to the waiting caller
                box.append(("err", exc))
            done.set()

    def _check_open(self) -> None:
        if self._closed:
            # fail fast instead of waiting a whole deadline on a dead queue
            raise RuntimeError("engine stopped")

    @staticmethod
    def _unbox(box: list):
        kind, value = box[0]
        if kind == "err":
            raise value
        return value

    def fetch(self, fn, timeout_s: float):
        """Run `fn` on the worker and wait for it (blocking)."""
        self._check_open()
        box: list = []
        done = threading.Event()
        self._q.put((fn, box, done))
        if not done.wait(timeout_s):
            raise TimeoutError(f"fetch exceeded {timeout_s}s")
        return self._unbox(box)

    async def fetch_async(self, fn, timeout_s: float):
        """Run `fn` on the worker; the event loop keeps serving meanwhile."""
        self._check_open()
        loop = asyncio.get_running_loop()
        event = asyncio.Event()
        box: list = []
        self._q.put((fn, box, _LoopNotify(loop, event)))
        try:
            await asyncio.wait_for(event.wait(), timeout_s)
        except asyncio.TimeoutError:
            raise TimeoutError(f"fetch exceeded {timeout_s}s") from None
        return self._unbox(box)

    def close(self):
        self._closed = True
        self._q.put(None)


@dataclass
class GenerationOutput:
    token_id: int
    text_delta: str
    finished: bool = False
    finish_reason: Optional[str] = None
    num_generated: int = 0
    # the whole text so far (a resumed stream's includes the checkpointed
    # tokens': the detokenizer was replayed through them)
    cumulative_text: str = ""
    # the token's log-probability and the request's top alternatives as
    # (token id, logprob), best first; None unless it asked for logprobs
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


class _Slot:
    """Host-side state for one decode lane."""

    __slots__ = (
        "request_id", "prompt_ids", "prompt_len", "pages", "pos", "generated",
        "params", "queue", "detok", "stop_texts", "prefilling", "admitted_at",
        "timeline", "deadline", "adapter_id",
    )

    def __init__(self):
        self.request_id: Optional[str] = None
        # the occupant's LoRA stack row (-1 = the base model)
        self.adapter_id = -1
        # chunked prefill in progress: {"req", "seq", "done", "logits"};
        # each mixed step, or each legacy prefill_chunk call, carries the
        # lane's next chunk ("logits": the last legacy chunk's, which the
        # first token is sampled from)
        self.prefilling: Optional[dict] = None
        # the occupant's observability.RequestTimeline
        self.timeline = None
        # the occupant's resilience.Deadline (None = unbounded): a drain's
        # checkpoint carries what is left of it
        self.deadline = None

    def reset(self):
        self.request_id = None
        self.prefilling = None
        self.timeline = None
        self.deadline = None
        self.adapter_id = -1


class _QueuedRequest:
    def __init__(self, request_id, prompt_ids, params, queue, timeline=None,
                 deadline=None, adapter_id: int = -1, kv_data=None,
                 first_token: Optional[int] = None):
        self.request_id = request_id
        self.prompt_ids: List[int] = prompt_ids
        self.params = params
        self.queue = queue
        # LoRA stack row (-1 = the base model); it survives preemption and
        # a drain checkpoint carries its adapter's name
        self.adapter_id = adapter_id
        # resilience.Deadline captured at submit: a request whose budget
        # dies while it waits is failed with DeadlineExceededError
        self.deadline = deadline
        # observability.RequestTimeline, stamped received at submit
        self.timeline = timeline
        # P/D disaggregation: the prompt's KV computed by a prefill-role
        # server (a CPU tensor [L, P, 2, n_kv, ps, d]) and its sampled
        # first token; admission injects the pages instead of prefilling
        self.kv_data = kv_data
        self.first_token = first_token
        # a preempted request's stream state, restored when it seats again:
        # {"generated", "detok", "stop_texts", "pos", "admitted_at", "kv"};
        # "kv" is its spill's key in the tier store (None: re-prefill)
        self.resume: Optional[dict] = None
        # page-in of a tier-resident prefix (engine._maybe_page_in): None =
        # not consulted yet, "pending" = an upload is in flight (admission
        # waits, decoding goes on), "done" = consulted: admit on what the
        # device prefix cache holds now
        self.pagein: Optional[str] = None

    @property
    def kv_len(self) -> int:
        """Token positions whose KV must exist before decoding starts."""
        return self.resume["pos"] if self.resume else len(self.prompt_ids)
