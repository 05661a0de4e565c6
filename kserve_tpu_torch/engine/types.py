"""Engine runtime types: configuration, the output record, and slot and
queue bookkeeping.

Port of kserve_tpu/engine/types.py (EngineConfig :36 with the fields the
port uses, spec_decode_k_from_env :210, GenerationOutput :317 with its
logprobs, _Slot :331, _QueuedRequest :359 with its `resume` state, its
`pagein` state, its `timeline` and `kv_len`).  The knobs the port does
not run yet (weight_quant, tp/dp/sp/pp) are kept so a configuration
asking for them is rejected at engine construction instead of silently
ignored.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..kvstore.tiers import DEFAULT_DISK_DIR

logger = logging.getLogger(__name__)


@dataclass
class EngineConfig:
    max_batch_size: int = 8
    page_size: int = 16
    num_pages: int = 2048
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
    # not run by this port yet: any other value is rejected
    weight_quant: str = "none"
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


@dataclass
class GenerationOutput:
    token_id: int
    text_delta: str
    finished: bool = False
    finish_reason: Optional[str] = None
    num_generated: int = 0
    # the token's log-probability and the request's top alternatives as
    # (token id, logprob), best first; None unless it asked for logprobs
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


class _Slot:
    """Host-side state for one decode lane."""

    __slots__ = (
        "request_id", "prompt_ids", "prompt_len", "pages", "pos", "generated",
        "params", "queue", "detok", "stop_texts", "prefilling", "admitted_at",
        "timeline",
    )

    def __init__(self):
        self.request_id: Optional[str] = None
        # chunked prefill in progress: {"req", "seq", "done", "logits"};
        # each mixed step, or each legacy prefill_chunk call, carries the
        # lane's next chunk ("logits": the last legacy chunk's, which the
        # first token is sampled from)
        self.prefilling: Optional[dict] = None
        # the occupant's observability.RequestTimeline
        self.timeline = None

    def reset(self):
        self.request_id = None
        self.prefilling = None
        self.timeline = None


class _QueuedRequest:
    def __init__(self, request_id, prompt_ids, params, queue, timeline=None):
        self.request_id = request_id
        self.prompt_ids: List[int] = prompt_ids
        self.params = params
        self.queue = queue
        # observability.RequestTimeline, stamped received at submit
        self.timeline = timeline
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
