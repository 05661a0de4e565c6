"""Portable generation checkpoints: the unit of preemption-safe resume.

Port of kserve_tpu/lifecycle/checkpoint.py, byte for byte on the wire: a
checkpoint written by either package resumes on the other.  When a drain
budget expires the engine snapshots each live request into a
`GenerationCheckpoint`: prompt ids, every token decoded so far, the
sampling params (the seed too, so a seeded lane stays reproducible), the
LoRA adapter and the remaining request deadline.  It reaches the caller
as a `GenerationPreempted` raised into the stream; the protocol layer
serializes it into the `x-generation-checkpoint` header or body, and a
healthy replica resumes it with `engine.resume_generation(checkpoint)`:
a prefill of prompt + generated[:-1], then decoding from the next token,
with nothing lost and nothing repeated.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import operator
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..protocol.limits import (  # noqa: F401 — re-exported by lifecycle
    CHECKPOINT_FIELD_SIZE_LIMIT,
    CHECKPOINT_HEADER_MAX_BYTES,
)

CHECKPOINT_HEADER = "x-generation-checkpoint"
# RESPONSE headers cross parsers this server does not control (a stock
# aiohttp client stops at 8190 bytes a field): above this size a 503
# carries the checkpoint in its JSON body only
CHECKPOINT_HEADER_SAFE_BYTES = 8000


@dataclass
class GenerationCheckpoint:
    request_id: str
    prompt_ids: List[int]
    generated: List[int] = field(default_factory=list)
    # dataclasses.asdict(SamplingParams): plain JSON types only
    sampling: Dict[str, Any] = field(default_factory=dict)
    adapter: Optional[str] = None
    model_name: Optional[str] = None
    # the request deadline's remaining seconds at the snapshot (None =
    # unbounded), as the x-request-deadline header carries it
    deadline_remaining_s: Optional[float] = None
    # drain (lifecycle drain) | preempt (KV pressure) | stall (watchdog
    # self-drain) | hedge (client-side stall-triggered migration)
    reason: str = "drain"

    @classmethod
    def capture(cls, request_id: str, prompt_ids: List[int],
                generated: List[int], params, adapter: Optional[str] = None,
                model_name: Optional[str] = None, deadline=None,
                reason: str = "drain") -> "GenerationCheckpoint":
        """`params` is an engine.sampling.SamplingParams, `deadline` a
        resilience.Deadline (or None)."""
        return cls(
            request_id=request_id,
            prompt_ids=[int(t) for t in prompt_ids],
            generated=[int(t) for t in generated],
            sampling=dataclasses.asdict(params),
            adapter=adapter,
            model_name=model_name,
            deadline_remaining_s=(max(deadline.remaining(), 0.0)
                                  if deadline is not None else None),
            reason=reason,
        )

    # the SamplingParams wire schema (tests/test_torch_lifecycle.py pins it
    # against the dataclass's fields)
    _SAMPLING_FLOATS = ("temperature", "top_p", "min_p", "repetition_penalty",
                        "frequency_penalty", "presence_penalty")
    _SAMPLING_INTS = ("top_k", "max_tokens", "min_tokens")
    _SAMPLING_OPT_INTS = ("seed", "logprobs")

    def validate(self, vocab_size: Optional[int] = None) -> "GenerationCheckpoint":
        """Normalize and bounds-check a checkpoint from the wire before an
        engine admits it.  Every field is untrusted: a non-integer or
        out-of-vocabulary id or a non-numeric sampling value raises
        ValueError to THIS caller, where admitted raw it would crash the
        shared run loop.  Mutates in place (ids to int, unknown sampling
        keys dropped, for rollouts) and returns self."""
        self.prompt_ids = self._int_ids("prompt_ids", self.prompt_ids, vocab_size)
        if not self.prompt_ids:
            raise ValueError("invalid checkpoint: empty prompt_ids")
        self.generated = self._int_ids("generated", self.generated, vocab_size)
        if not isinstance(self.sampling, dict):
            raise ValueError("invalid checkpoint: sampling must be an object")
        sampling: Dict[str, Any] = {}
        try:
            for key in self._SAMPLING_FLOATS:
                if key in self.sampling:
                    sampling[key] = float(self.sampling[key])
            for key in self._SAMPLING_INTS:
                if key in self.sampling:
                    sampling[key] = self._bounded_int(key, self.sampling[key])
            for key in self._SAMPLING_OPT_INTS:
                value = self.sampling.get(key)
                if key in self.sampling:
                    sampling[key] = (None if value is None
                                     else self._bounded_int(key, value))
        except (TypeError, ValueError) as exc:
            raise ValueError(f"invalid checkpoint: bad sampling value ({exc})") from exc
        if "ignore_eos" in self.sampling:
            sampling["ignore_eos"] = bool(self.sampling["ignore_eos"])
        stop = self.sampling.get("stop")
        if stop is not None:
            if not isinstance(stop, list) or any(not isinstance(s, str) for s in stop):
                raise ValueError("invalid checkpoint: stop must be a list of strings")
            sampling["stop"] = stop
        elif "stop" in self.sampling:
            sampling["stop"] = None
        # anything else is dropped: a newer replica's checkpoint must not
        # fail here on fields it added
        self.sampling = sampling
        return self

    @staticmethod
    def _bounded_int(field_name: str, value) -> int:
        """An untrusted sampling int, bounded to int32 (the engine uploads
        these as int32 tensors, where a larger one would raise inside the
        shared run loop)."""
        out = operator.index(value)
        if not -(2 ** 31) <= out < 2 ** 31:
            raise ValueError(f"{field_name} {out} outside int32 range")
        return out

    @staticmethod
    def _int_ids(field_name: str, values, vocab_size: Optional[int]) -> List[int]:
        try:
            ids = [operator.index(t) for t in values]
        except TypeError as exc:
            raise ValueError(
                f"invalid checkpoint: {field_name} must be integer token ids"
            ) from exc
        if vocab_size is not None:
            for t in ids:
                if not 0 <= t < vocab_size:
                    raise ValueError(
                        f"invalid checkpoint: {field_name} id {t} outside "
                        f"vocab [0, {vocab_size})")
        return ids

    @property
    def tokens_salvaged(self) -> int:
        return len(self.generated)

    def sampling_params(self):
        """The engine's SamplingParams of this checkpoint."""
        from ..engine.sampling import SamplingParams

        return SamplingParams(**self.sampling)

    # ---------------- wire forms ----------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "GenerationCheckpoint":
        if not isinstance(data, dict):
            raise ValueError(f"checkpoint must be an object, got {type(data).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        # unknown keys are dropped, so a newer replica's checkpoint resumes
        # on an older one during a rollout
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_json(cls, raw: str) -> "GenerationCheckpoint":
        return cls.from_dict(json.loads(raw))

    def to_header(self) -> str:
        """The base64 form of the x-generation-checkpoint header."""
        return base64.b64encode(self.to_json().encode("utf-8")).decode("ascii")

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["GenerationCheckpoint"]:
        """Parse the header form; a malformed value gives None (a
        checkpoint is a resume optimization, not an input schema)."""
        if not value:
            return None
        try:
            return cls.from_json(base64.b64decode(value).decode("utf-8"))
        except (ValueError, TypeError, KeyError):
            return None


class GenerationPreempted(Exception):
    """Raised into a generation's stream when this replica checkpointed it
    (drain budget expired, shutdown escalated, a watchdog self-drain): 503
    with the checkpoint at the protocol layer, which the client or the EPP
    resumes on a healthy replica."""

    def __init__(self, checkpoint: GenerationCheckpoint, reason: Optional[str] = None):
        self.checkpoint = checkpoint
        self.reason = reason or checkpoint.reason
        super().__init__(
            f"generation {checkpoint.request_id} preempted ({self.reason}); "
            f"{checkpoint.tokens_salvaged} decoded tokens checkpointed for resume")
