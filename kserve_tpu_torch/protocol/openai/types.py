"""OpenAI completion, chat, embedding and rerank types as standard-library
dataclasses.

Port of kserve_tpu/protocol/openai/types.py (the fields the port serves,
logprobs and sampling penalties among them, and the logprob blocks of
the responses) with hand validation in place of pydantic, which the card
machine does not have.  `CompletionRequest.from_json` /
`ChatCompletionRequest.from_json` raise InvalidInput (HTTP 400) on a
malformed body, and on what the port refuses: `logit_bias`, `echo`,
`best_of`, `suffix`.  `EmbeddingRequest.from_json` and
`RerankRequest.from_json` take the pydantic models' fields and defaults
(:259-304) and raise InvalidInput where those fail validation.  Responses serialize with `to_dict()`, dropping None
fields as the JAX package's `model_dump(exclude_none=True)` does.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from ...errors import InvalidInput


def random_uuid(prefix: str = "") -> str:
    return f"{prefix}{uuid.uuid4().hex}"


def _drop_none(value):
    if isinstance(value, dict):
        return {k: _drop_none(v) for k, v in value.items() if v is not None}
    if isinstance(value, list):
        return [_drop_none(v) for v in value]
    return value


class _Serializable:
    def to_dict(self) -> dict:
        return _drop_none(dataclasses.asdict(self))


def _get(body: dict, name: str, kinds, default=None, *, required=False):
    """body[name] checked against `kinds` (bool is never an int here)."""
    if name not in body or body[name] is None:
        if required:
            raise InvalidInput(f"missing required field {name!r}")
        return default
    value = body[name]
    kinds = kinds if isinstance(kinds, tuple) else (kinds,)
    accepted = kinds + (int,) if float in kinds else kinds  # JSON 0 is a float too
    if (isinstance(value, bool) and bool not in kinds) or not isinstance(value, accepted):
        raise InvalidInput(f"field {name!r} must be {_names(kinds)}")
    if float in kinds and isinstance(value, int):
        value = float(value)
    return value


def _names(kinds) -> str:
    return " or ".join(k.__name__ for k in kinds)


def _check_refused(body: dict) -> None:
    """Fields the port does not serve: 400 rather than silently ignored."""
    if body.get("logit_bias"):
        raise InvalidInput("logit_bias is not supported by this server yet")
    if body.get("echo"):
        raise InvalidInput("echo is not supported by this server yet")
    if body.get("best_of") not in (None, 1):
        raise InvalidInput("best_of is not supported by this server yet")
    if body.get("suffix"):
        raise InvalidInput("suffix is not supported by this server yet")


def _sampling_fields(body: dict) -> dict:
    out = dict(
        temperature=_get(body, "temperature", float, 1.0),
        top_p=_get(body, "top_p", float, 1.0),
        top_k=_get(body, "top_k", int),
        min_p=_get(body, "min_p", float),
        seed=_get(body, "seed", int),
        ignore_eos=_get(body, "ignore_eos", bool, False),
        min_tokens=_get(body, "min_tokens", int, 0),
        n=_get(body, "n", int, 1),
        stream=_get(body, "stream", bool, False),
        frequency_penalty=_get(body, "frequency_penalty", float, 0.0),
        presence_penalty=_get(body, "presence_penalty", float, 0.0),
        repetition_penalty=_get(body, "repetition_penalty", float),
    )
    if out["temperature"] < 0:
        raise InvalidInput("temperature must be >= 0")
    if not 0.0 < out["top_p"] <= 1.0:
        raise InvalidInput("top_p must be in (0, 1]")
    if out["top_k"] is not None and out["top_k"] < 0:
        raise InvalidInput("top_k must be >= 0")
    if out["min_p"] is not None and not 0.0 <= out["min_p"] <= 1.0:
        raise InvalidInput("min_p must be in [0, 1]")
    if out["n"] < 1:
        raise InvalidInput("n must be >= 1")
    stop = body.get("stop")
    if stop is not None and not (
            isinstance(stop, str)
            or (isinstance(stop, list) and all(isinstance(s, str) for s in stop))):
        raise InvalidInput("field 'stop' must be a string or a list of strings")
    out["stop"] = stop
    opts = _get(body, "stream_options", dict)
    out["include_usage"] = bool(opts and opts.get("include_usage"))
    return out


@dataclass
class UsageInfo(_Serializable):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclass
class ModelCard(_Serializable):
    id: str
    object: str = "model"
    created: int = field(default_factory=lambda: int(time.time()))
    owned_by: str = "kserve-tpu-torch"


@dataclass
class ModelList(_Serializable):
    object: str = "list"
    data: List[ModelCard] = field(default_factory=list)


@dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: bool = False
    include_usage: bool = False
    ignore_eos: bool = False
    min_tokens: int = 0
    n: int = 1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: Optional[float] = None
    logprobs: Optional[int] = None  # top alternatives per token

    @staticmethod
    def from_json(body: Any) -> "CompletionRequest":
        if not isinstance(body, dict):
            raise InvalidInput("request body must be a JSON object")
        _check_refused(body)
        prompt = body.get("prompt")
        ok = isinstance(prompt, str) or (
            isinstance(prompt, list) and prompt and (
                all(isinstance(p, str) for p in prompt)
                or all(isinstance(p, int) and not isinstance(p, bool) for p in prompt)
                or all(isinstance(p, list) and p and all(
                    isinstance(t, int) and not isinstance(t, bool) for t in p)
                    for p in prompt)))
        if not ok:
            raise InvalidInput(
                "field 'prompt' must be a string, a list of strings, a list "
                "of token ids or a list of token-id lists")
        max_tokens = _get(body, "max_tokens", int, 16)
        if max_tokens < 1:
            raise InvalidInput("max_tokens must be >= 1")
        return CompletionRequest(
            model=_get(body, "model", str, required=True), prompt=prompt,
            max_tokens=max_tokens, logprobs=_get(body, "logprobs", int),
            **_sampling_fields(body))


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class ChatCompletionRequest:
    model: str
    messages: List[ChatMessage]
    max_tokens: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stream: bool = False
    include_usage: bool = False
    ignore_eos: bool = False
    min_tokens: int = 0
    n: int = 1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: Optional[float] = None
    logprobs: bool = False  # the chat dialect: a gate ...
    top_logprobs: Optional[int] = None  # ... and the alternatives' count

    @staticmethod
    def from_json(body: Any) -> "ChatCompletionRequest":
        if not isinstance(body, dict):
            raise InvalidInput("request body must be a JSON object")
        _check_refused(body)
        raw = body.get("messages")
        if not isinstance(raw, list) or not raw:
            raise InvalidInput("field 'messages' must be a non-empty list")
        messages = []
        for m in raw:
            if not isinstance(m, dict) or not isinstance(m.get("role"), str):
                raise InvalidInput("every message needs a string 'role'")
            content = m.get("content")
            if isinstance(content, list):
                # text parts only; other parts carry nothing this model reads
                if not all(isinstance(p, dict) for p in content):
                    raise InvalidInput("message content parts must be objects")
                content = "".join(
                    str(p.get("text") or "") for p in content
                    if p.get("type") == "text")
            elif content is None:
                content = ""
            elif not isinstance(content, str):
                raise InvalidInput("message content must be a string or a list of parts")
            messages.append(ChatMessage(role=m["role"], content=content))
        max_tokens = (_get(body, "max_completion_tokens", int)
                      or _get(body, "max_tokens", int))
        if max_tokens is not None and max_tokens < 1:
            raise InvalidInput("max_tokens must be >= 1")
        return ChatCompletionRequest(
            model=_get(body, "model", str, required=True), messages=messages,
            max_tokens=max_tokens, logprobs=_get(body, "logprobs", bool, False),
            top_logprobs=_get(body, "top_logprobs", int), **_sampling_fields(body))


@dataclass
class CompletionLogprobs(_Serializable):
    """The legacy completions logprobs block: per token its text, offset
    and logprob, and with top alternatives a {token text: logprob} dict."""
    text_offset: List[int] = field(default_factory=list)
    token_logprobs: List[Optional[float]] = field(default_factory=list)
    tokens: List[str] = field(default_factory=list)
    top_logprobs: Optional[List[Optional[Dict[str, float]]]] = None


@dataclass
class CompletionChoice(_Serializable):
    index: int
    text: str
    finish_reason: Optional[str] = None
    logprobs: Optional[CompletionLogprobs] = None


@dataclass
class Completion(_Serializable):
    id: str = field(default_factory=lambda: random_uuid("cmpl-"))
    object: str = "text_completion"
    created: int = field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = field(default_factory=list)
    usage: Optional[UsageInfo] = None


@dataclass
class ChatCompletionLogprob(_Serializable):
    token: str
    logprob: float = -9999.0
    bytes: Optional[List[int]] = None


@dataclass
class ChatCompletionLogprobsContent(_Serializable):
    token: str
    logprob: float = -9999.0
    bytes: Optional[List[int]] = None
    top_logprobs: List[ChatCompletionLogprob] = field(default_factory=list)


@dataclass
class ChatCompletionLogprobs(_Serializable):
    content: Optional[List[ChatCompletionLogprobsContent]] = None


@dataclass
class ChatCompletionResponseMessage(_Serializable):
    role: str = "assistant"
    content: Optional[str] = None


@dataclass
class ChatCompletionChoice(_Serializable):
    index: int
    message: ChatCompletionResponseMessage
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatCompletionLogprobs] = None


@dataclass
class ChatCompletion(_Serializable):
    id: str = field(default_factory=lambda: random_uuid("chatcmpl-"))
    object: str = "chat.completion"
    created: int = field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionChoice] = field(default_factory=list)
    usage: Optional[UsageInfo] = None


@dataclass
class ChatCompletionChunkDelta(_Serializable):
    role: Optional[str] = None
    content: Optional[str] = None


@dataclass
class ChatCompletionChunkChoice(_Serializable):
    index: int
    delta: ChatCompletionChunkDelta
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatCompletionLogprobs] = None


@dataclass
class ChatCompletionChunk(_Serializable):
    id: str = field(default_factory=lambda: random_uuid("chatcmpl-"))
    object: str = "chat.completion.chunk"
    created: int = field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionChunkChoice] = field(default_factory=list)
    usage: Optional[UsageInfo] = None


# ---------------- embeddings / rerank ----------------


def _is_ids(value) -> bool:
    return isinstance(value, list) and all(
        isinstance(t, int) and not isinstance(t, bool) for t in value)


@dataclass
class EmbeddingRequest:
    model: str
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: str = "float"
    dimensions: Optional[int] = None
    user: Optional[str] = None

    @staticmethod
    def from_json(body: Any) -> "EmbeddingRequest":
        if not isinstance(body, dict):
            raise InvalidInput("request body must be a JSON object")
        value = body.get("input")
        if not (isinstance(value, str) or (isinstance(value, list) and (
                all(isinstance(v, str) for v in value) or _is_ids(value)
                or all(_is_ids(v) for v in value)))):
            raise InvalidInput(
                "field 'input' must be a string, a list of strings, a list of "
                "token ids or a list of token-id lists")
        fmt = _get(body, "encoding_format", str, "float")
        if fmt not in ("float", "base64"):
            raise InvalidInput("field 'encoding_format' must be 'float' or 'base64'")
        return EmbeddingRequest(
            model=_get(body, "model", str, required=True), input=value,
            encoding_format=fmt, dimensions=_get(body, "dimensions", int),
            user=_get(body, "user", str))


@dataclass
class EmbeddingObject(_Serializable):
    index: int
    embedding: Union[List[float], str]
    object: str = "embedding"


@dataclass
class Embedding(_Serializable):
    object: str = "list"
    data: List[EmbeddingObject] = field(default_factory=list)
    model: str = ""
    usage: UsageInfo = field(default_factory=UsageInfo)


@dataclass
class RerankRequest:
    model: str
    query: str
    documents: List[str]
    top_n: Optional[int] = None
    return_documents: bool = True

    @staticmethod
    def from_json(body: Any) -> "RerankRequest":
        if not isinstance(body, dict):
            raise InvalidInput("request body must be a JSON object")
        docs = body.get("documents")
        if not isinstance(docs, list) or not all(isinstance(d, str) for d in docs):
            raise InvalidInput("field 'documents' must be a list of strings")
        return RerankRequest(
            model=_get(body, "model", str, required=True),
            query=_get(body, "query", str, required=True), documents=docs,
            top_n=_get(body, "top_n", int),
            return_documents=_get(body, "return_documents", bool, True))


@dataclass
class RerankResultDocument(_Serializable):
    text: str


@dataclass
class RerankResult(_Serializable):
    index: int
    relevance_score: float
    document: Optional[RerankResultDocument] = None


@dataclass
class Rerank(_Serializable):
    id: str = field(default_factory=lambda: random_uuid("rerank-"))
    results: List[RerankResult] = field(default_factory=list)
    model: str = ""
    usage: UsageInfo = field(default_factory=UsageInfo)


def error_body(message: str, err_type: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": err_type}}
