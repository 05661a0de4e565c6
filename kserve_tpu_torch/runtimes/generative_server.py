"""Generative runtime of the PyTorch port: OpenAI completions and chat
(non-streaming and SSE) on top of engine.LLMEngine.

Port of kserve_tpu/runtimes/generative_server.py (`JAXGenerativeModel`
becomes `TorchGenerativeModel`; the flags this slice uses keep their
names).  Logprobs (`logprobs`, chat `top_logprobs`) and the sampling
penalties are served through the engine's legacy programs.  `--model_dir`
serves a HuggingFace checkpoint: config.json (unless --model_config names
a shape), tokenizer.json and tokenizer_config.json, and the safetensors
shards, streamed onto the device one tensor at a time
(models/llama.load_hf_weights_streamed).  `--random_weights` draws
seeded random weights on the device instead.

A request carrying the `x-generation-checkpoint` header (a checkpoint a
draining replica returned, from either package) resumes that generation
instead of starting one (kserve_tpu/runtimes/generative_server.py:
306-436): single prompt and n=1 only, streamed or not (a non-streamed
resume that asks for logprobs is refused: the checkpoint has no logprobs
of its prefix); a malformed or mismatched checkpoint answers 400.  A
streamed resume sends only the continuation, which the client splices
after what it has; a non-streamed one answers with the whole text.
`drain(deadline)` checkpoints what the drain budget cannot finish, and
`live()` goes false once the engine is wedged.  `--watchdog on|off`
(default $KSERVE_TPU_WATCHDOG) turns on the engine's stall watchdog.

`--weight_quant int8` serves int8 weights (random ones drawn int8, a
checkpoint quantized tensor by tensor as it streams in).
`--lora_adapters name=dir,...` loads HF PEFT adapters; the OpenAI `model`
field naming one selects it on completions and chat, JSON and SSE (vLLM's
semantics; `aliases` lists them, so the server routes those names here
and GET /openai/v1/models lists each as a model), and any other value
serves the base model (kserve_tpu/runtimes/generative_server.py:450).

Prefill/decode disaggregation (kserve_tpu/runtimes/generative_server.py:
78-94, :464-494): `--role prefill` answers POST /v1/prefill/{model} (the
prompt's KV and first token, protocol/pd.py) beside its completions;
`--role decode --prefill_url URL` (default $PREFILL_URL) fetches each
prompt's KV from that peer and decodes on from the injected pages, and
refuses logprobs (400: the wire carries none); a 400 from the peer (a
prompt over its max_prefill_len) answers 400 here too.  LoRA adapters
pass through both roles.  The parallelism flags the control plane
synthesizes (--tensor_parallel_size, ...) parse; the engine refuses any
of them above 1.

Entrypoint:
    python -m kserve_tpu_torch.runtimes.generative_server \\
        --model_name=llm --model_dir=/mnt/models \\
        [--device cuda|cpu] [--spec_decode_k K] [--kv_quant int8] \\
        [--kv_offload host --kv_offload_gib G] [--kv_persist_dir DIR] \\
        [--weight_quant int8] [--lora_adapters name=/adapter/dir,...] \\
        [--role prefill | --role decode --prefill_url http://peer:8080]
    # no checkpoint: --model_config=tiny|llama3-1b|llama3-8b|... --random_weights

The prefix cache is always on, as in the JAX server.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import time
from typing import AsyncIterator, Dict, List, Optional

import torch

from ..device import resolve_device
from ..engine.engine import EngineConfig, LLMEngine
from ..engine.sampling import SamplingParams
from ..engine.tokenizer import load_tokenizer
from ..engine.types import spec_decode_k_from_env
from ..engine.watchdog import watchdog_enabled_from_env
from ..kvstore import kv_persist_dir_from_env
from ..kvstore.tiers import DEFAULT_DISK_DIR
from ..errors import InvalidInput
from ..logging import configure_logging
from ..lifecycle import (
    CHECKPOINT_HEADER,
    GenerationCheckpoint,
    GenerationPreempted,
    ReplicaDrainingError,
)
from ..model_server import ModelServer
from ..models import llama
from ..protocol.pd import PrefillClient, serialize_kv
from ..protocol.openai.types import (
    ChatCompletion,
    ChatCompletionChoice,
    ChatCompletionChunk,
    ChatCompletionChunkChoice,
    ChatCompletionChunkDelta,
    ChatCompletionLogprob,
    ChatCompletionLogprobs,
    ChatCompletionLogprobsContent,
    ChatCompletionRequest,
    ChatCompletionResponseMessage,
    Completion,
    CompletionChoice,
    CompletionLogprobs,
    CompletionRequest,
    UsageInfo,
    random_uuid,
)

logger = logging.getLogger(__name__)

_NAMED_CONFIGS = {
    "tiny": llama.LlamaConfig.tiny,
    "llama3-1b": llama.LlamaConfig.llama3_1b,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "qwen3-0.6b": llama.LlamaConfig.qwen3_0_6b,
    "gemma2-2b": llama.LlamaConfig.gemma2_2b,
}


class TorchGenerativeModel:
    def __init__(
        self,
        name: str,
        model_config: Optional[llama.LlamaConfig] = None,
        engine_config: Optional[EngineConfig] = None,
        random_weights: bool = False,
        device=None,
        model_dir: Optional[str] = None,
        lora_adapters: Optional[Dict[str, str]] = None,
        role: str = "both",
        prefill_url: Optional[str] = None,
    ):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if role == "decode" and not prefill_url:
            # serving monolithically would hide that the disaggregated
            # topology is not in effect
            raise ValueError("role=decode requires --prefill_url (or $PREFILL_URL)")
        if not random_weights and not model_dir:
            raise ValueError("pass --model_dir, or --random_weights with "
                             "--model_config")
        if model_config is None and not model_dir:
            raise ValueError("pass --model_config (or a --model_dir with a "
                             "config.json)")
        self.name = name
        self.role = role
        self.prefill_url = prefill_url
        self._prefill_client: Optional[PrefillClient] = None
        self.device = resolve_device(device)
        # adapter name -> HF PEFT directory; the names are this model's
        # aliases: the OpenAI `model` field selects one
        self.lora_adapters = dict(lora_adapters or {})
        self.aliases = tuple(sorted(self.lora_adapters))
        self.model_dir = model_dir
        self.random_weights = random_weights
        self.engine_config = engine_config or EngineConfig()
        # the config and the tokenizer as kserve_tpu/runtimes/
        # generative_server.py:104-113 resolve them
        if model_config is None:
            cfg_path = os.path.join(model_dir, "config.json")
            if not os.path.exists(cfg_path):
                raise FileNotFoundError(
                    f"no config.json under {model_dir}; pass --model_config")
            model_config = llama.LlamaConfig.from_hf_config(cfg_path)
            model_config.dtype = self.engine_config.dtype
        self.model_config = model_config
        self.tokenizer = load_tokenizer(model_dir, model_config.vocab_size)
        self.engine: Optional[LLMEngine] = None
        self.ready = False
        # the streamed checkpoint read: {"n_tensors", "read_bytes",
        # "peak_host_bytes", "seconds"} (None with random weights)
        self.weights_stats: Optional[dict] = None

    def load(self):
        """Stream the checkpoint's weights onto the device unless
        --random_weights (kserve_tpu/runtimes/generative_server.py:
        114-140).  Returns the parameters, or None for the engine to draw
        random ones."""
        if self.random_weights:
            return None
        t0 = time.perf_counter()
        stats: dict = {}
        params = llama.load_hf_weights_streamed(
            self.model_dir, self.model_config, device=self.device, stats=stats,
            weight_quant=self.engine_config.weight_quant)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats["seconds"] = time.perf_counter() - t0
        self.weights_stats = stats
        logger.info(
            "weights streamed: %d tensors, %.1f MiB read, peak host staging "
            "%.1f MiB, %.2fs", stats["n_tensors"], stats["read_bytes"] / (1 << 20),
            stats["peak_host_bytes"] / (1 << 20), stats["seconds"])
        return params

    def _build_engine(self) -> LLMEngine:
        params = self.load()
        load_s = 0.0 if params is None else self.weights_stats["seconds"]
        # checkpoints name the served model: one resumes only where the
        # same model is served (kserve_tpu/runtimes/generative_server.py:
        # 152-154)
        return LLMEngine(self.model_config, self.engine_config, self.tokenizer,
                         params=params, device=self.device,
                         metrics_label=self.name, weights_seconds=load_s,
                         checkpoint_label=self.name,
                         lora_adapters=self.lora_adapters or None)

    async def start_engine(self) -> None:
        """Load the weights and build the engine (weights and KV cache on
        the device, off the event loop), then start its run loop; the
        model then turns ready."""
        self.engine = await asyncio.to_thread(self._build_engine)
        await self.engine.start()
        self.ready = True
        logger.info("generative model %s ready on %s", self.name, self.device)

    async def stop(self) -> None:
        self.ready = False
        if self.engine is not None:
            await self.engine.stop()
        if self._prefill_client is not None:
            await self._prefill_client.close()
            self._prefill_client = None

    async def drain(self, deadline=None) -> list:
        """The lifecycle drain: checkpoint what the budget cannot finish
        (kserve_tpu/runtimes/generative_server.py:210-215)."""
        if self.engine is None or not self.engine.running:
            return []
        return await self.engine.drain(deadline)

    async def healthy(self) -> bool:
        """Readiness: ready and the engine's loop running (kserve_tpu/
        runtimes/generative_server.py:217-218)."""
        return self.ready and self.engine is not None and self.engine.running

    async def live(self) -> bool:
        """Liveness: false once the engine is wedged, so the pod restarts
        instead of hanging behind a healthy-looking HTTP server."""
        return self.engine is None or not self.engine.wedged

    # ---------------- helpers ----------------

    def _logprobs_k(self, req) -> Optional[int]:
        """The two OpenAI logprob dialects as one int: None = not asked, 0 =
        the sampled token's logprob only, N = N top alternatives (port of
        kserve_tpu/runtimes/generative_server.py:228-258).  Completions:
        `logprobs` is the count.  Chat: `logprobs` is a gate and
        `top_logprobs` the count."""
        if isinstance(req, ChatCompletionRequest):
            if req.top_logprobs is not None and not req.logprobs:
                raise InvalidInput("top_logprobs requires logprobs=true")
            if not req.logprobs:
                return None
            k = req.top_logprobs or 0
        elif req.logprobs is None:
            return None
        else:
            k = req.logprobs
        max_k = self.engine_config.max_logprobs
        if not 0 <= k <= max_k:
            raise InvalidInput(f"logprobs must be between 0 and {max_k}")
        if self.role == "decode":
            # the P/D wire carries (kv, first_token) only
            raise InvalidInput(
                "logprobs is not supported with prefill/decode disaggregation")
        return k

    def _sampling_from(self, req, max_tokens: int) -> SamplingParams:
        stop = [req.stop] if isinstance(req.stop, str) else req.stop
        return SamplingParams(
            temperature=req.temperature,
            top_p=req.top_p,
            top_k=req.top_k or 0,
            min_p=req.min_p or 0.0,
            repetition_penalty=req.repetition_penalty or 1.0,
            frequency_penalty=req.frequency_penalty or 0.0,
            presence_penalty=req.presence_penalty or 0.0,
            max_tokens=max_tokens,
            min_tokens=req.min_tokens,
            ignore_eos=req.ignore_eos,
            stop=stop,
            seed=req.seed,
            logprobs=self._logprobs_k(req),
        )

    def _encode_prompt(self, prompt) -> List[List[int]]:
        if isinstance(prompt, str):
            return [self.tokenizer.encode(prompt)]
        if isinstance(prompt[0], int):
            return [list(prompt)]
        if isinstance(prompt[0], str):
            return [self.tokenizer.encode(p) for p in prompt]
        return [list(p) for p in prompt]

    def _adapter_for(self, request) -> Optional[str]:
        """The OpenAI `model` field naming a loaded LoRA adapter selects it
        (vLLM's semantics); any other value serves the base model."""
        name = getattr(request, "model", None)
        return name if name in self.lora_adapters else None

    def _generate(self, prompt_ids, params, adapter=None) -> AsyncIterator:
        """engine.generate with its validation errors (an unknown adapter
        among them) as 400s, raised here, before any response bytes are
        sent.  The decode role takes the prompt's KV from its prefill peer
        instead."""
        if self.role == "decode":
            if len(prompt_ids) + params.max_tokens > self.engine.config.max_model_len:
                raise InvalidInput(
                    "prompt+max_tokens exceeds max_model_len "
                    f"{self.engine.config.max_model_len}")
            try:
                self.engine._resolve_adapter(adapter)
            except ValueError as e:
                raise InvalidInput(str(e)) from e
            return self._generate_disaggregated(prompt_ids, params, adapter)
        try:
            return self.engine.generate(prompt_ids, params, adapter=adapter)
        except ValueError as e:
            raise InvalidInput(str(e)) from e

    async def _generate_disaggregated(self, prompt_ids, params, adapter=None):
        """Decode role: the prompt's KV and first token from the prefill
        peer, then decoding on from the injected pages."""
        if self._prefill_client is None:
            self._prefill_client = PrefillClient(self.prefill_url)
        kv, first_token = await self._prefill_client.prefill(
            self.name, prompt_ids, params, adapter=adapter)
        if self.device.type == "cuda":
            # the pinned copy the inject uploads from, made off the event
            # loop (upload() takes an already pinned tensor as it is)
            kv = await asyncio.to_thread(kv.pin_memory)
        source = self.engine.generate_injected(prompt_ids, params, kv,
                                               first_token, adapter=adapter)
        try:
            async for out in source:
                yield out
        finally:
            await source.aclose()

    async def handle_prefill(self, prompt_ids, params, adapter=None):
        """The prefill route (protocol/pd.py): one detached prefill's
        (meta JSON, payload bytes); a refused request is a 400."""
        try:
            first_token, kv = await self.engine.prefill_detached(
                prompt_ids, params, adapter=adapter)
        except ValueError as e:
            raise InvalidInput(str(e)) from e
        return serialize_kv(kv, first_token)

    @staticmethod
    def _raise_gathered(results: list) -> list:
        """Errors of a gather of several generations (kserve_tpu/runtimes/
        generative_server.py:378-401): a lone GenerationPreempted re-raises
        (503 with its checkpoint); several cannot each carry one, so a
        preemption among them becomes a plain retryable 503; any other
        error wins."""
        errors = [r for r in results if isinstance(r, BaseException)]
        if not errors:
            return results
        for e in errors:
            if not isinstance(e, GenerationPreempted):
                raise e
        if len(results) == 1:
            raise errors[0]
        raise ReplicaDrainingError(
            "replica drained mid-request; multi-choice responses cannot "
            "carry per-choice checkpoints — retry on another replica")

    async def _gather(self, sources, with_logprobs: bool) -> list:
        return self._raise_gathered(await asyncio.gather(
            *[self._run_one(s, with_logprobs) for s in sources],
            return_exceptions=True))

    # ---------------- checkpoint resume ----------------

    @staticmethod
    def _checkpoint_from(headers) -> Optional[GenerationCheckpoint]:
        """The checkpoint riding the request's x-generation-checkpoint
        header.  A value that does not decode reads as none, as in the JAX
        server (a checkpoint is a resume optimization); one that decodes
        with bad fields is refused with 400 at admission."""
        if not headers:
            return None
        return GenerationCheckpoint.from_header(headers.get(CHECKPOINT_HEADER))

    def _resume_checks(self, request, ckpt) -> None:
        """A checkpoint is one generation, and the prefix's logprobs are
        not in it: a non-streamed resume cannot answer them."""
        if not request.stream and self._logprobs_k(request) is not None:
            raise InvalidInput(
                "checkpoint resume cannot reconstruct logprobs for the "
                "checkpointed prefix in a non-streaming response; retry the "
                "request without the checkpoint")

    def _resume_source(self, ckpt) -> AsyncIterator:
        """Admit the checkpoint once (the engine counts each call); a
        malformed or mismatched one is the client's error: 400."""
        try:
            return self.engine.resume_generation(ckpt)
        except ValueError as e:
            raise InvalidInput(f"cannot resume from checkpoint: {e}") from e

    @staticmethod
    async def _splice_resume(ckpt, source):
        """Run a resumed generation to its end: (the whole text, the
        checkpoint's tokens and the continuation's, the finish reason,
        usage against the checkpoint's prompt)."""
        n_gen, finish, last = 0, None, None
        async for out in source:
            last, n_gen, finish = out, out.num_generated, out.finish_reason
        text = last.cumulative_text if last is not None else ""
        usage = UsageInfo(prompt_tokens=len(ckpt.prompt_ids),
                          completion_tokens=n_gen,
                          total_tokens=len(ckpt.prompt_ids) + n_gen)
        return text, finish or "stop", usage

    @staticmethod
    async def _run_one(source, with_logprobs: bool):
        """(text, tokens generated, finish reason, the (token id, text
        delta, logprob, top) entries when logprobs were asked for)."""
        text, n_gen, finish = "", 0, None
        entries = [] if with_logprobs else None
        async for out in source:
            text += out.text_delta
            n_gen = out.num_generated
            finish = out.finish_reason
            if entries is not None and out.token_id >= 0:
                entries.append((out.token_id, out.text_delta, out.logprob,
                                out.top_logprobs))
        return text, n_gen, finish or "stop", entries

    # ---------------- logprob blocks ----------------

    def _token_str(self, token_id: int) -> str:
        return self.tokenizer.decode([token_id])

    def _completion_logprobs(self, entries, k: int,
                             offset0: int = 0) -> CompletionLogprobs:
        """The completions logprobs block of engine entries (port of
        kserve_tpu/runtimes/generative_server.py:515-540): the sampled
        token joins each top_logprobs dict, as OpenAI's does.  The dict is
        keyed by token text, and a byte tokenizer decodes distinct ids to
        the same text, so the first (best) of a collision is kept."""
        lp = CompletionLogprobs(top_logprobs=[] if k > 0 else None)
        offset = offset0
        for tid, delta, logprob, top in entries:
            lp.tokens.append(self._token_str(tid))
            lp.token_logprobs.append(logprob)
            lp.text_offset.append(offset)
            offset += len(delta)
            if k > 0:
                d: dict = {}
                for t, v in (top or [])[:k]:
                    d.setdefault(self._token_str(t), v)
                if logprob is not None:
                    d.setdefault(self._token_str(tid), logprob)
                lp.top_logprobs.append(d)
        return lp

    def _chat_logprobs(self, entries, k: int) -> ChatCompletionLogprobs:
        """The chat logprobs block (port of kserve_tpu/runtimes/
        generative_server.py:542-560)."""
        content = []
        for tid, _delta, logprob, top in entries:
            tok = self._token_str(tid)
            content.append(ChatCompletionLogprobsContent(
                token=tok,
                logprob=logprob if logprob is not None else -9999.0,
                bytes=list(tok.encode("utf-8")),
                top_logprobs=[
                    ChatCompletionLogprob(
                        token=self._token_str(t), logprob=v,
                        bytes=list(self._token_str(t).encode("utf-8")))
                    for t, v in (top or [])[:k]]))
        return ChatCompletionLogprobs(content=content)

    # ---------------- completions ----------------

    async def create_completion(self, request: CompletionRequest, headers=None):
        ckpt = self._checkpoint_from(headers)
        if ckpt is not None:
            prompt = request.prompt
            if request.n > 1 or (isinstance(prompt, list) and len(prompt) > 1
                                 and isinstance(prompt[0], (str, list))):
                raise InvalidInput(
                    "checkpoint resume supports a single prompt with n=1")
            self._resume_checks(request, ckpt)
            source = self._resume_source(ckpt)
            params = ckpt.sampling_params()
            if request.stream:
                return self._stream_completion(
                    request, list(ckpt.prompt_ids), params, source)
            text, finish, usage = await self._splice_resume(ckpt, source)
            return Completion(model=request.model, usage=usage, choices=[
                CompletionChoice(index=0, text=text, finish_reason=finish)])
        prompts = self._encode_prompt(request.prompt)
        params = self._sampling_from(request, request.max_tokens)
        adapter = self._adapter_for(request)
        if request.stream:
            if len(prompts) > 1 or request.n > 1:
                raise InvalidInput("streaming supports a single prompt with n=1")
            return self._stream_completion(
                request, prompts[0], params,
                self._generate(prompts[0], params, adapter))
        runs = [p for p in prompts for _ in range(request.n)]
        sources = [self._generate(p, params, adapter) for p in runs]
        k = params.logprobs
        results = await self._gather(sources, k is not None)
        usage = UsageInfo()
        choices = []
        for idx, (prompt_ids, (text, n_gen, finish, entries)) in enumerate(
                zip(runs, results)):
            choices.append(CompletionChoice(
                index=idx, text=text, finish_reason=finish,
                logprobs=(None if entries is None
                          else self._completion_logprobs(entries, k))))
            usage.prompt_tokens += len(prompt_ids)
            usage.completion_tokens += n_gen
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return Completion(model=request.model, choices=choices, usage=usage)

    async def _stream_completion(self, request, prompt_ids, params, source):
        completion_id = random_uuid("cmpl-")
        text_offset = 0
        try:
            async for out in source:
                lp = None
                if params.logprobs is not None and out.token_id >= 0:
                    lp = self._completion_logprobs(
                        [(out.token_id, out.text_delta, out.logprob,
                          out.top_logprobs)], params.logprobs, text_offset)
                text_offset += len(out.text_delta)
                chunk = Completion(
                    id=completion_id, model=request.model,
                    choices=[CompletionChoice(index=0, text=out.text_delta,
                                              finish_reason=out.finish_reason,
                                              logprobs=lp)])
                if request.include_usage and out.finished:
                    chunk.usage = UsageInfo(
                        prompt_tokens=len(prompt_ids),
                        completion_tokens=out.num_generated,
                        total_tokens=len(prompt_ids) + out.num_generated)
                yield chunk
        finally:
            await source.aclose()

    # ---------------- chat ----------------

    def _chat_prompt(self, request: ChatCompletionRequest) -> List[int]:
        messages = [{"role": m.role, "content": m.content} for m in request.messages]
        text = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
        return self.tokenizer.encode(text)

    async def create_chat_completion(self, request: ChatCompletionRequest,
                                     headers=None):
        ckpt = self._checkpoint_from(headers)
        if ckpt is not None:
            if request.n > 1:
                raise InvalidInput("checkpoint resume supports n=1")
            self._resume_checks(request, ckpt)
            source = self._resume_source(ckpt)
            if request.stream:
                return self._stream_chat(request, list(ckpt.prompt_ids),
                                         ckpt.sampling_params(), source)
            text, finish, usage = await self._splice_resume(ckpt, source)
            return ChatCompletion(model=request.model, usage=usage, choices=[
                ChatCompletionChoice(
                    index=0, message=ChatCompletionResponseMessage(content=text),
                    finish_reason=finish)])
        prompt_ids = self._chat_prompt(request)
        params = self._sampling_from(request, request.max_tokens or 256)
        adapter = self._adapter_for(request)
        if request.stream:
            if request.n > 1:
                raise InvalidInput("streaming supports n=1")
            return self._stream_chat(
                request, prompt_ids, params,
                self._generate(prompt_ids, params, adapter))
        sources = [self._generate(prompt_ids, params, adapter)
                   for _ in range(request.n)]
        k = params.logprobs
        results = await self._gather(sources, k is not None)
        usage = UsageInfo(prompt_tokens=len(prompt_ids) * request.n)
        choices = []
        for i, (text, n_gen, finish, entries) in enumerate(results):
            choices.append(ChatCompletionChoice(
                index=i, message=ChatCompletionResponseMessage(content=text),
                finish_reason=finish,
                logprobs=(None if entries is None
                          else self._chat_logprobs(entries, k))))
            usage.completion_tokens += n_gen
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return ChatCompletion(model=request.model, choices=choices, usage=usage)

    async def _stream_chat(self, request, prompt_ids, params, source):
        chunk_id = random_uuid("chatcmpl-")
        yield ChatCompletionChunk(
            id=chunk_id, model=request.model,
            choices=[ChatCompletionChunkChoice(
                index=0, delta=ChatCompletionChunkDelta(role="assistant", content=""))])
        try:
            async for out in source:
                lp = None
                if params.logprobs is not None and out.token_id >= 0:
                    lp = self._chat_logprobs(
                        [(out.token_id, out.text_delta, out.logprob,
                          out.top_logprobs)], params.logprobs)
                chunk = ChatCompletionChunk(
                    id=chunk_id, model=request.model,
                    choices=[ChatCompletionChunkChoice(
                        index=0, delta=ChatCompletionChunkDelta(content=out.text_delta),
                        finish_reason=out.finish_reason, logprobs=lp)])
                if request.include_usage and out.finished:
                    chunk.usage = UsageInfo(
                        prompt_tokens=len(prompt_ids),
                        completion_tokens=out.num_generated,
                        total_tokens=len(prompt_ids) + out.num_generated)
                yield chunk
        finally:
            await source.aclose()


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="kserve_tpu_torch generative server")
    parser.add_argument("--model_name", default="model")
    parser.add_argument(
        "--model_dir", default=None,
        help="a HuggingFace checkpoint directory: config.json, tokenizer.json "
        "(+ tokenizer_config.json) and *.safetensors")
    parser.add_argument("--model_config", default=None, choices=sorted(_NAMED_CONFIGS),
                        help="a named shape (instead of --model_dir's config.json)")
    parser.add_argument("--random_weights", action="store_true")
    parser.add_argument("--http_port", default=8080, type=int)
    parser.add_argument(
        "--role", default="both", choices=("both", "prefill", "decode"),
        help="P/D disaggregation role; decode needs --prefill_url")
    parser.add_argument(
        "--prefill_url", default=os.getenv("PREFILL_URL") or None,
        help="base URL of the prefill-role peer (decode role)")
    # the control plane's parallelism flags (kserve_tpu/controlplane/
    # llmisvc.py); the engine refuses any above 1
    parser.add_argument("--tensor_parallel_size", "--tp", default=1, type=int)
    parser.add_argument("--data_parallel_size", "--dp", default=1, type=int)
    parser.add_argument("--sequence_parallel_size", "--sp", default=1, type=int)
    parser.add_argument("--pipeline_parallel_size", "--pp", default=1, type=int)
    parser.add_argument("--max_batch_size", default=8, type=int)
    parser.add_argument("--kv_pages", default=2048, type=int)
    parser.add_argument("--page_size", default=16, type=int)
    parser.add_argument("--max_model_len", default=2048, type=int)
    parser.add_argument("--max_prefill_len", default=1024, type=int)
    parser.add_argument("--kv_dtype", default="bfloat16", type=str)
    parser.add_argument(
        "--kv_quant", default="none", choices=("none", "int8"),
        help="int8: KV pages in int8 with per-row f32 scales (half the KV "
        "bytes of bfloat16; --kv_dtype then sets the activation dtype)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without CUDA, cuda raises")
    parser.add_argument(
        "--spec_decode_k", default=None, type=int,
        help="speculative decoding: K draft tokens per lane verified per "
        "round of the dense mixed_decode program (0 = dense packing "
        "alone); defaults to $KSERVE_TPU_SPEC_DECODE_K (off).  Greedy and "
        "seeded streams stay token-identical to spec-off")
    # the KV hierarchy (kvstore/); the prefix cache is always on
    parser.add_argument(
        "--kv_offload", default="none", choices=("none", "host"),
        help="host: a preempted lane's KV pages spill to host RAM (and "
        "disk) and are injected back on resume instead of re-prefilled; "
        "evicted prefix pages demote there too")
    parser.add_argument("--kv_offload_gib", default=0.0, type=float,
                        help="host RAM tier budget (GiB)")
    parser.add_argument(
        "--kv_offload_disk_gib", default=0.0, type=float,
        help="disk tier budget (GiB) under --kv_offload_dir; entries demote "
        "host->disk per --kv_offload_policy")
    parser.add_argument("--kv_offload_dir", default=DEFAULT_DISK_DIR)
    parser.add_argument("--kv_offload_policy", default="lru",
                        choices=("lru", "arc"))
    parser.add_argument(
        "--kv_persist_dir", default=None,
        help="persistent prefix store directory: reused prefix pages are "
        "written there and a restarted server pages them in; defaults to "
        "$KSERVE_TPU_KV_PERSIST (off)")
    parser.add_argument(
        "--weight_quant", default="none", choices=("none", "int8"),
        help="int8: int8 linears with per-channel f32 scales (about half "
        "the weight bytes of bfloat16); random weights are drawn int8, a "
        "checkpoint is quantized tensor by tensor as it is read")
    parser.add_argument(
        "--lora_adapters", default=None,
        help="comma-separated name=/local/adapter/dir (HF PEFT format); the "
        "OpenAI `model` field naming an adapter selects it")
    parser.add_argument(
        "--watchdog", default=None, choices=("on", "off"),
        help="gray-failure engine watchdog: a confirmed no-progress stall "
        "flips readiness and self-drains with checkpoints; defaults to "
        "$KSERVE_TPU_WATCHDOG (off)")
    return parser


def build_model(args) -> TorchGenerativeModel:
    """The served model for parsed `build_arg_parser()` arguments.  The
    model's activation dtype follows --kv_dtype (the kernels read pages in
    the activation dtype, or int8 pages with --kv_quant int8)."""
    model_config = None
    if args.model_config is not None:
        model_config = _NAMED_CONFIGS[args.model_config]()
        model_config.dtype = args.kv_dtype
    engine_config = EngineConfig(
        max_batch_size=args.max_batch_size,
        page_size=args.page_size,
        num_pages=args.kv_pages,
        max_pages_per_seq=max(1, args.max_model_len // args.page_size),
        max_prefill_len=args.max_prefill_len,
        dtype=args.kv_dtype,
        kv_quant=args.kv_quant,
        spec_decode_k=(args.spec_decode_k if args.spec_decode_k is not None
                       else spec_decode_k_from_env()),
        kv_offload=args.kv_offload,
        kv_offload_gib=args.kv_offload_gib,
        kv_offload_disk_gib=args.kv_offload_disk_gib,
        kv_offload_dir=args.kv_offload_dir,
        kv_offload_policy=args.kv_offload_policy,
        kv_persist_dir=args.kv_persist_dir or kv_persist_dir_from_env(),
        watchdog=(args.watchdog == "on" if args.watchdog is not None
                  else watchdog_enabled_from_env()),
        weight_quant=args.weight_quant,
        tp=args.tensor_parallel_size,
        dp=args.data_parallel_size,
        sp=args.sequence_parallel_size,
        pp=args.pipeline_parallel_size,
    )
    lora_adapters = None
    if args.lora_adapters:
        lora_adapters = dict(
            pair.split("=", 1) for pair in args.lora_adapters.split(",") if pair)
    return TorchGenerativeModel(
        args.model_name, model_config, engine_config,
        random_weights=args.random_weights, device=args.device,
        model_dir=args.model_dir, lora_adapters=lora_adapters,
        role=args.role, prefill_url=args.prefill_url)


def main(argv=None) -> None:
    # every record carries its request and trace ids (logging.py)
    configure_logging()
    args = build_arg_parser().parse_args(argv)
    model = build_model(args)
    ModelServer(http_port=args.http_port).start([model])


if __name__ == "__main__":
    main()
