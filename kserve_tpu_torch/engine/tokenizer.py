"""Tokenizer facade: a HuggingFace tokenizer.json (BPE) read on the
standard library when the model directory has one, a reversible
byte-level tokenizer otherwise, and incremental detokenization that only
emits prefix-stable text.

Port of kserve_tpu/engine/tokenizer.py.  The JAX package's HFTokenizer
runs the `tokenizers` package, which the card machine does not have;
this one runs engine/tokenizer_json.py.  A chat template is rendered
with jinja2 when it can be imported (the port's only optional import);
otherwise the default template is used, which the tokenizer says once,
when it is loaded.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Sequence

from .tokenizer_json import TokenizerJSON

logger = logging.getLogger(__name__)


class BaseTokenizer:
    eos_token_id: int = -1
    bos_token_id: int = -1

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def apply_chat_template(self, messages: List[dict],
                            add_generation_prompt: bool = True, **kwargs) -> str:
        """Fallback chat template (chatml-ish)."""
        parts = []
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content") or ""
            parts.append(f"<|{role}|>\n{content}\n")
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


class ByteTokenizer(BaseTokenizer):
    """256 byte tokens + BOS/EOS/PAD; reversible on arbitrary text."""

    PAD = 256
    BOS = 257
    EOS = 258

    def __init__(self, vocab_size: int = 512):
        self._vocab_size = max(vocab_size, 259)
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer(BaseTokenizer):
    """A model directory's tokenizer.json, with the special tokens and the
    chat template of its tokenizer_config.json (kserve_tpu/engine/
    tokenizer.py:67-134, on engine/tokenizer_json.py)."""

    def __init__(self, model_dir: str):
        with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as f:
            self._tok = TokenizerJSON(json.load(f))
        self.eos_token_id = -1
        self.bos_token_id = -1
        self._chat_template: Optional[str] = None
        self._template_warned = False
        # how chat prompts are rendered: "jinja2", "default" (no template,
        # or no jinja2 to render it)
        self.chat_template_mode = "default"
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            self._chat_template = cfg.get("chat_template")
            eos = cfg.get("eos_token")
            bos = cfg.get("bos_token")
            if isinstance(eos, dict):
                eos = eos.get("content")
            if isinstance(bos, dict):
                bos = bos.get("content")
            # `or -1` as in the JAX tokenizer: a token whose id is 0 reads
            # as absent (ROADMAP C11)
            if eos:
                self.eos_token_id = self._tok.token_to_id(eos) or -1
            if bos:
                self.bos_token_id = self._tok.token_to_id(bos) or -1
        self._jinja = None
        if self._chat_template:
            try:
                import jinja2
            except ImportError:
                logger.warning(
                    "jinja2 is not installed: chat prompts of %s use the "
                    "default template, not its chat_template", model_dir)
            else:
                self._jinja = jinja2
                self.chat_template_mode = "jinja2"

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text)
        if add_bos and self.bos_token_id >= 0:
            return [self.bos_token_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages, add_generation_prompt=True, **kwargs) -> str:
        if self._jinja is not None:
            try:
                tmpl = self._jinja.Environment().from_string(self._chat_template)
                return tmpl.render(
                    messages=messages,
                    add_generation_prompt=add_generation_prompt,
                    bos_token="",
                    eos_token="",
                    **kwargs,
                )
            except Exception:  # noqa: BLE001 — template syntax varies by model
                # a broken template fails the same way on every request:
                # warn once with the traceback, then use the default
                if not self._template_warned:
                    self._template_warned = True
                    logger.warning(
                        "chat template render failed; falling back to the "
                        "default template", exc_info=True)
        return super().apply_chat_template(messages, add_generation_prompt, **kwargs)


def load_tokenizer(model_dir: Optional[str], vocab_size: int = 512) -> BaseTokenizer:
    """The model directory's tokenizer.json, or the byte tokenizer when
    there is none."""
    if model_dir and os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        return HFTokenizer(model_dir)
    return ByteTokenizer(vocab_size)


class IncrementalDetokenizer:
    """Streams prefix-stable text deltas from a growing id sequence."""

    def __init__(self, tokenizer: BaseTokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = ""

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids)
        # hold back while the tail is an incomplete byte sequence
        if text.endswith("�"):
            return ""
        delta = text[len(self._emitted):]
        self._emitted = text
        return delta

    @property
    def text(self) -> str:
        return self._emitted
