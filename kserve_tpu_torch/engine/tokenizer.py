"""Tokenizer facade: a reversible byte-level tokenizer, and incremental
detokenization that only emits prefix-stable text.

Port of kserve_tpu/engine/tokenizer.py without the HuggingFace
`tokenizers` backend, which the card machine does not have: `load_tokenizer`
returns the byte tokenizer until a standard-library reader of
tokenizer.json is ported.
"""

from __future__ import annotations

from typing import List, Sequence


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


def load_tokenizer(vocab_size: int = 512) -> BaseTokenizer:
    """The byte tokenizer (no tokenizer.json reader in this port yet)."""
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
