"""Page-aligned prefix digests: the keys of the engine's prefix cache,
and the endpoint picker's affinity keys.

Port of kserve_tpu/scheduler/prefix.py.  A key is a blake2b chain over
page-sized runs of token ids (blake2b(prev_digest || page tokens as
little-endian int64)), stable across processes.  The bytes are the JAX
package's exactly: the EPP's picker scores replicas by these digests,
and persisted prefix pages are named by them.  Text affinity (OpenAI
requests, where the picker has no tokenizer) chains the same way over
fixed-size byte chunks of the UTF-8 prompt: two prompts that share a
byte prefix almost always share a token prefix.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np

TEXT_CHUNK_BYTES = 64  # ~16 tokens of typical English text


def token_prefix_digests(
    seq: Sequence[int], page_size: int, for_lookup: bool = True
) -> List[bytes]:
    """Digest-chained keys of the page-aligned prefixes of `seq`.

    Lookup leaves at least one token to prefill (the sampler needs
    logits); registration may include the final exactly-full page."""
    count = (len(seq) - 1) // page_size if for_lookup else len(seq) // page_size
    keys: List[bytes] = []
    digest = b""
    for i in range(count):
        h = hashlib.blake2b(digest, digest_size=16)
        h.update(_tokens_bytes(seq[i * page_size: (i + 1) * page_size]))
        digest = h.digest()
        keys.append(digest)
    return keys


def _tokens_bytes(tokens: Sequence[int]) -> bytes:
    return np.asarray(tokens, np.int64).tobytes()


def text_prefix_digests(text: str, chunk_bytes: int = TEXT_CHUNK_BYTES) -> List[bytes]:
    """Digest-chained keys over fixed-size byte chunks of `text` (complete
    chunks only, so a shared prefix yields a shared key run)."""
    raw = text.encode("utf-8", errors="replace")
    keys: List[bytes] = []
    digest = b""
    for i in range(len(raw) // chunk_bytes):
        h = hashlib.blake2b(digest, digest_size=16)
        h.update(raw[i * chunk_bytes: (i + 1) * chunk_bytes])
        digest = h.digest()
        keys.append(digest)
    return keys
