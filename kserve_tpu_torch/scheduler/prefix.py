"""Page-aligned prefix digests: the keys of the engine's prefix cache.

Port of kserve_tpu/scheduler/prefix.py:25-47.  A key is a blake2b chain
over page-sized runs of token ids (blake2b(prev_digest || page tokens as
little-endian int64)), stable across processes.  The bytes are the JAX
package's exactly: its EPP endpoint picker scores replicas by these
digests, and persisted prefix pages are named by them.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


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
