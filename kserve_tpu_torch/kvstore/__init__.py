"""Hierarchical KV page store (port of kserve_tpu/kvstore/).

One store holds the two host-side KV paths:

- the spill path: a preempted lane's device KV parks in host RAM or on
  disk and is injected back when the lane resumes;
- the prefix path: prefix-cache pages evicted from the device demote into
  the same tiers instead of being dropped, keyed by the digest chains of
  scheduler/prefix.py, above a persistent layer of digest-named files
  that survive a restart.

Tier order: device (engine/prefix_cache.py, outside this package) -> host
RAM -> node-local disk -> persistent prefix files.  A page dropped
anywhere is a performance event, never a correctness one: the engine
prefills it again.  Payloads are dicts of CPU torch tensors; on disk a
bfloat16 tensor is kept as its int16 bits with a dtype tag (payload.py),
so the port needs no numpy bfloat16 type.  A replica serves its
persisted pages to peers, and fetches theirs, through the verified page
fabric of peer.py.
"""

from .payload import Payload, payload_nbytes
from .peer import (
    PAGE_ROUTE,
    PageVerifyError,
    PeerPageClient,
    PeerPageIndex,
    decode_page,
    decode_payload,
    digest_set_wire,
    encode_page,
)
from .persist import PersistentPrefixStore, kv_persist_dir_from_env
from .store import HierarchicalKVStore, KVStoreConfig, PrefixStoreStats
from .tiers import KVTierStore, TierConfig

__all__ = [
    "PAGE_ROUTE",
    "HierarchicalKVStore",
    "KVStoreConfig",
    "KVTierStore",
    "PageVerifyError",
    "Payload",
    "PeerPageClient",
    "PeerPageIndex",
    "PersistentPrefixStore",
    "PrefixStoreStats",
    "TierConfig",
    "decode_page",
    "decode_payload",
    "digest_set_wire",
    "encode_page",
    "kv_persist_dir_from_env",
    "payload_nbytes",
]
