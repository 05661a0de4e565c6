"""Prefix cache: digest-chained prompt pages shared across requests.

Port of kserve_tpu/engine/prefix_cache.py.  Full prompt pages are kept
after a request finishes (the cache holds its own reference in the
engine's refcounted PageAllocator, so a shared page outlives its owner),
in LRU order; a later request with the same page-aligned prefix reuses
them and prefills only its uncached tail.  Under page pressure the engine
evicts cold cached pages before it fails an admission or preempts a lane.

Keys are the blake2b digest chains of scheduler/prefix.py, byte for byte
the JAX package's.

This is the device layer of the KV hierarchy (kvstore/).  Two seams join
it to the tiers below:

- ``demote_cb``: evicted (key, page) pairs are offered to the engine
  before their pages can be reused, so their contents can be gathered
  into the host, disk or persistent tiers instead of being dropped;
- ``adopt``: the page-in path inserts tier-resident pages it injected
  back into the cache, so the next admission's lookup hits them like
  locally prefilled pages.  ``adopted_hits`` counts admissions served
  from pages that were never prefilled in this process.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

from ..scheduler.prefix import token_prefix_digests

logger = logging.getLogger(__name__)


class PrefixCache:
    def __init__(self, page_size: int, enabled: bool, allocator,
                 demote_cb: Optional[Callable] = None):
        self.page_size = page_size
        self.enabled = enabled
        self.allocator = allocator
        # chained page key -> page id, LRU order (front = coldest)
        self._pages: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0  # pages reused
        # eviction seam: called with [(key, page_id)] while the pages'
        # contents are still valid (nothing allocates until it returns)
        self._demote_cb = demote_cb
        # keys inserted by page-in rather than by a local prefill
        self.adopted: set = set()
        self.adopted_hits = 0  # hits on adopted pages

    def __len__(self) -> int:
        return len(self._pages)

    def _keys(self, seq: Sequence[int], for_lookup: bool) -> List[bytes]:
        return token_prefix_digests(seq, self.page_size, for_lookup)

    def pages_held_alone(self) -> int:
        """Cached pages whose one reference is the cache's own.  With no
        request seated, free pages plus these make num_pages - 1; a
        leaked reference on a cached page shows as a shortfall."""
        return sum(1 for page in self._pages.values()
                   if self.allocator.refcount(page) == 1)

    def contains_key(self, key: bytes) -> bool:
        return key in self._pages

    def lookup(self, seq: Sequence[int]) -> List[int]:
        """Longest cached page run of `seq` (not yet shared: the caller
        shares on admission)."""
        return self.lookup_run(seq)[0]

    def lookup_run(self, seq: Sequence[int]) -> Tuple[List[int], List[bytes]]:
        """(cached page run, the whole lookup key chain): the chain past
        the run is what admission asks the tier store for."""
        if not self.enabled:
            return [], []
        keys = self._keys(seq, for_lookup=True)
        pages: List[int] = []
        for key in keys:
            page = self._pages.get(key)
            if page is None:
                break
            self._pages.move_to_end(key)  # LRU touch
            pages.append(page)
        return pages, keys

    def count_adopted_hits(self, hit_keys: Sequence[bytes]) -> None:
        """Count hits on adopted entries, once per admission served (a
        held request's repeated lookups must not count)."""
        self.adopted_hits += sum(1 for k in hit_keys if k in self.adopted)

    def register(self, prompt_ids: List[int], pages: List[int],
                 start_page: int = 0) -> None:
        """Register full prompt pages; `start_page` skips prefixes already
        registered (incremental registration, one chunk at a time)."""
        if not self.enabled:
            return
        for i, key in enumerate(self._keys(prompt_ids, for_lookup=False)):
            if i < start_page or key in self._pages:
                continue
            page = pages[i]
            self._pages[key] = page
            self.allocator.share([page])  # the cache's own reference

    def adopt(self, entries: Sequence[Tuple[bytes, int]]) -> None:
        """Insert paged-in entries, taking over each page's allocator
        reference (the page-in path allocated them for the cache); a key
        already present keeps its page and the duplicate is freed."""
        if not self.enabled:
            for _, page in entries:
                self.allocator.free([page])
            return
        for key, page in entries:
            if key in self._pages:
                self.allocator.free([page])
                continue
            self._pages[key] = page
            self.adopted.add(key)

    def ensure_allocatable(self, n: int) -> bool:
        """can_allocate(n), evicting cold cached pages (LRU) to get there.
        Evicted pages are offered to the demote seam first: their
        contents may be reused only after it returns."""
        evicted: List[Tuple[bytes, int]] = []
        while not self.allocator.can_allocate(n) and self._pages:
            key, page = self._pages.popitem(last=False)
            evicted.append((key, page))
            self.adopted.discard(key)
            # freed now so the loop's can_allocate sees it; the page stays
            # intact until the seam below returns (nothing allocates
            # before this method's caller regains control)
            self.allocator.free([page])
        if evicted and self._demote_cb is not None:
            try:
                self._demote_cb(evicted)
            except Exception:  # noqa: BLE001 — demotion is an optimization:
                # a failed gather or store must not fail the admission
                logger.exception("prefix-page demotion failed")
        return self.allocator.can_allocate(n)

    def hottest_digests(self, max_digests: int) -> List[str]:
        """Hex digests, the most recently used last."""
        if max_digests <= 0:
            return []
        return [k.hex() for k in list(self._pages.keys())[-max_digests:]]
