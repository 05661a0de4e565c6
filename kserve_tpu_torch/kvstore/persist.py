"""Content-addressed persistent prefix store: digest-named KV page files
that survive a restart.

Port of kserve_tpu/kvstore/persist.py.  Each file holds the device KV of one
page-aligned prefix page, named by the prefix cache's blake2b chain key.
The key commits to every token of the prefix and to the page size, so a
file cannot be replayed against another prompt.  A restarted server
indexes the directory at construction and pages hot prefixes back in on
first use.  `read_page_bytes` hands an entry's file bytes to the peer
page server (kvstore/peer.py), and `generation` stamps the digest set
that peers learn of.

Failure semantics:

- a write is atomic (a temporary file, then a rename), so a torn write is
  never visible;
- a corrupt, truncated, foreign or older-format entry logs a warning,
  counts a ``corrupt`` event, is unlinked best-effort and reads as a miss:
  the engine prefills the page again;
- every filesystem error is survivable: a read-only or full volume turns
  the layer into a no-op, it never stops serving.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Callable, List, Optional, Set

import numpy as np

from .payload import Payload, payload_arrays, payload_from_arrays

logger = logging.getLogger(__name__)

#: bump when the entry layout changes: older entries read as corrupt
#: (logged and prefilled again), never misread.  The JAX package writes
#: format 1 (numpy payloads with ml_dtypes bfloat16); this port's entries
#: keep bfloat16 as int16 bits with dtype tags (kvstore/payload.py), so a
#: file of either package reads as corrupt in the other
PERSIST_FORMAT = 2

_PREFIX = "px-"
_SUFFIX = ".kvpage"


def kv_persist_dir_from_env() -> Optional[str]:
    """``KSERVE_TPU_KV_PERSIST`` names the persistent prefix directory;
    empty or unset disables the layer."""
    value = os.environ.get("KSERVE_TPU_KV_PERSIST", "").strip()
    return value or None


class PersistentPrefixStore:
    """One digest -> one ``px-<hex>.kvpage`` npz file under `root`."""

    def __init__(self, root: str,
                 on_event: Optional[Callable[[str, str], None]] = None):
        self.root = root
        self._on_event = on_event
        self._digests: Set[bytes] = set()
        self.writable = True
        # bumped on every change of the digest set (a store, a corrupt
        # entry dropped), so that peers' indexes age out stale snapshots
        self.generation = 0
        try:
            os.makedirs(root, exist_ok=True)
        except OSError as exc:
            logger.warning("kv-persist-disabled dir=%s error=%s", root,
                           f"{type(exc).__name__}: {exc}")
            self.writable = False
        self._index()

    def _event(self, event: str) -> None:
        if self._on_event is not None:
            self._on_event("persist", event)

    def _index(self) -> None:
        """Scan the directory once: the digests this server holds before
        it has prefilled anything."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
                continue
            try:
                self._digests.add(bytes.fromhex(name[len(_PREFIX):-len(_SUFFIX)]))
            except ValueError:
                continue  # a foreign file: ignored, never deleted

    def _path(self, digest: bytes) -> str:
        return os.path.join(self.root, f"{_PREFIX}{digest.hex()}{_SUFFIX}")

    def __len__(self) -> int:
        return len(self._digests)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._digests

    def digests(self) -> List[bytes]:
        return sorted(self._digests)

    def read_page_bytes(self, digest: bytes) -> Optional[bytes]:
        """One entry's file bytes, as they are on disk, for the peer page
        server: the fetching peer verifies them before it adopts them, so
        nothing is checked here.  None on a miss or a filesystem error
        (the peer reads a 404 and prefills the page)."""
        if digest not in self._digests:
            return None
        try:
            with open(self._path(digest), "rb") as f:
                return f.read()
        except OSError:
            return None

    def store(self, digest: bytes, payload: Payload) -> bool:
        """Persist one page payload (atomic).  Content addressed: an
        existing entry is never rewritten.  A full or read-only volume
        logs and returns False."""
        if not self.writable:
            return False
        if digest in self._digests:
            return True
        tmp_name = None
        try:
            with tempfile.NamedTemporaryFile(
                    "wb", dir=self.root, suffix=".tmp", delete=False) as f:
                tmp_name = f.name
                np.savez(f, fmt=np.int64(PERSIST_FORMAT), **payload_arrays(payload))
            os.replace(tmp_name, self._path(digest))
            tmp_name = None
            self._digests.add(digest)
            self.generation += 1
            self._event("store")
            return True
        except (OSError, ValueError) as exc:
            logger.warning("kv-persist-store-failed digest=%s error=%s",
                           digest.hex(), f"{type(exc).__name__}: {exc}")
            return False
        finally:
            if tmp_name is not None:
                try:
                    os.unlink(tmp_name)
                except OSError:
                    pass

    def load(self, digest: bytes) -> Optional[Payload]:
        """One page payload; None on a miss or any corruption (the entry
        is unlinked best-effort and the engine prefills the page again)."""
        if digest not in self._digests:
            return None
        path = self._path(digest)
        try:
            with np.load(path) as data:
                fmt = int(data["fmt"])
                if fmt != PERSIST_FORMAT:
                    raise ValueError(f"format skew: {fmt} != {PERSIST_FORMAT}")
                return payload_from_arrays(data)
        except Exception as exc:  # noqa: BLE001 — corrupt-entry containment:
            # np.load raises OSError, ValueError, BadZipFile or KeyError by
            # where the file is torn; all mean the same here
            self._event("corrupt")
            logger.warning(
                "kv-persist-entry-corrupt digest=%s path=%s error=%s: the page "
                "will be prefilled again", digest.hex(), path,
                f"{type(exc).__name__}: {exc}")
            self._digests.discard(digest)
            self.generation += 1
            # best-effort, and skipped on a volume known to be read-only:
            # the discard above already makes the entry a miss
            if self.writable:
                try:
                    os.unlink(path)
                except OSError as unlink_exc:
                    logger.warning(
                        "kv-persist-unlink-failed digest=%s error=%s: entry "
                        "left on disk (read-only volume?); writes disabled",
                        digest.hex(), f"{type(unlink_exc).__name__}: {unlink_exc}")
                    self.writable = False
            return None
