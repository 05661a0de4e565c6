"""storage-initializer entry point: download (src, dest) pairs before the
runtime container starts (port of kserve_tpu/storage/initializer.py).

Usage: python -m kserve_tpu_torch.storage.initializer [--manifest] <src> <dest> [...]

--manifest: after each download, write `.kserve_manifest.json` ({"files":
{relative path: size}}, keys sorted) into the dest dir, byte for byte as
the JAX initializer writes it.  The LocalModelNode agent verifies cached
copies against it (a missing or truncated file is corrupt and downloaded
again), and its absence marks an interrupted download.  A bad argument
count exits 2.
"""

from __future__ import annotations

import json
import os
import sys

from ..logging import configure_logging, logger
from .storage import Storage

MANIFEST_NAME = ".kserve_manifest.json"


def write_manifest(dest: str) -> None:
    files = {}
    for root, _, names in os.walk(dest):
        for name in names:
            if name == MANIFEST_NAME:
                continue
            path = os.path.join(root, name)
            files[os.path.relpath(path, dest)] = os.path.getsize(path)
    with open(os.path.join(dest, MANIFEST_NAME), "w") as f:
        json.dump({"files": files}, f, sort_keys=True)


def main(argv=None) -> int:
    configure_logging()
    args = list(argv if argv is not None else sys.argv[1:])
    manifest = False
    if args and args[0] == "--manifest":
        manifest = True
        args = args[1:]
    if len(args) < 2 or len(args) % 2 != 0:
        print(
            "usage: initializer [--manifest] <src-uri> <dest-dir> "
            "[<src-uri> <dest-dir> ...]",
            file=sys.stderr,
        )
        return 2
    for src, dest in zip(args[::2], args[1::2]):
        logger.info("initializer: %s -> %s", src, dest)
        Storage.download(src, dest)
        if manifest:
            write_manifest(dest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
