"""Model-artifact discovery shared by the predictive runtimes (port of
kserve_tpu/runtimes/artifact.py)."""

from __future__ import annotations

import os
import pathlib
from typing import Sequence


def find_model_file(model_dir: str, extensions: Sequence[str]) -> str:
    """Resolve a model file: `model_dir` may be the file itself or a directory
    scanned (sorted) for the first matching extension.  Hidden files are
    passed over: the storage initializer's `.kserve_manifest.json` sorts
    before `model.json`, and the JAX runtimes pick it (ROADMAP C23)."""
    p = pathlib.Path(model_dir)
    if p.is_file():
        return str(p)
    if not p.is_dir():
        raise RuntimeError(f"model path {model_dir} does not exist")
    candidates = [f for f in sorted(os.listdir(p))
                  if f.endswith(tuple(extensions)) and not f.startswith(".")]
    if not candidates:
        raise RuntimeError(f"No model file with extension {tuple(extensions)} in {model_dir}")
    return str(p / candidates[0])
