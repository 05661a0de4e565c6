"""Name -> model registry with load and unload (port of
kserve_tpu/model_repository.py).

A registered object is a `BaseModel` or a handle with the same duck type
(a `name`, a `ready` flag, and `stop()` / `start_engine()` where it has an
engine, as the generative models do); a handle without `ready` counts as
ready, as the JAX registry counts its handles.
"""

from __future__ import annotations

from typing import Dict, Optional

from .model import BaseModel


class ModelRepository:
    """The registry the data plane dispatches against.  `models` may be a
    dict to share (the REST server's), keyed by name."""

    def __init__(self, models: Optional[Dict[str, object]] = None):
        self.models: Dict[str, object] = {} if models is None else models

    def get_model(self, name: str):
        """The model of `name`, directly or through an alias (a LoRA adapter
        selects its model by the OpenAI `model` field)."""
        model = self.models.get(name)
        if model is not None:
            return model
        for candidate in self.models.values():
            if name in getattr(candidate, "aliases", ()):
                return candidate
        return None

    def get_models(self) -> Dict[str, object]:
        return self.models

    async def is_model_ready(self, name: str) -> bool:
        model = self.get_model(name)
        if model is None:
            return False
        return bool(getattr(model, "ready", True))

    def update(self, model):
        self.models[model.name] = model

    def load(self, name: str) -> bool:
        """Load a registered model that is not ready; whether it is ready
        after.  Runtimes that serve many models override this."""
        model = self.get_model(name)
        if model is None:
            return False
        if isinstance(model, BaseModel) and not model.ready:
            model.load()
        return bool(getattr(model, "ready", True))

    def unload(self, name: str):
        """Remove `name` and return what its `stop()` returned (a
        coroutine for an engine model, for the caller to await)."""
        if name not in self.models:
            raise KeyError(f"model with name {name} does not exist")
        model = self.models.pop(name)
        stop = getattr(model, "stop", None)
        return stop() if stop is not None else None
