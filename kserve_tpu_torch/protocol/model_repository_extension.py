"""The repository extension (load and unload) of the V2 head (port of
kserve_tpu/protocol/model_repository_extension.py)."""

from __future__ import annotations

import asyncio
import inspect

from ..errors import ModelNotFound
from ..model_repository import ModelRepository


class ModelRepositoryExtension:
    def __init__(self, model_registry: ModelRepository):
        self._model_registry = model_registry

    async def load(self, model_name: str) -> None:
        loaded = await asyncio.get_running_loop().run_in_executor(
            None, self._model_registry.load, model_name
        )
        if not loaded:
            raise ModelNotFound(model_name)

    async def unload(self, model_name: str) -> None:
        try:
            stopped = self._model_registry.unload(model_name)
        except KeyError:
            raise ModelNotFound(model_name)
        if inspect.isawaitable(stopped):
            await stopped
