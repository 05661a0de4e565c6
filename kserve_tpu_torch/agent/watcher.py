"""Multi-model serving agent: watches the modelconfig that the TrainedModel
controller writes, downloads artifacts, and hot-loads and unloads models
(port of kserve_tpu/agent/watcher.py).

Reference: pkg/agent/watcher.go (the configmap mount), puller.go
(per-model serialized downloads), downloader.go, syncer.go (boot
reconcile).  One asyncio task polls the file's mtime; each sync diffs the
desired specs against the loaded ones, unloads what went, and (re)loads
what is new or changed; a model that fails to load is logged and left out,
and the others go on.  The default factory builds the port's predictive
models (runtimes/predictive_server.py) on cuda unless given a device.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Callable, Dict, Optional

from ..logging import logger
from ..model import BaseModel, _maybe_await
from ..model_repository import ModelRepository
from ..storage.storage import Storage

DEFAULT_CONFIG_FILE = "/mnt/configs/models.json"
DEFAULT_MODEL_DIR = "/mnt/models"


def default_model_factory(name: str, spec: dict, model_dir: str,
                          device=None) -> BaseModel:
    """A loaded predictive model from a modelconfig entry ({framework,
    storageUri, memory}), on `device` (cuda by default)."""
    framework = (spec.get("framework") or "sklearn").lower()
    from ..runtimes.predictive_server import build_model

    model = build_model(framework, name, model_dir, device=device)
    model.load()
    return model


class ModelAgent:
    """Reconciles the model repository against the modelconfig file."""

    def __init__(
        self,
        repository: ModelRepository,
        config_file: str = DEFAULT_CONFIG_FILE,
        models_dir: str = DEFAULT_MODEL_DIR,
        model_factory: Callable[[str, dict, str], BaseModel] = default_model_factory,
        poll_interval: float = 1.0,
    ):
        self.repository = repository
        self.config_file = config_file
        self.models_dir = models_dir
        self.model_factory = model_factory
        self.poll_interval = poll_interval
        self._specs: Dict[str, dict] = {}
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self._mtime = 0.0

    # ---------------- lifecycle ----------------

    async def start(self):
        await self.sync()  # boot reconcile (syncer.go's role)
        self._task = asyncio.create_task(self._watch_loop())

    async def stop(self):
        self._stopped = True
        if self._task:
            self._task.cancel()
            self._task = None

    async def _watch_loop(self):
        while not self._stopped:
            try:
                mtime = os.path.getmtime(self.config_file)
                if mtime != self._mtime:
                    self._mtime = mtime
                    await self.sync()
            except FileNotFoundError:
                pass
            except Exception:
                logger.exception("model agent sync failed")
            await asyncio.sleep(self.poll_interval)

    # ---------------- reconcile ----------------

    def _desired(self) -> Dict[str, dict]:
        try:
            with open(self.config_file) as f:
                entries = json.load(f)
        except FileNotFoundError:
            return {}
        desired = {}
        for entry in entries:
            name = entry.get("modelName")
            if name:
                desired[name] = entry.get("modelSpec", {})
        return desired

    async def sync(self):
        desired = self._desired()
        current = dict(self._specs)
        for name in current:
            if name not in desired:
                await self._unload(name)
        for name, spec in desired.items():
            if current.get(name) != spec:
                await self._load(name, spec)

    async def _load(self, name: str, spec: dict):
        logger.info("agent: loading model %s", name)
        try:
            model_dir = os.path.join(self.models_dir, name)
            uri = spec.get("storageUri")
            loop = asyncio.get_running_loop()
            if uri:
                await loop.run_in_executor(None, Storage.download, uri, model_dir)
            model = await loop.run_in_executor(
                None, self.model_factory, name, spec, model_dir)
            self.repository.update(model)
            self._specs[name] = spec
            logger.info("agent: model %s ready", name)
        except Exception:
            logger.exception("agent: failed to load model %s", name)

    async def _unload(self, name: str):
        logger.info("agent: unloading model %s", name)
        try:
            # an engine model's stop() is a coroutine
            await _maybe_await(self.repository.unload(name))
        except KeyError:
            pass
        self._specs.pop(name, None)
