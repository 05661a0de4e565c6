"""The port's multi-model agent (kserve_tpu_torch/agent/watcher.py): the
JAX agent's three cases (sync loads and unloads, the mtime watch picks up
a change, a changed spec reloads and an unchanged one does not), run
against the port and against the JAX agent side by side; an engine
model's stop() coroutine awaited on unload; one model's failed load
isolated from the others; and a real XGBoost dump pulled from a file://
URI by the default factory, whose V2 outputs equal the port's directly
built model and the JAX package's."""

import asyncio
import functools
import json
import os

import numpy as np
import pytest

import chip_smoke
from kserve_tpu.agent.watcher import ModelAgent as JModelAgent
from kserve_tpu.agent.watcher import default_model_factory as jfactory
from kserve_tpu.model import BaseModel as JBaseModel
from kserve_tpu.model_repository import ModelRepository as JModelRepository
from kserve_tpu_torch.agent import watcher
from kserve_tpu_torch.agent.watcher import ModelAgent, default_model_factory
from kserve_tpu_torch.infer_type import InferInput, InferRequest
from kserve_tpu_torch.model import BaseModel
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.runtimes.predictive_server import build_model

PACKAGES = {
    "port": (ModelAgent, ModelRepository, BaseModel),
    "jax": (JModelAgent, JModelRepository, JBaseModel),
}


def _stub_factory(base):
    class StubModel(base):
        def __init__(self, name):
            super().__init__(name)
            self.ready = True

    return lambda name, spec, model_dir: StubModel(name)


def write_config(path, entries):
    path.write_text(json.dumps(entries))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_sync_loads_and_unloads(tmp_path, pkg):
    Agent, Repo, base = PACKAGES[pkg]
    cfg = tmp_path / "models.json"
    write_config(cfg, [
        {"modelName": "a", "modelSpec": {"framework": "sklearn"}},
        {"modelName": "b", "modelSpec": {"framework": "xgboost"}},
    ])
    repo = Repo()
    agent = Agent(repo, config_file=str(cfg), models_dir=str(tmp_path),
                  model_factory=_stub_factory(base), poll_interval=0.05)
    asyncio.run(agent.sync())
    assert set(repo.get_models()) == {"a", "b"}
    write_config(cfg, [{"modelName": "b", "modelSpec": {"framework": "xgboost"}}])
    asyncio.run(agent.sync())
    assert set(repo.get_models()) == {"b"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_watch_picks_up_changes(tmp_path, pkg):
    Agent, Repo, base = PACKAGES[pkg]
    cfg = tmp_path / "models.json"
    write_config(cfg, [])
    repo = Repo()

    async def main():
        agent = Agent(repo, config_file=str(cfg), models_dir=str(tmp_path),
                      model_factory=_stub_factory(base), poll_interval=0.05)
        await agent.start()
        try:
            write_config(cfg, [{"modelName": "late", "modelSpec": {}}])
            os.utime(cfg, (0, 12345))  # force an mtime change
            for _ in range(40):
                if "late" in repo.get_models():
                    break
                await asyncio.sleep(0.05)
        finally:
            await agent.stop()

    asyncio.run(main())
    assert "late" in repo.get_models()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_spec_change_reloads(tmp_path, pkg):
    Agent, Repo, base = PACKAGES[pkg]
    cfg = tmp_path / "models.json"
    write_config(cfg, [{"modelName": "m", "modelSpec": {"v": 1}}])
    loads = []
    stub = _stub_factory(base)

    def counting_factory(name, spec, model_dir):
        loads.append(spec)
        return stub(name, spec, model_dir)

    agent = Agent(Repo(), config_file=str(cfg), models_dir=str(tmp_path),
                  model_factory=counting_factory)
    asyncio.run(agent.sync())
    asyncio.run(agent.sync())  # no change: no reload
    assert len(loads) == 1
    write_config(cfg, [{"modelName": "m", "modelSpec": {"v": 2}}])
    asyncio.run(agent.sync())
    assert len(loads) == 2


def test_engine_stop_is_awaited_and_a_failed_load_is_isolated(tmp_path):
    cfg = tmp_path / "models.json"
    write_config(cfg, [{"modelName": "engine", "modelSpec": {}},
                       {"modelName": "broken", "modelSpec": {}},
                       {"modelName": "plain", "modelSpec": {}}])
    stopped = []

    class EngineModel(BaseModel):
        def __init__(self, name):
            super().__init__(name)
            self.ready = True

        async def stop(self):  # an engine model's stop is a coroutine
            stopped.append(self.name)

    def factory(name, spec, model_dir):
        if name == "broken":
            raise RuntimeError("no artifact")
        return EngineModel(name)

    repo = ModelRepository()
    agent = ModelAgent(repo, config_file=str(cfg), models_dir=str(tmp_path),
                       model_factory=factory)
    asyncio.run(agent.sync())
    assert set(repo.get_models()) == {"engine", "plain"}
    write_config(cfg, [{"modelName": "plain", "modelSpec": {}}])
    asyncio.run(agent.sync())
    assert set(repo.get_models()) == {"plain"} and stopped == ["engine"]


def _v2(model, X):
    req = InferRequest(model_name=model.name, infer_inputs=[
        InferInput("input-0", list(X.shape), "FP32", data=X)])
    res = asyncio.run(model(req))
    return res.outputs[0].as_numpy()


def test_xgboost_dump_from_a_file_uri(tmp_path):
    """The default factory over a file:// storageUri (an XGBoost dump and
    a .tar.gz of another): V2 outputs equal to the port's directly built
    model's, and the JAX agent's predictions equal to them within 1e-6."""
    import tarfile

    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    src.mkdir()
    (src / "model.json").write_text(json.dumps(chip_smoke.xgb_dump(rng, 20, 4, 6)))
    packed = tmp_path / "other"
    packed.mkdir()
    (packed / "model.json").write_text(json.dumps(chip_smoke.xgb_dump(rng, 30, 3, 6)))
    with tarfile.open(tmp_path / "other.tar.gz", "w:gz") as tar:
        tar.add(packed / "model.json", arcname="model.json")
    cfg = tmp_path / "models.json"
    write_config(cfg, [
        {"modelName": "xgb", "modelSpec": {"framework": "xgboost",
                                           "storageUri": f"file://{src}"}},
        {"modelName": "xgb-tgz", "modelSpec": {"framework": "xgboost",
                                               "storageUri": f"file://{tmp_path}/other.tar.gz"}},
    ])
    repo = ModelRepository()
    agent = ModelAgent(repo, config_file=str(cfg), models_dir=str(tmp_path / "models"),
                       model_factory=functools.partial(default_model_factory, device="cpu"))
    asyncio.run(agent.sync())
    assert set(repo.get_models()) == {"xgb", "xgb-tgz"}
    jrepo = JModelRepository()
    jagent = JModelAgent(jrepo, config_file=str(cfg),
                         models_dir=str(tmp_path / "jmodels"), model_factory=jfactory)
    asyncio.run(jagent.sync())
    X = rng.normal(size=(16, 6)).astype(np.float32)
    for name, direct_dir in (("xgb", src), ("xgb-tgz", packed)):
        served = repo.get_model(name)
        assert served.ready and served.device.type == "cpu"
        direct = build_model("xgboost", name, str(direct_dir), device="cpu")
        direct.load()
        got, want = _v2(served, X), _v2(direct, X)
        np.testing.assert_array_equal(got, want)
        jpred = asyncio.run(jrepo.get_model(name)({"instances": X.tolist()}))["predictions"]
        np.testing.assert_allclose(got, np.asarray(jpred), atol=1e-6, rtol=0)


def test_default_factory_runs_on_cuda_unless_given_a_device(tmp_path, monkeypatch):
    import torch

    (tmp_path / "model.json").write_text(json.dumps(
        chip_smoke.xgb_dump(np.random.default_rng(1), 2, 2, 3)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        watcher.default_model_factory("m", {"framework": "xgboost"}, str(tmp_path))
    model = watcher.default_model_factory("m", {"framework": "xgboost"}, str(tmp_path),
                                          device="cpu")
    assert model.ready
