"""The PyTorch port stands alone: importing it loads neither jax nor the
JAX package, no source of it (or chip_smoke.py) imports them or
ml_dtypes (the card machine has none: the port's KV payloads keep
bfloat16 as int16 bits; the V2 codec alone looks ml_dtypes up, inside a
function, for the optional BF16 datatype, as the JAX codec does), nor
any package the card machine lacks
(aiohttp, httpx, pydantic, prometheus_client, ...: the HTTP layer, the
lifecycle and resilience layers and the metrics are standard library),
and its entry points refuse to run without CUDA unless asked for the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "kserve_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "kserve_tpu", "ml_dtypes"}
# (file, root) pairs allowed as a lazy, optional import
OPTIONAL_FORBIDDEN = {("kserve_tpu_torch/utils/numpy_codec.py", "ml_dtypes")}


def _port_modules():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_import_loads_no_jax_and_no_jax_package():
    assert {"kserve_tpu_torch.models.moe", "kserve_tpu_torch.protocol.pd",
            "kserve_tpu_torch.protocol.http_client", "kserve_tpu_torch.kvstore.peer",
            "kserve_tpu_torch.resilience.retry",
            "kserve_tpu_torch.resilience.breaker",
            "kserve_tpu_torch.model", "kserve_tpu_torch.model_repository",
            "kserve_tpu_torch.infer_type", "kserve_tpu_torch.utils.numpy_codec",
            "kserve_tpu_torch.utils.inference", "kserve_tpu_torch.protocol.dataplane",
            "kserve_tpu_torch.protocol.model_repository_extension",
            "kserve_tpu_torch.protocol.rest.v1_endpoints",
            "kserve_tpu_torch.protocol.rest.v2_endpoints",
            "kserve_tpu_torch.runtimes.artifact", "kserve_tpu_torch.runtimes.gbdt_server",
            "kserve_tpu_torch.runtimes.sklearn_server",
            "kserve_tpu_torch.runtimes.predictive_server",
            "kserve_tpu_torch.runtimes.tensorize.trees",
            "kserve_tpu_torch.runtimes.tensorize.xgb_parse",
            "kserve_tpu_torch.runtimes.tensorize.lgb_parse",
            "kserve_tpu_torch.runtimes.tensorize.sklearn_convert",
            "kserve_tpu_torch.models.bert", "kserve_tpu_torch.runtimes.encoder_server",
            "kserve_tpu_torch.protocol.openai.openai_model",
            "kserve_tpu_torch.protocol.rest.http_server", "kserve_tpu_torch.tracing",
            "kserve_tpu_torch.inference_client", "kserve_tpu_torch.graph.router",
            "kserve_tpu_torch.scheduler.epp", "kserve_tpu_torch.scheduler.picker",
            "kserve_tpu_torch.scheduler.health", "kserve_tpu_torch.scheduler.latency",
            "kserve_tpu_torch.autoscale.signals", "kserve_tpu_torch.logging",
            "kserve_tpu_torch.observability.spans",
            "kserve_tpu_torch.observability.introspection",
            "kserve_tpu_torch.protocol.limits",
            "kserve_tpu_torch.autoscale.policy", "kserve_tpu_torch.autoscale.hold",
            "kserve_tpu_torch.autoscale.loop", "kserve_tpu_torch.autoscale.actuator",
            "kserve_tpu_torch.autoscale.__main__", "kserve_tpu_torch.activator",
            "kserve_tpu_torch.api.http_transport", "kserve_tpu_torch.controlplane.gvk",
            "kserve_tpu_torch.storage.storage", "kserve_tpu_torch.storage.initializer",
            "kserve_tpu_torch.agent.watcher", "kserve_tpu_torch.protocol.timeseries",
            "kserve_tpu_torch.runtimes.timeseries_server",
            "kserve_tpu_torch.runtimes.explainer_server",
            } <= set(_port_modules())
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'kserve_tpu',\n"
        "                                    'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            root = mod.split(".")[0]
            assert root not in FORBIDDEN_ROOTS or (rel, root) in OPTIONAL_FORBIDDEN, (
                f"{rel}:{node.lineno} imports {mod}")


def test_entry_points_raise_without_cuda(monkeypatch):
    from kserve_tpu_torch.device import resolve_device
    from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
    from kserve_tpu_torch.models.llama import LlamaConfig
    from kserve_tpu_torch.runtimes.generative_server import (
        TorchGenerativeModel,
        build_arg_parser,
        build_model,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(cfg, EngineConfig(dtype="float32"), ByteTokenizer(512))
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchGenerativeModel("m", cfg, random_weights=True)
    args = build_arg_parser().parse_args(
        ["--model_config=tiny", "--random_weights"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(args)
    # asking for the CPU is allowed
    assert resolve_device("cpu").type == "cpu"


def test_engine_rejects_what_the_slice_does_not_run():
    from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
    from kserve_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig.tiny(dtype="float32")
    for knob in (dict(tp=2), dict(pp=2), dict(sp=2), dict(dp=2)):
        with pytest.raises(NotImplementedError):
            LLMEngine(cfg, EngineConfig(dtype="float32", **knob),
                      ByteTokenizer(512), device="cpu")
    # int8 weights are served (tests/test_torch_quant.py); another
    # weight_quant is refused as the JAX engine refuses it
    with pytest.raises(ValueError, match="weight_quant"):
        LLMEngine(cfg, EngineConfig(dtype="float32", weight_quant="int4"),
                  ByteTokenizer(512), device="cpu")


# packages the card machine does not have, or is not promised: the port
# keeps its own standard-library readers and writers instead (jinja2, for
# chat templates, and yaml, for HTTPCluster.apply_yaml, are imported only
# inside the function that needs them)
CARD_MISSING = {"safetensors", "tokenizers", "regex", "prometheus_client",
                "aiohttp", "httpx", "pydantic", "jinja2", "yaml"}
OPTIONAL_IMPORTS = {("kserve_tpu_torch/engine/tokenizer.py", "jinja2"),
                    ("chip_smoke.py", "jinja2"),
                    ("kserve_tpu_torch/api/http_transport.py", "yaml")}


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_only_what_the_card_machine_has(path):
    rel = str(path.relative_to(REPO))
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            root = mod.split(".")[0]
            assert root not in CARD_MISSING or (rel, root) in OPTIONAL_IMPORTS, (
                f"{rel}:{node.lineno} imports {mod}")


def test_checkpoint_server_needs_none_of_them(tmp_path):
    """A --model_dir server's modules load, and a tokenizer.json and a
    safetensors shard are read, with every package the card machine lacks
    blocked."""
    code = (
        "import sys\n"
        f"for name in {sorted(CARD_MISSING)!r}:\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from kserve_tpu_torch.runtimes import generative_server\n"
        "from kserve_tpu_torch.models import safetensors_io as sio\n"
        "from kserve_tpu_torch.engine.tokenizer import HFTokenizer\n"
        "from kserve_tpu_torch import metrics\n"
        "from kserve_tpu_torch import lifecycle, resilience, model_server\n"
        "from kserve_tpu_torch.engine import watchdog\n"
        "from kserve_tpu_torch.protocol import pd, http_client\n"
        "from kserve_tpu_torch.kvstore import peer\n"
        "from kserve_tpu_torch.resilience import FaultInjectingTransport, RetryPolicy\n"
        "kv = torch.arange(8, dtype=torch.float32).to(torch.bfloat16).reshape(1, 1, 2, 1, 2, 2)\n"
        "meta, payload = pd.serialize_kv(kv, 3)\n"
        "back, first = pd.deserialize_kv(meta, bytes(payload))\n"
        "assert first == 3 and torch.equal(back, kv)\n"
        "assert bytes(peer.decode_page(peer.encode_page(b'x' * 16, b'abc'), b'x' * 16)) == b'abc'\n"
        "ck = lifecycle.GenerationCheckpoint('r', [1, 2], [3])\n"
        "assert lifecycle.GenerationCheckpoint.from_header(ck.to_header()) == ck\n"
        "assert resilience.Deadline.from_header('1.5').remaining() > 1\n"
        f"d = {str(tmp_path)!r}\n"
        "sio.save_file({'w': torch.ones(2, dtype=torch.bfloat16)}, d + '/m.safetensors')\n"
        "(_, w), = sio.iter_tensors(d + '/m.safetensors')\n"
        "assert w.tolist() == [1.0, 1.0]\n"
        "import json\n"
        "json.dump({'model': {'type': 'BPE', 'vocab': {'a': 0, 'b': 1, 'ab': 2},\n"
        "           'merges': ['a b']}}, open(d + '/tokenizer.json', 'w'))\n"
        "json.dump({'chat_template': '{{ x }}'}, open(d + '/tokenizer_config.json', 'w'))\n"
        "tok = HFTokenizer(d)\n"
        "assert tok.encode('abab') == [2, 2] and tok.chat_template_mode == 'default'\n"
        "assert metrics.generate_latest()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_predictive_server_needs_none_of_them(tmp_path):
    """The predictive runtimes' modules load, and an XGBoost dump and a
    plainly pickled estimator are served on the CPU, with every package
    the card machine lacks blocked, sklearn, joblib, pandas and ml_dtypes
    with them."""
    code = (
        "import json, pickle, sys\n"
        f"for name in {sorted(CARD_MISSING | {'sklearn', 'joblib', 'pandas', 'ml_dtypes'})!r}:\n"
        "    sys.modules[name] = None\n"
        "import asyncio, numpy as np\n"
        "from kserve_tpu_torch.runtimes import predictive_server\n"
        "from kserve_tpu_torch.utils import numpy_codec\n"
        "from kserve_tpu_torch.protocol.rest import server\n"
        "assert numpy_codec.to_np_dtype('BF16') is None\n"
        f"d = {str(tmp_path)!r}\n"
        "tree = {'left_children': [1, -1, -1], 'right_children': [2, -1, -1],\n"
        "        'split_indices': [0, 0, 0], 'split_conditions': [0.5, 0.2, -0.1]}\n"
        "doc = {'learner': {'learner_model_param': {'base_score': '0.5', 'num_class': '0',\n"
        "       'num_feature': '1'}, 'objective': {'name': 'binary:logistic'},\n"
        "       'gradient_booster': {'name': 'gbtree', 'model': {'tree_info': [0],\n"
        "       'trees': [tree]}}}}\n"
        "json.dump(doc, open(d + '/model.json', 'w'))\n"
        "m = predictive_server.build_model('xgboost', 'x', d, device='cpu')\n"
        "assert m.load()\n"
        "p = asyncio.run(m({'instances': [[0.0], [1.0]]}))['predictions']\n"
        "assert np.allclose(p, 1 / (1 + np.exp(-np.array([0.2, -0.1])))), p\n"
        "class LinearRegression:\n"
        "    pass\n"
        "est = LinearRegression()\n"
        "est.coef_, est.intercept_, est.n_features_in_ = np.array([2.0]), 1.0, 1\n"
        "import os; os.makedirs(d + '/lin')\n"
        "pickle.dump(est, open(d + '/lin/model.pkl', 'wb'))\n"
        "sys.modules['__main__'].LinearRegression = LinearRegression\n"
        "m = predictive_server.build_model('sklearn', 'l', d + '/lin', device='cpu')\n"
        "assert m.load() and m._tensorized is not None\n"
        "assert asyncio.run(m({'instances': [[3.0]]}))['predictions'] == [7.0]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_encoder_and_router_need_none_of_them(tmp_path):
    """The encoder runtime, the graph router and the inference client load,
    and a BERT checkpoint with a WordPiece tokenizer.json is served on the
    CPU, with every package the card machine lacks blocked."""
    code = (
        "import asyncio, json, sys\n"
        f"for name in {sorted(CARD_MISSING)!r}:\n"
        "    sys.modules[name] = None\n"
        "from kserve_tpu_torch.runtimes import encoder_server\n"
        "from kserve_tpu_torch.graph import router\n"
        "from kserve_tpu_torch import inference_client, tracing\n"
        "from kserve_tpu_torch.models import bert, safetensors_io as sio\n"
        "from kserve_tpu_torch.protocol.openai.types import EmbeddingRequest\n"
        f"d = {str(tmp_path)!r}\n"
        "cfg = bert.BertConfig.tiny()\n"
        "params = bert.init_params(cfg, seed=2, device='cpu')\n"
        "sio.save_file(bert.hf_tensors(params), d + '/model.safetensors')\n"
        "json.dump({'vocab_size': 128, 'hidden_size': 32, 'num_hidden_layers': 2,\n"
        "           'num_attention_heads': 4, 'intermediate_size': 64,\n"
        "           'max_position_embeddings': 64}, open(d + '/config.json', 'w'))\n"
        "vocab = {t: i for i, t in enumerate(['[PAD]', '[UNK]', 'hello', '##s', ','])}\n"
        "json.dump({'normalizer': {'type': 'BertNormalizer'},\n"
        "           'pre_tokenizer': {'type': 'BertPreTokenizer'},\n"
        "           'decoder': {'type': 'WordPiece'},\n"
        "           'model': {'type': 'WordPiece', 'vocab': vocab}}, open(d + '/tokenizer.json', 'w'))\n"
        "m = encoder_server.TorchEncoderModel('e', model_dir=d, device='cpu')\n"
        "assert m.load() and m.tokenizer.encode('Hellos, x', add_bos=False) == [2, 3, 4, 1]\n"
        "assert all(bool((a == b).all()) for a, b in zip(\n"
        "    bert.hf_tensors(m.params).values(), bert.hf_tensors(params).values()))\n"
        "out = asyncio.run(m.create_embedding(EmbeddingRequest.from_json(\n"
        "    {'model': 'e', 'input': 'hello'})))\n"
        "assert len(out.data[0].embedding) == 32\n"
        "assert router.GraphRouter({'nodes': {}}).retry_policy.max_attempts == 2\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_epp_and_tracer_need_none_of_them():
    """The EPP, the picker and its health and latency layers, the span
    tracer and exporter, logging and the profiler route load, and the
    EPP's entry point parses its flags, with every package the card
    machine lacks blocked (opentelemetry and grpc with them)."""
    code = (
        "import sys\n"
        f"for name in {sorted(CARD_MISSING | {'opentelemetry', 'grpc'})!r}:\n"
        "    sys.modules[name] = None\n"
        "from kserve_tpu_torch.scheduler import epp, picker, health, latency\n"
        "from kserve_tpu_torch.autoscale import signals\n"
        "from kserve_tpu_torch import tracing, logging as tlogging\n"
        "from kserve_tpu_torch.observability import introspection, spans\n"
        "args = epp.build_arg_parser().parse_args(['--replicas', 'http://a:1'])\n"
        "p = epp.build_picker(args)\n"
        "assert list(p.replicas) == ['http://a:1'] and p.prefix_weight == 4.0\n"
        "t = tracing.Tracer(None)\n"
        "with t.start_as_current_span('x') as s:\n"
        "    assert tracing.current_span() is s\n"
        "assert tracing.otlp_request([s], 'svc')['resourceSpans'][0]['scopeSpans']\n"
        "tlogging.configure_logging()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_autoscaler_and_activator_need_none_of_them():
    """The autoscaler (policies, hold queue, loop, actuator, CLI), the
    Kubernetes transport and the activator load, parse their flags and
    take one decision, with every package the card machine lacks blocked
    (PyYAML with them: apply_yaml alone needs it, and says so); and
    chip_smoke.py has the `scale` phase that drives them on the card."""
    code = (
        "import sys\n"
        f"for name in {sorted(CARD_MISSING)!r}:\n"
        "    sys.modules[name] = None\n"
        "from kserve_tpu_torch import activator, autoscale\n"
        "from kserve_tpu_torch.autoscale import __main__ as cli\n"
        "from kserve_tpu_torch.api import http_transport\n"
        "from kserve_tpu_torch.controlplane import gvk\n"
        "args = cli.build_arg_parser().parse_args(['--epp-url', 'http://e', "
        "'--deployment', 'd'])\n"
        "policy = cli.build_policy(args)\n"
        "d = policy.decide(autoscale.FleetSignals(held_requests=3), 0)\n"
        "assert (d.action, d.reason) == ('scale_up', 'hold_demand'), d\n"
        "a = activator.Activator('http://b:1', port=0)\n"
        "assert a.holds.max_holds == 512 and a.stats['buffered'] == 0\n"
        "assert gvk.object_path(gvk.BUILTIN_RESOURCES['Deployment'], 'ns', 'x') == "
        "'/apis/apps/v1/namespaces/ns/deployments/x'\n"
        "try:\n"
        "    http_transport.HTTPCluster('http://127.0.0.1:9').apply_yaml('x.yaml')\n"
        "except ImportError as e:\n"
        "    assert 'PyYAML' in str(e)\n"
        "else:\n"
        "    raise AssertionError('apply_yaml ran without PyYAML')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    phases = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", "") == "SERVED_PHASES")
    assert "scale" in {k.value for k in phases.keys}


def test_storage_agent_forecaster_and_explainer_need_none_of_them(tmp_path):
    """Storage and the initializer (urllib in place of httpx), the agent,
    the time-series protocol and forecaster and the explainer load and
    run on the CPU with every package the card machine lacks blocked
    (the SDK-gated providers with them); and chip_smoke.py has the phases
    that drive them on the card."""
    code = (
        "import asyncio, json, os, sys\n"
        f"for name in {sorted(CARD_MISSING | {'boto3', 'huggingface_hub', 'grpc'})!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from kserve_tpu_torch.storage import storage, initializer\n"
        "from kserve_tpu_torch.agent import watcher\n"
        "from kserve_tpu_torch.protocol import timeseries\n"
        "from kserve_tpu_torch.runtimes import timeseries_server, explainer_server\n"
        f"d = {str(tmp_path)!r}\n"
        "os.makedirs(d + '/src/sub')\n"
        "open(d + '/src/sub/w.bin', 'wb').write(b'w' * 10)\n"
        "assert initializer.main(['--manifest', d + '/src', d + '/out']) == 0\n"
        "m = json.load(open(d + '/out/.kserve_manifest.json'))\n"
        "assert m == {'files': {'sub/w.bin': 10}}, m\n"
        "try:\n"
        "    storage.Storage.download('hf://org/repo', d + '/hf')\n"
        "except storage.StorageError as e:\n"
        "    assert 'huggingface_hub' in str(e)\n"
        "else:\n"
        "    raise AssertionError('hf:// ran without huggingface_hub')\n"
        "fc = timeseries_server.SeasonalNaiveForecaster('fc', device='cpu')\n"
        "fc.load()\n"
        "req = timeseries.ForecastRequest.from_json({'model': 'fc', 'inputs': [\n"
        "    {'type': 'univariate_time_series', 'name': 's', 'frequency': 'H',\n"
        "     'series': [1.0, 5.0, 2.0, 8.0] * 4}], 'options': {'horizon': 4}})\n"
        "out = asyncio.run(fc.create_forecast(req)).to_dict()\n"
        "assert out['outputs'][0]['content'][0]['mean_forecast'] == [1.0, 5.0, 2.0, 8.0]\n"
        "masks = np.array([[0, 0], [1, 1], [1, 0], [0, 1]], dtype=np.float64)\n"
        "w = explainer_server._shapley_kernel_weights(masks.sum(1), 2)\n"
        "phi = explainer_server.kernelshap_solve(masks, masks @ [2.0, 1.0], w, 'cpu')\n"
        "assert np.allclose(phi, [2.0, 1.0], atol=1e-5), phi\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    phases = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                  and getattr(node.targets[0], "id", "") == "SERVED_PHASES")
    assert {"artifacts", "explain", "forecast"} <= {k.value for k in phases.keys}
