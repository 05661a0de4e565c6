"""The port's encoder runtime (runtimes/encoder_server.py) against the JAX
package's JAXEncoderModel on the CPU, with the same tiny weights: the
embeddings (float, base64, `dimensions`), rerank (`top_n`,
`return_documents`), V1 and V2 classification and fill-mask, and the
400s, called directly and over the port's server beside the JAX server
serving the same models (/openai/v1/embeddings and /rerank with their
/openai aliases, the V1 and V2 routes; 404 unknown, 503 not ready, 400
for the wrong kind of model).  Floats within 1e-5 (f32, another
summation order), labels, order and argmax exactly."""

import asyncio
import base64
import json

import numpy as np
import pytest
import torch
from aiohttp import ClientSession
from aiohttp.test_utils import TestClient, TestServer

import jax

from kserve_tpu.model_repository import ModelRepository as JModelRepository
from kserve_tpu.models import bert as jbert
from kserve_tpu.protocol.model_repository_extension import (
    ModelRepositoryExtension as JModelRepositoryExtension,
)
from kserve_tpu.protocol.openai import types as jtypes
from kserve_tpu.protocol.openai.dataplane import OpenAIDataPlane
from kserve_tpu.protocol.openai.openai_model import OpenAIGenerativeModel
from kserve_tpu.protocol.rest.server import RESTServer as JRESTServer
from kserve_tpu.runtimes.encoder_server import JAXEncoderModel
from kserve_tpu_torch.errors import InvalidInput
from kserve_tpu_torch.infer_type import InferInput, InferRequest
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.models import bert as tbert
from kserve_tpu_torch.protocol.openai import types as ttypes
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.runtimes import encoder_server

TOL = 1e-5
MAX_LENGTH = 64
TEXTS = ["hello world", "goodbye, cruel world!", "é ü"]
DOCS = ["tpus are accelerators", "bananas are yellow", "tpu serving", "x"]


def _pair(name, task="embedding"):
    """(JAX model, port model) with the same tiny weights."""
    j = JAXEncoderModel(name, config=jbert.BertConfig.tiny(), task=task,
                        random_weights=True, max_length=MAX_LENGTH)
    j.load()
    t = encoder_server.TorchEncoderModel(name, config=tbert.BertConfig.tiny(), task=task,
                                         random_weights=True, max_length=MAX_LENGTH,
                                         device="cpu")
    t.load()
    t.params = tbert.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                                     device="cpu")
    return j, t


@pytest.fixture(scope="module")
def models():
    return {"enc": _pair("enc"), "mlm": _pair("mlm", task="fill_mask")}


def _close(a, b, path=""):
    """Equal JSON, floats within TOL; base64 embeddings decoded first."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            if k in ("id", "created"):
                continue
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= TOL, (path, a, b)
    elif isinstance(a, str) and path.endswith(".embedding"):
        np.testing.assert_allclose(np.frombuffer(base64.b64decode(b), np.float32),
                                   np.frombuffer(base64.b64decode(a), np.float32),
                                   atol=TOL, rtol=0)
    else:
        assert a == b, (path, a, b)


EMBEDDINGS = [
    {"model": "enc", "input": TEXTS},
    {"model": "enc", "input": "one string"},
    {"model": "enc", "input": TEXTS, "encoding_format": "base64"},
    {"model": "enc", "input": TEXTS[:2], "dimensions": 8},
    {"model": "enc", "input": TEXTS[:1], "dimensions": 5, "encoding_format": "base64"},
]
RERANKS = [
    {"model": "enc", "query": "what is a tpu", "documents": DOCS},
    {"model": "enc", "query": "what is a tpu", "documents": DOCS, "top_n": 2},
    {"model": "enc", "query": "q", "documents": DOCS, "return_documents": False},
]


@pytest.mark.parametrize("body", EMBEDDINGS, ids=range(len(EMBEDDINGS)))
def test_embeddings_match_jax(models, body):
    j, t = models["enc"]
    want = asyncio.run(j.create_embedding(jtypes.EmbeddingRequest.model_validate(body)))
    got = asyncio.run(t.create_embedding(ttypes.EmbeddingRequest.from_json(body)))
    _close(want.model_dump(exclude_none=True), got.to_dict())
    vec = got.data[0].embedding
    if isinstance(vec, list) and "dimensions" not in body:
        assert abs(np.linalg.norm(vec) - 1.0) < 1e-5


@pytest.mark.parametrize("body", RERANKS, ids=range(len(RERANKS)))
def test_rerank_matches_jax(models, body):
    j, t = models["enc"]
    want = asyncio.run(j.create_rerank(jtypes.RerankRequest.model_validate(body)))
    got = asyncio.run(t.create_rerank(ttypes.RerankRequest.from_json(body)))
    assert [r.index for r in got.results] == [r.index for r in want.results]
    _close(want.model_dump(exclude_none=True), got.to_dict())


def _v2(pkg_request, pkg_input, texts):
    inp = pkg_input("text", [len(texts)], "BYTES")
    inp.set_data_from_numpy(np.array(texts, dtype=object), binary_data=False)
    return pkg_request(model_name="m", infer_inputs=[inp], request_id="r1")


@pytest.mark.parametrize("model", ["enc", "mlm"])
@pytest.mark.parametrize("form", ["v1", "v2"])
def test_predict_labels_and_argmax_match_jax(models, model, form):
    from kserve_tpu import infer_type as jit

    j, t = models[model]
    texts = ["good movie", "a bad, bad movie", "é"]
    if form == "v1":
        want = asyncio.run(j({"instances": texts}))
        got = asyncio.run(t({"instances": texts}))
        assert got == want
        if model == "mlm":  # every position of the bucket, padded ones too
            assert np.asarray(got["predictions"]).shape == (3, 16)
    else:
        want = asyncio.run(j(_v2(jit.InferRequest, jit.InferInput, texts)))
        got = asyncio.run(t(_v2(InferRequest, InferInput, texts)))
        np.testing.assert_array_equal(got.outputs[0].as_numpy(),
                                      want.outputs[0].as_numpy())
        assert got.outputs[0].datatype == want.outputs[0].datatype


@pytest.mark.parametrize("case", ["empty_input", "token_ids", "no_documents",
                                  "not_strings"])
def test_refusals_match_jax(models, case):
    j, t = models["enc"]
    from kserve_tpu.errors import InvalidInput as JInvalidInput

    if case in ("empty_input", "token_ids"):
        body = {"model": "enc", "input": [] if case == "empty_input" else [1, 2, 3]}
        calls = (lambda: j.create_embedding(jtypes.EmbeddingRequest.model_validate(body)),
                 lambda: t.create_embedding(ttypes.EmbeddingRequest.from_json(body)))
    elif case == "no_documents":
        body = {"model": "enc", "query": "q", "documents": []}
        calls = (lambda: j.create_rerank(jtypes.RerankRequest.model_validate(body)),
                 lambda: t.create_rerank(ttypes.RerankRequest.from_json(body)))
    else:
        calls = (lambda: j({"instances": [1, 2]}), lambda: t({"instances": [1, 2]}))
    with pytest.raises(JInvalidInput) as want:
        asyncio.run(calls[0]())
    with pytest.raises(InvalidInput) as got:
        asyncio.run(calls[1]())
    assert str(got.value) == str(want.value)


def test_unknown_task_and_no_cuda_raise(monkeypatch):
    with pytest.raises(ValueError, match="unknown task"):
        encoder_server.TorchEncoderModel("m", task="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = encoder_server.build_arg_parser().parse_args(
        ["--model_config=tiny", "--random_weights"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder_server.build_model(args)
    args.device = "cpu"
    model = encoder_server.build_model(args)
    assert model.load() and model.params["word_embeddings"].device.type == "cpu"
    assert model.config == tbert.BertConfig.tiny()


# ---------------- the routes, against the JAX server ----------------


class _PortGenerative:
    """A ready generative handle: it has completions, not embeddings."""

    name, ready = "gen", True

    async def create_completion(self, req, headers=None):
        raise AssertionError("not called")


V2_BODY = {"id": "r1", "inputs": [{"name": "text", "shape": [2], "datatype": "BYTES",
                                   "data": ["good movie", "bad"]}]}
ROUTES = (
    [("/openai/v1/embeddings", b) for b in EMBEDDINGS]
    + [("/openai/embeddings", EMBEDDINGS[0])]
    + [("/openai/v1/rerank", b) for b in RERANKS]
    + [("/openai/rerank", RERANKS[1]),
       ("/openai/v1/embeddings", {"model": "nope", "input": "x"}),
       ("/openai/v1/embeddings", {"model": "cold", "input": "x"}),
       ("/openai/v1/embeddings", {"model": "gen", "input": "x"}),
       ("/openai/v1/rerank", {"model": "gen", "query": "q", "documents": ["d"]}),
       ("/openai/v1/completions", {"model": "enc", "prompt": "hi"}),
       ("/openai/v1/embeddings", {"model": "enc", "input": []}),
       ("/openai/v1/embeddings", {"model": "enc", "input": "x", "encoding_format": "hex"}),
       ("/openai/v1/rerank", {"model": "enc", "query": "q", "documents": []}),
       ("/openai/v1/rerank", {"model": "enc", "documents": ["d"]}),
       ("/v1/models/enc:predict", {"instances": ["good movie", "bad"]}),
       ("/v1/models/mlm:predict", {"instances": ["good movie", "bad"]}),
       ("/v1/models/enc:predict", {"instances": [1, 2]}),
       ("/v2/models/enc/infer", V2_BODY),
       ("/v2/models/mlm/infer", V2_BODY)]
)


def test_routes_match_the_jax_server(models):
    cold_j, cold_t = _pair("cold")
    cold_j.ready = cold_t.ready = False

    async def main():
        jrepo = JModelRepository()
        gen = OpenAIGenerativeModel("gen")
        gen.ready = True
        for m in (models["enc"][0], models["mlm"][0], cold_j, gen):
            jrepo.update(m)
        jserver = JRESTServer(OpenAIDataPlane(jrepo), JModelRepositoryExtension(jrepo))
        trepo = ModelRepository()
        for m in (models["enc"][1], models["mlm"][1], cold_t, _PortGenerative()):
            trepo.update(m)
        tserver = RESTServer(trepo, "127.0.0.1", 0)
        port = await tserver.start()
        out = []
        try:
            async with TestClient(TestServer(jserver.create_application())) as jclient, \
                    ClientSession(f"http://127.0.0.1:{port}") as tclient:
                for path, body in ROUTES:
                    pair = []
                    for client in (jclient, tclient):
                        res = await client.post(path, data=json.dumps(body).encode(),
                                                headers={"Content-Type": "application/json"})
                        pair.append((res.status, json.loads(await res.read())))
                    out.append((path, body, *pair))
        finally:
            await tserver.stop()
        return out

    for path, body, (ws, want), (gs, got) in asyncio.run(main()):
        assert gs == ws, (path, body, want, got)
        if ws == 200:
            _close(want, got, path)
        elif body.get("model") == "gen" or path.endswith("/completions"):
            assert "does not support this endpoint" in got["error"]["message"]
