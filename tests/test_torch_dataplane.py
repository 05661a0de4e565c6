"""The port's V1/V2 data plane against the JAX package's on the CPU: the
numpy codec, the infer types' JSON and binary forms (byte-equal for the
same tensors), DataPlane.decode / encode (V2 JSON, the binary-tensor
extension, structured and binary CloudEvents), and the V1 and V2 routes
of the port's standard-library server against the JAX aiohttp server
serving the same models: bodies equal (FP32 data within 1e-6), including
the 400 / 404 / 501 / 503 answers, a generative handle in the same
repository, and the request stage histograms on /metrics."""

import asyncio
import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from kserve_tpu import infer_type as jit
from kserve_tpu import metrics as jmetrics
from kserve_tpu.model import Model as JModel
from kserve_tpu.model_repository import ModelRepository as JModelRepository
from kserve_tpu.protocol.dataplane import DataPlane as JDataPlane
from kserve_tpu.protocol.model_repository_extension import (
    ModelRepositoryExtension as JModelRepositoryExtension,
)
from kserve_tpu.protocol.openai.openai_model import OpenAIGenerativeModel
from kserve_tpu.protocol.rest.server import RESTServer as JRESTServer
from kserve_tpu.runtimes import gbdt_server as jgbdt
from kserve_tpu.utils import numpy_codec as jcodec
from kserve_tpu_torch import infer_type as tit
from kserve_tpu_torch.errors import InvalidInput
from kserve_tpu_torch.model import Model
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.protocol.dataplane import DataPlane
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.runtimes import gbdt_server
from kserve_tpu_torch.utils import numpy_codec as tcodec
from test_predictive_runtimes import XGB_BINARY

OIP_TYPES = ["BOOL", "UINT8", "UINT16", "UINT32", "UINT64", "INT8", "INT16", "INT32",
             "INT64", "FP16", "FP32", "FP64", "BF16", "BYTES", "NOPE"]


@pytest.mark.parametrize("datatype", OIP_TYPES)
def test_codec_dtype_table_matches_jax(datatype):
    want = jcodec.to_np_dtype(datatype)
    assert tcodec.to_np_dtype(datatype) == want
    if want is not None:
        assert tcodec.from_np_dtype(want) == jcodec.from_np_dtype(want)
    assert tcodec.from_np_dtype(np.dtype(np.complex64)) is None


def test_codec_bytes_round_trip_matches_jax():
    t = np.array([[b"a", "bé"], [np.bytes_(b"c"), 7]], dtype=object)
    raw = tcodec.serialize_byte_tensor(t)
    assert raw == jcodec.serialize_byte_tensor(t)
    assert tcodec.serialize_byte_tensor(np.array([], dtype=object)) == b""
    back = tcodec.deserialize_bytes_tensor(raw)
    assert list(back) == list(jcodec.deserialize_bytes_tensor(raw))
    for bad in (raw[:2], raw[:-1]):
        with pytest.raises(ValueError, match="malformed"):
            tcodec.deserialize_bytes_tensor(bad)


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "fp32": rng.normal(size=(2, 3)).astype(np.float32),
        "int64": rng.integers(-5, 5, size=(4,)).astype(np.int64),
        "bool": np.array([[True, False]]),
        "fp16": rng.normal(size=(3,)).astype(np.float16),
        "bytes": np.array([b"x", b"yz"], dtype=object),
    }


def _request(pkg, binary: bool):
    inputs = []
    for name, arr in _tensors().items():
        inp = pkg.InferInput(name, list(arr.shape), "FP32")
        inp.set_data_from_numpy(arr, binary_data=binary or name == "fp16")
        inputs.append(inp)
    return pkg.InferRequest(model_name="m", infer_inputs=inputs, request_id="r1",
                            parameters={"p": 1},
                            request_outputs=[pkg.RequestedOutput("o", {"binary_data": True})])


@pytest.mark.parametrize("binary", [False, True])
def test_infer_request_forms_match_jax(binary):
    jbody, jlen = _request(jit, binary).to_rest()
    tbody, tlen = _request(tit, binary).to_rest()
    assert tlen == jlen and tbody == jbody
    raw = jbody if jlen is not None else json.dumps(jbody).encode()
    n = jlen if jlen is not None else len(raw)
    jreq = jit.InferRequest.from_bytes(raw, n, "m")
    treq = tit.InferRequest.from_bytes(raw, n, "m")
    assert treq.id == jreq.id and treq.parameters == jreq.parameters
    for a, b in zip(treq.inputs, jreq.inputs):
        assert (a.name, a.shape, a.datatype) == (b.name, b.shape, b.datatype)
        np.testing.assert_array_equal(a.as_numpy(), b.as_numpy())
    with pytest.raises(InvalidInput, match="exceeds body size"):
        tit.InferRequest.from_bytes(raw, len(raw) + 1, "m")
    with pytest.raises(InvalidInput, match="missing 'inputs'"):
        tit.InferRequest.from_dict({"id": "x"})


@pytest.mark.parametrize("requested", [None, True, False])
def test_infer_response_forms_match_jax(requested):
    def response(pkg):
        outs = []
        for i, (name, arr) in enumerate(_tensors().items()):
            out = pkg.InferOutput(name, list(arr.shape), "FP32")
            out.set_data_from_numpy(arr, binary_data=bool(i % 2) or name == "fp16")
            outs.append(out)
        return pkg.InferResponse("r1", "m", outs, model_version="2", parameters={"q": "v"})

    def ro(pkg):
        if requested is None:
            return None
        return [pkg.RequestedOutput(n, {"binary_data": requested}) for n in ("fp32", "int64")]

    jbody, jlen = response(jit).to_rest(ro(jit))
    tbody, tlen = response(tit).to_rest(ro(tit))
    assert tlen == jlen and tbody == jbody
    if jlen is not None:
        jres = jit.InferResponse.from_bytes(jbody, jlen)
        tres = tit.InferResponse.from_bytes(tbody, tlen)
    else:
        jres, tres = jit.InferResponse.from_dict(jbody), tit.InferResponse.from_dict(tbody)
    for a, b in zip(tres.outputs, jres.outputs):
        np.testing.assert_array_equal(a.as_numpy(), b.as_numpy())
        assert a.as_numpy().dtype == b.as_numpy().dtype


def _decode_cases():
    v2 = {"id": "1", "inputs": [{"name": "x", "shape": [1, 2], "datatype": "FP32",
                                 "data": [1.5, 2.5]}]}
    head = json.dumps({"inputs": [{"name": "x", "shape": [2], "datatype": "INT32",
                                   "parameters": {"binary_data_size": 8}}]}).encode()
    ce = {"specversion": "1.0", "source": "s", "type": "t", "id": "i", "time": "now"}
    ce_headers = {"ce-specversion": "1.0", "ce-source": "s", "ce-type": "t", "ce-id": "i",
                  "Content-Type": "application/json"}
    return {
        "v1": (json.dumps({"instances": [[1, 2]]}).encode(), None, None),
        "v2_json": (json.dumps(v2).encode(), None, None),
        "v2_binary": (head + np.array([3, 4], np.int32).tobytes(), None, len(head)),
        "ce_structured": (json.dumps(dict(ce, data={"instances": [[5]]})).encode(), None, None),
        "ce_structured_str": (json.dumps(dict(ce, data=json.dumps(v2))).encode(), None, None),
        "ce_binary": (json.dumps({"instances": [[6]]}).encode(), ce_headers, None),
        "bad_json": (b"{nope", None, None),
        "bad_ce_binary": (b"{nope", ce_headers, None),
    }


def _view(decoded):
    body, attrs = decoded
    if hasattr(body, "inputs"):
        body = [(i.name, i.shape, i.datatype, i.as_numpy().tolist()) for i in body.inputs]
    return body, attrs


@pytest.mark.parametrize("case", sorted(_decode_cases()))
def test_decode_matches_jax(case):
    body, headers, json_length = _decode_cases()[case]
    jdp = JDataPlane(JModelRepository())
    tdp = DataPlane(ModelRepository())
    try:
        want = _view(jdp.decode(body, headers, json_length=json_length, model_name="m"))
    except Exception as e:  # noqa: BLE001 — the port must raise alike
        with pytest.raises(InvalidInput) as got:
            tdp.decode(body, headers, json_length=json_length, model_name="m")
        assert (type(e).__name__, str(got.value)) == ("InvalidInput", str(e))
        return
    assert _view(tdp.decode(body, headers, json_length=json_length, model_name="m")) == want
    # a CloudEvent request gets CloudEvent response headers
    jbody, jh = jdp.encode("m", {"x": 1}, headers, want[1])
    tbody, th = tdp.encode("m", {"x": 1}, headers, want[1])
    assert tbody == jbody
    assert sorted(th) == sorted(jh)
    assert {k: v for k, v in th.items() if k != "ce-id"} == {
        k: v for k, v in jh.items() if k != "ce-id"}


# ---------------------------------------------------------------- routes


class _Bare:
    """A Model with no predict of its own and no predictor_host."""


def _models(pkg_model, pkg_gbdt, model_dir, gen):
    forest = pkg_gbdt.XGBoostModel("xgb", model_dir, **(
        {"device": "cpu"} if pkg_gbdt is gbdt_server else {}))
    forest.load()
    bare = pkg_model("bare")
    bare.ready = True
    starting = pkg_model("starting")  # registered, never loaded
    return [forest, bare, starting, gen]


class _PortGen:
    """The duck type of the port's generative model (no __call__)."""

    def __init__(self, name):
        self.name, self.ready = name, True

    async def healthy(self):
        return True


ROUTES = [
    ("GET", "/", None, {}),
    ("GET", "/v1/models", None, {}),
    ("GET", "/v1/models/xgb", None, {}),
    ("GET", "/v1/models/nope", None, {}),
    ("GET", "/v2", None, {}),
    ("GET", "/v2/models/xgb", None, {}),
    ("GET", "/v2/models/xgb/ready", None, {}),
    ("GET", "/v2/models/starting/ready", None, {}),
    ("GET", "/v2/models/gen/ready", None, {}),
    ("GET", "/v2/models/nope/ready", None, {}),
    ("GET", "/v2/health/live", None, {}),
    ("GET", "/v2/health/ready", None, {}),
    ("POST", "/v1/models/xgb:predict", {"instances": [[0.0, 0.0], [1.0, 2.0], [0.5, 0.5]]}, {}),
    ("POST", "/v1/models/xgb:predict", {"id": "v", "inputs": [{"name": "i", "shape": [1, 2],
                                                    "datatype": "FP32", "data": [1, 2]}]}, {}),
    ("POST", "/v1/models/xgb:predict", {"instances": [[1.0, 2.0, 3.0]]}, {}),
    ("POST", "/v1/models/xgb:predict", b"{not json", {}),
    ("POST", "/v1/models/xgb:predict", {"instances": 3}, {}),
    ("POST", "/v1/models/xgb:predict", {"specversion": "1.0", "source": "s", "type": "t",
                                        "id": "i", "time": "t",
                                        "data": {"instances": [[1.0, 1.5]]}}, {}),
    ("POST", "/v1/models/xgb:predict", {"instances": [[0.2, 2.0]]},
     {"ce-specversion": "1.0", "ce-source": "s", "ce-type": "t", "ce-id": "i"}),
    ("POST", "/v1/models/nope:predict", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v1/models/starting:predict", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v1/models/bare:predict", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v1/models/bare:explain", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v1/models/xgb:explain", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v1/models/gen:predict", {"instances": [[1.0, 2.0]]}, {}),
    ("POST", "/v2/models/xgb/infer", {"id": "q1", "inputs": [
        {"name": "i", "shape": [2, 2], "datatype": "FP32", "data": [0, 0, 1, 2]}]}, {}),
    ("POST", "/v2/models/xgb/versions/7/infer", {"id": "q2", "inputs": [
        {"name": "i", "shape": [1, 2], "datatype": "FP64", "data": [0.5, 0.5]}],
        "outputs": [{"name": "output-0", "parameters": {"binary_data": True}}]}, {}),
    ("POST", "/v2/models/xgb/infer", "BINARY", {}),
    ("POST", "/v2/models/xgb/infer", {"id": "q3"}, {}),
    ("POST", "/v2/models/xgb/infer", {"id": "q4", "inputs": []},
     {"Inference-Header-Content-Length": "x"}),
    ("POST", "/v2/models/nope/infer", {"id": "q5", "inputs": []}, {}),
    ("POST", "/v2/repository/models/nope/load", None, {}),
    ("POST", "/v2/repository/models/xgb/load", None, {}),
    ("POST", "/v2/repository/models/nope/unload", None, {}),
    ("POST", "/v2/repository/models/bare/unload", None, {}),
    ("GET", "/v1/models", None, {}),
    ("GET", "/v2/models/bare/ready", None, {}),
]


def _binary_infer_body():
    X = np.array([[0.0, 0.0], [1.0, 2.0], [0.5, 0.5]], dtype=np.float32)
    head = json.dumps({"id": "b1", "inputs": [{"name": "i", "shape": [3, 2],
                                               "datatype": "FP32",
                                               "parameters": {"binary_data_size": 24}}]})
    head = head.encode()
    return head + X.tobytes(), {"Inference-Header-Content-Length": str(len(head)),
                                "Content-Type": "application/octet-stream"}


async def _drive(client, method, path, body, headers):
    headers = dict(headers)
    if body == "BINARY":
        body, extra = _binary_infer_body()
        headers.update(extra)
    elif isinstance(body, dict):
        body = json.dumps(body).encode()
        headers.setdefault("Content-Type", "application/json")
    res = await client.request(method, path, data=body, headers=headers)
    return (res.status, {k.lower(): v for k, v in res.headers.items()}, await res.read())


def _media_type(headers):
    """The content type without parameters (aiohttp adds a charset)."""
    return headers.get("content-type", "").split(";")[0]


def _parse(status, headers, raw):
    n = headers.get("inference-header-content-length")
    if n is not None:
        head = json.loads(raw[:int(n)])
        return status, head, raw[int(n):], _media_type(headers)
    try:
        return status, json.loads(raw), None, _media_type(headers)
    except ValueError:
        return status, None, None, None


def _close(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_routes_match_the_jax_server(tmp_path):
    (tmp_path / "model.json").write_text(json.dumps(XGB_BINARY))

    async def main():
        jrepo = JModelRepository()
        for m in _models(JModel, jgbdt, str(tmp_path), OpenAIGenerativeModel("gen")):
            jrepo.update(m)
        jrepo.get_model("gen").ready = True
        jserver = JRESTServer(JDataPlane(jrepo), JModelRepositoryExtension(jrepo))
        trepo = ModelRepository()
        for m in _models(Model, gbdt_server, str(tmp_path), _PortGen("gen")):
            trepo.update(m)
        tserver = RESTServer(trepo, "127.0.0.1", 0)
        port = await tserver.start()
        jclient = TestClient(TestServer(jserver.create_application()))
        from aiohttp import ClientSession

        out = []
        try:
            async with jclient, ClientSession(f"http://127.0.0.1:{port}") as tclient:
                for method, path, body, headers in ROUTES:
                    want = await _drive(jclient, method, path, body, headers)
                    got = await _drive(tclient, method, path, body, headers)
                    out.append((method, path, want, got))
        finally:
            await tserver.stop()
        return out

    for method, path, want, got in asyncio.run(main()):
        w, g = _parse(*want), _parse(*got)
        assert g[0] == w[0], (method, path, w, g)
        if path.startswith("/v1/models/gen"):
            # not callable: 500 naming the class, which differs
            assert w[1]["error"].startswith("TypeError") and g[1]["error"].startswith("TypeError")
            continue
        if w[1] is None:  # aiohttp's text 405/404 pages
            continue
        assert g[3] == w[3], (method, path)
        _close(w[1], g[1], path)
        if w[2] is not None:
            np.testing.assert_allclose(np.frombuffer(g[2], np.float32),
                                       np.frombuffer(w[2], np.float32), atol=1e-6, rtol=0)
        if "ce-specversion" in want[1]:
            for k in ("ce-specversion", "ce-source", "ce-type"):
                assert got[1][k] == want[1][k], k


def test_stage_histograms_on_metrics(tmp_path, run_async):
    from kserve_tpu_torch import metrics

    (tmp_path / "model.json").write_text(json.dumps(XGB_BINARY))
    model = gbdt_server.XGBoostModel("hist-xgb", str(tmp_path), device="cpu")
    model.load()
    run_async(model({"instances": [[1.0, 2.0]]}))
    families = {f.name: f for f in text_string_to_metric_families(
        metrics.generate_latest().decode())}
    for jmetric in (jmetrics.PRE_HIST_TIME, jmetrics.PREDICT_HIST_TIME,
                    jmetrics.POST_HIST_TIME, jmetrics.EXPLAIN_HIST_TIME):
        fam = families[jmetric._name]
        assert (fam.type, fam.documentation) == (jmetric._type, jmetric._documentation)
        assert tuple(getattr(metrics, [k for k in ("PRE_HIST_TIME", "PREDICT_HIST_TIME",
                                                   "POST_HIST_TIME", "EXPLAIN_HIST_TIME")
                                       if getattr(metrics, k).name == jmetric._name][0])
                     .buckets) == tuple(jmetric._upper_bounds)
    counts = {s.name: s.value for s in families["request_predict_seconds"].samples
              if s.labels.get("model_name") == "hist-xgb"}
    assert counts["request_predict_seconds_count"] == 1
