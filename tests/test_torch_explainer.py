"""The port's explainer runtime (kserve_tpu_torch/runtimes/
explainer_server.py) against the JAX package's on the CPU.

The permutation method against the JAX one over the same stub predictor
(served over HTTP; the same seed sends the same rows) within 1e-5
relative; Kernel SHAP against a float64 numpy QR solve of the same
coalitions within 1e-6 of max|phi| at 3 and 28 features (the port solves
by QR too: the normal equations, condition ~6.8e12, stray up to 3e-3 of
max|phi| in float64), efficiency within 1e-9 against the stub's exact outputs at 28
features (at 3, equal to the numpy solve's own ~5e-9); the JAX
result within its own 0.2 at 3 features, and at 28 features NaN where the
port's is finite (ROADMAP C22: the JAX normal equations are float32)."""

import asyncio

import numpy as np
import pytest

from kserve_tpu.errors import InvalidInput as JInvalidInput
from kserve_tpu.runtimes import explainer_server as jexp
from kserve_tpu_torch.errors import InvalidInput
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.runtimes import explainer_server as texp
from test_explainer import _LinearPredictor, _serve

SHAP_TOL = 1e-6  # of max|phi|


def _logistic(n, seed=0):
    rng = np.random.default_rng(seed)
    W, b = rng.normal(size=n), 0.1

    def f(rows):
        return 1.0 / (1.0 + np.exp(-(np.asarray(rows) @ W + b)))

    return f


def _stubbed(cls, f, sent=None, **kw):
    """An explainer whose predictor is `f` in process (no HTTP), recording
    the rows it is sent."""

    class Stubbed(cls):
        async def _predict_rows(self, rows, headers):
            if sent is not None:
                sent.append(np.array(rows))
            return np.asarray(f(rows), dtype=np.float64)[:, None]

    if cls is texp.ExplainerModel:
        kw.setdefault("device", "cpu")
    return Stubbed("m", "127.0.0.1:1", **kw)


def _numpy_shap(masks, y):
    """The reference's weighted ridge least squares in float64 numpy, by
    QR of the square-root-weighted system (the normal equations, condition
    ~6.8e12 at 28 features, stray 2e-4 to 3e-3 of max|phi| from a
    40-digit solve in numpy and in torch alike, QR within 4e-9:
    scripts/kernelshap_precision.py)."""
    k, n = masks.shape
    sw = np.sqrt(texp._shapley_kernel_weights(masks.sum(axis=1), n))
    X = np.concatenate([masks, np.ones((k, 1))], axis=1)
    Xa = np.concatenate([sw[:, None] * X, np.sqrt(1e-6) * np.eye(n + 1)])
    ya = np.concatenate([sw * y, np.zeros(n + 1)])
    q, r = np.linalg.qr(Xa)
    return np.linalg.solve(r, q.T @ ya)[:n]


def test_kernel_weights_are_the_jax_weights():
    sizes = np.array([0, 1, 2, 5, 14, 27, 28], dtype=np.float64)
    np.testing.assert_array_equal(texp._shapley_kernel_weights(sizes, 28),
                                  jexp._shapley_kernel_weights(sizes, 28))


@pytest.mark.parametrize("method", ["permutation", "kernelshap"])
def test_same_rows_as_jax(method):
    """The predictor receives the JAX explainer's rows, in its order."""
    f = _logistic(5)
    sent_t, sent_j = [], []
    payload = {"instances": np.random.default_rng(1).normal(size=(2, 5)).tolist(),
               "background": np.random.default_rng(2).normal(size=(7, 5)).tolist()}
    kw = dict(method=method, n_samples=40)
    asyncio.run(_stubbed(texp.ExplainerModel, f, sent_t, **kw).explain(payload))
    asyncio.run(_stubbed(jexp.ExplainerModel, f, sent_j, **kw).explain(payload))
    assert len(sent_t) == len(sent_j) == 2
    for a, b in zip(sent_t, sent_j):
        np.testing.assert_array_equal(a, b)


def test_permutation_matches_jax_over_http():
    """Both explainers against one stub predictor served over HTTP (the
    V1 :predict under the explainer's own name)."""

    async def main():
        runner, port = await _serve(_LinearPredictor().app())
        try:
            payload = {"instances": [[1.0, 1.0, 1.0], [0.5, -2.0, 3.0]],
                       "background": [[0.0, 0.0, 0.0], [1.0, 2.0, -1.0]]}
            out = []
            for model in (texp.ExplainerModel("exp", f"127.0.0.1:{port}", n_samples=96,
                                              device="cpu"),
                          jexp.ExplainerModel("exp", f"127.0.0.1:{port}", n_samples=96)):
                out.append(await model.explain(payload))
            return out
        finally:
            await runner.cleanup()

    got, want = asyncio.run(main())
    assert got["method"] == want["method"] == "permutation"
    np.testing.assert_allclose(got["explanations"], want["explanations"], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("n,n_samples", [(3, 96), (28, 2104)])
def test_kernelshap_matches_numpy_float64(n, n_samples):
    f = _logistic(n, seed=n)
    rng = np.random.default_rng(n)
    x, bg = rng.normal(size=(2, n)), rng.normal(size=(100, n))
    sent = []
    model = _stubbed(texp.ExplainerModel, f, sent, method="kernelshap",
                     n_samples=n_samples)
    out = asyncio.run(model.explain({"instances": x.tolist(), "background": bg.tolist()}))
    phi = np.asarray(out["explanations"])
    assert out["method"] == "kernelshap" and phi.shape == (2, n)
    assert np.isfinite(phi).all()
    # the coalitions, drawn as the reference draws them
    rs = np.random.RandomState(0)
    for i, row in enumerate(x):
        masks = rs.randint(0, 2, size=(max(n_samples, n + 2), n)).astype(np.float64)
        masks[0, :], masks[1, :] = 0.0, 1.0
        rows = masks * row + (1.0 - masks) * bg.mean(axis=0)
        np.testing.assert_array_equal(sent[i][1:], rows)
        ref = _numpy_shap(masks, f(rows))
        err = np.abs(phi[i] - ref).max() / np.abs(ref).max()
        assert err <= SHAP_TOL, err
        # efficiency: sum(phi) = f(x) - f(mean background), within 1e-9 at
        # 28 features; at 3 the middle coalitions' weights (1/3) against
        # the 1e6 of the empty and full ones leave ~5e-9 in the numpy
        # float64 solve itself, which the port's gap then equals
        target = f(row[None])[0] - f(bg.mean(axis=0)[None])[0]
        gap, ref_gap = phi[i].sum() - target, ref.sum() - target
        if n == 28:
            assert abs(gap) <= 1e-9, gap
        else:
            assert abs(gap - ref_gap) <= 1e-12 and abs(gap) <= 1e-8, (gap, ref_gap)


def test_jax_within_its_tolerance_at_3_and_nan_at_28_features():
    """C22: the JAX Kernel SHAP builds its normal equations in float32; at
    3 features a linear model's weights come back within its own test's
    0.2, at 28 features every attribution is NaN; the port's are finite."""
    lin = lambda rows: np.asarray(rows) @ np.array([3.0, 0.0, 1.0])  # noqa: E731
    payload = {"instances": [[1.0, 1.0, 1.0]], "background": [[0.0, 0.0, 0.0]]}
    kw = dict(method="kernelshap", n_samples=96)
    want = asyncio.run(_stubbed(jexp.ExplainerModel, lin, **kw).explain(payload))
    got = asyncio.run(_stubbed(texp.ExplainerModel, lin, **kw).explain(payload))
    np.testing.assert_allclose(want["explanations"][0], [3.0, 0.0, 1.0], atol=0.2)
    np.testing.assert_allclose(got["explanations"][0], [3.0, 0.0, 1.0], atol=1e-4)
    f = _logistic(28)
    rng = np.random.default_rng(4)
    payload = {"instances": rng.normal(size=(1, 28)).tolist(),
               "background": rng.normal(size=(100, 28)).tolist()}
    kw = dict(method="kernelshap", n_samples=2104)
    want = asyncio.run(_stubbed(jexp.ExplainerModel, f, **kw).explain(payload))
    got = asyncio.run(_stubbed(texp.ExplainerModel, f, **kw).explain(payload))
    assert not np.isfinite(want["explanations"]).any()
    assert np.isfinite(got["explanations"]).all()


def test_request_method_overrides_the_flag_and_bad_input_is_400():
    f = _logistic(4)
    model = _stubbed(texp.ExplainerModel, f, method="permutation", n_samples=8)
    out = asyncio.run(model.explain({"instances": [[1.0, 2.0, 3.0, 4.0]],
                                     "method": "kernelshap"}))
    assert out["method"] == "kernelshap"
    for bad in ({}, {"instances": []}):
        with pytest.raises(InvalidInput):
            asyncio.run(model.explain(bad))
        with pytest.raises(JInvalidInput):
            asyncio.run(_stubbed(jexp.ExplainerModel, f).explain(bad))
    with pytest.raises(InvalidInput, match="method"):
        asyncio.run(model.explain({"instances": [[1.0] * 4], "method": "lime"}))
    with pytest.raises(ValueError):
        texp.ExplainerModel("m", "h:1", method="lime", device="cpu")


def test_explain_served_through_the_port_server():
    """POST :explain on the port's REST server reaches the explainer, which
    forwards its rows to the predictor's :predict."""
    import json
    import urllib.request

    async def main():
        runner, pport = await _serve(_LinearPredictor().app())
        model = texp.ExplainerModel("exp", f"127.0.0.1:{pport}", method="kernelshap",
                                    n_samples=96, device="cpu")
        server = RESTServer(ModelRepository({"exp": model}), "127.0.0.1", 0)
        port = await server.start()
        try:
            def post():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/models/exp:explain",
                    data=json.dumps({"instances": [[1.0, 1.0, 1.0]]}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            return await asyncio.to_thread(post)
        finally:
            await server.stop()
            await runner.cleanup()

    status, body = asyncio.run(main())
    assert status == 200 and body["method"] == "kernelshap"
    np.testing.assert_allclose(body["explanations"][0], [3.0, 0.0, 1.0], atol=1e-4)


def test_explainer_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = texp.build_arg_parser().parse_args(["--predictor_host", "h:1"])
    assert args.device == "cuda" and args.method == "permutation" and args.n_samples == 64
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.ExplainerModel("m", "h:1")
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.main(["--predictor_host", "h:1", "--http_port", "0"])
    assert texp.ExplainerModel("m", "h:1", device="cpu").device.type == "cpu"
