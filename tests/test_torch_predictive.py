"""The port's predictive runtimes (kserve_tpu_torch/runtimes/) against the
JAX package's on the CPU: the XGBoost and LightGBM parsers and the forest
traversal on seeded dumps (binary, softprob / softmax, multiclass, one-vs-
all and regression), the links, every sklearn converter the JAX tests fit
and a few more, and the runtimes' V1 and V2 answers.  Labels must be
equal; raw scores and probabilities within 1e-6 absolute (the SVC's pair
decisions within 1e-4, see test_sklearn_converters).  The dumps come from
chip_smoke.py's writers, whose float64 walks (the card's reference) are
held here to the traversal's leaves and margins."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from kserve_tpu.infer_type import InferInput as JInferInput
from kserve_tpu.infer_type import InferRequest as JInferRequest
from kserve_tpu.runtimes import gbdt_server as jgbdt
from kserve_tpu.runtimes import sklearn_server as jsks
from kserve_tpu.runtimes.tensorize import lgb_parse as jlgb
from kserve_tpu.runtimes.tensorize import sklearn_convert as jsk
from kserve_tpu.runtimes.tensorize import trees as jtrees
from kserve_tpu.runtimes.tensorize import xgb_parse as jxgb
from kserve_tpu_torch.infer_type import InferInput, InferRequest
from kserve_tpu_torch.runtimes import gbdt_server, sklearn_server
from kserve_tpu_torch.runtimes.tensorize import lgb_parse, sklearn_convert, trees, xgb_parse
from test_predictive_runtimes import LGB_BINARY, XGB_BINARY

ATOL = 1e-6


def _lgb_classes(text: str, objective: str, n: int) -> str:
    """A one-class LightGBM dump relabelled as `n` interleaved classes."""
    return (text.replace("num_class=1\nnum_tree_per_iteration=1",
                         f"num_class={n}\nnum_tree_per_iteration={n}")
            .replace("objective=binary sigmoid:1", f"objective={objective}"))


def _dumps():
    rng = np.random.default_rng
    lgb_ova = _lgb_classes(chip_smoke.lgb_dump(rng(5), 9, 7, 5), "multiclassova "
                           "num_class:3 sigmoid:1", 3)
    return {
        "xgb_binary": ("xgb", XGB_BINARY),
        "xgb_softprob": ("xgb", chip_smoke.xgb_dump(
            rng(1), 9, 3, 5, objective="multi:softprob", num_class=3, base_score=0.5)),
        "xgb_softmax": ("xgb", chip_smoke.xgb_dump(
            rng(1), 9, 3, 5, objective="multi:softmax", num_class=3, base_score=0.5)),
        "xgb_regression": ("xgb", chip_smoke.xgb_dump(
            rng(2), 6, 4, 5, objective="reg:squarederror", base_score=0.25)),
        "xgb_logistic_deep": ("xgb", chip_smoke.xgb_dump(rng(6), 12, 6, 7)),
        "lgb_binary": ("lgb", LGB_BINARY),
        "lgb_leafwise": ("lgb", chip_smoke.lgb_dump(rng(3), 10, 31, 7)),
        "lgb_regression": ("lgb", chip_smoke.lgb_dump(rng(4), 6, 9, 5,
                                                      objective="regression")),
        "lgb_multiclass": ("lgb", _lgb_classes(chip_smoke.lgb_dump(rng(7), 9, 7, 5),
                                               "multiclass num_class:3", 3)),
        "lgb_multiclassova": ("lgb", lgb_ova),
    }


DUMPS = _dumps()
PARSERS = {"xgb": (jxgb.parse_xgboost_json, xgb_parse.parse_xgboost_json),
           "lgb": (jlgb.parse_lightgbm_text, lgb_parse.parse_lightgbm_text)}


def _rows(forest, n=48, seed=0):
    return np.random.default_rng(seed).normal(size=(n, forest.n_features)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(DUMPS))
def test_forest_matches_jax(name):
    kind, doc = DUMPS[name]
    jparse, tparse = PARSERS[kind]
    jf, tf = jparse(doc), tparse(doc)
    for field in ("feature", "threshold", "left", "right", "leaf_value", "class_of_tree"):
        a, b = getattr(jf, field), getattr(tf, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    for field in ("max_depth", "n_features", "n_outputs", "base_score", "strict_less",
                  "link_scale", "output_labels"):
        assert getattr(jf, field) == getattr(tf, field), field
    assert (jf.aggregation.value, jf.link.value) == (tf.aggregation.value, tf.link.value)
    X = _rows(tf)
    # float64 and int64 rows are cast to float32 first, as the JAX
    # traversal casts them (numpy's astype rounds as jnp's does)
    X64 = X.astype(np.float64) * 1.0000001
    Xi = np.rint(X * 2).astype(np.int64)
    _, j_raw = jtrees.forest_predict_fn(jf)
    j_out = np.asarray(j_raw(np.concatenate([X, X64.astype(np.float32),
                                             Xi.astype(np.float32)])))
    j_proba = np.asarray(jtrees.apply_link(j_out[:len(X)], jf.link, jf.link_scale))
    t_proba, t_raw = trees.forest_predict_fn(tf, "cpu")
    raw = t_raw(X)
    assert raw.dtype == torch.float32 and raw.device.type == "cpu"
    t_out = torch.cat([raw, t_raw(X64), t_raw(Xi)]).numpy()
    np.testing.assert_allclose(t_out, j_out, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_proba(X).numpy(), j_proba, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["xgb_binary", "xgb_softprob", "xgb_logistic_deep",
                                  "lgb_binary", "lgb_leafwise", "lgb_regression"])
def test_traversal_leaves_equal_the_float64_walk(name):
    """The leaves the traversal reaches, read directly, are the smoke's
    float64 walk's, and its margins agree with the walk's to f32."""
    kind, doc = DUMPS[name]
    forest = PARSERS[kind][1](doc)
    X = _rows(forest, n=64, seed=1)
    # rows on a split exactly: f32 comparisons must decide as f64 ones do
    X[0, :] = np.float32(0.5)
    fa = trees.forest_apply(forest, "cpu")
    walk = chip_smoke.walk_xgb if kind == "xgb" else chip_smoke.walk_lgb
    leaves, margin = walk(doc, X)
    got = fa.leaves(X)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), leaves)
    margin = margin.reshape(len(X), -1)
    np.testing.assert_allclose(fa(X).numpy(), margin, atol=1e-5, rtol=0)


def test_nan_goes_right_as_in_jax():
    forest = xgb_parse.parse_xgboost_json(XGB_BINARY)
    X = np.array([[np.nan, np.nan], [0.0, np.nan]], dtype=np.float32)
    got = trees.forest_predict_fn(forest, "cpu")[1](X).numpy()
    want = np.asarray(jtrees.forest_predict_fn(jxgb.parse_xgboost_json(XGB_BINARY))[1](X))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("link", list(trees.Link), ids=lambda l: l.value)
@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_apply_link_matches_jax(link, scale):
    cols = 1 if link == trees.Link.SIGMOID else 3
    raw = np.random.default_rng(2).normal(size=(16, cols)).astype(np.float32) * 3
    if link == trees.Link.NORMALIZE:
        raw = np.abs(raw)
    got = trees.apply_link(torch.from_numpy(raw), link, scale).numpy()
    want = np.asarray(jtrees.apply_link(raw, jtrees.Link(link.value), scale))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _v2_request(pkg_input, pkg_request, X, binary):
    inp = pkg_input("input-0", list(X.shape), "FP32")
    inp.set_data_from_numpy(X, binary_data=binary)
    return pkg_request(model_name="m", infer_inputs=[inp], request_id="r1")


@pytest.mark.parametrize("name,proba", [("xgb_binary", False), ("xgb_binary", True),
                                        ("xgb_softmax", False), ("xgb_regression", False),
                                        ("lgb_leafwise", False), ("lgb_multiclass", True)])
def test_gbdt_runtime_answers_match_jax(tmp_path, run_async, name, proba):
    kind, doc = DUMPS[name]
    if kind == "xgb":
        (tmp_path / "model.json").write_text(json.dumps(doc))
        jcls, tcls = jgbdt.XGBoostModel, gbdt_server.XGBoostModel
    else:
        (tmp_path / "model.txt").write_text(doc)
        jcls, tcls = jgbdt.LightGBMModel, gbdt_server.LightGBMModel
    jm = jcls("m", str(tmp_path), predict_proba=proba)
    tm = tcls("m", str(tmp_path), predict_proba=proba, device="cpu")
    assert jm.load() and tm.load()
    assert tm._apply.feature.device.type == "cpu"
    X = _rows(tm._forest, n=5, seed=3)
    jv1 = run_async(jm({"instances": X.tolist()}))
    tv1 = run_async(tm({"instances": X.tolist()}))
    np.testing.assert_allclose(tv1["predictions"], jv1["predictions"], atol=ATOL, rtol=0)
    assert np.asarray(tv1["predictions"]).dtype == np.asarray(jv1["predictions"]).dtype
    for binary in (False, True):
        jres = run_async(jm(_v2_request(JInferInput, JInferRequest, X, binary)))
        tres = run_async(tm(_v2_request(InferInput, InferRequest, X, binary)))
        jout, tout = jres.outputs[0], tres.outputs[0]
        assert (tout.name, tout.datatype, tout.shape) == (jout.name, jout.datatype, jout.shape)
        assert (tout.raw_data is None) == (jout.raw_data is None)
        np.testing.assert_allclose(tout.as_numpy(), jout.as_numpy(), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def iris():
    from sklearn.datasets import load_iris

    return load_iris(return_X_y=True)


@pytest.fixture(scope="module")
def fitted(iris):
    """`key` -> (estimator, rows), each estimator fitted once for the module."""
    cache = {}

    def get(key):
        if key not in cache:
            cache[key] = _fit(key, iris)
        return cache[key]

    return get


def _fit(key, iris):
    from sklearn import cluster, ensemble, linear_model, neural_network, pipeline, svm
    from sklearn import preprocessing as pre
    from sklearn.datasets import make_classification, make_regression

    X, y = iris
    Xr, yr = make_regression(n_samples=100, n_features=5, random_state=0)
    Xb, yb = make_classification(n_samples=100, n_features=5, random_state=1)
    return {
        # the estimators tests/test_predictive_runtimes.py fits
        "svc_iris": lambda: (svm.SVC().fit(X, y), X),
        "random_forest_proba": lambda: (ensemble.RandomForestClassifier(
            n_estimators=20, random_state=0).fit(X, y), X),
        "gradient_boosting_multiclass": lambda: (ensemble.GradientBoostingClassifier(
            n_estimators=10, random_state=0).fit(X, y), X),
        "logistic_regression": lambda: (linear_model.LogisticRegression(
            max_iter=500).fit(X, y), X),
        "pipeline_scaler_svc": lambda: (pipeline.make_pipeline(
            pre.StandardScaler(), svm.SVC()).fit(X, y), X),
        "binary_svc": lambda: (svm.SVC().fit(Xb, yb), Xb),
        "random_forest_regression": lambda: (ensemble.RandomForestRegressor(
            n_estimators=10, random_state=0).fit(Xr, yr), Xr),
        # more of the converters
        "gradient_boosting_binary": lambda: (ensemble.GradientBoostingClassifier(
            n_estimators=8, random_state=0).fit(Xb, yb), Xb),
        "linear_svc_multiclass": lambda: (svm.LinearSVC(max_iter=5000).fit(X, y), X),
        "svr": lambda: (svm.SVR().fit(Xr / 100, yr / 100), Xr / 100),
        "kmeans": lambda: (cluster.KMeans(n_clusters=3, n_init=2, random_state=0).fit(X), X),
        "mlp": lambda: (neural_network.MLPClassifier(
            hidden_layer_sizes=(8,), max_iter=300, random_state=0).fit(X, y), X),
        "pipeline_minmax_normalizer_logistic": lambda: (pipeline.make_pipeline(
            pre.MinMaxScaler(), pre.Normalizer(), linear_model.LogisticRegression(
                max_iter=500)).fit(X, y), X),
    }[key]()


SKLEARN_CASES = ["svc_iris", "random_forest_proba", "gradient_boosting_multiclass",
                 "logistic_regression", "pipeline_scaler_svc", "binary_svc",
                 "random_forest_regression", "gradient_boosting_binary",
                 "linear_svc_multiclass", "svr", "kmeans", "mlp",
                 "pipeline_minmax_normalizer_logistic"]


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("key", SKLEARN_CASES)
def test_sklearn_converters(fitted, key):
    """Labels equal; probabilities within 1e-6 of the JAX conversion; raw
    decisions and regression values within 1e-6 plus 1e-6 of their size
    (XLA's f32 dot rounds as it adds, in an order that changes with the
    shape, where the port sums in float64: a decision of ~10 is ~8 f32
    ulps of 1e-6); the SVC's pair decisions within 1e-4: they sum ~45 RBF
    values whose f32 |x|^2 - 2 x.sv + |sv|^2 expansion in the JAX package
    rounds at |x|^2 (~40 for iris, an f32 ulp of 4e-6) and whose exp
    differs from XLA's by an ulp, so the two part by ~1e-5.  1e-4 is the
    JAX package's own tolerance for those values
    (tests/test_predictive_runtimes.py:90); the labels they vote on are
    held exactly."""
    est, X = fitted(key)
    j, t = jsk.convert_estimator(est), sklearn_convert.convert_estimator(est, "cpu")
    got = sklearn_convert.map_classes(t.predict(X), t.classes)
    want = jsk.map_classes(np.asarray(j.predict(X)), j.classes)
    assert got.dtype == want.dtype
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
    for fn in ("predict_proba", "decision_function"):
        jf, tf = getattr(j, fn), getattr(t, fn)
        assert (jf is None) == (tf is None), fn
        if tf is None:
            continue
        if fn == "predict_proba":
            atol, rtol = ATOL, 0
        elif "svc" in key and "linear" not in key:
            atol, rtol = 1e-4, 0
        else:
            atol, rtol = ATOL, 1e-6
        np.testing.assert_allclose(tf(X).numpy(), np.asarray(jf(X)), atol=atol, rtol=rtol)


def test_multi_output_tree_is_unsupported():
    from sklearn.ensemble import RandomForestRegressor

    X = np.random.RandomState(0).rand(50, 4)
    Y = np.random.RandomState(1).rand(50, 3)
    est = RandomForestRegressor(n_estimators=3, random_state=0).fit(X, Y)
    with pytest.raises(sklearn_convert.UnsupportedEstimator):
        sklearn_convert.convert_estimator(est, "cpu")


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("proba", [False, True])
def test_sklearn_runtime_answers_match_jax(tmp_path, iris, fitted, run_async, proba):
    import joblib
    from sklearn.ensemble import RandomForestRegressor

    X, y = iris
    Xf = X[::7].astype(np.float64)
    cases = {"svc": fitted("svc_iris")[0],
             "forest": fitted("random_forest_proba")[0],
             # no converter (multi-output): the estimator's own predict on
             # the host, in both packages
             "native": RandomForestRegressor(n_estimators=3, random_state=0).fit(
                 X, np.stack([y, y * 2.0], axis=1))}
    for name, est in cases.items():
        d = tmp_path / name
        d.mkdir()
        joblib.dump(est, d / "model.joblib")
        jm = jsks.SKLearnModel("m", str(d), predict_proba=proba)
        tm = sklearn_server.SKLearnModel("m", str(d), predict_proba=proba, device="cpu")
        assert jm.load() and tm.load()
        assert (tm._tensorized is None) == (name == "native")
        jv1 = run_async(jm({"instances": Xf.tolist()}))
        tv1 = run_async(tm({"instances": Xf.tolist()}))
        np.testing.assert_allclose(tv1["predictions"], jv1["predictions"], atol=ATOL, rtol=0)
        jres = run_async(jm(_v2_request(JInferInput, JInferRequest, Xf, True)))
        tres = run_async(tm(_v2_request(InferInput, InferRequest, Xf, True)))
        assert tres.outputs[0].datatype == jres.outputs[0].datatype
        np.testing.assert_allclose(tres.outputs[0].as_numpy(), jres.outputs[0].as_numpy(),
                                   atol=ATOL, rtol=0)


def test_feature_count_and_input_errors_match_jax(tmp_path, run_async):
    from kserve_tpu.errors import InvalidInput as JInvalidInput
    from kserve_tpu_torch.errors import InferenceError, InvalidInput

    (tmp_path / "model.json").write_text(json.dumps(XGB_BINARY))
    jm = jgbdt.XGBoostModel("m", str(tmp_path))
    tm = gbdt_server.XGBoostModel("m", str(tmp_path), device="cpu")
    jm.load(), tm.load()
    for body in ({"instances": [[1.0, 2.0, 3.0]]}, {"rows": [[1.0, 2.0]]}):
        with pytest.raises(JInvalidInput) as je:
            run_async(jm(body))
        with pytest.raises(InvalidInput) as te:
            run_async(tm(body))
        assert str(te.value) == str(je.value)
    with pytest.raises(InferenceError):
        run_async(tm({"instances": [["a", "b"]]}))


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from kserve_tpu_torch.runtimes import predictive_server

    (tmp_path / "model.json").write_text(json.dumps(XGB_BINARY))
    argv = ["--framework=xgboost", f"--model_dir={tmp_path}", "--model_name=m"]
    args = predictive_server.build_arg_parser().parse_args(argv)
    assert args.device == "cuda" and args.http_port == 8080
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for framework in sorted(predictive_server.FRAMEWORKS):
        with pytest.raises(RuntimeError, match="CUDA"):
            predictive_server.build_model(framework, "m", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        predictive_server.main(argv + ["--http_port=0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        trees.forest_apply(xgb_parse.parse_xgboost_json(XGB_BINARY))
    with pytest.raises(RuntimeError, match="CUDA"):
        sklearn_convert.convert_estimator(object())
    model = predictive_server.build_model("xgboost", "m", str(tmp_path), device="cpu")
    assert model.load() and model.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown framework"):
        predictive_server.build_model("onnx", "m", str(tmp_path), device="cpu")
