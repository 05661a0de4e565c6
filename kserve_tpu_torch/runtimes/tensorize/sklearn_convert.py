"""sklearn estimator -> torch inference functions on the device (port of
kserve_tpu/runtimes/tensorize/sklearn_convert.py).

The fitted estimator is converted at load time: trees become the gather
programs of trees.py, kernels and linear models become products.  Anything
without a converter raises UnsupportedEstimator, and the runtime then
serves the estimator's own predict on the host, as the JAX runtime does.

Every product is exact to full float32 whatever the caller's TF32
settings are (the JAX package runs its products at "highest" precision
because a lower one flips decision boundaries, and the RBF kernel's
|x|^2 - 2 x.sv + |sv|^2 expansion is exact only in full f32).  `_mm` is
one float64 GEMM rounded to float32: TF32 (and
$TORCH_ALLOW_TF32_CUBLAS_OVERRIDE) applies only to float32 products, and
a float64 sum of float32 terms is at least as exact as a float32 one.
Weights are held in float64 once, at conversion; the distance expansions
are summed in float64 too, then rounded to float32.

Supported: Pipeline, StandardScaler/MinMaxScaler/MaxAbsScaler/Normalizer,
DecisionTree*, RandomForest*, ExtraTrees*, GradientBoosting*, linear models
(LinearRegression/Ridge/Lasso/ElasticNet/LogisticRegression/SGD*), SVC/SVR
(libsvm ovo decision), MLPClassifier/MLPRegressor, KMeans.  Each function
takes rows (numpy, a list or a tensor), casts them to float32 on the
device, and returns a tensor on the device; argmax labels are int32, as
the JAX functions return them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ...device import resolve_device, upload
from .trees import (
    Aggregation,
    Link,
    apply_link,
    as_f32,
    build_forest,
    forest_apply,
    threshold_to_f32,
)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, K] @ b [K, N] as one float64 GEMM, rounded to float32."""
    return (a.double() @ b.double()).float()


def _f64(x, dev: torch.device) -> torch.Tensor:
    """A weight rounded to float32 (as the JAX package holds it), then held
    in float64 on `dev` for `_mm`."""
    return upload(np.asarray(x, dtype=np.float32), dev, torch.float32).double()


def _sq_dist(X: torch.Tensor, c_t: torch.Tensor, c_sq: torch.Tensor) -> torch.Tensor:
    """|x|^2 - 2 x.c + |c|^2 [B, N] for float64 `c_t` [K, N] and `c_sq`
    [1, N], summed in float64 and rounded to float32."""
    x = X.double()
    return ((x * x).sum(dim=1, keepdim=True) - 2.0 * (x @ c_t) + c_sq).float()


def _argmax(x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(x, dim=-1).to(torch.int32)


@dataclass
class Tensorized:
    """Inference functions of one fitted estimator."""

    predict: Callable  # X -> labels / regression values
    predict_proba: Optional[Callable] = None
    decision_function: Optional[Callable] = None
    classes: Optional[np.ndarray] = None


class UnsupportedEstimator(Exception):
    pass


def _on(dev: torch.device, fn: Callable) -> Callable:
    """`fn` over the rows cast to float32 on `dev`."""
    return lambda X: fn(as_f32(X, dev))


# ---------------- transforms ----------------


def _convert_transform(tr, dev) -> Callable:
    name = type(tr).__name__
    if name == "StandardScaler":
        mean = upload(tr.mean_, dev, torch.float32) if tr.with_mean else 0.0
        scale = upload(tr.scale_, dev, torch.float32) if tr.with_std else 1.0
        return lambda X: (X - mean) / scale
    if name == "MinMaxScaler":
        scale = upload(tr.scale_, dev, torch.float32)
        min_ = upload(tr.min_, dev, torch.float32)
        return lambda X: X * scale + min_
    if name == "MaxAbsScaler":
        scale = upload(tr.scale_, dev, torch.float32)
        return lambda X: X / scale
    if name == "Normalizer":
        if tr.norm == "l2":
            return lambda X: X / torch.linalg.norm(X, dim=1, keepdim=True).clamp(min=1e-12)
        if tr.norm == "l1":
            return lambda X: X / X.abs().sum(dim=1, keepdim=True).clamp(min=1e-12)
        return lambda X: X / X.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    raise UnsupportedEstimator(name)


# ---------------- trees ----------------


def _sklearn_tree_arrays(tree, is_classifier: bool, normalize_leaves: bool):
    t = tree.tree_
    feature = np.where(t.children_left < 0, -1, t.feature).astype(np.int32)
    value = t.value.astype(np.float32)  # [n_nodes, n_outputs, n_classes|1]
    if value.shape[1] != 1:
        raise UnsupportedEstimator(
            f"multi-output tree ({value.shape[1]} outputs); native fallback"
        )
    value = value[:, 0, :]
    if is_classifier and normalize_leaves:
        denom = np.clip(value.sum(axis=1, keepdims=True), 1e-12, None)
        value = value / denom
    return (
        feature,
        threshold_to_f32(t.threshold),
        t.children_left.astype(np.int32),
        t.children_right.astype(np.int32),
        value,
    )


def _forest_tensorized(est, apply) -> Tensorized:
    if hasattr(est, "classes_"):
        return Tensorized(predict=lambda X: _argmax(apply(X)),
                          predict_proba=lambda X: apply(X), classes=est.classes_)
    return Tensorized(predict=lambda X: apply(X)[..., 0])


def _convert_decision_tree(est, dev) -> Tensorized:
    arrays = _sklearn_tree_arrays(est, hasattr(est, "classes_"), normalize_leaves=True)
    forest = build_forest(
        [arrays],
        max_depth=est.get_depth(),
        n_features=est.n_features_in_,
        n_outputs=arrays[4].shape[1],
        aggregation=Aggregation.SUM,
        link=Link.IDENTITY,
    )
    return _forest_tensorized(est, forest_apply(forest, dev))


def _convert_forest(est, dev) -> Tensorized:
    is_clf = hasattr(est, "classes_")
    trees = [
        _sklearn_tree_arrays(t, is_clf, normalize_leaves=True) for t in est.estimators_
    ]
    forest = build_forest(
        trees,
        max_depth=max(t.get_depth() for t in est.estimators_),
        n_features=est.n_features_in_,
        n_outputs=trees[0][4].shape[1],
        aggregation=Aggregation.MEAN,
        link=Link.IDENTITY,
    )
    return _forest_tensorized(est, forest_apply(forest, dev))


def _convert_gradient_boosting(est, dev) -> Tensorized:
    is_clf = hasattr(est, "classes_")
    lr = est.learning_rate
    stages = est.estimators_  # [n_stages, K] of DecisionTreeRegressor
    n_stages, K = stages.shape
    trees = []
    class_of_tree = []
    for s in range(n_stages):
        for k in range(K):
            f, t, l, r, v = _sklearn_tree_arrays(stages[s, k], False, False)
            trees.append((f, t, l, r, v * lr))
            class_of_tree.append(k)
    max_depth = max(t.get_depth() for row in stages for t in row)
    # constant init contribution (DummyEstimator): probe at a zero point.
    # _raw_predict_init is private sklearn API — if it moves, refuse to
    # convert (native fallback) rather than silently dropping the prior.
    zero = np.zeros((1, est.n_features_in_), dtype=np.float64)
    try:
        base = est._raw_predict_init(zero)[0].astype(np.float32)
    except AttributeError as e:
        raise UnsupportedEstimator(
            f"GradientBoosting init probe failed ({e}); native fallback"
        )
    forest = build_forest(
        trees,
        max_depth=max_depth,
        n_features=est.n_features_in_,
        n_outputs=max(K, 1),
        aggregation=Aggregation.SUM,
        link=Link.IDENTITY,
        class_of_tree=np.asarray(class_of_tree, dtype=np.int32),
    )
    apply = forest_apply(forest, dev)
    base_t = upload(base, dev, torch.float32)

    def raw(X):
        return apply(X) + base_t

    if is_clf:
        link = Link.SIGMOID if len(est.classes_) == 2 else Link.SOFTMAX

        def proba(X):
            return apply_link(raw(X), link)

        return Tensorized(predict=lambda X: _argmax(proba(X)), predict_proba=proba,
                          decision_function=raw, classes=est.classes_)
    return Tensorized(predict=lambda X: raw(X)[..., 0])


# ---------------- linear ----------------


def _convert_linear(est, dev) -> Tensorized:
    coef = np.atleast_2d(est.coef_).astype(np.float32)
    intercept = np.atleast_1d(est.intercept_).astype(np.float32)
    W = _f64(coef.T, dev)
    b = upload(intercept, dev, torch.float32)

    def decision(X):
        return _mm(X, W) + b

    if not hasattr(est, "classes_"):
        if coef.shape[0] == 1:
            return Tensorized(predict=_on(dev, lambda X: decision(X)[..., 0]))
        return Tensorized(predict=_on(dev, decision))
    classes = est.classes_
    loss = getattr(est, "loss", None)
    probabilistic = type(est).__name__ == "LogisticRegression" or loss in ("log_loss", "log")
    if probabilistic:
        if len(classes) == 2:
            def proba(X):
                return apply_link(decision(X), Link.SIGMOID)
        else:
            def proba(X):
                return torch.softmax(decision(X), dim=-1)

        return Tensorized(predict=_on(dev, lambda X: _argmax(proba(X))),
                          predict_proba=_on(dev, proba),
                          decision_function=_on(dev, decision), classes=classes)
    if len(classes) == 2:
        def predict(X):
            return (decision(X)[..., 0] > 0).to(torch.int32)
    else:
        def predict(X):
            return _argmax(decision(X))
    return Tensorized(predict=_on(dev, predict), decision_function=_on(dev, decision),
                      classes=classes)


# ---------------- SVM (libsvm ovo) ----------------


def _svm_kernel_fn(est, dev):
    kernel = est.kernel
    gamma = est._gamma if hasattr(est, "_gamma") else est.gamma
    coef0 = est.coef0
    degree = est.degree
    sv_t = _f64(est.support_vectors_.T, dev)
    sv_sq = (sv_t * sv_t).sum(dim=0, keepdim=True)

    def k(X):
        if kernel == "linear":
            return _mm(X, sv_t)
        if kernel == "rbf":
            return torch.exp(-gamma * _sq_dist(X, sv_t, sv_sq))
        if kernel == "poly":
            return (gamma * _mm(X, sv_t) + coef0) ** degree
        if kernel == "sigmoid":
            return torch.tanh(gamma * _mm(X, sv_t) + coef0)
        raise UnsupportedEstimator(f"SVC kernel {kernel}")

    return k


def _convert_svc(est, dev) -> Tensorized:
    classes = est.classes_
    n_classes = len(classes)
    n_support = est.n_support_
    starts = np.concatenate([[0], np.cumsum(n_support)])
    dual = est.dual_coef_.astype(np.float32)  # [n_classes-1, n_sv]
    intercept = est.intercept_.astype(np.float32)
    n_sv = est.support_vectors_.shape[0]
    pairs = [(i, j) for i in range(n_classes) for j in range(i + 1, n_classes)]
    C = np.zeros((len(pairs), n_sv), dtype=np.float32)
    for p, (i, j) in enumerate(pairs):
        # libsvm: decision(i,j) uses class-i SVs with dual row (j-1) and
        # class-j SVs with dual row i
        si, ei = starts[i], starts[i + 1]
        sj, ej = starts[j], starts[j + 1]
        C[p, si:ei] = dual[j - 1, si:ei]
        C[p, sj:ej] = dual[i, sj:ej]
    C_t = _f64(C.T, dev)
    b = upload(intercept, dev, torch.float32)
    kernel = _svm_kernel_fn(est, dev)
    pos = np.zeros((len(pairs), n_classes), dtype=np.float32)
    neg = np.zeros((len(pairs), n_classes), dtype=np.float32)
    for p, (i, j) in enumerate(pairs):
        pos[p, i] = 1.0
        neg[p, j] = 1.0
    pos_t, neg_t = _f64(pos, dev), _f64(neg, dev)
    # libsvm tie-break: lowest class index wins -> a tiny descending bias
    bias = -torch.arange(n_classes, dtype=torch.float32, device=dev) * 1e-6

    def decision(X):
        return _mm(kernel(X), C_t) + b  # [B, n_pairs]

    def predict_idx(X):
        win = (decision(X) > 0).to(torch.float32)
        votes = _mm(win, pos_t) + _mm(1.0 - win, neg_t)
        return _argmax(votes + bias)

    if n_classes == 2:
        # the public dual_coef_/intercept_ already carry sklearn's binary sign
        # convention: decision>0 -> classes_[1]
        return Tensorized(
            predict=_on(dev, lambda X: (decision(X)[..., 0] > 0).to(torch.int32)),
            decision_function=_on(dev, lambda X: decision(X)[..., 0]),
            classes=classes,
        )
    return Tensorized(predict=_on(dev, predict_idx), decision_function=_on(dev, decision),
                      classes=classes)


def _convert_svr(est, dev) -> Tensorized:
    dual = _f64(est.dual_coef_[0][:, None], dev)
    b = float(est.intercept_[0])
    kernel = _svm_kernel_fn(est, dev)
    return Tensorized(predict=_on(dev, lambda X: _mm(kernel(X), dual)[:, 0] + b))


# ---------------- MLP ----------------

_MLP_ACT = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "logistic": torch.sigmoid,
    "identity": lambda x: x,
}


def _convert_mlp(est, dev) -> Tensorized:
    Ws = [_f64(w, dev) for w in est.coefs_]
    bs = [upload(b.astype(np.float32), dev, torch.float32) for b in est.intercepts_]
    act = _MLP_ACT[est.activation]
    out_act = est.out_activation_

    def forward(X):
        h = X
        for W, b in zip(Ws[:-1], bs[:-1]):
            h = act(_mm(h, W) + b)
        out = _mm(h, Ws[-1]) + bs[-1]
        if out_act == "softmax":
            return torch.softmax(out, dim=-1)
        if out_act == "logistic":
            return torch.sigmoid(out)
        return out

    if hasattr(est, "classes_"):
        if len(est.classes_) == 2:
            def proba(X):
                f = forward(X)
                return torch.cat([1 - f, f], dim=-1)
        else:
            proba = forward
        return Tensorized(predict=_on(dev, lambda X: _argmax(proba(X))),
                          predict_proba=_on(dev, proba), classes=est.classes_)
    if est.coefs_[-1].shape[1] == 1:
        return Tensorized(predict=_on(dev, lambda X: forward(X)[..., 0]))
    return Tensorized(predict=_on(dev, forward))


def _convert_kmeans(est, dev) -> Tensorized:
    centers_t = _f64(est.cluster_centers_.T, dev)
    centers_sq = (centers_t * centers_t).sum(dim=0, keepdim=True)

    def predict(X):
        return torch.argmin(_sq_dist(X, centers_t, centers_sq), dim=-1).to(torch.int32)

    return Tensorized(predict=_on(dev, predict))


# ---------------- dispatch ----------------

_CONVERTERS = {
    "DecisionTreeClassifier": _convert_decision_tree,
    "DecisionTreeRegressor": _convert_decision_tree,
    "ExtraTreeClassifier": _convert_decision_tree,
    "ExtraTreeRegressor": _convert_decision_tree,
    "RandomForestClassifier": _convert_forest,
    "RandomForestRegressor": _convert_forest,
    "ExtraTreesClassifier": _convert_forest,
    "ExtraTreesRegressor": _convert_forest,
    "GradientBoostingClassifier": _convert_gradient_boosting,
    "GradientBoostingRegressor": _convert_gradient_boosting,
    "LinearRegression": _convert_linear,
    "Ridge": _convert_linear,
    "Lasso": _convert_linear,
    "ElasticNet": _convert_linear,
    "LogisticRegression": _convert_linear,
    "SGDClassifier": _convert_linear,
    "SGDRegressor": _convert_linear,
    "LinearSVC": _convert_linear,
    "LinearSVR": _convert_linear,
    "SVC": _convert_svc,
    "NuSVC": _convert_svc,
    "SVR": _convert_svr,
    "NuSVR": _convert_svr,
    "MLPClassifier": _convert_mlp,
    "MLPRegressor": _convert_mlp,
    "KMeans": _convert_kmeans,
}


def convert_estimator(est, device=None) -> Tensorized:
    """Fitted sklearn estimator (or Pipeline) -> Tensorized functions on
    `device` (default cuda).  Raises UnsupportedEstimator when no converter
    exists."""
    dev = resolve_device(device)
    name = type(est).__name__
    if name == "Pipeline":
        transforms = [_convert_transform(tr, dev) for _, tr in est.steps[:-1]]
        final = convert_estimator(est.steps[-1][1], dev)

        def chain(fn):
            if fn is None:
                return None

            def wrapped(X):
                h = as_f32(X, dev)
                for t in transforms:
                    h = t(h)
                return fn(h)

            return wrapped

        return Tensorized(
            predict=chain(final.predict),
            predict_proba=chain(final.predict_proba),
            decision_function=chain(final.decision_function),
            classes=final.classes,
        )
    conv = _CONVERTERS.get(name)
    if conv is None:
        raise UnsupportedEstimator(name)
    return conv(est, dev)


def map_classes(indices, classes: Optional[np.ndarray]):
    """Map argmax indices back to the original class labels on the host."""
    if torch.is_tensor(indices):
        indices = indices.cpu().numpy()
    if classes is None:
        return indices
    return np.asarray(classes)[np.asarray(indices)]
