"""Decision-tree ensembles as dense tensors on the device (port of
kserve_tpu/runtimes/tensorize/trees.py).

Every tree becomes padded arrays (feature, threshold, children, leaf
values), built in numpy exactly as the JAX package builds them.
`forest_apply` puts them on the device, flattened over (tree, node) so
that a gather of a child index yields the next flat index, and walks
`max_depth` levels of gathers over [batch, tree]: a loop of fixed length
with no host read inside, since leaves and padding nodes point to
themselves and extra levels leave them in place.  Inputs are cast to
float32 as in the JAX traversal, and the thresholds are float32 rounded
so that the float32 comparison agrees with the float64 one
(`threshold_to_f32`).  No product here goes through a GEMM, so no TF32
setting of the caller changes a result.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device, upload


def threshold_to_f32(thr: np.ndarray, strict: bool = False) -> np.ndarray:
    """Cast split thresholds f64->f32 so the f32 comparison agrees with the
    f64 decision for every f32-representable x (round-to-nearest casting
    flips boundary samples when the f64 midpoint collides with a data value).
    `x <= thr` needs round-toward-neg-inf; strict `x < thr` round-toward-inf.
    """
    thr32 = thr.astype(np.float32)
    if strict:
        under = thr32.astype(np.float64) < thr
        if np.any(under):
            thr32 = np.where(under, np.nextafter(thr32, np.float32(np.inf)), thr32)
    else:
        over = thr32.astype(np.float64) > thr
        if np.any(over):
            thr32 = np.where(over, np.nextafter(thr32, np.float32(-np.inf)), thr32)
    return thr32.astype(np.float32)


class Aggregation(Enum):
    SUM = "sum"  # gradient boosting: sum of leaf scores (+ base)
    MEAN = "mean"  # random forest regressor / classifier prob average
    VOTE = "vote"  # hard-voting ensembles (unused by default runtimes)


class Link(Enum):
    IDENTITY = "identity"
    SIGMOID = "sigmoid"  # binary logistic
    SOFTMAX = "softmax"  # multiclass
    NORMALIZE = "normalize"  # probability re-normalization (sklearn RF)
    SIGMOID_EACH = "sigmoid_each"  # one-vs-all: independent sigmoid per class


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Edge-count depth of a tree given child arrays (leaves: left < 0)."""
    maxd = 0
    stack = [(0, 0)]
    while stack:
        node, d = stack.pop()
        maxd = max(maxd, d)
        if left[node] >= 0:
            stack.append((left[node], d + 1))
            stack.append((right[node], d + 1))
    return maxd


@dataclass
class ForestArrays:
    """Padded ensemble: all arrays are [n_trees, max_nodes(...)].

    Leaves are encoded as `feature == -1`; their children point to
    themselves so extra traversal iterations are no-ops.
    `leaf_value` is [n_trees, max_nodes, n_outputs].
    """

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_value: np.ndarray
    max_depth: int
    n_features: int
    n_outputs: int
    aggregation: Aggregation = Aggregation.SUM
    link: Link = Link.IDENTITY
    base_score: float = 0.0
    # multiclass boosting: tree t contributes to output class t % n_outputs
    class_of_tree: Optional[np.ndarray] = None
    # decision comparison: True -> go left when x < threshold (lgbm uses <=,
    # sklearn uses <=, xgboost uses <); encoded per-forest
    strict_less: bool = False
    # margin multiplier applied before the link (LightGBM `sigmoid:K`)
    link_scale: float = 1.0
    # framework returns argmax labels, not probabilities (xgboost multi:softmax)
    output_labels: bool = False

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def _pad_trees(trees: list) -> tuple:
    """trees: list of (feature, threshold, left, right, leaf_value[n, c])."""
    max_nodes = max(t[0].shape[0] for t in trees)
    n_trees = len(trees)
    n_out = trees[0][4].shape[1]
    feature = np.full((n_trees, max_nodes), -1, dtype=np.int32)
    threshold = np.zeros((n_trees, max_nodes), dtype=np.float32)
    left = np.zeros((n_trees, max_nodes), dtype=np.int32)
    right = np.zeros((n_trees, max_nodes), dtype=np.int32)
    leaf_value = np.zeros((n_trees, max_nodes, n_out), dtype=np.float32)
    for i, (f, t, l, r, v) in enumerate(trees):
        n = f.shape[0]
        feature[i, :n] = f
        threshold[i, :n] = t
        left[i, :n] = l
        right[i, :n] = r
        leaf_value[i, :n] = v
        # padding nodes are self-looping leaves
        pad = np.arange(n, max_nodes, dtype=np.int32)
        left[i, n:] = pad
        right[i, n:] = pad
    # leaves self-loop so fixed-depth iteration is idempotent past the leaf
    leaf_mask = feature < 0
    node_idx = np.broadcast_to(np.arange(max_nodes, dtype=np.int32), feature.shape)
    left = np.where(leaf_mask, node_idx, left)
    right = np.where(leaf_mask, node_idx, right)
    return feature, threshold, left, right, leaf_value


def build_forest(
    trees: list,
    max_depth: int,
    n_features: int,
    n_outputs: int,
    aggregation: Aggregation,
    link: Link,
    base_score: float = 0.0,
    class_of_tree: Optional[np.ndarray] = None,
    strict_less: bool = False,
) -> ForestArrays:
    feature, threshold, left, right, leaf_value = _pad_trees(trees)
    return ForestArrays(
        feature=feature,
        threshold=threshold,
        left=left,
        right=right,
        leaf_value=leaf_value,
        max_depth=max_depth,
        n_features=n_features,
        n_outputs=n_outputs,
        aggregation=aggregation,
        link=link,
        base_score=base_score,
        class_of_tree=class_of_tree,
        strict_less=strict_less,
    )


def as_f32(X, device: torch.device) -> torch.Tensor:
    """Model input (numpy, a list, or a tensor) as float32 on `device`: an
    f64 or integer input is rounded to float32 first, as the JAX runtimes
    cast it."""
    if not torch.is_tensor(X):
        # a copy: the rows of a binary-tensor request are a read-only view
        X = np.array(X, dtype=np.float32)
    return upload(X, device, torch.float32)


class ForestApply:
    """A forest's padded arrays on `device`, flattened over (tree, node):
    `feature` holds each node's feature (0 at leaves, whose children are
    themselves), `left` / `right` the flat index of each child."""

    def __init__(self, forest: ForestArrays, device=None):
        self.device = dev = resolve_device(device)
        n_trees, max_nodes = forest.feature.shape
        base = (np.arange(n_trees, dtype=np.int64) * max_nodes)[:, None]
        self.n_trees = n_trees
        self.depth = max(forest.max_depth, 1)
        self.strict_less = forest.strict_less
        self.aggregation = forest.aggregation
        self.base_score = forest.base_score
        self.feature = upload(np.maximum(forest.feature, 0).reshape(-1), dev, torch.int64)
        self.threshold = upload(forest.threshold.reshape(-1), dev, torch.float32)
        self.left = upload((forest.left + base).reshape(-1), dev, torch.int64)
        self.right = upload((forest.right + base).reshape(-1), dev, torch.int64)
        self.leaf_value = upload(
            forest.leaf_value.reshape(n_trees * max_nodes, -1), dev, torch.float32)
        self.roots = upload(base[:, 0], dev, torch.int64)
        # boosted multiclass: each tree's score goes to its class, as a
        # [T, C] one-hot summed elementwise (the JAX einsum)
        self.class_onehot = None
        if forest.class_of_tree is not None:
            onehot = np.zeros((n_trees, forest.n_outputs), dtype=np.float32)
            onehot[np.arange(n_trees), forest.class_of_tree] = 1.0
            self.class_onehot = upload(onehot, dev, torch.float32)

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """Every array the traversal reads."""
        arrays = (self.feature, self.threshold, self.left, self.right,
                  self.leaf_value, self.roots)
        return arrays + ((self.class_onehot,) if self.class_onehot is not None else ())

    def _walk(self, X: torch.Tensor) -> torch.Tensor:
        """Flat leaf index [B, T] reached by each row in each tree."""
        idx = self.roots.expand(X.shape[0], self.n_trees)
        for _ in range(self.depth):
            x = torch.gather(X, 1, self.feature[idx])
            t = self.threshold[idx]
            go_left = (x < t) if self.strict_less else (x <= t)
            idx = torch.where(go_left, self.left[idx], self.right[idx])
        return idx

    def leaves(self, X) -> torch.Tensor:
        """Node index within its tree [B, T] of the leaf each row reaches."""
        return self._walk(as_f32(X, self.device)) - self.roots

    def __call__(self, X) -> torch.Tensor:
        """Raw ensemble output [B, n_outputs] (before the link)."""
        values = self.leaf_value[self._walk(as_f32(X, self.device))]  # [B, T, C]
        if self.class_onehot is not None:
            out = (values[..., 0].unsqueeze(-1) * self.class_onehot).sum(dim=1)
        elif self.aggregation == Aggregation.MEAN:
            out = values.mean(dim=1)
        else:
            out = values.sum(dim=1)
        return out + self.base_score


def forest_apply(forest: ForestArrays, device=None) -> ForestApply:
    """The forest on `device` (default cuda): a callable X:[B,F] -> raw
    ensemble output [B, n_outputs] (before the link)."""
    return ForestApply(forest, device)


def apply_link(raw: torch.Tensor, link: Link, scale: float = 1.0) -> torch.Tensor:
    if scale != 1.0:
        raw = raw * scale
    if link == Link.SIGMOID:
        p1 = torch.sigmoid(raw[..., 0])
        return torch.stack([1.0 - p1, p1], dim=-1)
    if link == Link.SIGMOID_EACH:
        return torch.sigmoid(raw)
    if link == Link.SOFTMAX:
        return torch.softmax(raw, dim=-1)
    if link == Link.NORMALIZE:
        denom = torch.clamp(raw.sum(dim=-1, keepdim=True), min=1e-12)
        return raw / denom
    return raw


def forest_predict_fn(forest: ForestArrays, device=None):
    """(proba_fn, raw_fn) over X:[B,F], both on one ForestApply."""
    apply = forest_apply(forest, device)

    def raw_fn(X):
        return apply(X)

    def proba_fn(X):
        return apply_link(apply(X), forest.link, forest.link_scale)

    return proba_fn, raw_fn
