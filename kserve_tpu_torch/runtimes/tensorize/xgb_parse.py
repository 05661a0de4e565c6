"""XGBoost JSON model parser -> ForestArrays, no xgboost dependency (port
of kserve_tpu/runtimes/tensorize/xgb_parse.py).

Reads the documented JSON serialization (learner/gradient_booster/model/trees
with split_indices/split_conditions/left_children/right_children, leaf values
stored in split_conditions at leaf nodes, per-tree class in tree_info).
XGBoost routes `x < threshold` left (strict), missing values via default_left
(treated as left==default here; NaNs compare false and take the right
branch).
"""

from __future__ import annotations

import json
import math

import numpy as np

from .trees import Aggregation, ForestArrays, Link, build_forest, threshold_to_f32, tree_depth


_LINKS = {
    "binary:logistic": Link.SIGMOID,
    "multi:softprob": Link.SOFTMAX,
    "multi:softmax": Link.SOFTMAX,
}


def parse_xgboost_json(path_or_dict) -> ForestArrays:
    if isinstance(path_or_dict, (str, bytes)):
        with open(path_or_dict) as f:
            doc = json.load(f)
    else:
        doc = path_or_dict
    learner = doc["learner"]
    booster = learner["gradient_booster"]
    if booster.get("name", "gbtree") != "gbtree":
        raise ValueError(f"unsupported booster {booster.get('name')}")
    model = booster["model"]
    trees_json = model["trees"]
    tree_info = model.get("tree_info", [0] * len(trees_json))
    params = learner.get("learner_model_param", {})
    num_class = int(params.get("num_class", "0") or 0)
    n_features = int(params.get("num_feature", "0") or 0)
    base_score = float(params.get("base_score", "0.5") or 0.5)
    objective = learner.get("objective", {}).get("name", "reg:squarederror")

    trees = []
    max_depth = 1
    for t in trees_json:
        left = np.asarray(t["left_children"], dtype=np.int32)
        right = np.asarray(t["right_children"], dtype=np.int32)
        split_cond = np.asarray(t["split_conditions"], dtype=np.float64)
        split_idx = np.asarray(t["split_indices"], dtype=np.int32)
        is_leaf = left < 0
        feature = np.where(is_leaf, -1, split_idx).astype(np.int32)
        threshold = threshold_to_f32(np.where(is_leaf, 0.0, split_cond), strict=True)
        value = np.where(is_leaf, split_cond, 0.0).astype(np.float32)[:, None]
        max_depth = max(max_depth, tree_depth(left, right))
        trees.append((feature, threshold, left, right, value))

    link = _LINKS.get(objective, Link.IDENTITY)
    n_outputs = max(num_class, 1)
    class_of_tree = (
        np.asarray(tree_info, dtype=np.int32) if num_class > 1 else None
    )
    # margin-space base: logistic objectives store base_score in probability
    if objective.startswith("binary:") and 0.0 < base_score < 1.0:
        base = math.log(base_score / (1.0 - base_score))
    else:
        base = base_score
    forest = build_forest(
        trees,
        max_depth=max_depth,
        n_features=n_features,
        n_outputs=n_outputs,
        aggregation=Aggregation.SUM,
        link=link,
        base_score=base,
        class_of_tree=class_of_tree,
        strict_less=True,
    )
    # multi:softmax: Booster.predict returns argmax class labels, not probs
    forest.output_labels = objective == "multi:softmax"
    return forest
