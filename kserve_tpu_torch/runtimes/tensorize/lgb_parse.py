"""LightGBM text model parser -> ForestArrays, no lightgbm dependency (port
of kserve_tpu/runtimes/tensorize/lgb_parse.py).

Reads the `model.txt` format (Tree=N sections with split_feature/threshold/
left_child/right_child/leaf_value).  LightGBM encoding: internal nodes are
indexed 0..num_leaves-2, children >= 0 are internal, children < 0 are leaves
(leaf index = -child - 1), numerical rule `x <= threshold` routes left.
Multiclass models interleave trees per class (num_tree_per_iteration).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from .trees import Aggregation, ForestArrays, Link, build_forest, threshold_to_f32, tree_depth


def _parse_sections(text: str) -> tuple:
    header: Dict[str, str] = {}
    trees: List[Dict[str, str]] = []
    current: Dict[str, str] = header
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("Tree="):
            current = {}
            trees.append(current)
            continue
        if line.startswith("end of trees"):
            current = {}
            continue
        if "=" in line:
            key, _, val = line.partition("=")
            current[key] = val
    return header, trees


def _arr(section: Dict[str, str], key: str, dtype):
    val = section.get(key, "")
    if not val:
        return np.zeros(0, dtype=dtype)
    return np.asarray(val.split(" "), dtype=dtype)


def parse_lightgbm_text(path_or_text: str) -> ForestArrays:
    if "\n" not in path_or_text:
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    header, tree_sections = _parse_sections(text)
    num_class = int(header.get("num_class", "1"))
    trees_per_iter = int(header.get("num_tree_per_iteration", "1"))
    n_features = int(header.get("max_feature_idx", "0")) + 1
    objective = header.get("objective", "regression")

    trees = []
    max_depth = 1
    for sec in tree_sections:
        num_leaves = int(sec["num_leaves"])
        leaf_value = _arr(sec, "leaf_value", np.float64)
        if num_leaves == 1:
            # stump: single leaf
            feature = np.asarray([-1], dtype=np.int32)
            threshold = np.zeros(1, dtype=np.float32)
            left = np.asarray([0], dtype=np.int32)
            right = np.asarray([0], dtype=np.int32)
            value = leaf_value.astype(np.float32)[:1, None]
            trees.append((feature, threshold, left, right, value))
            continue
        if int(sec.get("num_cat", "0") or 0) > 0:
            raise ValueError(
                "LightGBM categorical splits are not supported by the "
                "parser; re-train with numeric features"
            )
        decision_type = _arr(sec, "decision_type", np.int32)
        if np.any(decision_type & 1):
            raise ValueError("categorical decision_type in LightGBM model")
        split_feature = _arr(sec, "split_feature", np.int32)
        thr = _arr(sec, "threshold", np.float64)
        left_child = _arr(sec, "left_child", np.int32)
        right_child = _arr(sec, "right_child", np.int32)
        n_internal = num_leaves - 1
        n_nodes = n_internal + num_leaves

        def remap(child: np.ndarray) -> np.ndarray:
            # internal child keeps its index; leaf child -k-1 -> n_internal + k
            return np.where(child >= 0, child, n_internal + (-child - 1)).astype(np.int32)

        feature = np.concatenate(
            [split_feature, np.full(num_leaves, -1, dtype=np.int32)]
        )
        threshold = np.concatenate(
            [threshold_to_f32(thr), np.zeros(num_leaves, dtype=np.float32)]
        )
        left = np.concatenate(
            [remap(left_child), np.arange(n_internal, n_nodes, dtype=np.int32)]
        )
        right = np.concatenate(
            [remap(right_child), np.arange(n_internal, n_nodes, dtype=np.int32)]
        )
        value = np.concatenate(
            [np.zeros(n_internal, dtype=np.float32), leaf_value.astype(np.float32)]
        )[:, None]
        # children arrays here are already remapped (leaves have feature=-1),
        # so mask leaf self-loops for the shared depth helper
        depth_left = np.where(feature >= 0, left, -1)
        max_depth = max(max_depth, tree_depth(depth_left, right))
        trees.append((feature, threshold, left, right, value))

    # objective line examples: "binary sigmoid:1", "multiclass num_class:3",
    # "multiclassova num_class:3 sigmoid:1", "regression"
    link_scale = 1.0
    m = re.search(r"sigmoid:([0-9.]+)", objective)
    if m:
        link_scale = float(m.group(1))
    if objective.startswith("binary"):
        link = Link.SIGMOID
    elif objective.startswith("multiclassova"):
        link = Link.SIGMOID_EACH  # one-vs-all: independent sigmoid per class
    elif objective.startswith("multiclass"):
        link = Link.SOFTMAX
        link_scale = 1.0
    else:
        link = Link.IDENTITY
        link_scale = 1.0
    n_outputs = max(num_class, 1)
    class_of_tree = None
    if trees_per_iter > 1:
        class_of_tree = np.asarray(
            [i % trees_per_iter for i in range(len(trees))], dtype=np.int32
        )
    forest = build_forest(
        trees,
        max_depth=max_depth,
        n_features=n_features,
        n_outputs=n_outputs,
        aggregation=Aggregation.SUM,
        link=link,
        base_score=0.0,
        class_of_tree=class_of_tree,
        strict_less=False,
    )
    forest.link_scale = link_scale
    return forest
