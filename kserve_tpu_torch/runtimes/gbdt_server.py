"""XGBoost / LightGBM runtimes: parse the model dump, serve the forest on
the device (port of kserve_tpu/runtimes/gbdt_server.py).

No GBDT framework is needed to serve: the dump is parsed by
tensorize/{xgb_parse,lgb_parse} and walked by tensorize/trees.py on the
card (`device`, default cuda; "cpu" when asked for).  The answers are the
booster's own: P(class 1) for a binary logistic model, probability rows
for softprob, argmax labels for multi:softmax, raw scores for a
regression, and the probability rows whenever `predict_proba` is set.
"""

from __future__ import annotations

import logging
from typing import Dict, Union

import numpy as np

from ..device import resolve_device
from ..errors import InferenceError, InvalidInput
from ..infer_type import InferRequest, InferResponse
from ..model import Model
from ..utils.inference import (
    get_predict_input,
    get_predict_response,
    single_input_matrix,
    validate_feature_count,
)
from .artifact import find_model_file
from .tensorize.lgb_parse import parse_lightgbm_text
from .tensorize.trees import Link, apply_link, forest_apply
from .tensorize.xgb_parse import parse_xgboost_json

logger = logging.getLogger(__name__)


class _ForestModel(Model):
    EXTENSIONS: tuple = ()

    def __init__(self, name: str, model_dir: str, predict_proba: bool = False,
                 device=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.predict_proba_mode = predict_proba
        self.device = resolve_device(device)
        self._forest = None
        self._apply = None  # the ForestApply on the device
        self.ready = False

    def _parse(self, path: str):
        raise NotImplementedError

    def _proba_fn(self, X):
        return apply_link(self._apply(X), self._forest.link, self._forest.link_scale)

    def load(self) -> bool:
        self._forest = self._parse(find_model_file(self.model_dir, self.EXTENSIONS))
        self._apply = forest_apply(self._forest, self.device)
        probe = np.zeros((1, max(self._forest.n_features, 1)), dtype=np.float32)
        self._proba_fn(probe).cpu()
        logger.info("model %s: %d trees, depth %d, %d features, forest on %s",
                    self.name, self._forest.n_trees, self._forest.max_depth,
                    self._forest.n_features, self._apply.feature.device)
        self.ready = True
        return self.ready

    def predict(
        self, payload: Union[Dict, InferRequest], headers=None, response_headers=None
    ) -> Union[Dict, InferResponse]:
        instances = single_input_matrix(get_predict_input(payload), self.name)
        validate_feature_count(instances, self._forest.n_features, self.name)
        try:
            probs = self._proba_fn(instances).cpu().numpy()
            # Booster.predict's answer: sigmoid -> P(class 1), softmax ->
            # probability rows (multi:softmax -> argmax labels), identity ->
            # raw scores
            if self._forest.link == Link.IDENTITY:
                result = probs[..., 0] if probs.shape[-1] == 1 else probs
            elif self._forest.output_labels and not self.predict_proba_mode:
                result = np.argmax(probs, axis=-1)
            elif self._forest.link == Link.SIGMOID and not self.predict_proba_mode:
                result = probs[..., 1]
            else:
                result = probs
            return get_predict_response(payload, result, self.name)
        except InvalidInput:
            raise
        except Exception as e:
            raise InferenceError(str(e))


class XGBoostModel(_ForestModel):
    EXTENSIONS = (".json",)

    def _parse(self, path: str):
        return parse_xgboost_json(path)


class LightGBMModel(_ForestModel):
    EXTENSIONS = (".txt", ".bst", ".model")

    def _parse(self, path: str):
        return parse_lightgbm_text(path)
