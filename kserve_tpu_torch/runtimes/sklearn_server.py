"""sklearn runtime: a pickled estimator, converted to torch functions on the
device (port of kserve_tpu/runtimes/sklearn_server.py).

The artifact is the first of model.joblib / .pkl / .pickle in the model
directory, read with joblib where it imports and else with the standard
library's pickle (the card machine has no joblib; a plain pickle reads the
same either way).  `predict_proba` selects the probability rows where the
estimator has them.  An estimator without a converter is served by its
own predict on the host, as the JAX runtime serves it.
"""

from __future__ import annotations

import logging
import pickle
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
from .tensorize.sklearn_convert import (
    Tensorized,
    UnsupportedEstimator,
    convert_estimator,
    map_classes,
)

logger = logging.getLogger(__name__)

MODEL_EXTENSIONS = (".joblib", ".pkl", ".pickle")


def _read_estimator(path: str):
    """Unpickle the artifact.  Only load a model directory you trust:
    unpickling runs code."""
    try:
        import joblib
    except ImportError:
        with open(path, "rb") as f:
            return pickle.load(f)
    return joblib.load(path)


class SKLearnModel(Model):
    def __init__(self, name: str, model_dir: str, predict_proba: bool = False,
                 device=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.predict_proba_mode = predict_proba
        self.device = resolve_device(device)
        self._estimator = None
        self._tensorized: Tensorized | None = None
        self.ready = False

    def load(self) -> bool:
        self._estimator = _read_estimator(find_model_file(self.model_dir, MODEL_EXTENSIONS))
        try:
            self._tensorized = convert_estimator(self._estimator, self.device)
            n_features = getattr(self._estimator, "n_features_in_", None)
            if n_features:
                probe = np.zeros((1, n_features), dtype=np.float32)
                self._tensorized.predict(probe).cpu()
            logger.info("model %s: %s converted on %s", self.name,
                        type(self._estimator).__name__, self.device)
        except UnsupportedEstimator as e:
            logger.warning(
                "Estimator %s has no converter; serving native sklearn on host", e)
            self._tensorized = None
        self.ready = True
        return self.ready

    def predict(
        self, payload: Union[Dict, InferRequest], headers=None, response_headers=None
    ) -> Union[Dict, InferResponse]:
        instances = single_input_matrix(get_predict_input(payload), self.name)
        validate_feature_count(
            instances, getattr(self._estimator, "n_features_in_", 0), self.name
        )
        try:
            if self._tensorized is not None:
                if self.predict_proba_mode and self._tensorized.predict_proba is not None:
                    result = self._tensorized.predict_proba(instances).cpu().numpy()
                else:
                    result = map_classes(self._tensorized.predict(instances),
                                         self._tensorized.classes)
            else:
                if self.predict_proba_mode and hasattr(self._estimator, "predict_proba"):
                    result = self._estimator.predict_proba(instances)
                else:
                    result = self._estimator.predict(instances)
            return get_predict_response(payload, result, self.name)
        except InvalidInput:
            raise
        except Exception as e:
            raise InferenceError(str(e))
