"""Online per-replica latency prediction for SLO-aware routing (port of
kserve_tpu/scheduler/latency.py; numpy).

The EPP's proxy sees every request's first byte and completion, so the
predictor learns online, per replica:
- TTFT ~ w . [1, queue_depth, prompt_len], fit by recursive least squares
  with forgetting (it follows a replica's load profile as it drifts);
- TPOT = EWMA of (total - ttft) / generated_tokens.

predict() returns None until a replica has enough observations: the
picker then scores it by queue depth alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

MIN_OBSERVATIONS = 5
FORGETTING = 0.98  # RLS forgetting factor: ~50-observation memory
# covariance trace bound: forgetting divides P by 0.98 per observation, so
# directions a uniform workload never excites wind up geometrically and
# overflow to NaN after ~35k requests; rescaling past the cap keeps the
# filter adaptive without the blow-up
P_TRACE_CAP = 1e6


def estimate_prompt_len(prompt_ids, prompt_text) -> int:
    """Shared token-count estimate for observations AND predictions —
    the two must use the same scale or the fitted prompt_len coefficient
    mis-predicts (~4 chars/token for text without a tokenizer)."""
    if prompt_ids:
        return len(prompt_ids)
    if prompt_text:
        return len(prompt_text) // 4
    return 0


@dataclass
class _ReplicaModel:
    # RLS state for 3 features [1, queue_depth, prompt_len]
    P: np.ndarray = field(default_factory=lambda: np.eye(3) * 1e3)
    w: np.ndarray = field(default_factory=lambda: np.zeros(3))
    n: int = 0
    tpot_ewma: Optional[float] = None


class LatencyPredictor:
    def __init__(self, tpot_alpha: float = 0.2):
        self._models: Dict[str, _ReplicaModel] = {}
        self.tpot_alpha = tpot_alpha

    def _model(self, url: str) -> _ReplicaModel:
        return self._models.setdefault(url.rstrip("/"), _ReplicaModel())

    def forget(self, url: str) -> None:
        self._models.pop(url.rstrip("/"), None)

    def observe(self, url: str, prompt_len: int, queue_depth: int,
                ttft_s: float, n_tokens: int = 0,
                total_s: Optional[float] = None) -> None:
        """One completed (or first-byte'd) request through `url`."""
        m = self._model(url)
        x = np.asarray([1.0, float(queue_depth), float(prompt_len)])
        # recursive least squares with forgetting
        Px = m.P @ x
        k = Px / (FORGETTING + x @ Px)
        m.w = m.w + k * (ttft_s - x @ m.w)
        m.P = (m.P - np.outer(k, Px)) / FORGETTING
        trace = float(np.trace(m.P))
        if not np.isfinite(trace) or trace > P_TRACE_CAP:
            m.P = np.eye(3) * (P_TRACE_CAP / 3)
        if not np.all(np.isfinite(m.w)):
            m.w = np.zeros(3)
            m.n = 0  # relearn; never serve NaN predictions
            return
        m.n += 1
        if total_s is not None and n_tokens > 1:
            tpot = max(total_s - ttft_s, 0.0) / (n_tokens - 1)
            if m.tpot_ewma is None:
                m.tpot_ewma = tpot
            else:
                m.tpot_ewma = (
                    self.tpot_alpha * tpot
                    + (1 - self.tpot_alpha) * m.tpot_ewma
                )

    def predict_ttft(self, url: str, prompt_len: int,
                     queue_depth: int) -> Optional[float]:
        m = self._models.get(url.rstrip("/"))
        if m is None or m.n < MIN_OBSERVATIONS:
            return None
        x = np.asarray([1.0, float(queue_depth), float(prompt_len)])
        return max(float(x @ m.w), 0.0)

    def predict_tpot(self, url: str) -> Optional[float]:
        m = self._models.get(url.rstrip("/"))
        if m is None or m.tpot_ewma is None:
            return None
        return m.tpot_ewma

    def predict_total(self, url: str, prompt_len: int, queue_depth: int,
                      max_tokens: int) -> Optional[float]:
        ttft = self.predict_ttft(url, prompt_len, queue_depth)
        if ttft is None:
            return None
        tpot = self.predict_tpot(url) or 0.0
        return ttft + tpot * max(max_tokens - 1, 0)

    def snapshot(self) -> Dict[str, dict]:
        """Observability: per-replica fitted state (the /state analogue of
        the reference predictor's metrics endpoint)."""
        out = {}
        for url, m in self._models.items():
            out[url] = {
                "observations": m.n,
                "ttft_weights": [round(float(v), 6) for v in m.w],
                "tpot_ewma_s": (round(m.tpot_ewma, 6)
                                if m.tpot_ewma is not None else None),
            }
        return out
