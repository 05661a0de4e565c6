"""Explainer runtime: model-agnostic attributions over a predictor (port of
kserve_tpu/runtimes/explainer_server.py).

The black-box model stays behind its predictor's REST API: `explain`
draws the perturbed rows on the host from `np.random.RandomState(seed)`,
in the JAX package's order, so that the predictor receives the rows the
reference sends; one batched V1 `:predict` call per explained row goes
out under the explainer's own model name (`Model`'s predictor_host
forwarding), and the reduction to attributions runs in torch float64 on
the explainer's device (cuda unless given "cpu").

Two methods, selectable per request ("method") or by flag:
- "permutation": mean |prediction delta| when each feature is resampled
  from a background distribution (permutation feature importance);
- "kernelshap": Kernel SHAP with the standard Shapley kernel weights,
  solved as a weighted least squares over sampled coalitions.  The
  weights are 1e6 for the empty and full coalitions against ~1e-9 for
  the middle ones at 28 features: the JAX package's float32 normal
  equations (x64 off) give NaN there, and the port solves by QR in
  float64 (`kernelshap_solve`).

Usage:
    python -m kserve_tpu_torch.runtimes.explainer_server \\
        --model_name=m --predictor_host=host:port [--method=kernelshap] \\
        [--n_samples=64] [--http_port=8080] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from math import comb
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device, upload
from ..errors import InvalidInput
from ..model import Model, PredictorConfig
from ..model_server import ModelServer

logger = logging.getLogger(__name__)

METHODS = ("permutation", "kernelshap")


def _shapley_kernel_weights(mask_sizes: np.ndarray, n_features: int) -> np.ndarray:
    """Kernel SHAP coalition weights; the degenerate (all-off / all-on)
    coalitions get a large finite weight instead of infinity."""
    weights = np.zeros_like(mask_sizes, dtype=np.float64)
    for i, size in enumerate(mask_sizes):
        if size == 0 or size == n_features:
            weights[i] = 1e6
        else:
            weights[i] = (n_features - 1) / (
                comb(n_features, int(size)) * size * (n_features - size)
            )
    return weights


def kernelshap_solve(masks: np.ndarray, y: np.ndarray, weights: np.ndarray,
                     device) -> np.ndarray:
    """phi of the reference's weighted ridge least squares, y ~ masks @ phi
    + phi0 with weights `weights` and ridge 1e-6 on every coefficient, in
    float64 on `device`; returns phi without phi0.

    The reference forms the normal equations X^T W X + 1e-6 I, whose
    condition number is ~6.8e12 at 28 features, so that even a float64
    solve of them strays 2e-4 to 3e-3 of max|phi| from the exact answer;
    the same problem is solved here by Householder QR of the
    square-root-weighted system stacked over sqrt(1e-6) I, within 3e-10 of
    max|phi| of a 40-digit solve (scripts/kernelshap_precision.py)."""
    k, n = masks.shape
    device = torch.device(device)
    M = upload(masks, device, torch.float64)
    X = torch.cat([M, torch.ones((k, 1), dtype=torch.float64, device=device)], dim=1)
    sw = upload(weights, device, torch.float64).sqrt()[:, None]
    Y = upload(y, device, torch.float64)[:, None]
    ridge = torch.eye(n + 1, dtype=torch.float64, device=device) * (1e-6 ** 0.5)
    Xa = torch.cat([sw * X, ridge])
    Ya = torch.cat([sw * Y, torch.zeros((n + 1, 1), dtype=torch.float64, device=device)])
    Q, R = torch.linalg.qr(Xa)
    phi = torch.linalg.solve_triangular(R, Q.T @ Ya, upper=True)[:n, 0]
    return phi.cpu().numpy()


def permutation_reduce(preds: np.ndarray, n: int, reps: int, device) -> np.ndarray:
    """mean |base - perturbed| per feature of the top class of the base row
    (preds[0]), in float64 on `device`."""
    target = int(np.argmax(preds[0]))
    p = upload(np.ascontiguousarray(preds[:, target]), torch.device(device),
               torch.float64)
    return (p[0] - p[1:].reshape(n, reps)).abs().mean(dim=1).cpu().numpy()


class ExplainerModel(Model):
    """explain() perturbs each instance, makes ONE batched predictor call
    per instance, and reduces the attributions on the device."""

    def __init__(
        self,
        name: str,
        predictor_host: str,
        method: str = "permutation",
        n_samples: int = 64,
        seed: int = 0,
        device=None,
    ):
        super().__init__(
            name,
            predictor_config=PredictorConfig(predictor_host=predictor_host),
        )
        if method not in METHODS:
            raise ValueError(f"unknown explanation method {method!r}")
        self.method = method
        self.n_samples = n_samples
        self.seed = seed
        self.device = resolve_device(device)
        self.ready = True

    def load(self) -> bool:
        self.ready = True
        return True

    async def _predict_rows(self, rows: np.ndarray, headers) -> np.ndarray:
        """One batched predictor round trip for all the perturbed rows."""
        response = await self.predict({"instances": rows.tolist()}, headers)
        preds = response.get("predictions") if isinstance(response, dict) else response
        arr = np.asarray(preds, dtype=np.float64)
        if arr.ndim > 1:  # class scores: explain the top class of the base row
            arr = arr.reshape(arr.shape[0], -1)
        else:
            arr = arr[:, None]
        return arr

    async def explain(self, payload, headers: Optional[Dict[str, str]] = None):
        instances = payload.get("instances") if isinstance(payload, dict) else None
        if not instances:
            raise InvalidInput("explain expects {'instances': [row, ...]}")
        method = payload.get("method") or self.method
        if method not in METHODS:
            raise InvalidInput(f"unknown explanation method {method!r}")
        rng = np.random.RandomState(self.seed)
        x = np.asarray(instances, dtype=np.float64)
        if x.ndim == 1:
            x = x[None, :]
        n_features = x.shape[1]
        background = np.asarray(
            payload.get("background") or [np.zeros(n_features).tolist()],
            dtype=np.float64,
        )
        explanations = []
        for row in x:
            if method == "permutation":
                attributions = await self._permutation(row, background, rng, headers)
            else:
                attributions = await self._kernelshap(row, background, rng, headers)
            explanations.append(attributions.tolist())
        return {"explanations": explanations, "method": method}

    async def _permutation(self, row, background, rng, headers) -> np.ndarray:
        n = row.shape[0]
        reps = max(1, self.n_samples // n)
        rows: List[np.ndarray] = [row]
        for j in range(n):
            for _ in range(reps):
                perturbed = row.copy()
                bg = background[rng.randint(len(background))]
                perturbed[j] = bg[j]
                rows.append(perturbed)
        preds = await self._predict_rows(np.stack(rows), headers)
        return permutation_reduce(preds, n, reps, self.device)

    async def _kernelshap(self, row, background, rng, headers) -> np.ndarray:
        n = row.shape[0]
        k = max(self.n_samples, n + 2)
        masks = rng.randint(0, 2, size=(k, n)).astype(np.float64)
        masks[0, :] = 0.0
        masks[1, :] = 1.0
        bg = background.mean(axis=0)
        rows = masks * row[None, :] + (1.0 - masks) * bg[None, :]
        preds = await self._predict_rows(np.vstack([row[None, :], rows]), headers)
        target = int(np.argmax(preds[0]))
        weights = _shapley_kernel_weights(masks.sum(axis=1), n)
        return kernelshap_solve(masks, preds[1:, target], weights, self.device)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_name", default="model")
    parser.add_argument("--predictor_host", required=True)
    parser.add_argument("--method", default="permutation", choices=METHODS)
    parser.add_argument("--n_samples", default=64, type=int)
    parser.add_argument("--http_port", default=8080, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fall back to the CPU")
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    model = ExplainerModel(
        args.model_name, args.predictor_host,
        method=args.method, n_samples=args.n_samples, device=args.device,
    )
    logger.info("explainer %s -> predictor %s (%s) on %s", args.model_name,
                args.predictor_host, args.method, model.device)
    ModelServer(http_port=args.http_port).start([model])


if __name__ == "__main__":
    main()
