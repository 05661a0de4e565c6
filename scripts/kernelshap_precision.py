"""How far Kernel SHAP's weighted least squares strays from its exact
answer when solved through the normal equations and when solved by QR,
on the CPU.

    python3 scripts/kernelshap_precision.py [--features 28] [--samples 2104] [--seeds 3]

Each case draws a logistic model of `--features` inputs, an explained row
and 100 background rows from a seed, and the coalitions as the explainer
runtime draws them (`np.random.RandomState(0)`, the empty and full
coalitions first).  The reference's problem is y ~ masks @ phi + phi0 with
the Shapley kernel weights (1e6 for the empty and full coalitions) and a
ridge of 1e-6 on every coefficient.  It is solved four ways: the normal
equations X^T W X + 1e-6 I in float64 numpy and in float64 torch, and
Householder QR of the square-root-weighted system in numpy and through
the port's `kernelshap_solve` (torch, CPU); each against the same normal
equations solved with mpmath at 40 digits.  Prints one JSON line per
case: each solve's max |error| / max |phi|, the condition number of the
normal equations, and the efficiency gap sum(phi) - (f(x) - f(mean
background)) of the exact answer and of the port's.  Needs mpmath.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kserve_tpu_torch.runtimes.explainer_server import (  # noqa: E402
    _shapley_kernel_weights,
    kernelshap_solve,
)


def _exact(masks: np.ndarray, w: np.ndarray, y: np.ndarray, digits: int = 40) -> np.ndarray:
    """The normal equations built and solved with mpmath (masks are 0/1,
    so each entry is a sum of weights)."""
    import mpmath

    mpmath.mp.dps = digits
    k, n = masks.shape
    X = np.concatenate([masks, np.ones((k, 1))], axis=1).astype(bool)
    wm = [mpmath.mpf(float(v)) for v in w]
    ym = [mpmath.mpf(float(v)) for v in y]
    A = mpmath.matrix(n + 1, n + 1)
    b = mpmath.matrix(n + 1, 1)
    for i in range(n + 1):
        for j in range(i, n + 1):
            A[i, j] = A[j, i] = mpmath.fsum(wm[r] for r in range(k) if X[r, i] and X[r, j])
        A[i, i] += mpmath.mpf(1) / 10 ** 6
        b[i] = mpmath.fsum(wm[r] * ym[r] for r in range(k) if X[r, i])
    return np.array([float(v) for v in mpmath.lu_solve(A, b)])[:n]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--samples", type=int, default=2104)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args(argv)
    n = args.features
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        W, bias = rng.normal(size=n), 0.1
        x, bg = rng.normal(size=n), rng.normal(size=(100, n))

        def f(rows):
            return 1.0 / (1.0 + np.exp(-(np.asarray(rows) @ W + bias)))

        masks = np.random.RandomState(0).randint(
            0, 2, size=(max(args.samples, n + 2), n)).astype(np.float64)
        masks[0, :], masks[1, :] = 0.0, 1.0
        y = f(masks * x + (1.0 - masks) * bg.mean(axis=0))
        w = _shapley_kernel_weights(masks.sum(axis=1), n)
        X = np.concatenate([masks, np.ones((len(masks), 1))], axis=1)
        A = X.T @ (w[:, None] * X) + 1e-6 * np.eye(n + 1)
        normal_np = np.linalg.solve(A, X.T @ (w * y))[:n]
        Xt, wt, yt = (torch.from_numpy(v) for v in (X, w, y))
        At = Xt.T @ (wt[:, None] * Xt) + 1e-6 * torch.eye(n + 1, dtype=torch.float64)
        normal_torch = torch.linalg.solve(At, Xt.T @ (wt * yt)).numpy()[:n]
        sw = np.sqrt(w)
        Xa = np.concatenate([sw[:, None] * X, np.sqrt(1e-6) * np.eye(n + 1)])
        q, r = np.linalg.qr(Xa)
        qr_np = np.linalg.solve(r, q.T @ np.concatenate([sw * y, np.zeros(n + 1)]))[:n]
        port = kernelshap_solve(masks, y, w, "cpu")
        exact = _exact(masks, w, y)
        scale = np.abs(exact).max()
        target = f(x[None])[0] - f(bg.mean(axis=0)[None])[0]
        print(json.dumps({
            "seed": seed, "features": n, "coalitions": len(masks),
            "normal_equations_cond": float(np.linalg.cond(A)),
            "err_of_max_phi": {
                name: float(np.abs(v - exact).max() / scale)
                for name, v in (("normal_numpy", normal_np), ("normal_torch", normal_torch),
                                ("qr_numpy", qr_np), ("port_qr_torch", port))},
            "efficiency_gap": {"exact": float(exact.sum() - target),
                               "port": float(port.sum() - target)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
