"""Profile one V2 inference request of the port's predictive runtimes in
process on the card: kernel launches per request, device busy time and
the request's wall, at 1 and 1,024 rows.

    python3 scripts/torch_profile_predictive.py [--seed 0] [--iters 50]

The models are chip_smoke.py's predictive phase's, written from `--seed`:
the XGBoost binary:logistic dump (HIGGS's 28 features, 500 trees of depth
8), the LightGBM binary dump (500 trees of 255 leaves grown leaf-wise) and
the iris SVC stand-in (4 features, 3 classes, RBF, 45 support vectors).
Each request is a V2 InferRequest holding the rows as an FP32 binary
tensor, answered by `Model.__call__` (the input's decode, the predict with
its upload and its copy back, the response) without HTTP, so its wall
beside chip_smoke.py's served v2/infer p50 says what the HTTP stack and
the process boundary add.  The wall is the median of `--iters` warm
requests; then one request runs under torch.profiler, whose CUDA events
give the kernel launches and their device time, the copies, and the
device's idle share of that request's wall.  One JSON line per model and
batch on stdout, then one with the card's name and power limit as
nvidia-smi reports them.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCHES = (1, 1024)


def _write_models(np, tmp: str, seed: int) -> dict:
    """{name: (framework, model_dir, feature width)} of the smoke's models."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    xgb = cs.xgb_dump(rng, cs.PREDICTIVE_TREES, cs.XGB_DEPTH, cs.HIGGS_FEATURES)
    lgb = cs.lgb_dump(rng, cs.PREDICTIVE_TREES, cs.LGB_LEAVES, cs.HIGGS_FEATURES)
    models = {}
    for name, framework, fname, text in (
            ("xgb-higgs", "xgboost", "model.json", json.dumps(xgb)),
            ("lgb-higgs", "lightgbm", "model.txt", lgb)):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
        models[name] = (framework, d, cs.HIGGS_FEATURES)
    with open(os.path.join(tmp, cs.STANDINS_MODULE + ".py"), "w") as f:
        f.write(cs.STANDINS_SOURCE)
    sys.path.insert(0, tmp)
    S = importlib.import_module(cs.STANDINS_MODULE)
    svc = cs._standins(np, rng, S)["svc"][0]
    d = os.path.join(tmp, "iris-svc")
    os.makedirs(d)
    with open(os.path.join(d, "model.pkl"), "wb") as f:
        pickle.dump(svc, f)
    models["iris-svc"] = ("sklearn", d, 4)
    return models


async def _profile(torch, model, request, iters: int) -> dict:
    """The median wall of `iters` warm requests, then one request under
    torch.profiler."""
    async def call():
        t0 = time.perf_counter()
        await model(request)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(5):
        await call()
    walls = [await call() for _ in range(iters)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = await call()
    launches, busy, copies, copy_ms, by_name = 0, 0.0, 0, 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if ev.key.startswith(("Memcpy", "Memset")):
            copies += ev.count
            copy_ms += ms
            continue
        launches += ev.count
        busy += ms
        by_name[ev.key[:80]] = by_name.get(ev.key[:80], 0) + ev.count
    return {
        "wall_ms_p50": statistics.median(walls), "wall_ms_min": min(walls),
        "profiled_wall_ms": prof_wall, "kernel_launches": launches,
        "kernel_busy_ms": busy, "copies": copies, "copy_ms": copy_ms,
        "device_idle_share": max(0.0, 1 - (busy + copy_ms) / prof_wall),
        "launches_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }


async def _run(torch, np, models: dict, seed: int, iters: int, device) -> None:
    from kserve_tpu_torch.infer_type import InferInput, InferRequest
    from kserve_tpu_torch.runtimes.predictive_server import build_model

    rng = np.random.default_rng(seed + 1)
    for name, (framework, model_dir, width) in models.items():
        model = build_model(framework, name, model_dir, device=device)
        model.load()
        for b in BATCHES:
            X = rng.normal(size=(b, width)).astype(np.float32)
            inp = InferInput("input-0", [b, width], "FP32")
            inp.set_data_from_numpy(X, binary_data=True)
            request = InferRequest(model_name=name, infer_inputs=[inp],
                                   request_id="profile")
            row = await _profile(torch, model, request, iters)
            print(json.dumps({"model": name, "rows": b, **row}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    os.makedirs(REPO / "build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="profile_predictive_", dir=REPO / "build")
    try:
        models = _write_models(np, tmp, args.seed)
        asyncio.run(_run(torch, np, models, args.seed, args.iters, "cuda"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
