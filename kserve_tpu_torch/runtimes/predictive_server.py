"""One predictive runtime for three frameworks: --framework {sklearn,
xgboost,lightgbm} (port of kserve_tpu/runtimes/predictive_server.py).

Usage:
    python -m kserve_tpu_torch.runtimes.predictive_server \\
        --model_name=iris --model_dir=/mnt/models --framework=sklearn

The model runs on cuda unless --device cpu is given; without CUDA and
without --device cpu it raises.  Served over the V1 and V2 REST routes
(no gRPC server).
"""

from __future__ import annotations

import argparse
import logging

from ..model_server import ModelServer
from .gbdt_server import LightGBMModel, XGBoostModel
from .sklearn_server import SKLearnModel

FRAMEWORKS = {
    "sklearn": SKLearnModel,
    "xgboost": XGBoostModel,
    "lightgbm": LightGBMModel,
}


def build_model(framework: str, name: str, model_dir: str, predict_proba: bool = False,
                device=None):
    try:
        cls = FRAMEWORKS[framework]
    except KeyError:
        raise ValueError(
            f"unknown framework {framework!r}; expected one of {sorted(FRAMEWORKS)}"
        )
    return cls(name, model_dir, predict_proba=predict_proba, device=device)


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--framework", required=True, choices=sorted(FRAMEWORKS))
    parser.add_argument("--model_name", default="model")
    parser.add_argument("--model_dir", default="/mnt/models")
    parser.add_argument("--http_port", default=8080, type=int)
    parser.add_argument(
        "--predict_proba", default=False, type=lambda x: str(x).lower() == "true"
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fall back to the CPU")
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    model = build_model(args.framework, args.model_name, args.model_dir,
                        args.predict_proba, device=args.device)
    model.load()
    ModelServer(http_port=args.http_port).start([model])


if __name__ == "__main__":
    main()
