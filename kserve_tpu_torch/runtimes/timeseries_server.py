"""Time-series forecasting runtime: a seasonal-naive-with-drift forecaster
serving the /v1/timeseries protocol (port of
kserve_tpu/runtimes/timeseries_server.py).

Method: classical seasonal-naive with drift.  For season length m (the
candidate period of best lag autocorrelation over the series, or 1 =
plain naive):
    forecast[t] = y[T - m + (t mod m)] + drift * (t // m + 1)
    drift = (y[T-1] - y[T-1-m]) / m  (0 when m >= T)
Quantiles come from the empirical residuals of the one-season-back
in-sample prediction, scaled by sqrt(step) (random-walk widening).

The mean and the residuals are one float32 torch function per series on
the model's device (cuda unless given "cpu"), over the series padded to a
power-of-two bucket with its valid length masking the padding, as the JAX
package's jitted program computes them; the season pick and the quantiles
stay on the host in float64.  A multivariate series is forecast column by
column.

Usage:
    python -m kserve_tpu_torch.runtimes.timeseries_server \\
        --model_name=forecaster --http_port=8080 [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device, upload
from ..model_server import ModelServer
from ..protocol.timeseries import (
    ForecastOutput,
    ForecastRequest,
    ForecastResponse,
    Status,
    TimeSeriesForecast,
    TimeSeriesModel,
    TimeSeriesType,
    advance_timestamp,
    make_forecast_response,
)

logger = logging.getLogger(__name__)

_SEASON_CANDIDATES = (1, 4, 7, 12, 24)


def _pick_season(y: np.ndarray) -> int:
    """Best candidate period by lag autocorrelation over the series."""
    T = len(y)
    best, best_r = 1, -np.inf
    yc = y - y.mean()
    denom = float(np.dot(yc, yc)) or 1.0
    for m in _SEASON_CANDIDATES:
        if m >= T:
            continue
        r = float(np.dot(yc[m:], yc[:-m])) / denom
        if r > best_r:
            best, best_r = m, r
    return best


def seasonal_naive(y: torch.Tensor, valid_len: int, m: int, horizon: int) -> torch.Tensor:
    """y: [T] float32, a series padded past `valid_len`; returns one [horizon
    + T] float32 tensor: the mean forecast, then the in-sample
    one-season-back residuals (0 outside [m, valid_len))."""
    T = y.shape[0]
    dev = y.device
    last = valid_len - 1
    season_ok = m < valid_len
    if season_ok:
        # divided by a tensor: on CUDA a division by a Python scalar is a
        # product with its reciprocal, which rounds otherwise
        drift = (y[last] - y[max(last - m, 0)]) / torch.full(
            (), float(m), dtype=y.dtype, device=dev)
    else:
        drift = torch.zeros((), dtype=y.dtype, device=dev)
    t = torch.arange(horizon, device=dev)
    src = valid_len - m + t % m if season_ok else torch.full_like(t, last)
    mean = y[src.clamp(0, T - 1)] + drift * (t // m + 1)
    idx = torch.arange(T, device=dev)
    pred = y[(idx - m).clamp(0, T - 1)]
    keep = (idx >= m) & (idx < valid_len)
    resid = torch.where(keep, y - pred, torch.zeros_like(y))
    return torch.cat([mean, resid])


class SeasonalNaiveForecaster(TimeSeriesModel):
    def __init__(self, name: str = "forecaster", device=None):
        super().__init__(name)
        self.device = resolve_device(device)

    def load(self) -> bool:
        self.ready = True
        return True

    @staticmethod
    def _bucket(n: int, lo: int = 8) -> int:
        b = lo
        while b < n:
            b *= 2
        return b

    def _one(self, values: np.ndarray, horizon: int,
             quantiles: Optional[List[float]]):
        m = _pick_season(values)
        T = len(values)
        # powers-of-two buckets, the padding masked by the valid length:
        # the JAX program's shapes, so that the outputs match it
        Tb = self._bucket(T)
        Hb = self._bucket(horizon)
        padded = np.zeros((Tb,), np.float32)
        padded[:T] = values
        out = seasonal_naive(upload(padded, self.device, torch.float32), T, m, Hb)
        out = out.cpu().numpy().astype(np.float64)  # one copy back per series
        mean = out[:horizon]
        qmap = None
        if quantiles:
            r = out[Hb:Hb + T]
            r = r[m:T] if T > m else np.zeros((1,))
            if r.size == 0:
                r = np.zeros((1,))
            steps = np.sqrt(np.arange(1, horizon + 1, dtype=np.float64))
            qmap = {
                str(q): (mean + np.quantile(r, q) * steps).tolist()
                for q in quantiles
            }
        return mean.tolist(), qmap

    async def create_forecast(self, request: ForecastRequest,
                              context=None) -> ForecastResponse:
        horizon = request.options.horizon
        quantiles = request.options.quantiles
        content = []
        for ts in request.inputs:
            series = np.asarray(ts.series, np.float64)
            if ts.type == TimeSeriesType.MULTIVARIATE:
                # each variable ([T, V] columns) on its own
                means = []
                qmaps: dict = {}
                for v in range(series.shape[1]):
                    mean_v, qmap_v = self._one(series[:, v], horizon, quantiles)
                    means.append(mean_v)
                    for q, vals in (qmap_v or {}).items():
                        qmaps.setdefault(q, []).append(vals)
                mean = np.asarray(means).T.tolist()  # [horizon, V]
                qmap = {
                    q: np.asarray(cols).T.tolist() for q, cols in qmaps.items()
                } or None
            else:
                mean, qmap = self._one(series, horizon, quantiles)
            start = ts.start_timestamp or "1970-01-01T00:00:00"
            content.append(TimeSeriesForecast(
                type=ts.type,
                name=ts.name,
                mean_forecast=mean,
                frequency=ts.frequency,
                start_timestamp=advance_timestamp(
                    start, ts.frequency, len(ts.series)),
                quantiles=qmap,
            ))
        output = ForecastOutput(status=Status.COMPLETED, content=content)
        return make_forecast_response(self.name, [output])


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_name", default="forecaster")
    parser.add_argument("--http_port", default=8080, type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; no fall back to the CPU")
    return parser


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_arg_parser().parse_args(argv)
    model = SeasonalNaiveForecaster(args.model_name, device=args.device)
    model.load()
    logger.info("timeseries forecaster %s ready on %s", args.model_name, model.device)
    ModelServer(http_port=args.http_port).start([model])


if __name__ == "__main__":
    main()
