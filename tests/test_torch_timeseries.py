"""The port's time-series protocol and seasonal-naive forecaster
(kserve_tpu_torch/protocol/timeseries.py, runtimes/timeseries_server.py)
against the JAX package's on the CPU: seeded series through both
forecasters (means and quantiles within 1e-6 relative: univariate,
multivariate, a series shorter than every season but 1, the T and H
bucket edges), `advance_timestamp`'s calendar cases against the JAX
function, the bad requests of tests/test_timeseries.py with the JAX
server's statuses and messages, and one request served end to end by the
port's REST server."""

import asyncio
import json

import numpy as np
import pytest
from aiohttp import ClientSession
from aiohttp.test_utils import TestClient, TestServer

from kserve_tpu import ModelRepository as JModelRepository
from kserve_tpu.protocol import timeseries as jts
from kserve_tpu.protocol.model_repository_extension import (
    ModelRepositoryExtension as JModelRepositoryExtension,
)
from kserve_tpu.protocol.openai.dataplane import OpenAIDataPlane
from kserve_tpu.protocol.rest.server import RESTServer as JRESTServer
from kserve_tpu.runtimes import timeseries_server as jserver
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.protocol import timeseries as tts
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.runtimes import timeseries_server as tserver
from test_timeseries import LastValueForecaster

REL = 1e-6


def _series(rng, T, period=24, trend=0.002, noise=0.3, level=10.0, weekly=0.5):
    """A daily season of amplitude 3, a weekly one, a trend and noise."""
    t = np.arange(T)
    return (level + trend * t + 3 * np.sin(2 * np.pi * t / period)
            + weekly * np.sin(2 * np.pi * t / (7 * period)) + noise * rng.normal(size=T))


def _request(model, inputs, horizon, quantiles=None):
    options = {"horizon": horizon}
    if quantiles is not None:
        options["quantiles"] = quantiles
    return {"model": model, "inputs": inputs, "options": options}


def _univariate(name, values, freq="H", start="2026-01-01T00:00:00"):
    return {"type": "univariate_time_series", "name": name,
            "series": [float(v) for v in values], "frequency": freq,
            "start_timestamp": start}


def _both(body):
    """The same body through the JAX forecaster and the port's (CPU)."""
    jm = jserver.SeasonalNaiveForecaster("fc")
    jm.load()
    tm = tserver.SeasonalNaiveForecaster("fc", device="cpu")
    tm.load()
    want = asyncio.run(jm.create_forecast(jts.ForecastRequest.model_validate(body)))
    got = asyncio.run(tm.create_forecast(tts.ForecastRequest.from_json(body)))
    return want.model_dump(exclude_none=True, mode="json"), got.to_dict()


def _close(a, b, path="$"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert abs(a - b) <= REL * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _same_forecast(want, got):
    for key in ("id", "created_at"):
        want.pop(key), got.pop(key)
    for o in want["outputs"] + got["outputs"]:
        o.pop("id")
    _close(want, got)


@pytest.mark.parametrize("T,horizon", [(200, 48), (8, 8), (9, 9), (16, 17), (17, 16),
                                       (3, 5), (1, 2), (10, 30), (1000, 100)])
def test_univariate_matches_jax(T, horizon):
    """Seeded series at the bucket edges (8 -> 8, 9 -> 16, 16 / 17), a
    series shorter than every season but 1 (T = 3, and T = 1) and one of
    10 points (seasons 1, 4 and 7 only)."""
    rng = np.random.default_rng(T * 100 + horizon)
    body = _request("fc", [_univariate("s", _series(rng, T))], horizon, [0.1, 0.5, 0.9])
    want, got = _both(body)
    assert got["status"] == "completed" and got["model"] == "fc"
    _same_forecast(want, got)


def test_season_pick_and_drift_match_jax():
    rng = np.random.default_rng(3)
    for period, m in ((24, 24), (12, 12), (7, 7)):
        # 12 weeks: over shorter series lag 1 beats lag 24 (the lag-24 sum
        # has 23 terms fewer)
        y = _series(rng, 2016, period=period, noise=0.05)
        assert tserver._pick_season(y) == jserver._pick_season(y) == m
    # a pure period-4 signal forecasts its next period exactly
    body = _request("fc", [_univariate("p", [1.0, 5.0, 2.0, 8.0] * 4)], 4)
    want, got = _both(body)
    _same_forecast(want, got)
    fc = got["outputs"][0]["content"][0]
    assert fc["mean_forecast"] == [1.0, 5.0, 2.0, 8.0]
    assert fc["start_timestamp"] == "2026-01-01T16:00:00"


def test_multivariate_and_several_inputs_match_jax():
    rng = np.random.default_rng(7)
    cols = np.stack([_series(rng, 96, level=10.0 * (v + 1)) for v in range(3)], axis=1)
    inputs = [
        {"type": "multivariate_time_series", "name": "mv", "series": cols.tolist(),
         "frequency": "H", "start_timestamp": "2026-03-01T00:00:00"},
        _univariate("u", _series(rng, 50), freq="D"),
    ]
    want, got = _both(_request("fc", inputs, 20, [0.25, 0.75]))
    _same_forecast(want, got)
    fc = got["outputs"][0]["content"][0]
    assert np.asarray(fc["mean_forecast"]).shape == (20, 3)
    assert np.asarray(fc["quantiles"]["0.25"]).shape == (20, 3)
    assert fc["start_timestamp"] == "2026-03-05T00:00:00"


def test_forecast_function_is_float32_on_the_padded_bucket():
    """The port's device function alone against the JAX jitted program on
    the same padded bucket: means and residuals bit for bit or within
    float32 rounding."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(11)
    fn = jserver._jit_forecast()
    for T, m, H in ((100, 24, 64), (30, 7, 8), (5, 24, 16), (64, 1, 16)):
        padded = np.zeros(tserver.SeasonalNaiveForecaster._bucket(T), np.float32)
        padded[:T] = _series(rng, T)
        jmean, jresid = fn(jnp.asarray(padded), jnp.asarray(T, jnp.int32), m, H)
        out = tserver.seasonal_naive(torch.from_numpy(padded), T, m, H)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out[:H].numpy(), np.asarray(jmean), rtol=REL, atol=0)
        np.testing.assert_allclose(out[H:].numpy(), np.asarray(jresid), rtol=REL, atol=1e-7)


@pytest.mark.parametrize("start,freq,steps", [
    ("2026-01-31T00:00:00", "M", 1), ("2026-01-01T00:00:00", "quarter", 2),
    ("2026-03-01T10:00:00", "H", 5), ("2024-02-29T00:00:00", "year", 1),
    ("2024-02-29T00:00:00", "Y", 4), ("2026-12-31T23:59:59", "S", 1),
    ("2026-12-31T23:00:00Z", "T", 90), ("2026-01-01T00:00:00+02:00", "W", 3),
    ("2026-10-31T00:00:00", "month", 4), ("2026-01-01", "D", 2016),
])
def test_advance_timestamp_matches_jax(start, freq, steps):
    assert tts.advance_timestamp(start, tts.Frequency(freq), steps) == \
        jts.advance_timestamp(start, jts.Frequency(freq), steps)


def _bad_requests():
    ragged = _request("naive", [{"type": "multivariate_time_series", "name": "s1",
                                 "series": [[1.0, 2.0], [3.0]], "frequency": "D"}], 3)
    rows_as_uni = _request("naive", [_univariate("s1", [1.0])], 3)
    rows_as_uni["inputs"][0]["series"] = [[1.0, 2.0]]
    scalars_as_multi = _request("naive", [_univariate("s1", [1.0, 2.0])], 3)
    scalars_as_multi["inputs"][0]["type"] = "multivariate_time_series"
    base = _request("naive", [_univariate("s1", [1.0, 2.0, 3.0], freq="D")], 3)
    return {
        "ghost": dict(base, model="ghost"),
        "horizon_0": dict(base, options={"horizon": 0}),
        "quantile_1.5": dict(base, options={"horizon": 2, "quantiles": [1.5]}),
        "huge_horizon": dict(base, options={"horizon": 10_000_000}),
        "ragged": ragged, "rows_as_univariate": rows_as_uni,
        "scalars_as_multivariate": scalars_as_multi,
        "empty": dict(base, inputs=[_univariate("s1", [])]),
        "bad_timestamp": dict(base, inputs=[_univariate("s1", [1.0], start="noon")]),
        "not_a_forecaster": dict(base, model="plain"),
        "not_ready": dict(base, model="cold"),
    }


def _serve_both(bodies, jmodels, tmodels):
    """Each (method, path, body) through the JAX server and the port's:
    [(status, json) of JAX, (status, json) of the port]."""

    async def main():
        jrepo = JModelRepository()
        for m in jmodels:
            jrepo.update(m)
        jserver_ = JRESTServer(OpenAIDataPlane(jrepo), JModelRepositoryExtension(jrepo))
        server = RESTServer(ModelRepository({m.name: m for m in tmodels}), "127.0.0.1", 0)
        port = await server.start()
        out = []
        try:
            async with TestClient(TestServer(jserver_.create_application())) as jc, \
                    ClientSession(f"http://127.0.0.1:{port}") as tc:
                for method, path, body in bodies:
                    pair = []
                    for client in (jc, tc):
                        kw = {} if body is None else (
                            {"data": body} if isinstance(body, str) else {"json": body})
                        async with client.request(method, path, **kw) as r:
                            pair.append((r.status, json.loads(await r.text())))
                    out.append(pair)
        finally:
            await server.stop()
        return out

    return asyncio.run(main())


def _model_sets():
    from kserve_tpu.model import BaseModel as JBase
    from kserve_tpu_torch.model import BaseModel as TBase

    class TLastValue(tts.TimeSeriesModel):
        def __init__(self):
            super().__init__("naive")
            self.ready = True

    jplain, tplain = JBase("plain"), TBase("plain")
    jplain.ready = tplain.ready = True
    jcold = jserver.SeasonalNaiveForecaster("cold")
    tcold = tserver.SeasonalNaiveForecaster("cold", device="cpu")
    return [LastValueForecaster(), jplain, jcold], [TLastValue(), tplain, tcold]


def test_bad_requests_answer_as_the_jax_server():
    bad = _bad_requests()
    bodies = [("POST", "/v1/timeseries/forecast", b) for b in bad.values()]
    # a body pydantic refuses, and one that is not JSON: 400 on both
    bodies += [("POST", "/v1/timeseries/forecast", {"x": 1}),
               ("POST", "/v1/timeseries/forecast", "{not json")]
    jmodels, tmodels = _model_sets()
    results = _serve_both(bodies, jmodels, tmodels)
    for name, ((ws, wb), (gs, gb)) in zip(list(bad) + ["pydantic", "json"], results):
        assert gs == ws and gs in (400, 404, 503), (name, ws, wb, gs, gb)
        if name == "pydantic":
            # pydantic's own wording is not reproduced; the field is named
            assert "model" in gb["error"] and "Field required" in gb["error"]
        elif name == "json":
            assert gb["error"].startswith("invalid JSON body") and \
                wb["error"].startswith("invalid JSON body")
        else:
            assert gb == wb, (name, wb, gb)


def test_models_route_and_served_forecast():
    """GET /v1/timeseries/models lists only forecasters; the port's
    forecaster served end to end equals the JAX one served."""
    jmodels, tmodels = _model_sets()
    jfc = jserver.SeasonalNaiveForecaster("fc")
    jfc.load()
    tfc = tserver.SeasonalNaiveForecaster("fc", device="cpu")
    tfc.load()
    rng = np.random.default_rng(5)
    body = _request("fc", [_univariate("s", _series(rng, 72))], 24, [0.1, 0.5, 0.9])
    results = _serve_both([("GET", "/v1/timeseries/models", None),
                           ("POST", "/v1/timeseries/forecast", body)],
                          jmodels[:2] + [jfc], tmodels[:2] + [tfc])
    (wm, gm), (wf, gf) = results
    assert gm == wm and sorted(gm[1]) == ["fc", "naive"]
    assert gf[0] == wf[0] == 200
    _same_forecast(wf[1], gf[1])
    q = gf[1]["outputs"][0]["content"][0]["quantiles"]
    assert all(a <= b <= c for a, b, c in zip(q["0.1"], q["0.5"], q["0.9"]))


def test_forecaster_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tserver.build_arg_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.SeasonalNaiveForecaster("fc")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.main(["--http_port", "0"])
    assert tserver.SeasonalNaiveForecaster("fc", device="cpu").device.type == "cpu"
