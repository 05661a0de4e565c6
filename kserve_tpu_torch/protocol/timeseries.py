"""Time-series forecasting protocol: request and response types, the
frequency step math and the data plane (port of
kserve_tpu/protocol/timeseries.py).

Reference: python/kserve/kserve/protocol/rest/timeseries/ (univariate and
multivariate series, the Frequency enum and its step math, quantile
forecasts, per-output status; POST /v1/timeseries/forecast and GET
/v1/timeseries/models, served by protocol/rest/server.py).  The types are
standard-library dataclasses with hand validation in place of pydantic,
which the card machine does not have: `ForecastRequest.from_json` raises
InvalidInput (HTTP 400) where the pydantic model fails validation, and
responses serialize with `to_dict()`, dropping None fields as
`model_dump(exclude_none=True)` does.  Unknown fields are accepted and
ignored (the JAX models allow extras).
"""

from __future__ import annotations

import calendar
import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from enum import Enum
from typing import Any, Dict, List, Optional, Union

from ..errors import InvalidInput, ModelNotFound, ModelNotReady
from ..model import BaseModel as ServableModel

# List[float] (univariate) or List[List[float]] (multivariate, one inner
# list per timestep)
TimeSeries = Union[List[float], List[List[float]]]


class Frequency(str, Enum):
    SECOND = "second"
    SECOND_SHORT = "S"
    MINUTE = "minute"
    MINUTE_SHORT = "T"
    HOUR = "hour"
    HOUR_SHORT = "H"
    DAY = "day"
    DAY_SHORT = "D"
    WEEK = "week"
    WEEK_SHORT = "W"
    MONTH = "month"
    MONTH_SHORT = "M"
    QUARTER = "quarter"
    QUARTER_SHORT = "Q"
    YEAR = "year"
    YEAR_SHORT = "Y"


def _month_add(dt: datetime, months: int) -> datetime:
    month = dt.month - 1 + months
    year = dt.year + month // 12
    month = month % 12 + 1
    # clamp the day (Jan 31 + 1 month -> Feb 28/29)
    return dt.replace(
        year=year, month=month,
        day=min(dt.day, calendar.monthrange(year, month)[1]))


FREQUENCY_MAP = {
    "S": lambda steps: timedelta(seconds=steps),
    "second": lambda steps: timedelta(seconds=steps),
    "T": lambda steps: timedelta(minutes=steps),
    "minute": lambda steps: timedelta(minutes=steps),
    "H": lambda steps: timedelta(hours=steps),
    "hour": lambda steps: timedelta(hours=steps),
    "D": lambda steps: timedelta(days=steps),
    "day": lambda steps: timedelta(days=steps),
    "W": lambda steps: timedelta(weeks=steps),
    "week": lambda steps: timedelta(weeks=steps),
}
_MONTHLY = {"M": 1, "month": 1, "Q": 3, "quarter": 3, "Y": 12, "year": 12}


def _parse_iso(ts: str) -> datetime:
    # older fromisoformat rejects the common 'Z' UTC suffix
    return datetime.fromisoformat(ts.replace("Z", "+00:00"))


def advance_timestamp(start: str, frequency: Frequency, steps: int) -> str:
    """ISO8601 start + N frequency steps (a forecast starts one step after
    the observation window's end)."""
    dt = _parse_iso(start)
    freq = frequency.value
    if freq in _MONTHLY:
        return _month_add(dt, _MONTHLY[freq] * steps).isoformat()
    return (dt + FREQUENCY_MAP[freq](steps)).isoformat()


# one request may not demand more than this many forecast steps (a cap on
# the allocation a single unauthenticated call can cause)
MAX_HORIZON = 10_000


class Status(str, Enum):
    COMPLETED = "completed"
    ERROR = "error"
    PENDING = "pending"
    PARTIAL = "partial"


class TimeSeriesType(str, Enum):
    UNIVARIATE = "univariate_time_series"
    MULTIVARIATE = "multivariate_time_series"


def _plain(value):
    """A dataclass dump with enums as their values and None fields dropped."""
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items() if v is not None}
    if isinstance(value, list):
        return [_plain(v) for v in value]
    return value


class _Serializable:
    def to_dict(self) -> dict:
        return _plain(dataclasses.asdict(self))


# ---------------------------------------------------------------- validation


def _fail(loc: str, msg: str):
    raise InvalidInput(f"validation error for ForecastRequest: {loc}: {msg}")


def _field(body: dict, name: str, loc: str, required: bool = True):
    if name not in body:
        if required:
            _fail(f"{loc}{name}", "Field required")
        return None
    return body[name]


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _as_int(v, loc: str) -> int:
    if isinstance(v, bool) or not isinstance(v, (int, float)) or (
            isinstance(v, float) and not v.is_integer()):
        _fail(loc, "Input should be a valid integer")
    return int(v)


def _as_str(v, loc: str) -> str:
    if not isinstance(v, str):
        _fail(loc, "Input should be a valid string")
    return v


def _as_enum(cls, v, loc: str):
    try:
        return cls(v)
    except ValueError:
        allowed = ", ".join(repr(m.value) for m in cls)
        _fail(loc, f"Input should be {allowed}")


def _as_series(v, loc: str) -> TimeSeries:
    """A list of numbers, or a list of lists of numbers (as floats)."""
    if not isinstance(v, list):
        _fail(loc, "Input should be a valid list")
    if all(_is_number(x) for x in v):
        return [float(x) for x in v]
    if all(isinstance(row, list) and all(_is_number(x) for x in row) for row in v):
        return [[float(x) for x in row] for row in v]
    _fail(loc, "Input should be a list of numbers or a list of lists of numbers")


@dataclass
class TimeSeriesInput:
    type: TimeSeriesType
    name: str
    series: TimeSeries
    frequency: Frequency
    start_timestamp: Optional[str] = None

    @staticmethod
    def from_json(body: Any, loc: str) -> "TimeSeriesInput":
        if not isinstance(body, dict):
            _fail(loc.rstrip("."), "Input should be a valid dictionary")
        start = _field(body, "start_timestamp", loc, required=False)
        return TimeSeriesInput(
            type=_as_enum(TimeSeriesType, _field(body, "type", loc), loc + "type"),
            name=_as_str(_field(body, "name", loc), loc + "name"),
            series=_as_series(_field(body, "series", loc), loc + "series"),
            frequency=_as_enum(Frequency, _field(body, "frequency", loc),
                               loc + "frequency"),
            start_timestamp=(None if start is None
                             else _as_str(start, loc + "start_timestamp")))


@dataclass
class ForecastOptions:
    horizon: int
    quantiles: Optional[List[float]] = None

    @staticmethod
    def from_json(body: Any) -> "ForecastOptions":
        if not isinstance(body, dict):
            _fail("options", "Input should be a valid dictionary")
        quantiles = _field(body, "quantiles", "options.", required=False)
        if quantiles is not None:
            if not isinstance(quantiles, list) or not all(_is_number(q) for q in quantiles):
                _fail("options.quantiles", "Input should be a list of numbers")
            quantiles = [float(q) for q in quantiles]
        return ForecastOptions(
            horizon=_as_int(_field(body, "horizon", "options."), "options.horizon"),
            quantiles=quantiles)


@dataclass
class ForecastRequest:
    model: str
    inputs: List[TimeSeriesInput]
    options: ForecastOptions
    metadata: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_json(body: Any) -> "ForecastRequest":
        if not isinstance(body, dict):
            _fail("body", "Input should be a valid dictionary")
        missing = [k for k in ("model", "inputs", "options") if k not in body]
        if missing:
            _fail(", ".join(missing), "Field required")
        inputs = body["inputs"]
        if not isinstance(inputs, list):
            _fail("inputs", "Input should be a valid list")
        metadata = body.get("metadata")
        if metadata is not None and not isinstance(metadata, dict):
            _fail("metadata", "Input should be a valid dictionary")
        return ForecastRequest(
            model=_as_str(body["model"], "model"),
            inputs=[TimeSeriesInput.from_json(ts, f"inputs.{i}.")
                    for i, ts in enumerate(inputs)],
            options=ForecastOptions.from_json(body["options"]),
            metadata=metadata)


# ---------------------------------------------------------------- responses


@dataclass
class Error(_Serializable):
    message: str
    type: str
    code: Optional[str] = None
    param: Optional[str] = None


@dataclass
class TimeSeriesForecast(_Serializable):
    type: TimeSeriesType
    name: str
    mean_forecast: TimeSeries
    frequency: Frequency
    start_timestamp: str
    quantiles: Optional[Dict[str, TimeSeries]] = None


@dataclass
class ForecastOutput(_Serializable):
    status: Status
    content: List[TimeSeriesForecast]
    type: str = "forecast"
    id: str = field(default_factory=lambda: f"fo-{uuid.uuid4().hex}")
    error: Optional[Error] = None


@dataclass
class Usage(_Serializable):
    prompt_tokens: int
    completion_tokens: int
    total_tokens: int


@dataclass
class ForecastResponse(_Serializable):
    id: str
    created_at: int
    status: Status
    model: str
    outputs: List[ForecastOutput]
    error: Optional[Error] = None
    usage: Optional[Usage] = None


def make_forecast_response(model: str, outputs: List[ForecastOutput],
                           usage: Optional[Usage] = None) -> ForecastResponse:
    """The response envelope with its id, timestamp and aggregate status."""
    if outputs and all(o.status == Status.COMPLETED for o in outputs):
        status = Status.COMPLETED
    elif any(o.status == Status.COMPLETED for o in outputs):
        status = Status.PARTIAL
    else:
        status = Status.ERROR
    return ForecastResponse(
        id=f"forecast-{uuid.uuid4().hex}",
        created_at=int(time.time()),
        status=status,
        model=model,
        outputs=outputs,
        usage=usage,
    )


class TimeSeriesModel(ServableModel):
    """Forecasting runtimes implement create_forecast."""

    async def create_forecast(self, request: ForecastRequest,
                              context=None) -> ForecastResponse:
        raise NotImplementedError()


def _validate_series(inputs: List[TimeSeriesInput]) -> None:
    for ts in inputs:
        if not ts.series:
            raise InvalidInput(f"series {ts.name!r} is empty")
        first = ts.series[0]
        if ts.type == TimeSeriesType.MULTIVARIATE:
            if not isinstance(first, list):
                raise InvalidInput(
                    f"series {ts.name!r} is multivariate but rows are scalars")
            width = len(first)
            if width == 0:
                raise InvalidInput(
                    f"series {ts.name!r} rows are empty (0 variables)")
            if any(not isinstance(row, list) or len(row) != width
                   for row in ts.series):
                raise InvalidInput(
                    f"series {ts.name!r} rows must all have {width} variables")
        elif isinstance(first, list):
            raise InvalidInput(
                f"series {ts.name!r} is univariate but rows are lists")
        if ts.start_timestamp is not None:
            try:
                _parse_iso(ts.start_timestamp)
            except ValueError:
                raise InvalidInput(
                    f"series {ts.name!r} start_timestamp is not ISO8601")


class TimeSeriesDataPlane:
    """Validation and model dispatch (the reference's dataplane.py)."""

    def __init__(self, model_registry):
        self._registry = model_registry

    async def forecast(self, request: ForecastRequest) -> ForecastResponse:
        model = self._registry.get_model(request.model)
        if model is None:
            raise ModelNotFound(request.model)
        if not await self._registry.is_model_ready(request.model):
            raise ModelNotReady(request.model)
        if not isinstance(model, TimeSeriesModel):
            raise InvalidInput(
                f"model {request.model} does not support forecasting")
        if request.options.horizon < 1:
            raise InvalidInput("options.horizon must be >= 1")
        if request.options.horizon > MAX_HORIZON:
            raise InvalidInput(
                f"options.horizon must be <= {MAX_HORIZON}")
        for q in request.options.quantiles or []:
            if not 0.0 < q < 1.0:
                raise InvalidInput(f"quantile {q} outside (0, 1)")
        _validate_series(request.inputs)
        return await model.create_forecast(request)

    async def models(self) -> List[str]:
        return [
            name for name in self._registry.get_models()
            if isinstance(self._registry.get_model(name), TimeSeriesModel)
        ]
