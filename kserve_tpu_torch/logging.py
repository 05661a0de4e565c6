"""Structured logging for the data plane (port of kserve_tpu/logging.py).

Every record handled by the port's handlers carries the request id and
the trace id of the request it was logged in (`rid=... tid=...`), so one
grep collects a request's story across the wire, the engine and a drain.
The request id is tracing.py's (`request_scope` binds it for every
request a server answers), and the trace id is the bound TraceContext's;
`bind_log_context` binds both for code outside a server's request (the
EPP's proxy hop, a test).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import logging.config
from typing import Iterator, Optional

from . import tracing

KSERVE_TPU_LOGGER_NAME = "kserve_tpu_torch"
KSERVE_TPU_TRACE_LOGGER_NAME = "kserve_tpu_torch.trace"
KSERVE_TPU_LOGGER_FORMAT = (
    "%(asctime)s.%(msecs)03d %(process)s %(name)s %(levelname)s "
    "rid=%(request_id)s tid=%(trace_id)s "
    "[%(funcName)s():%(lineno)s] %(message)s"
)
KSERVE_TPU_TRACE_LOGGER_FORMAT = (
    "%(asctime)s.%(msecs)03d %(name)s rid=%(request_id)s tid=%(trace_id)s "
    "%(message)s"
)
KSERVE_TPU_LOG_DATE_FORMAT = "%Y-%m-%d %H:%M:%S"

logger = logging.getLogger(KSERVE_TPU_LOGGER_NAME)
trace_logger = logging.getLogger(KSERVE_TPU_TRACE_LOGGER_NAME)

# a trace id bound without a whole TraceContext (bind_log_context)
_log_trace_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "kserve_tpu_torch_log_trace_id", default=None)


def current_request_id() -> str:
    return tracing.current_request_id() or "-"


def current_log_trace_id() -> str:
    bound = _log_trace_id.get()
    if bound:
        return bound
    ctx = tracing.current_trace_context()
    return ctx.trace_id if ctx is not None else "-"


@contextlib.contextmanager
def bind_log_context(request_id: str = "-", trace_id: str = "-") -> Iterator[None]:
    """Bind request_id / trace_id for every log record emitted inside."""
    t1 = tracing._current_request_id.set(request_id)
    t2 = _log_trace_id.set(trace_id)
    try:
        yield
    finally:
        _log_trace_id.reset(t2)
        tracing._current_request_id.reset(t1)


class RequestContextFilter(logging.Filter):
    """Stamps the bound request_id / trace_id onto every record (filters
    run for all records, unlike formatter defaults, so records of other
    libraries passing through these handlers format too)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = getattr(record, "request_id", None) or current_request_id()
        record.trace_id = getattr(record, "trace_id", None) or current_log_trace_id()
        return True


KSERVE_TPU_LOG_CONFIG = {
    "version": 1,
    "disable_existing_loggers": False,
    "formatters": {
        "kserve_tpu": {
            "()": "logging.Formatter",
            "fmt": KSERVE_TPU_LOGGER_FORMAT,
            "datefmt": KSERVE_TPU_LOG_DATE_FORMAT,
        },
        "kserve_tpu_trace": {
            "()": "logging.Formatter",
            "fmt": KSERVE_TPU_TRACE_LOGGER_FORMAT,
            "datefmt": KSERVE_TPU_LOG_DATE_FORMAT,
        },
    },
    "filters": {
        "request_context": {
            "()": "kserve_tpu_torch.logging.RequestContextFilter",
        },
    },
    "handlers": {
        "kserve_tpu": {
            "formatter": "kserve_tpu",
            "class": "logging.StreamHandler",
            "stream": "ext://sys.stderr",
            "filters": ["request_context"],
        },
        "kserve_tpu_trace": {
            "formatter": "kserve_tpu_trace",
            "class": "logging.StreamHandler",
            "stream": "ext://sys.stderr",
            "filters": ["request_context"],
        },
    },
    "loggers": {
        KSERVE_TPU_LOGGER_NAME: {
            "handlers": ["kserve_tpu"],
            "level": "INFO",
            "propagate": False,
        },
        KSERVE_TPU_TRACE_LOGGER_NAME: {
            "handlers": ["kserve_tpu_trace"],
            "level": "INFO",
            "propagate": False,
        },
    },
}


def configure_logging(log_config=None) -> None:
    """Apply the default (or a given) logging config: a dict, or a path to
    a JSON or an INI file (the JAX package also reads YAML, which needs a
    package the card machine lacks)."""
    if log_config is None:
        log_config = KSERVE_TPU_LOG_CONFIG
    if isinstance(log_config, dict):
        logging.config.dictConfig(log_config)
    elif isinstance(log_config, str):
        if log_config.endswith(".json"):
            import json

            with open(log_config) as f:
                logging.config.dictConfig(json.load(f))
        else:
            logging.config.fileConfig(log_config, disable_existing_loggers=False)
