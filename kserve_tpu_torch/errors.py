"""Typed exceptions of the data plane and the protocol layers, and the HTTP
status each maps to (port of kserve_tpu/errors.py)."""

from __future__ import annotations


class InferenceError(RuntimeError):
    """Raised by a model when inference itself fails: HTTP 500."""

    def __init__(self, reason: str, status: str | None = None, debug_info: str | None = None):
        self.reason = reason
        self.status = status
        self.debug_info = debug_info
        super().__init__(reason)

    def __str__(self) -> str:
        msg = self.reason
        if self.status:
            msg = f"{msg}, status: {self.status}"
        if self.debug_info:
            msg = f"{msg}, debug: {self.debug_info}"
        return msg


class InvalidInput(ValueError):
    """A malformed or unsupported request: HTTP 400."""

    def __init__(self, reason: str):
        self.reason = reason
        super().__init__(reason)


class ModelNotFound(Exception):
    """The request names no served model: HTTP 404."""

    def __init__(self, model_name: str | None = None):
        self.model_name = model_name
        self.reason = f"Model with name {model_name} does not exist."
        super().__init__(self.reason)


class ModelNotReady(RuntimeError):
    """The model exists but has not finished loading: HTTP 503."""

    def __init__(self, model_name: str, detail: str | None = None):
        self.model_name = model_name
        self.error_msg = f"Model with name {model_name} is not ready."
        if detail:
            self.error_msg = self.error_msg + " " + detail
        super().__init__(self.error_msg)


class ServerNotReady(RuntimeError):
    """The server as a whole is not ready: HTTP 503."""

    def __init__(self, detail: str | None = None):
        self.error_msg = detail or "Server is not ready."
        super().__init__(self.error_msg)


class ServerNotLive(RuntimeError):
    """HTTP 503."""

    def __init__(self, detail: str | None = None):
        self.error_msg = detail or "Server is not live."
        super().__init__(self.error_msg)


class UnsupportedProtocol(Exception):
    """HTTP 400."""

    def __init__(self, protocol_version: str):
        self.reason = f"Unsupported protocol {protocol_version}."
        super().__init__(self.reason)


class NoModelReady(RuntimeError):
    """A server started with models of which none is ready and none starts
    an engine."""

    def __init__(self, models: list):
        self.models = models
        super().__init__()

    def __str__(self) -> str:
        names = [getattr(m, "name", str(m)) for m in self.models]
        return f"Models with name {','.join(names)} are not ready."
