"""Errors the HTTP layer maps to status codes (port of the two of
kserve_tpu/errors.py this slice raises)."""


class InvalidInput(ValueError):
    """A malformed or unsupported request: HTTP 400."""


class ModelNotFound(Exception):
    """The request names no served model: HTTP 404."""
