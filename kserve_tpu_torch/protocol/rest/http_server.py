"""The HTTP/1.1 wire of the port's servers on `asyncio.start_server`
(standard library only): connections kept alive, request heads and
bodies read, answers written whole or as chunked server-sent events.

`HTTPServer` serves one connection's requests in turn and hands each to
`_respond(method, path, query, headers, body, writer, keep_alive)`, which
a server subclasses: the model server (server.py), the graph router
(graph/router.py), the EPP (scheduler/epp.py) and the activator
(activator.py) share this wire; the last two relay a streamed upstream
answer through `_relay`.  Every
request runs bound to its trace context and request id
(tracing.request_scope: a child of the caller's `traceparent` or a new
root; its `x-request-id` or a new one), and every answer echoes
`x-request-id` (kserve_tpu/tracing.py:223-238).

With a tracer (tracing.get_tracer() is not None, i.e.
$OTEL_EXPORTER_OTLP_ENDPOINT set) each request is one span, the
counterpart of kserve_tpu/tracing.py:241-287: its ids are the bound
context's (its parent is the caller's span), its name is "{method}
{route template}" (`_route_template`; never the raw path, so N models are
not N span names), with the attributes http.method, http.target,
http.status_code (the answer's, from its head), kserve.model, trace_id and
span_id.  An exception that escapes `_respond` marks it as an error; a
mapped status (an HTTPError, a 4xx) leaves it clean.

Connections are kept alive (HTTP/1.1; HTTP/1.0 with `Connection:
keep-alive`) until the client sends `Connection: close`, a request
cannot be read to its end, or the connection idles `idle_timeout`
seconds.  A request body comes with a Content-Length or
`Transfer-Encoding: chunked`; a streamed answer is sent chunked.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import time
from typing import Dict, Optional, Tuple

from ..limits import CHECKPOINT_FIELD_SIZE_LIMIT, MAX_HEAD_BYTES
from ...tracing import (
    REQUEST_ID_HEADER,
    SPAN_KIND_SERVER,
    TraceContext,
    current_request_id,
    get_tracer,
    mark_span_error,
    request_scope,
)
from ..openai.types import error_body

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 16 << 20
# hop-by-hop headers a proxy drops in both directions, and the framing
# headers it writes anew
HOP_HEADERS = frozenset({
    "connection", "keep-alive", "proxy-authenticate", "proxy-authorization",
    "te", "trailers", "transfer-encoding", "upgrade", "host",
    "content-length",
})
# seconds an idle kept-alive connection waits for its next request
# (aiohttp's keepalive_timeout, the JAX server's)
IDLE_TIMEOUT_S = 75.0
_REASONS = {200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
            400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            411: "Length Required",
            413: "Payload Too Large", 422: "Unprocessable Entity",
            429: "Too Many Requests", 500: "Internal Server Error",
            501: "Not Implemented", 502: "Bad Gateway",
            503: "Service Unavailable", 504: "Gateway Timeout"}


# the span of the request being answered, when a tracer is configured
_request_span: contextvars.ContextVar = contextvars.ContextVar(
    "kserve_tpu_torch_request_span", default=None)


def request_span():
    """The span of the request being answered, or None."""
    return _request_span.get()


class HTTPError(Exception):
    """An answer of `status` with the message in an OpenAI error body."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class BadRequest(HTTPError):
    """A request that could not be read to its end: after the answer the
    connection closes, since the next request's start is unknown."""


class HTTPServer:
    """Listens on `host:port` (port 0 picks a free one) and answers each
    request through `_respond`.  An HTTPError raised there answers its
    status; another exception answers 500 through `_on_error`."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 idle_timeout: float = IDLE_TIMEOUT_S):
        self.host = host
        self.port = port
        self.idle_timeout = idle_timeout
        self._server: Optional[asyncio.base_events.Server] = None
        # open connections: stop() closes the idle kept-alive ones, which
        # the server's wait_closed() would otherwise wait for
        self._writers: set = set()

    async def start(self) -> int:
        """Listen; returns the bound port."""
        # a listen backlog above the largest batch a server seats (asyncio's
        # default is 100): every lane's client may connect at once
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=MAX_HEAD_BYTES, backlog=1024)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("%s listening on %s:%d", type(self).__name__, self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None

    async def _respond(self, method: str, path: str, query: str,
                       headers: Dict[str, str], body: bytes, writer,
                       keep_alive: bool) -> None:
        raise NotImplementedError

    def _route_template(self, method: str, path: str) -> Tuple[str, Optional[str]]:
        """(route template, model name or None) of a request: its span's
        name.  A server whose paths carry names overrides it."""
        return path, None

    async def _on_error(self, exc: Exception, path: str, writer,
                        keep_alive: bool) -> None:
        """The answer to an unexpected exception of `_respond`."""
        logger.error("request failed", exc_info=exc)
        await self._send_json(writer, 500, error_body(str(exc), "internal_error"),
                              keep_alive)

    # ---------------- wire ----------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One connection: requests in turn until it closes."""
        self._writers.add(writer)
        try:
            while await self._serve_one(reader, writer):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _serve_one(self, reader, writer) -> bool:
        """Read and answer one request; True when the connection stays
        open for the next."""
        try:
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          self.idle_timeout)
        except (asyncio.TimeoutError, asyncio.IncompleteReadError):
            return False  # idle too long, or the client closed
        except asyncio.LimitOverrunError:
            await self._send_json(writer, 400, error_body("request head too large"),
                                  keep_alive=False)
            return False
        try:
            method, path, query, version, headers = self._parse_head(head)
        except BadRequest as e:
            await self._send_json(writer, e.status, error_body(str(e)), keep_alive=False)
            return False
        tokens = {t.strip().lower() for t in headers.get("connection", "").split(",")}
        keep_alive = ("keep-alive" in tokens if version == "HTTP/1.0"
                      else "close" not in tokens)
        with request_scope(headers) as (ctx, _):
            span = self._start_request_span(method, path, headers, ctx)
            token = _request_span.set(span)
            try:
                body = await self._read_body(method, headers, reader, writer)
                await self._respond(method, path, query, headers, body, writer,
                                    keep_alive)
            except BadRequest as e:
                await self._send_json(writer, e.status, error_body(str(e)),
                                      keep_alive=False)
                return False
            except HTTPError as e:
                await self._send_json(writer, e.status, error_body(str(e)), keep_alive)
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                if span is not None:
                    mark_span_error(span, e)
                return False
            except Exception as e:  # noqa: BLE001 — one request's failure must not stop the server
                if span is not None:
                    mark_span_error(span, e)
                await self._on_error(e, path, writer, keep_alive)
            finally:
                _request_span.reset(token)
                if span is not None:
                    span.end()
        return keep_alive

    def _start_request_span(self, method: str, path: str,
                            headers: Dict[str, str], ctx: TraceContext):
        """The request's span (None without a tracer): the bound context's
        ids, a child of the caller's span."""
        tracer = get_tracer()
        if tracer is None:
            return None
        template, model = self._route_template(method, path)
        attributes = {"http.method": method, "http.target": path,
                      "trace_id": ctx.trace_id, "span_id": ctx.span_id}
        if model:
            attributes["kserve.model"] = model
        caller = TraceContext.from_headers(headers)
        return tracer.start_span(
            f"{method} {template}", attributes=attributes, context=ctx,
            parent_span_id=caller.span_id if caller is not None else None,
            kind=SPAN_KIND_SERVER)

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[str, str, str, str, Dict[str, str]]:
        """(method, path, query string, HTTP version, lower-cased headers).
        A header line longer than CHECKPOINT_FIELD_SIZE_LIMIT is refused."""
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise BadRequest(400, "malformed request line")
        method, target, version = parts
        headers = {}
        for line in lines[1:]:
            if len(line) > CHECKPOINT_FIELD_SIZE_LIMIT:
                raise BadRequest(400, "request header field too large")
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        path, _, query = target.partition("?")
        return method, path, query, version, headers

    async def _read_body(self, method: str, headers: Dict[str, str],
                         reader, writer) -> bytes:
        """The request body: Content-Length bytes, or the chunks of a
        `Transfer-Encoding: chunked` body (its trailers dropped).  A POST
        without either is refused (411)."""
        te = headers.get("transfer-encoding", "").lower()
        chunked = te == "chunked"
        if te and not chunked:
            raise BadRequest(501, f"transfer-encoding {te!r} is not supported")
        if not chunked and "content-length" not in headers:
            if method == "POST":
                raise BadRequest(
                    411, "a Content-Length or Transfer-Encoding: chunked "
                    "header is required")
            return b""
        n = 0
        if not chunked:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise BadRequest(400, "bad Content-Length") from None
            if n < 0 or n > MAX_BODY_BYTES:
                raise BadRequest(413, "request body too large")
        if headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        if not chunked:
            return await reader.readexactly(n)
        body = bytearray()
        while True:
            line = await reader.readuntil(b"\r\n")
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise BadRequest(400, "bad chunk size") from None
            if size < 0 or len(body) + size > MAX_BODY_BYTES:
                raise BadRequest(413, "request body too large")
            if size == 0:
                while await reader.readuntil(b"\r\n") != b"\r\n":
                    pass  # trailer fields
                return bytes(body)
            body += await reader.readexactly(size)
            if await reader.readexactly(2) != b"\r\n":
                raise BadRequest(400, "malformed chunk")

    @staticmethod
    def _head(status: int, content_type: str, length: Optional[int],
              keep_alive: bool, headers: Optional[Dict[str, str]] = None) -> bytes:
        """The answer's head; it echoes the bound request id unless
        `headers` carry one."""
        headers = dict(headers or {})
        names = {k.lower() for k in headers}
        rid = current_request_id()
        if rid and REQUEST_ID_HEADER not in names:
            headers[REQUEST_ID_HEADER] = rid
        span = _request_span.get()
        if span is not None:
            span.set_attribute("http.status_code", status)
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                 f"Content-Type: {content_type}",
                 f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        else:
            lines.append("Transfer-Encoding: chunked")
            if "cache-control" not in names:
                lines.append("Cache-Control: no-cache")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _send(self, writer, status: int, content_type: str, data,
                    keep_alive: bool, headers: Optional[Dict[str, str]] = None) -> None:
        """One whole answer; `data` is bytes-like (a P/D KV payload is a
        view of a tensor's memory, written without joining it first)."""
        writer.write(self._head(status, content_type, len(data), keep_alive, headers))
        writer.write(data)
        await writer.drain()

    async def _send_json(self, writer, status: int, obj, keep_alive: bool,
                         headers: Optional[Dict[str, str]] = None) -> None:
        await self._send(writer, status, "application/json",
                         json.dumps(obj).encode("utf-8"), keep_alive, headers)

    async def _relay(self, upstream, writer, keep_alive: bool) -> Tuple[Optional[float], int]:
        """Relay a streamed answer (http_client.StreamedResponse) as it
        arrives: its status and headers less HOP_HEADERS, then its body
        piece by piece (chunked unless it came with a length), and close
        it.  Returns (monotonic time of the first piece or None, pieces).
        A failure after the head is sent propagates: no second answer is
        possible, so the caller cuts the connection.  The EPP's proxy and
        the activator's relay through this."""
        try:
            out_headers = {k: v for k, v in upstream.headers.items()
                           if k not in HOP_HEADERS}
            ctype = out_headers.pop("content-type", "application/octet-stream")
            length = upstream.headers.get("content-length")
            chunked = length is None
            writer.write(self._head(upstream.status, ctype,
                                    None if chunked else int(length),
                                    keep_alive, out_headers))
            await writer.drain()
            first, pieces = None, 0
            async for piece in upstream.body():
                if not piece:
                    continue
                if first is None:
                    first = time.monotonic()
                pieces += 1
                writer.write(self._chunk(piece) if chunked else piece)
                await writer.drain()
            if chunked:
                writer.write(b"0\r\n\r\n")
                await writer.drain()
            return first, pieces
        finally:
            await upstream.aclose()

    @staticmethod
    def _chunk(data: bytes) -> bytes:
        return b"%x\r\n%s\r\n" % (len(data), data)

    @staticmethod
    def _expect(method: str, allowed: str) -> None:
        if method != allowed:
            raise HTTPError(405, f"method {method} not allowed")
