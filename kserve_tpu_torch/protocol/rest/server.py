"""HTTP/1.1 REST server on `asyncio.start_server` (standard library only).

Port of the routes of kserve_tpu/protocol/rest/server.py and
protocol/openai/endpoints.py that the generative slice serves; the JAX
package's aiohttp stack is not available on the card machine.

Routes:
  GET  /v2/health/live, /v2/health/ready
  GET  /openai/v1/models
  POST /openai/v1/completions, /openai/v1/chat/completions
       (JSON, or text/event-stream with `"stream": true`, ending
       `data: [DONE]`)
  GET  /metrics          the engine's series (metrics.py), text format 0.0.4
  GET  /admin/telemetry  per model: TTFT / ITL / queue-wait percentiles and
       recent request timelines (kserve_tpu/observability/
       introspection.py:115-126; the port has no profiler, so
       "profiler" always reads inactive)
The /openai/v1 routes also answer under /openai.

Connections are kept alive (HTTP/1.1; HTTP/1.0 with `Connection:
keep-alive`) until the client sends `Connection: close`, a request
cannot be read to its end, or the connection idles `idle_timeout`
seconds.  A request body comes with a Content-Length or
`Transfer-Encoding: chunked`; a streamed answer is sent chunked.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional, Tuple

from ...errors import InvalidInput, ModelNotFound
from ...metrics import CONTENT_TYPE_LATEST, generate_latest
from ..openai.types import (
    ChatCompletionRequest,
    CompletionRequest,
    ModelCard,
    ModelList,
    error_body,
)

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 16 << 20
# seconds an idle kept-alive connection waits for its next request
# (aiohttp's keepalive_timeout, the JAX server's)
IDLE_TIMEOUT_S = 75.0
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 411: "Length Required",
            413: "Payload Too Large", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable"}


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _BadRequest(_HTTPError):
    """A request that could not be read to its end: after the answer the
    connection closes, since the next request's start is unknown."""


class RESTServer:
    """Serves `models` ({name: model}) where each model has `name`,
    `ready`, `async create_completion(req)` and `async
    create_chat_completion(req)` (returning a response object or, for a
    streamed request, an async iterator of chunks)."""

    def __init__(self, models: Dict[str, object], host: str = "0.0.0.0",
                 port: int = 8080, idle_timeout: float = IDLE_TIMEOUT_S):
        self.models = models
        self.host = host
        self.port = port
        self.idle_timeout = idle_timeout
        self._server: Optional[asyncio.base_events.Server] = None
        # open connections: stop() closes the idle kept-alive ones, which
        # the server's wait_closed() would otherwise wait for
        self._writers: set = set()

    async def start(self) -> int:
        """Listen; returns the bound port (port 0 picks a free one)."""
        # a listen backlog above the largest batch a server seats (asyncio's
        # default is 100): every lane's client may connect at once
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=1 << 16, backlog=1024)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("REST server listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None

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
        keep_alive = False
        try:
            method, path, version, headers = self._parse_head(head)
            tokens = {t.strip().lower()
                      for t in headers.get("connection", "").split(",")}
            keep_alive = ("keep-alive" in tokens if version == "HTTP/1.0"
                          else "close" not in tokens)
            body = await self._read_body(method, headers, reader, writer)
            await self._route(method, path, body, writer, keep_alive)
        except _BadRequest as e:
            await self._send_json(writer, e.status, error_body(str(e)),
                                  keep_alive=False)
            return False
        except _HTTPError as e:
            await self._send_json(writer, e.status, error_body(str(e)), keep_alive)
        except InvalidInput as e:
            await self._send_json(writer, 400, error_body(str(e)), keep_alive)
        except ModelNotFound as e:
            await self._send_json(writer, 404, error_body(str(e), "not_found"),
                                  keep_alive)
        except (ConnectionError, asyncio.IncompleteReadError):
            return False
        except Exception as e:  # noqa: BLE001 — one request's failure must not stop the server
            logger.exception("request failed")
            await self._send_json(writer, 500, error_body(str(e), "internal_error"),
                                  keep_alive)
        return keep_alive

    @staticmethod
    def _parse_head(head: bytes) -> Tuple[str, str, str, Dict[str, str]]:
        """(method, path, HTTP version, lower-cased headers)."""
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest(400, "malformed request line")
        method, target, version = parts
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        return method, target.split("?", 1)[0], version, headers

    async def _read_body(self, method: str, headers: Dict[str, str],
                         reader, writer) -> bytes:
        """The request body: Content-Length bytes, or the chunks of a
        `Transfer-Encoding: chunked` body (its trailers dropped).  A POST
        without either is refused (411)."""
        te = headers.get("transfer-encoding", "").lower()
        chunked = te == "chunked"
        if te and not chunked:
            raise _BadRequest(501, f"transfer-encoding {te!r} is not supported")
        if not chunked and "content-length" not in headers:
            if method == "POST":
                raise _BadRequest(
                    411, "a Content-Length or Transfer-Encoding: chunked "
                    "header is required")
            return b""
        n = 0
        if not chunked:
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise _BadRequest(400, "bad Content-Length") from None
            if n < 0 or n > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
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
                raise _BadRequest(400, "bad chunk size") from None
            if size < 0 or len(body) + size > MAX_BODY_BYTES:
                raise _BadRequest(413, "request body too large")
            if size == 0:
                while await reader.readuntil(b"\r\n") != b"\r\n":
                    pass  # trailer fields
                return bytes(body)
            body += await reader.readexactly(size)
            if await reader.readexactly(2) != b"\r\n":
                raise _BadRequest(400, "malformed chunk")

    @staticmethod
    def _head(status: int, content_type: str, length: Optional[int],
              keep_alive: bool) -> bytes:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                 f"Content-Type: {content_type}",
                 f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        else:
            lines += ["Transfer-Encoding: chunked", "Cache-Control: no-cache"]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _send(self, writer, status: int, content_type: str, data: bytes,
                    keep_alive: bool) -> None:
        writer.write(self._head(status, content_type, len(data), keep_alive) + data)
        await writer.drain()

    async def _send_json(self, writer, status: int, obj, keep_alive: bool) -> None:
        await self._send(writer, status, "application/json",
                         json.dumps(obj).encode("utf-8"), keep_alive)

    @staticmethod
    def _chunk(data: bytes) -> bytes:
        return b"%x\r\n%s\r\n" % (len(data), data)

    async def _send_sse(self, writer, chunks, keep_alive: bool) -> None:
        """Server-sent events in a chunked body: one chunk per event, then
        `data: [DONE]` and the last chunk."""
        writer.write(self._head(200, "text/event-stream", None, keep_alive))
        await writer.drain()
        try:
            async for chunk in chunks:
                writer.write(self._chunk(
                    f"data: {json.dumps(chunk.to_dict())}\n\n".encode("utf-8")))
                await writer.drain()
            writer.write(self._chunk(b"data: [DONE]\n\n"))
        except ConnectionError:
            raise
        except Exception as e:  # noqa: BLE001 — headers are sent: report in-band
            # a second response cannot follow the headers: the stream ends
            # with an error event and without [DONE]
            logger.exception("mid-stream failure")
            writer.write(self._chunk(
                f"data: {json.dumps(error_body(str(e), 'internal_error'))}\n\n"
                .encode("utf-8")))
        finally:
            # a client that went away releases its engine slot now, not at GC
            await chunks.aclose()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    # ---------------- routes ----------------

    async def _route(self, method: str, path: str, body: bytes, writer,
                     keep_alive: bool) -> None:
        if path.startswith("/openai/") and not path.startswith("/openai/v1/"):
            path = "/openai/v1/" + path[len("/openai/"):]
        if path == "/v2/health/live":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, {"live": True}, keep_alive)
        if path == "/v2/health/ready":
            self._expect(method, "GET")
            ready = all(m.ready for m in self.models.values())
            return await self._send_json(writer, 200 if ready else 503,
                                         {"ready": ready}, keep_alive)
        if path == "/openai/v1/models":
            self._expect(method, "GET")
            cards = [ModelCard(id=name) for name in self.models]
            return await self._send_json(writer, 200, ModelList(data=cards).to_dict(),
                                         keep_alive)
        if path == "/metrics":
            self._expect(method, "GET")
            return await self._send(writer, 200, CONTENT_TYPE_LATEST,
                                    generate_latest(), keep_alive)
        if path == "/admin/telemetry":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, self._telemetry(), keep_alive)
        if path == "/openai/v1/completions":
            self._expect(method, "POST")
            req = CompletionRequest.from_json(self._json(body))
            result = await self._model(req.model).create_completion(req)
        elif path == "/openai/v1/chat/completions":
            self._expect(method, "POST")
            req = ChatCompletionRequest.from_json(self._json(body))
            result = await self._model(req.model).create_chat_completion(req)
        else:
            raise _HTTPError(404, f"no route for {path}")
        if req.stream:
            return await self._send_sse(writer, result, keep_alive)
        return await self._send_json(writer, 200, result.to_dict(), keep_alive)

    def _telemetry(self) -> dict:
        """The GET /admin/telemetry payload: each model's engine
        telemetry_snapshot()."""
        models = {}
        for name, model in self.models.items():
            snap = getattr(getattr(model, "engine", None), "telemetry_snapshot", None)
            if callable(snap):
                models[name] = snap()
        return {"models": models, "profiler": {"active": False, "capture": None}}

    @staticmethod
    def _expect(method: str, allowed: str) -> None:
        if method != allowed:
            raise _HTTPError(405, f"method {method} not allowed")

    @staticmethod
    def _json(body: bytes):
        try:
            return json.loads(body)
        except (ValueError, UnicodeDecodeError) as e:
            raise InvalidInput(f"invalid JSON body: {e}") from None

    def _model(self, name: str):
        model = self.models.get(name)
        if model is None:
            raise ModelNotFound(f"model {name!r} is not served here")
        if not model.ready:
            raise _HTTPError(503, f"model {name!r} is not ready")
        return model
