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
The /openai/v1 routes also answer under /openai.  One request per
connection (`Connection: close`); bodies need a Content-Length.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, Optional, Tuple

from ...errors import InvalidInput, ModelNotFound
from ..openai.types import (
    ChatCompletionRequest,
    CompletionRequest,
    ModelCard,
    ModelList,
    error_body,
)

logger = logging.getLogger(__name__)

MAX_BODY_BYTES = 16 << 20
_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 411: "Length Required",
            413: "Payload Too Large", 500: "Internal Server Error",
            503: "Service Unavailable"}


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class RESTServer:
    """Serves `models` ({name: model}) where each model has `name`,
    `ready`, `async create_completion(req)` and `async
    create_chat_completion(req)` (returning a response object or, for a
    streamed request, an async iterator of chunks)."""

    def __init__(self, models: Dict[str, object], host: str = "0.0.0.0",
                 port: int = 8080):
        self.models = models
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None

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
            await self._server.wait_closed()
            self._server = None

    # ---------------- wire ----------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, body = await self._read_request(reader, writer)
                await self._route(method, path, body, writer)
            except _HTTPError as e:
                await self._send_json(writer, e.status, error_body(str(e)))
            except InvalidInput as e:
                await self._send_json(writer, 400, error_body(str(e)))
            except ModelNotFound as e:
                await self._send_json(writer, 404, error_body(str(e), "not_found"))
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            except Exception as e:  # noqa: BLE001 — one request's failure must not stop the server
                logger.exception("request failed")
                await self._send_json(writer, 500, error_body(str(e), "internal_error"))
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def _read_request(self, reader, writer) -> Tuple[str, str, bytes]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            raise _HTTPError(400, "request head too large") from None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3:
            raise _HTTPError(400, "malformed request line")
        method, target, _ = parts
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        body = b""
        if method == "POST":
            if "content-length" not in headers:
                raise _HTTPError(411, "a Content-Length header is required")
            try:
                n = int(headers["content-length"])
            except ValueError:
                raise _HTTPError(400, "bad Content-Length") from None
            if n < 0 or n > MAX_BODY_BYTES:
                raise _HTTPError(413, "request body too large")
            if headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await writer.drain()
            body = await reader.readexactly(n)
        return method, target.split("?", 1)[0], body

    @staticmethod
    def _head(status: int, content_type: str, length: Optional[int]) -> bytes:
        lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                 f"Content-Type: {content_type}", "Connection: close"]
        if length is not None:
            lines.append(f"Content-Length: {length}")
        else:
            lines.append("Cache-Control: no-cache")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _send_json(self, writer, status: int, obj) -> None:
        data = json.dumps(obj).encode("utf-8")
        writer.write(self._head(status, "application/json", len(data)) + data)
        await writer.drain()

    async def _send_sse(self, writer, chunks) -> None:
        writer.write(self._head(200, "text/event-stream", None))
        await writer.drain()
        try:
            async for chunk in chunks:
                writer.write(f"data: {json.dumps(chunk.to_dict())}\n\n".encode("utf-8"))
                await writer.drain()
            writer.write(b"data: [DONE]\n\n")
        except ConnectionError:
            return
        except Exception as e:  # noqa: BLE001 — headers are sent: report in-band
            # a second response cannot follow the headers: the stream ends
            # with an error event and without [DONE]
            logger.exception("mid-stream failure")
            writer.write(f"data: {json.dumps(error_body(str(e), 'internal_error'))}\n\n"
                         .encode("utf-8"))
        finally:
            # a client that went away releases its engine slot now, not at GC
            await chunks.aclose()
        await writer.drain()

    # ---------------- routes ----------------

    async def _route(self, method: str, path: str, body: bytes, writer) -> None:
        if path.startswith("/openai/") and not path.startswith("/openai/v1/"):
            path = "/openai/v1/" + path[len("/openai/"):]
        if path == "/v2/health/live":
            self._expect(method, "GET")
            return await self._send_json(writer, 200, {"live": True})
        if path == "/v2/health/ready":
            self._expect(method, "GET")
            ready = all(m.ready for m in self.models.values())
            return await self._send_json(writer, 200 if ready else 503, {"ready": ready})
        if path == "/openai/v1/models":
            self._expect(method, "GET")
            cards = [ModelCard(id=name) for name in self.models]
            return await self._send_json(writer, 200, ModelList(data=cards).to_dict())
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
            return await self._send_sse(writer, result)
        return await self._send_json(writer, 200, result.to_dict())

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
