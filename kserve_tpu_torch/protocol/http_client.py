"""A small asynchronous HTTP/1.1 client on the standard library.

It takes the place of aiohttp (the P/D prefill client, kserve_tpu/
protocol/pd.py) and httpx (the peer page client, kserve_tpu/kvstore/
peer.py), which the card machine does not have.  Requests go out over
`asyncio.open_connection`, never through a blocking call in a thread, so
a caller that waits on an injected clock waits on nothing else.

A client sends each request through its *transport*: an async callable
(method, url, headers, body) -> Response.  The default, SocketTransport,
speaks HTTP/1.1 over TCP and keeps idle connections alive per host and
event loop.  A test passes its own handler instead (the counterpart of
httpx.MockTransport), and resilience.faults.FaultInjectingTransport wraps
either one.  Transport failures raise HTTPError subclasses: ConnectError
(nothing listening, or refused), ConnectTimeout (the timeout ran out
before the request was sent: replaying it cannot duplicate work),
ReadTimeout (no answer in time after it was sent) and ReadError (the
connection died mid-answer).

A response body with a Content-Length is read into one buffer of that
size, chunk by chunk from the stream: a P/D KV transfer (134 MB for a
1,024-token Llama-3-8B prompt) is never copied again once read.

`AsyncHTTPClient.stream` is the streamed form (aiohttp's `iter_any()`,
which the EPP's proxy relays with, kserve_tpu/scheduler/epp.py:284-296):
it returns once the status and headers are read, and the body comes as
an async iterator of pieces as they arrive (each chunk of a chunked
body, or up to 64 KiB of a length-framed or unframed one).  A response
head may be as long as a server's request head (limits.MAX_HEAD_BYTES:
a checkpoint header of up to CHECKPOINT_FIELD_SIZE_LIMIT bytes and
64 KiB for the rest).
"""

from __future__ import annotations

import asyncio
import inspect
import json as _json
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import urlsplit

from .limits import MAX_HEAD_BYTES

Body = Union[bytes, bytearray, memoryview]

# the largest piece read from the stream at a time into a body buffer
_READ_CHUNK = 1 << 20
# the largest piece a streamed body yields at a time
_STREAM_PIECE = 1 << 16
# idle kept-alive connections pooled per (event loop, host, port)
_MAX_IDLE_PER_HOST = 8


class HTTPError(Exception):
    """A request that got no complete response."""


class ConnectError(HTTPError):
    """The connection could not be opened (refused, unreachable)."""


class ConnectTimeout(HTTPError):
    """The client's timeout ran out before the request was sent."""


class ReadTimeout(HTTPError):
    """No complete response within the client's timeout, the request sent."""


class ReadError(HTTPError):
    """The connection died while the response was read."""


@dataclass
class Response:
    status: int
    # header names lower-cased
    headers: Dict[str, str] = field(default_factory=dict)
    body: Body = b""

    def text(self) -> str:
        return bytes(self.body).decode("utf-8", errors="replace")


Transport = Callable[[str, str, Dict[str, str], Body], Awaitable[Response]]


class StreamedResponse:
    """A response whose status and headers are read and whose body is not
    yet: iterate `body()` for its pieces, then (or instead) `aclose()`.
    The connection goes back to the pool only after a whole body."""

    def __init__(self, status: int, headers: Dict[str, str],
                 pieces: AsyncIterator[bytes], close: Callable[[], None]):
        self.status = status
        self.headers = headers
        self._pieces = pieces
        self._close = close

    def body(self) -> AsyncIterator[bytes]:
        return self._pieces

    async def aclose(self) -> None:
        await self._pieces.aclose()
        self._close()


def _split(url: str) -> Tuple[str, int, str]:
    """(host, port, path with query) of an http:// URL."""
    parts = urlsplit(url)
    if parts.scheme != "http":
        raise ValueError(f"only http:// URLs are supported, got {url!r}")
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    return parts.hostname or "", parts.port or 80, path


class _Conn:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        self.writer.close()


class SocketTransport:
    """HTTP/1.1 over TCP, with idle kept-alive connections pooled per
    (event loop, host, port).  `timeout_s` bounds one whole exchange."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self._idle: Dict[tuple, List[_Conn]] = {}

    async def __call__(self, method: str, url: str, headers: Dict[str, str],
                       body: Body) -> Response:
        host, port, path = _split(url)
        key = (id(asyncio.get_running_loop()), host, port)
        request_head = self._request_head(method, host, port, path, headers, body)
        sent = []  # set once the request is on the wire
        try:
            return await asyncio.wait_for(
                self._exchange(key, host, port, request_head, body, method, sent),
                self.timeout_s)
        except asyncio.TimeoutError:
            if not sent:
                raise ConnectTimeout(
                    f"{method} {url}: not connected in {self.timeout_s}s") from None
            raise ReadTimeout(f"{method} {url}: no answer in {self.timeout_s}s") from None

    async def stream(self, method: str, url: str, headers: Dict[str, str],
                     body: Body) -> StreamedResponse:
        """Connect within `timeout_s`, send the request and read the
        response head; the head and the body come with no time limit (a
        whole completion answers only when it is done, and a generation
        streams as long as it runs)."""
        host, port, path = _split(url)
        key = (id(asyncio.get_running_loop()), host, port)
        request_head = self._request_head(method, host, port, path, headers, body)
        conn, status, rheaders, keep = await self._open(
            key, host, port, request_head, body, [], connect_timeout_s=self.timeout_s)
        done = []

        async def pieces():
            try:
                async for piece in self._iter_body(conn, method, status, rheaders):
                    yield piece
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                conn.close()
                raise ReadError(f"{host}:{port}: body cut short: {e!r}") from None
            done.append(True)

        keep = keep and ("content-length" in rheaders or rheaders.get(
            "transfer-encoding", "").lower() == "chunked" or method == "HEAD")

        def close():
            if done and keep and len(self._idle.setdefault(key, [])) < _MAX_IDLE_PER_HOST:
                self._idle[key].append(conn)
            else:
                conn.close()

        return StreamedResponse(status, rheaders, pieces(), close)

    @staticmethod
    def _request_head(method, host, port, path, headers, body) -> bytes:
        head = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
                f"Content-Length: {len(body)}"]
        head += [f"{k}: {v}" for k, v in headers.items()
                 if k.lower() not in ("host", "content-length")]
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")

    async def _open(self, key, host, port, request_head, body, sent,
                    connect_timeout_s: Optional[float] = None):
        """(connection, status, headers, keep-alive) once the response head
        is read; a pooled connection the server closed is replaced.  Only
        the connect is bounded by `connect_timeout_s`."""
        while True:
            pooled = self._idle.get(key)
            conn = pooled.pop() if pooled else None
            reused = conn is not None
            if conn is None:
                try:
                    reader, writer = await asyncio.wait_for(asyncio.open_connection(
                        host, port, limit=MAX_HEAD_BYTES), connect_timeout_s)
                except asyncio.TimeoutError:
                    raise ConnectTimeout(f"connect to {host}:{port}: not connected in "
                                         f"{connect_timeout_s}s") from None
                except OSError as e:
                    raise ConnectError(f"connect to {host}:{port}: {e}") from None
                conn = _Conn(reader, writer)
            sent.append(True)
            try:
                conn.writer.write(request_head)
                if body:
                    conn.writer.write(body)
                await conn.writer.drain()
                status, headers, keep = await self._read_head(conn)
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                conn.close()
                if reused:
                    continue
                raise ReadError(f"{host}:{port}: {e!r}") from None
            except BaseException:
                conn.close()
                raise
            return conn, status, headers, keep

    @staticmethod
    async def _iter_body(conn: _Conn, method: str, status: int,
                         headers: Dict[str, str]) -> AsyncIterator[bytes]:
        """The body's pieces as they arrive: each chunk of a chunked body,
        else pieces of at most _STREAM_PIECE bytes."""
        reader = conn.reader
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            return
        if headers.get("transfer-encoding", "").lower() == "chunked":
            while True:
                size = int((await reader.readuntil(b"\r\n")).split(b";", 1)[0], 16)
                if size == 0:
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailer fields
                    return
                piece = await reader.readexactly(size)
                await reader.readexactly(2)
                yield piece
        elif "content-length" in headers:
            left = int(headers["content-length"])
            while left > 0:
                piece = await reader.read(min(left, _STREAM_PIECE))
                if not piece:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(piece)
                yield piece
        else:
            while True:
                piece = await reader.read(_STREAM_PIECE)
                if not piece:
                    return
                yield piece

    async def _exchange(self, key, host, port, request_head, body, method, sent):
        conn, status, headers, keep = await self._open(key, host, port, request_head,
                                                       body, sent)
        try:
            data, keep = await self._read_body(conn, method, status, headers, keep)
        except (ConnectionError, asyncio.IncompleteReadError) as e:
            conn.close()
            raise ReadError(f"{host}:{port}: body cut short: {e!r}") from None
        except BaseException:
            conn.close()
            raise
        if keep and len(self._idle.setdefault(key, [])) < _MAX_IDLE_PER_HOST:
            self._idle[key].append(conn)
        else:
            conn.close()
        return Response(status, headers, data)

    @staticmethod
    async def _read_head(conn: _Conn):
        raw = await conn.reader.readuntil(b"\r\n\r\n")
        lines = raw.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ", 2)
        if len(parts) < 2 or not parts[0].startswith("HTTP/"):
            raise ConnectionError(f"malformed status line {lines[0]!r}")
        headers = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        tokens = {t.strip().lower() for t in headers.get("connection", "").split(",")}
        keep = ("keep-alive" in tokens if parts[0] == "HTTP/1.0"
                else "close" not in tokens)
        return int(parts[1]), headers, keep

    @staticmethod
    async def _read_body(conn: _Conn, method: str, status: int,
                         headers: Dict[str, str], keep: bool) -> Tuple[Body, bool]:
        """(the body, whether the connection may be reused)."""
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            return b"", keep
        chunked = headers.get("transfer-encoding", "").lower() == "chunked"
        if chunked or "content-length" not in headers:
            # chunked, or unframed (to the end of the connection)
            out = bytearray()
            async for piece in SocketTransport._iter_body(conn, method, status, headers):
                out += piece
            return out, keep and chunked
        n = int(headers["content-length"])
        buf = bytearray(n)
        view = memoryview(buf)
        off = 0
        while off < n:
            chunk = await conn.reader.read(min(n - off, _READ_CHUNK))
            if not chunk:
                raise asyncio.IncompleteReadError(bytes(view[:off]), n)
            view[off:off + len(chunk)] = chunk
            off += len(chunk)
        return buf, keep

    async def aclose(self) -> None:
        idle, self._idle = self._idle, {}
        for conns in idle.values():
            for conn in conns:
                conn.close()


class AsyncHTTPClient:
    """Requests through `transport` (a SocketTransport by default)."""

    def __init__(self, transport: Optional[Transport] = None,
                 timeout_s: float = 60.0):
        self.transport = transport if transport is not None else SocketTransport(timeout_s)

    async def request(self, method: str, url: str,
                      headers: Optional[Dict[str, str]] = None,
                      body: Body = b"", json=None) -> Response:
        headers = dict(headers or {})
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
            if not any(k.lower() == "content-type" for k in headers):
                headers["Content-Type"] = "application/json"
        result = self.transport(method, url, headers, body)
        if inspect.isawaitable(result):
            result = await result
        return result

    async def stream(self, method: str, url: str,
                     headers: Optional[Dict[str, str]] = None,
                     body: Body = b"") -> StreamedResponse:
        """The streamed form of `request` (the transport must have one:
        SocketTransport does)."""
        stream = getattr(self.transport, "stream", None)
        if stream is None:
            raise TypeError(f"{type(self.transport).__name__} has no streamed form")
        return await stream(method, url, dict(headers or {}), body)

    async def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> Response:
        return await self.request("GET", url, headers)

    async def post(self, url: str, json=None, body: Body = b"",
                   headers: Optional[Dict[str, str]] = None) -> Response:
        return await self.request("POST", url, headers, body, json=json)

    async def aclose(self) -> None:
        close = getattr(self.transport, "aclose", None)
        if close is not None:
            await close()
