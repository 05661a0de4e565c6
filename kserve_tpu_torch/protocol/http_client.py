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
"""

from __future__ import annotations

import asyncio
import inspect
import json as _json
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Tuple, Union
from urllib.parse import urlsplit

Body = Union[bytes, bytearray, memoryview]

# the largest piece read from the stream at a time into a body buffer
_READ_CHUNK = 1 << 20
# the response head (status line and headers) may not be longer
_HEAD_LIMIT = 1 << 20
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
        head = [f"{method} {path} HTTP/1.1", f"Host: {host}:{port}",
                f"Content-Length: {len(body)}"]
        head += [f"{k}: {v}" for k, v in headers.items()
                 if k.lower() not in ("host", "content-length")]
        request_head = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
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

    async def _exchange(self, key, host, port, request_head, body, method, sent):
        while True:
            pooled = self._idle.get(key)
            conn = pooled.pop() if pooled else None
            reused = conn is not None
            if conn is None:
                try:
                    reader, writer = await asyncio.open_connection(
                        host, port, limit=_HEAD_LIMIT)
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
                    continue  # the server closed an idle connection: a new one
                raise ReadError(f"{host}:{port}: {e!r}") from None
            except BaseException:
                conn.close()
                raise
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
        reader = conn.reader
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            return b"", keep
        if headers.get("transfer-encoding", "").lower() == "chunked":
            out = bytearray()
            while True:
                size = int((await reader.readuntil(b"\r\n")).split(b";", 1)[0], 16)
                if size == 0:
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailer fields
                    return out, keep
                out += await reader.readexactly(size)
                await reader.readexactly(2)
        if "content-length" in headers:
            n = int(headers["content-length"])
            buf = bytearray(n)
            view = memoryview(buf)
            off = 0
            while off < n:
                chunk = await reader.read(min(n - off, _READ_CHUNK))
                if not chunk:
                    raise asyncio.IncompleteReadError(bytes(view[:off]), n)
                view[off:off + len(chunk)] = chunk
                off += len(chunk)
            return buf, keep
        # no framing: the body runs to the end of the connection
        return await reader.read(), False

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

    async def get(self, url: str, headers: Optional[Dict[str, str]] = None) -> Response:
        return await self.request("GET", url, headers)

    async def post(self, url: str, json=None, body: Body = b"",
                   headers: Optional[Dict[str, str]] = None) -> Response:
        return await self.request("POST", url, headers, body, json=json)

    async def aclose(self) -> None:
        close = getattr(self.transport, "aclose", None)
        if close is not None:
            await close()
