"""The PyTorch port's standard-library OpenAI server, driven over real
sockets with the tiny config on --device cpu: health, models, a
completion, a streamed chat (SSE chunks then [DONE]), logprob blocks and
sampling penalties (mirroring tests/test_openai_serving.py:179-310 of the
JAX server), and 400s."""

import http.client
import json
import socket
import threading
import time

import pytest

from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model

ARGS = ["--model_name=tiny", "--model_config=tiny", "--random_weights",
        "--device=cpu", "--kv_dtype=float32", "--http_port=0",
        "--max_model_len=256", "--kv_pages=128", "--max_prefill_len=64"]


@pytest.fixture(scope="module")
def server():
    model = build_model(build_arg_parser().parse_args(ARGS))
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60), "server did not start"
    srv.model = model
    yield srv
    srv.request_stop()
    thread.join(30)
    assert not thread.is_alive()


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        if isinstance(body, dict):
            body = json.dumps(body)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()


def test_health_and_models(server):
    assert _request(server, "GET", "/v2/health/live")[0] == 200
    status, _, body = _request(server, "GET", "/v2/health/ready")
    assert status == 200 and json.loads(body) == {"ready": True}
    status, _, body = _request(server, "GET", "/openai/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(body)["data"]] == ["tiny"]


def test_completion(server):
    status, ctype, body = _request(server, "POST", "/openai/v1/completions", {
        "model": "tiny", "prompt": "hello world", "max_tokens": 7,
        "temperature": 0, "ignore_eos": True})
    assert status == 200 and ctype == "application/json"
    resp = json.loads(body)
    assert resp["object"] == "text_completion"
    assert resp["choices"][0]["finish_reason"] == "length"
    assert resp["usage"] == {"prompt_tokens": 12, "completion_tokens": 7,
                             "total_tokens": 19}
    # greedy is deterministic
    again = json.loads(_request(server, "POST", "/openai/v1/completions", {
        "model": "tiny", "prompt": "hello world", "max_tokens": 7,
        "temperature": 0, "ignore_eos": True})[2])
    assert again["choices"][0]["text"] == resp["choices"][0]["text"]


def test_streaming_chat(server):
    status, ctype, body = _request(server, "POST", "/openai/v1/chat/completions", {
        "model": "tiny", "stream": True, "max_tokens": 5, "temperature": 0,
        "ignore_eos": True, "messages": [{"role": "user", "content": "hi"}]})
    assert status == 200 and ctype == "text/event-stream"
    events = [line[len("data: "):] for line in body.split("\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert len(chunks) == 1 + 5  # the role chunk, then one per token
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("body", [
    b"{not json",
    # above EngineConfig.max_logprobs (20)
    {"model": "tiny", "prompt": "x", "logprobs": 21},
    # top_logprobs without the chat dialect's logprobs gate
    {"model": "tiny", "messages": [{"role": "user", "content": "x"}],
     "top_logprobs": 3},
    {"model": "tiny", "prompt": "x", "logit_bias": {"5": 1.0}},
    {"model": "tiny", "prompt": 5},
    {"prompt": "x"},
    {"model": "tiny", "prompt": "x", "max_tokens": 100000},
], ids=["malformed", "logprobs", "chat_logprobs", "logit_bias", "bad_prompt",
        "no_model", "too_long"])
def test_bad_requests_are_400(server, body):
    path = ("/openai/v1/chat/completions"
            if isinstance(body, dict) and "messages" in body
            else "/openai/v1/completions")
    status, _, text = _request(server, "POST", path, body)
    assert status == 400, text
    assert "error" in json.loads(text)


def _raw(server, payload: bytes) -> socket.socket:
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=60)
    sock.sendall(payload)
    return sock


def test_client_disconnect_mid_stream_frees_the_slot(server):
    body = json.dumps({"model": "tiny", "prompt": "x", "stream": True,
                       "max_tokens": 200, "ignore_eos": True}).encode()
    sock = _raw(server, b"POST /openai/v1/completions HTTP/1.1\r\n"
                + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    seen = b""
    while b"data: " not in seen:  # streaming has started
        seen += sock.recv(4096)
    sock.close()
    engine = server.model.engine
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if all(s.request_id is None for s in engine._slots):
            break
        time.sleep(0.05)
    assert all(s.request_id is None for s in engine._slots)
    assert (engine.allocator.free_pages + engine._prefix_cache.pages_held_alone()
            == engine.config.num_pages - 1)


def test_expect_100_continue(server):
    body = json.dumps({"model": "tiny", "prompt": "x", "max_tokens": 2}).encode()
    sock = _raw(server, b"POST /openai/v1/completions HTTP/1.1\r\n"
                + f"Content-Length: {len(body)}\r\nExpect: 100-continue\r\n"
                "Connection: close\r\n\r\n".encode())
    assert sock.recv(64).startswith(b"HTTP/1.1 100 Continue")
    sock.sendall(body)
    reply = b""
    while chunk := sock.recv(4096):
        reply += chunk
    sock.close()
    assert reply.startswith(b"HTTP/1.1 200 OK")


def test_unknown_model_is_404(server):
    status, _, _ = _request(server, "POST", "/openai/v1/completions",
                            {"model": "nope", "prompt": "x"})
    assert status == 404


def _events(body: str):
    return [json.loads(line[len("data: "):]) for line in body.split("\n")
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_completion_logprobs(server):
    status, _, body = _request(server, "POST", "/openai/v1/completions", {
        "model": "tiny", "prompt": "hello", "max_tokens": 5, "temperature": 0,
        "ignore_eos": True, "logprobs": 3})
    assert status == 200, body
    lp = json.loads(body)["choices"][0]["logprobs"]
    for key in ("tokens", "token_logprobs", "text_offset", "top_logprobs"):
        assert len(lp[key]) == 5
    assert all(v <= 0.0 for v in lp["token_logprobs"])
    for i, d in enumerate(lp["top_logprobs"]):
        # keyed by token text: a byte tokenizer can decode two ids to one
        # string, so only k + 1 bounds the entries
        assert 1 <= len(d) <= 4
        # greedy: the sampled token is the argmax, its logprob the best
        assert abs(max(d.values()) - lp["token_logprobs"][i]) < 1e-4


def test_chat_top_logprobs(server):
    status, _, body = _request(server, "POST", "/openai/v1/chat/completions", {
        "model": "tiny", "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4, "temperature": 0, "ignore_eos": True,
        "logprobs": True, "top_logprobs": 2})
    assert status == 200, body
    content = json.loads(body)["choices"][0]["logprobs"]["content"]
    assert len(content) == 4
    for entry in content:
        assert entry["logprob"] <= 0.0
        assert len(entry["top_logprobs"]) == 2
        assert isinstance(entry["bytes"], list)
        # greedy: the token is the top-1 entry and carries its logprob
        assert entry["top_logprobs"][0]["logprob"] == entry["logprob"]


@pytest.mark.parametrize("route", ["chat", "completion"])
def test_streamed_logprobs(server, route):
    """Every token's delta carries its own one-entry logprobs block."""
    body = {"model": "tiny", "max_tokens": 4, "temperature": 0,
            "ignore_eos": True, "stream": True}
    if route == "chat":
        path = "/openai/v1/chat/completions"
        body.update(messages=[{"role": "user", "content": "hi"}],
                    logprobs=True, top_logprobs=2)
    else:
        path = "/openai/v1/completions"
        body.update(prompt="hi", logprobs=2)
    status, _, text = _request(server, "POST", path, body)
    assert status == 200, text
    with_lp = [e["choices"][0]["logprobs"] for e in _events(text)
               if e["choices"][0].get("logprobs")]
    assert len(with_lp) == 4
    offsets = []
    for lp in with_lp:
        if route == "chat":
            (entry,) = lp["content"]
            assert entry["logprob"] <= 0.0 and len(entry["top_logprobs"]) == 2
        else:
            assert len(lp["tokens"]) == 1 and lp["token_logprobs"][0] <= 0.0
            assert 1 <= len(lp["top_logprobs"][0]) <= 3
            offsets.append(lp["text_offset"][0])
    assert offsets == sorted(offsets)


def test_logprobs_beside_a_plain_request(server):
    """A logprobs request and a plain one decode together; the plain one
    grows no logprobs field."""
    import concurrent.futures

    bodies = [{"model": "tiny", "prompt": "aa", "max_tokens": 6,
               "temperature": 0, "ignore_eos": True, "logprobs": 2},
              {"model": "tiny", "prompt": "bb", "max_tokens": 6,
               "temperature": 0, "ignore_eos": True}]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        replies = list(pool.map(
            lambda b: _request(server, "POST", "/openai/v1/completions", b),
            bodies))
    b1, b2 = (json.loads(r[2])["choices"][0] for r in replies)
    assert len(b1["logprobs"]["tokens"]) == 6
    assert "logprobs" not in b2


def test_sampling_penalties_are_served(server):
    """frequency/presence/repetition penalties answer 200 with every token;
    a strong repetition penalty changes the greedy text of a prompt."""
    def text(**kw):
        status, _, body = _request(server, "POST", "/openai/v1/completions", {
            "model": "tiny", "prompt": "hello world", "max_tokens": 12,
            "temperature": 0, "ignore_eos": True, **kw})
        assert status == 200, body
        resp = json.loads(body)
        assert resp["usage"]["completion_tokens"] == 12
        return resp["choices"][0]["text"]

    plain = text()
    assert text(frequency_penalty=0.5, presence_penalty=0.3) is not None
    assert text(repetition_penalty=50.0) != plain


def test_keep_alive_serves_requests_on_one_connection(server):
    """Three requests, one of them streamed, over one HTTPConnection: the
    server keeps the connection (the JAX server's aiohttp stack does)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("GET", "/v2/health/live")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Connection") == "keep-alive"
        assert json.loads(resp.read()) == {"live": True}
        sock = conn.sock
        conn.request("POST", "/openai/v1/chat/completions", body=json.dumps({
            "model": "tiny", "stream": True, "max_tokens": 3, "temperature": 0,
            "ignore_eos": True, "messages": [{"role": "user", "content": "hi"}]}))
        resp = conn.getresponse()
        assert resp.getheader("Transfer-Encoding") == "chunked"
        events = [line for line in resp.read().decode().split("\n")
                  if line.startswith("data: ")]
        assert events[-1] == "data: [DONE]" and len(events) == 1 + 3 + 1
        conn.request("POST", "/openai/v1/completions", body=json.dumps({
            "model": "tiny", "prompt": "x", "max_tokens": 2, "ignore_eos": True}))
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["usage"]["completion_tokens"] == 2
        assert conn.sock is sock  # no reconnect
    finally:
        conn.close()


def _read_response(sock) -> bytes:
    """One response with a Content-Length, read off a raw socket."""
    data = b""
    while b"\r\n\r\n" not in data:
        data += sock.recv(4096)
    head, body = data.split(b"\r\n\r\n", 1)
    length = int([line.split(b":")[1] for line in head.split(b"\r\n")
                  if line.lower().startswith(b"content-length")][0])
    while len(body) < length:
        body += sock.recv(4096)
    return head + b"\r\n\r\n" + body


def test_chunked_request_body_and_connection_close(server):
    body = json.dumps({"model": "tiny", "prompt": "hello world", "max_tokens": 3,
                       "temperature": 0, "ignore_eos": True}).encode()
    chunks = b"".join(b"%x;ext=1\r\n%s\r\n" % (len(body[i:i + 7]), body[i:i + 7])
                      for i in range(0, len(body), 7))
    sock = _raw(server, b"POST /openai/v1/completions HTTP/1.1\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n" + chunks
                + b"0\r\nX-Trailer: 1\r\n\r\n")
    try:
        reply = _read_response(sock)
        assert reply.startswith(b"HTTP/1.1 200 OK")
        assert b"Connection: keep-alive" in reply
        assert json.loads(reply.split(b"\r\n\r\n", 1)[1])["usage"] == {
            "prompt_tokens": 12, "completion_tokens": 3, "total_tokens": 15}
        # the same connection, then Connection: close is honoured
        sock.sendall(b"GET /v2/health/ready HTTP/1.1\r\nConnection: close\r\n\r\n")
        reply = _read_response(sock)
        assert reply.startswith(b"HTTP/1.1 200 OK") and b"Connection: close" in reply
        assert sock.recv(4096) == b""  # the server closed it
    finally:
        sock.close()


@pytest.mark.parametrize("head,status", [
    (b"POST /openai/v1/completions HTTP/1.1\r\n\r\n", 411),
    (b"POST /openai/v1/completions HTTP/1.1\r\nTransfer-Encoding: gzip\r\n\r\n", 501),
    (b"POST /openai/v1/completions HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
     b"zz\r\n", 400),
], ids=["no_length", "gzip", "bad_chunk"])
def test_unreadable_body_answers_and_closes(server, head, status):
    sock = _raw(server, head)
    try:
        reply = _read_response(sock)
        assert reply.startswith(f"HTTP/1.1 {status}".encode())
        assert b"Connection: close" in reply and sock.recv(4096) == b""
    finally:
        sock.close()


def test_idle_connection_times_out():
    import asyncio

    from kserve_tpu_torch.model_repository import ModelRepository
    from kserve_tpu_torch.protocol.rest.server import RESTServer

    async def run():
        rest = RESTServer(ModelRepository(), host="127.0.0.1", port=0, idle_timeout=0.2)
        port = await rest.start()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /v2/health/live HTTP/1.1\r\n\r\n")
            head = await reader.readuntil(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200") and b"keep-alive" in head
            await reader.readexactly(len(b'{"live": true}'))
            # idle past the timeout: the server closes the connection
            assert await asyncio.wait_for(reader.read(), timeout=5) == b""
            writer.close()
        finally:
            await rest.stop()
        # an idle kept-alive connection does not hold up stop()
        rest = RESTServer(ModelRepository(), host="127.0.0.1", port=0, idle_timeout=600)
        port = await rest.start()
        reader, idle = await asyncio.open_connection("127.0.0.1", port)
        idle.write(b"GET /v2/health/live HTTP/1.1\r\n\r\n")
        await reader.readuntil(b"\r\n\r\n")
        await asyncio.wait_for(rest.stop(), timeout=5)
        idle.close()

    asyncio.run(run())
