"""The lifecycle and resilience gates of the PyTorch port's standard-library
server.

First against the JAX server (aiohttp, in process) on the same scenarios,
with stub models: readiness and liveness while draining, the drain gate,
the shed gate, the deadline gate and their order, and /admin/drain, each
answering with the JAX server's status, Retry-After and body keys.  Then
on a real tiny model on the CPU, over sockets: a drain mid-stream ends
the SSE stream on the checkpoint event without [DONE], a non-streamed
request gets 503 with the checkpoint in header and body, both resume on a
second server through the x-generation-checkpoint header and splice into
its uninterrupted stream, a malformed checkpoint answers 400, a
checkpoint header past 64 KiB is read, x-request-deadline: 0 answers
504, a queue past the watermark answers 429, and the scheduler state's
keys are the JAX server's, less the peer fabric's."""

import asyncio
import http.client
import json
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from kserve_tpu import lifecycle as jlc
from kserve_tpu import resilience as jres
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch import lifecycle as tlc
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.metrics import SHED_REQUESTS
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.model_repository import ModelRepository as PortRepository
from kserve_tpu_torch.protocol.rest.server import MAX_HEAD_BYTES, RESTServer
from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model

# ---------------- the gates against the JAX server ----------------

COMPLETION = {"model": "dummy", "prompt": "x", "max_tokens": 2}
# name: (lifecycle state, queue depth, method, path, headers)
GATES = {
    "ready_starting": ("STARTING", 0, "GET", "/v2/health/ready", {}),
    "ready_ready": ("READY", 0, "GET", "/v2/health/ready", {}),
    "ready_draining": ("DRAINING", 0, "GET", "/v2/health/ready", {}),
    "live_draining": ("DRAINING", 0, "GET", "/v2/health/live", {}),
    "metrics_draining": ("DRAINING", 0, "GET", "/metrics", {}),
    "post_draining": ("DRAINING", 0, "POST", "/openai/v1/completions", {}),
    "post_terminating": ("TERMINATING", 0, "POST", "/openai/v1/completions", {}),
    "deadline_zero": ("READY", 0, "POST", "/openai/v1/completions",
                      {"x-request-deadline": "0"}),
    "deadline_negative": ("READY", 0, "POST", "/openai/v1/completions",
                          {"x-request-deadline": "-1.5"}),
    "shed": ("READY", 9, "POST", "/openai/v1/completions", {}),
    "shed_before_deadline": ("READY", 9, "POST", "/openai/v1/completions",
                             {"x-request-deadline": "0"}),
    "drain_before_shed": ("DRAINING", 9, "POST", "/openai/v1/completions",
                          {"x-request-deadline": "0"}),
    "shed_spares_get": ("READY", 9, "GET", "/v2/health/ready", {}),
    "drain_get": ("READY", 0, "GET", "/admin/drain", {}),
    "drain_post": ("READY", 0, "POST", "/admin/drain", {}),
    "drain_prestop": ("READY", 0, "GET", "/admin/drain?source=prestop", {}),
    "drain_get_while_draining": ("DRAINING", 0, "GET", "/admin/drain", {}),
}


def _lifecycle(pkg, clock_cls, state):
    lc = pkg.ReplicaLifecycle(clock=clock_cls(), drain_grace_s=20.0)
    if state != "STARTING":
        lc.mark_ready()
    if state in ("DRAINING", "TERMINATING"):
        lc.begin_drain()
    if state == "TERMINATING":
        lc.finish_drain()
    return lc


async def _jax_gate(state, depth, method, path, headers):
    from aiohttp.test_utils import TestClient, TestServer

    from kserve_tpu.model import Model
    from kserve_tpu.model_repository import ModelRepository
    from kserve_tpu.protocol.model_repository_extension import ModelRepositoryExtension
    from kserve_tpu.protocol.openai.dataplane import OpenAIDataPlane
    from kserve_tpu.protocol.rest.server import RESTServer as JaxRESTServer

    class Stub(Model):
        def __init__(self):
            super().__init__("dummy")
            self.ready = True
            self.engine = SimpleNamespace(queue_depth=depth)

    repo = ModelRepository()
    repo.update(Stub())
    lc = _lifecycle(jlc, jres.FakeClock, state)
    drains = []

    async def on_drain():
        drains.append(1)

    server = JaxRESTServer(OpenAIDataPlane(repo), ModelRepositoryExtension(repo),
                           shed_config=jres.ShedConfig(queue_watermark=4),
                           lifecycle=lc, on_drain=on_drain)
    client = TestClient(TestServer(server.create_application()))
    async with client:
        kw = {"json": COMPLETION} if method == "POST" else {}
        res = await client.request(method, path, headers=headers, **kw)
        body = await res.read()
        await asyncio.sleep(0)
        return _view(res.status, res.headers.get("Retry-After"), body, lc, drains)


async def _port_gate(state, depth, method, path, headers):
    lc = _lifecycle(tlc, tres.FakeClock, state)
    drains = []

    async def on_drain():
        drains.append(1)

    stub = SimpleNamespace(name="dummy", ready=True,
                           engine=SimpleNamespace(queue_depth=depth))
    server = RESTServer(PortRepository({"dummy": stub}), "127.0.0.1", 0, lifecycle=lc,
                        on_drain=on_drain,
                        shed_config=tres.ShedConfig(queue_watermark=4))
    port = await server.start()
    try:
        data = json.dumps(COMPLETION).encode() if method == "POST" else b""
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        head = [f"{method} {path} HTTP/1.1", f"Content-Length: {len(data)}",
                "Connection: close"] + [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + data)
        raw = await reader.read()
        writer.close()
        status, hdrs, body = _parse(raw)
        await asyncio.sleep(0)
        return _view(status, hdrs.get("retry-after"), body, lc, drains)
    finally:
        await server.stop()


def _parse(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split(" ")[1]), headers, body


def _view(status, retry_after, body, lc, drains):
    """What both servers must agree on: the status, Retry-After, the JSON
    body's keys (and its lifecycle/ready/live values), and the lifecycle
    state and drain calls after the request."""
    try:
        obj = json.loads(body)
    except ValueError:
        obj = None
    shown = None
    if isinstance(obj, dict):
        shown = {k: (v if k in ("lifecycle", "ready", "live") else type(v).__name__)
                 for k, v in obj.items()}
    return status, retry_after, shown, lc.state, len(drains)


@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_matches_jax_server(gate):
    state, depth, method, path, headers = GATES[gate]
    got = asyncio.run(_port_gate(state, depth, method, path, headers))
    want = asyncio.run(_jax_gate(state, depth, method, path, headers))
    assert got == want


def test_preempted_503_carries_the_checkpoint():
    """GenerationPreempted from a non-streamed handler: 503 + Retry-After,
    the checkpoint in the body, and in the header only while it fits
    CHECKPOINT_HEADER_SAFE_BYTES (the JAX server's rule)."""
    small = tlc.GenerationCheckpoint(request_id="s", prompt_ids=[1], generated=[2])
    big = tlc.GenerationCheckpoint(request_id="b", prompt_ids=list(range(10_000)))
    assert len(big.to_header()) > tlc.CHECKPOINT_HEADER_SAFE_BYTES
    current = {}

    async def create_completion(req, headers=None):
        raise tlc.GenerationPreempted(current["ckpt"])

    stub = SimpleNamespace(name="dummy", ready=True,
                           create_completion=create_completion)

    async def main():
        server = RESTServer(PortRepository({"dummy": stub}), "127.0.0.1", 0)
        port = await server.start()
        out = []
        try:
            for ckpt in (small, big):
                current["ckpt"] = ckpt
                data = json.dumps(COMPLETION).encode()
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(b"POST /openai/v1/completions HTTP/1.1\r\nConnection: "
                             b"close\r\nContent-Length: %d\r\n\r\n" % len(data) + data)
                out.append(_parse(await reader.read()))
                writer.close()
        finally:
            await server.stop()
        return out

    (s_status, s_head, s_body), (b_status, b_head, b_body) = asyncio.run(main())
    assert s_status == b_status == 503
    assert s_head["retry-after"] == b_head["retry-after"] == "1"
    assert s_head[tlc.CHECKPOINT_HEADER] == small.to_header()
    assert tlc.CHECKPOINT_HEADER not in b_head
    assert json.loads(s_body)["checkpoint"] == small.to_dict()
    assert json.loads(b_body)["checkpoint"] == big.to_dict()


# ---------------- a real tiny model over sockets ----------------

ARGS = ["--model_config=tiny", "--random_weights", "--device=cpu",
        "--kv_dtype=float32", "--http_port=0", "--max_model_len=256",
        "--kv_pages=128", "--max_prefill_len=64"]


def _serve(name, extra=(), grace=None):
    model = build_model(build_arg_parser().parse_args(
        ARGS + [f"--model_name={name}", *extra]))
    lc = tlc.ReplicaLifecycle(drain_grace_s=grace) if grace is not None else None
    srv = ModelServer(http_port=0, host="127.0.0.1", lifecycle=lc)
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60), "server did not start"
    srv.model, srv.thread = model, thread
    return srv


@pytest.fixture(scope="module")
def servers():
    """A: drains with a zero budget (checkpoints at once); B: the healthy
    replica, one slot, so a second request queues."""
    a = _serve("tiny", grace=0.0)
    b = _serve("tiny", ["--max_batch_size=1"])
    yield a, b
    for srv in (a, b):
        srv.request_stop()
        srv.thread.join(30)
        assert not srv.thread.is_alive()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


def _open_stream(port, body, headers=None):
    """A streamed POST: (connection, response) once its first event came."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/openai/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
    return conn, conn.getresponse()


def _events(resp, first=None):
    out = [] if first is None else [first]
    while True:
        line = resp.readline()
        if not line:
            return out
        line = line.decode().strip()
        if line.startswith("data: "):
            out.append(line[len("data: "):])


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition not reached")


# long enough that A's drain (zero budget) lands mid-stream: it comes
# after some 16 tokens
MAX_TOKENS = 64
STREAM_BODY = {"model": "tiny", "prompt": "resume me", "max_tokens": MAX_TOKENS,
               "temperature": 0, "ignore_eos": True, "stream": True}
PLAIN_BODY = {"model": "tiny", "prompt": "and me too", "max_tokens": MAX_TOKENS,
              "temperature": 0, "ignore_eos": True}


@pytest.fixture(scope="module")
def drained(servers):
    """Drain A with a stream and a non-streamed request in flight."""
    a, _ = servers
    conn, resp = _open_stream(a.port, STREAM_BODY)
    first = None
    while first is None:
        line = resp.readline().decode().strip()
        if line.startswith("data: "):
            first = line[len("data: "):]
    plain = {}
    t = threading.Thread(target=lambda: plain.update(
        r=_request(a.port, "POST", "/openai/v1/completions", PLAIN_BODY)))
    t.start()
    _wait(lambda: a.model.engine.scheduler_state()["inflight"] == 2)
    drain = _request(a.port, "POST", "/admin/drain")
    events = _events(resp, first)
    conn.close()
    t.join(60)
    return {"drain": drain, "events": events, "plain": plain["r"]}


def test_mid_stream_drain_ends_on_the_checkpoint_event(servers, drained):
    a, _ = servers
    status, _, body = drained["drain"]
    assert status == 200 and json.loads(body)["lifecycle"] in ("DRAINING",
                                                               "TERMINATING")
    events = drained["events"]
    assert "[DONE]" not in events
    last = json.loads(events[-1])
    assert last["error"]["type"] == "generation_preempted"
    ckpt = tlc.GenerationCheckpoint.from_header(last["checkpoint"])
    assert ckpt.model_name == "tiny" and ckpt.reason == "drain"
    assert len(ckpt.generated) == len(events) - 1 >= 1
    # while draining: readiness red, liveness green, new work 503
    _wait(lambda: a.lifecycle.state == "TERMINATING")
    status, _, body = _request(a.port, "GET", "/v2/health/ready")
    assert status == 503 and json.loads(body) == {"ready": False,
                                                  "lifecycle": "TERMINATING"}
    assert _request(a.port, "GET", "/v2/health/live")[0] == 200
    status, headers, _ = _request(a.port, "POST", "/openai/v1/completions",
                                  PLAIN_BODY)
    assert status == 503 and headers["Retry-After"] == "1"
    assert a.model.engine.checkpointed_count == 2


def test_non_streamed_request_gets_503_with_the_checkpoint(drained):
    status, headers, body = drained["plain"]
    assert status == 503 and headers["Retry-After"] == "1"
    ckpt = json.loads(body)["checkpoint"]
    assert tlc.GenerationCheckpoint.from_header(
        headers[tlc.CHECKPOINT_HEADER]).to_dict() == ckpt
    assert ckpt["prompt_ids"] and ckpt["sampling"]["max_tokens"] == MAX_TOKENS


def test_header_resume_splices(servers, drained):
    """Both checkpoints resume on B: the streamed one sends only the
    continuation, which spliced after the tokens A sent equals B's
    uninterrupted text; the non-streamed one answers with the whole text."""
    _, b = servers
    last = json.loads(drained["events"][-1])
    shown = "".join(json.loads(e)["choices"][0]["text"]
                    for e in drained["events"][:-1])
    conn, resp = _open_stream(b.port, STREAM_BODY,
                              {tlc.CHECKPOINT_HEADER: last["checkpoint"]})
    events = _events(resp)
    conn.close()
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert chunks[-1]["finish_reason"] == "length"
    ckpt = tlc.GenerationCheckpoint.from_header(last["checkpoint"])
    assert len(chunks) == MAX_TOKENS - len(ckpt.generated)
    want = json.loads(_request(b.port, "POST", "/openai/v1/completions",
                               dict(STREAM_BODY, stream=False))[2])
    assert shown + "".join(c["text"] for c in chunks) == want["choices"][0]["text"]
    plain = json.loads(drained["plain"][2])["checkpoint"]
    header = tlc.GenerationCheckpoint.from_dict(plain).to_header()
    status, _, body = _request(b.port, "POST", "/openai/v1/completions",
                               PLAIN_BODY, {tlc.CHECKPOINT_HEADER: header})
    assert status == 200
    got = json.loads(body)
    want = json.loads(_request(b.port, "POST", "/openai/v1/completions",
                               PLAIN_BODY)[2])
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    assert b.model.engine.resume_count == 2


def test_bad_checkpoints_answer_400(servers):
    _, b = servers
    base = dict(request_id="x", prompt_ids=[1, 2, 3], generated=[4],
                sampling={"max_tokens": 8}, model_name="tiny")
    for over in ({"prompt_ids": [1, "2"]}, {"model_name": "other"},
                 {"generated": list(range(8))}, {"prompt_ids": [1, 99999]},
                 {"adapter": "sql-lora"}):
        header = tlc.GenerationCheckpoint.from_dict(dict(base, **over)).to_header()
        status, _, body = _request(b.port, "POST", "/openai/v1/completions",
                                   PLAIN_BODY, {tlc.CHECKPOINT_HEADER: header})
        assert status == 400 and "cannot resume from checkpoint" in body, over
    # n > 1, and a non-streamed resume asking for logprobs
    header = tlc.GenerationCheckpoint.from_dict(base).to_header()
    for body in (dict(PLAIN_BODY, n=2), dict(PLAIN_BODY, logprobs=2)):
        assert _request(b.port, "POST", "/openai/v1/completions", body,
                        {tlc.CHECKPOINT_HEADER: header})[0] == 400


def test_large_checkpoint_header_is_read(servers):
    """A checkpoint header past the old 64 KiB head limit reaches the
    handler (which refuses this one for its length), and a head past
    MAX_HEAD_BYTES is refused before any handler."""
    _, b = servers
    big = tlc.GenerationCheckpoint(request_id="big", prompt_ids=[7] * 40_000,
                                   sampling={"max_tokens": 8}, model_name="tiny")
    header = big.to_header()
    assert 1 << 16 < len(header) < tlc.CHECKPOINT_FIELD_SIZE_LIMIT
    status, _, body = _request(b.port, "POST", "/openai/v1/completions",
                               PLAIN_BODY, {tlc.CHECKPOINT_HEADER: header})
    assert status == 400 and "max_model_len" in body
    status, _, body = _request(b.port, "POST", "/openai/v1/completions", PLAIN_BODY,
                               {tlc.CHECKPOINT_HEADER: "A" * MAX_HEAD_BYTES})
    assert status == 400 and "too large" in body


def test_deadline_and_shedding(servers):
    """x-request-deadline: 0 answers 504 before handling; with one slot
    busy and one request queued, a POST past a watermark of 1 answers
    429 with Retry-After, counted in the scheduler state and the metric."""
    _, b = servers
    assert _request(b.port, "POST", "/openai/v1/completions", PLAIN_BODY,
                    {"x-request-deadline": "0"})[0] == 504
    engine = b.model.engine
    conn, resp = _open_stream(b.port, STREAM_BODY)
    resp.readline()
    # hold the seated stream's next dispatch, so the slot stays busy and
    # the next request stays queued however fast the stream would finish
    gate = threading.Event()
    dispatch = engine._dispatch
    engine._dispatch = lambda plan: (gate.wait(60), dispatch(plan))[1]
    queued = {}
    t = threading.Thread(target=lambda: queued.update(
        r=_request(b.port, "POST", "/openai/v1/completions",
                   dict(PLAIN_BODY, max_tokens=4))))
    try:
        t.start()
        _wait(lambda: engine.queue_depth == 1)
        shed_before = SHED_REQUESTS.labels(component="rest").get()
        b.rest.shedder.config.queue_watermark = 1
        status, headers, _ = _request(b.port, "POST", "/openai/v1/completions",
                                      PLAIN_BODY)
        state = json.loads(_request(b.port, "GET", "/v1/internal/scheduler/state")[2])
    finally:
        b.rest.shedder.config.queue_watermark = 256
        engine._dispatch = dispatch
        gate.set()
    conn.close()
    t.join(60)
    assert status == 429 and headers["Retry-After"] == "1"
    assert state["shed"]["count"] >= 1 and state["queue_depth"] == 1
    assert SHED_REQUESTS.labels(component="rest").get() - shed_before == 1
    assert queued["r"][0] == 200


def _keys(obj):
    if not isinstance(obj, dict):
        return None
    return {k: _keys(v) for k, v in obj.items()}


def test_scheduler_state_keys_match_jax(servers):
    """The served state's keys, each engine's included (watchdog and spec
    blocks on), equal the JAX server's for the same config, less the peer
    fabric's `peer_pages` and `peer`."""
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    # the keys do not depend on the weights: zeros of the JAX init's shapes
    jparams = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jl.init_params(jcfg, jax.random.PRNGKey(0))))
    cfg = dict(max_batch_size=2, page_size=8, num_pages=32, max_pages_per_seq=8,
               max_prefill_len=16, prefill_buckets=(16,), dtype="float32",
               watchdog=True, spec_decode_k=2)
    jengine = jeng.LLMEngine(jcfg, jeng.EngineConfig(use_pallas=False, **cfg),
                             JaxByteTokenizer(512), params=jparams)
    tengine = LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512),
                        params=tl.params_from_jax(jparams, tcfg, device="cpu"),
                        device="cpu")
    want = _keys(jengine.scheduler_state())
    want.pop("peer_pages", None)
    want.pop("peer", None)
    assert _keys(tengine.scheduler_state()) == want
    _, b = servers
    served = json.loads(_request(b.port, "GET", "/v1/internal/scheduler/state")[2])
    assert set(served) == {"queue_depth", "inflight", "free_pages", "models",
                           "lifecycle", "shed", "telemetry"}
    assert set(served["shed"]) == {"count", "shedding"}
    assert set(served["telemetry"]) == {"ttft_p99_s", "itl_p99_s"}
    assert served["lifecycle"] == "READY"
    assert served["free_pages"] == b.model.engine.allocator.free_pages
    assert set(served["models"]["tiny"]) == set(
        b.model.engine.scheduler_state()) >= {"queue_depth", "inflight", "telemetry"}
