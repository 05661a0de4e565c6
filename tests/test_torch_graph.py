"""The port's graph router (graph/router.py), REST inference client
(inference_client.py), transformer forwarding (model.py) and trace
context (tracing.py) against the JAX package's on the CPU.

The router: eval_condition over a table of cases; Sequence ($request /
$response), Splitter (weights, open breakers left out), Ensemble (merged,
failed members named), Switch, nested nodes, soft and hard dependencies,
retries, and the client errors' statuses (a timeout before sending 504
and retried, after sending 504 and not retried, a refused connection
502, another transport failure 503), each case run through both routers
over in-memory backends with the same outcome and call count; the
per-backend breaker's 502s then instant 503s; the HTTP surface (POST /,
GET /healthz, 400 on a body that is not JSON) beside the JAX router's;
`x-request-deadline: 0` answering 504 before any call and the budget
decremented per hop; each step's `traceparent` a child of the caller's
trace.  The client: retries under the policy (Retry-After, checkpoints
carried, one trace per request), its URLs against the JAX client's, and
V1, V2 (JSON and binary) and explain forwarded by a transformer `Model`
to a port server on the CPU, equal to the direct answers."""

import asyncio
import json

import httpx
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from kserve_tpu import inference_client as jclient_mod
from kserve_tpu.graph import router as jrouter
from kserve_tpu.resilience import FakeClock as JFakeClock
from kserve_tpu.tracing import TraceContext as JTraceContext
from kserve_tpu_torch import metrics, tracing
from kserve_tpu_torch.errors import InferenceError
from kserve_tpu_torch.graph import router as trouter
from kserve_tpu_torch.infer_type import InferInput, InferRequest, InferResponse
from kserve_tpu_torch.inference_client import InferenceRESTClient, RESTConfig
from kserve_tpu_torch.lifecycle import CHECKPOINT_HEADER, GenerationCheckpoint
from kserve_tpu_torch.model import Model, PredictorConfig
from kserve_tpu_torch.model_repository import ModelRepository
from kserve_tpu_torch.protocol import http_client as hc
from kserve_tpu_torch.protocol.rest.server import RESTServer
from kserve_tpu_torch.resilience import FakeClock, RetryPolicy

# ---------------- eval_condition ----------------

CONDITIONS = [
    ("class==cat", {"class": "cat"}), ("class==dog", {"class": "cat"}),
    ("pred.0.score==0.9", {"pred": [{"score": 0.9}]}), ("pred.1.score==0.9", {"pred": [{}]}),
    ("pred.x==1", {"pred": [1]}), ("instances", {"instances": []}), ("missing", {}),
    ("", {}), ("flag==TRUE", {"flag": True}), ("flag==false", {"flag": True}),
    ("n==3", {"n": 3}), ("n==3.0", {"n": 3}), ("n==abc", {"n": 3}),
    ('name=="bob"', {"name": "bob"}), (" a.b == x ", {"a": {"b": "x"}}),
    ("a.b", {"a": "str"}), ("a==", {"a": ""}), ("a==None", {"a": None}),
]


@pytest.mark.parametrize("condition,payload", CONDITIONS, ids=range(len(CONDITIONS)))
def test_eval_condition_matches_jax(condition, payload):
    assert trouter.eval_condition(condition, payload) == jrouter.eval_condition(
        condition, payload)


# ---------------- node semantics, both routers ----------------

# a backend: body -> (status, payload[, headers]) or a fault name
FAULTS = ("connect", "connect_timeout", "read_timeout", "broken")


def _jax_router(nodes, backends, retries, calls, clock):
    raising = {"connect": httpx.ConnectError, "connect_timeout": httpx.ConnectTimeout,
               "read_timeout": httpx.ReadTimeout, "broken": httpx.RemoteProtocolError}

    class Transport(httpx.AsyncBaseTransport):
        async def handle_async_request(self, request):
            host = request.url.host
            calls.append((host, dict(request.headers)))
            out = backends[host](json.loads(request.content))
            if isinstance(out, str):
                raise raising[out]("injected", request=request)
            status, payload, *headers = out
            return httpx.Response(status, json=payload, headers=(headers or [{}])[0])

    client = httpx.AsyncClient(transport=Transport())
    return jrouter.GraphRouter({"nodes": nodes}, retries=retries, client=client, clock=clock)


def _port_router(nodes, backends, retries, calls, clock, **kw):
    raising = {"connect": hc.ConnectError, "connect_timeout": hc.ConnectTimeout,
               "read_timeout": hc.ReadTimeout, "broken": hc.ReadError}

    async def transport(method, url, headers, body):
        host = url.split("/")[2]
        calls.append((host, dict(headers)))
        out = backends[host](json.loads(body))
        if isinstance(out, str):
            raise raising[out]("injected")
        status, payload, *headers_out = out
        # compact, as httpx writes json= bodies (the message quotes them)
        return hc.Response(status, {k.lower(): v for k, v in (headers_out or [{}])[0].items()},
                           json.dumps(payload, separators=(",", ":")).encode())

    return trouter.GraphRouter({"nodes": nodes}, retries=retries,
                               client=hc.AsyncHTTPClient(transport), clock=clock, **kw)


def _outcome(router, payload, runs=1):
    async def main():
        out = []
        for _ in range(runs):
            try:
                out.append(("ok", await router.execute_node("root", payload, {})))
            except (jrouter.GraphExecutionError, trouter.GraphExecutionError) as e:
                # a transport failure's message ends in the client's own text
                out.append(("error", e.status, str(e).split(": injected")[0]))
        return out
    return asyncio.run(main())


def _seq(*steps):
    return {"root": {"routerType": "Sequence", "steps": list(steps)}}


OK_A = {"a": lambda b: (200, {"stage": "a", "got": b}), "b": lambda b: (200, {"stage": "b", "got": b})}
CASES = {
    "sequence_pipes": (_seq({"serviceName": "a", "name": "m"},
                            {"serviceName": "b", "name": "m", "data": "$response"}), OK_A, 0),
    "sequence_request": (_seq({"serviceName": "a", "name": "m"},
                              {"serviceName": "b", "name": "m", "data": "$request"}), OK_A, 0),
    "service_url": (_seq({"serviceUrl": "http://a/v2/models/x/infer"}), OK_A, 0),
    "ensemble": ({"root": {"routerType": "Ensemble", "steps": [
        {"serviceName": "a", "name": "first"}, {"serviceName": "b"}, {"serviceUrl": "http://a/p"}]}},
        OK_A, 0),
    "ensemble_member_fails": ({"root": {"routerType": "Ensemble", "steps": [
        {"serviceName": "a", "name": "first"}, {"serviceName": "bad", "name": "second"}]}},
        dict(OK_A, bad=lambda b: (500, {"error": "boom"})), 0),
    "switch_dog": ({"root": {"routerType": "Switch", "steps": [
        {"serviceName": "a", "name": "m", "condition": "kind==cat"},
        {"serviceName": "b", "name": "m", "condition": "kind==dog"}]}}, OK_A, 0),
    "switch_none": ({"root": {"routerType": "Switch", "steps": [
        {"serviceName": "a", "name": "m", "condition": "kind==bird"}]}}, OK_A, 0),
    "splitter_weights": ({"root": {"routerType": "Splitter", "steps": [
        {"serviceName": "a", "name": "m", "weight": 100},
        {"serviceName": "b", "name": "m", "weight": 0}]}}, OK_A, 0),
    "splitter_no_weight": ({"root": {"routerType": "Splitter", "steps": [
        {"serviceName": "a", "name": "m"}]}}, OK_A, 0),
    "nested": ({"root": {"routerType": "Sequence", "steps": [{"nodeName": "inner"}]},
                "inner": _seq({"serviceName": "a", "name": "m"})["root"]}, OK_A, 0),
    "missing_node": (_seq({"nodeName": "nope"}), OK_A, 0),
    "unknown_type": ({"root": {"routerType": "Bogus"}}, OK_A, 0),
    "no_service": (_seq({"name": "m"}), OK_A, 0),
    "soft_then_good": (_seq({"serviceName": "bad", "name": "m", "dependency": "Soft"},
                            {"serviceName": "b", "name": "m"}),
                       dict(OK_A, bad=lambda b: (500, {"error": "boom"})), 1),
    "hard_fails": (_seq({"serviceName": "bad", "name": "m"}),
                   dict(bad=lambda b: (500, {"error": "boom"})), 1),
    "client_fault_400": (_seq({"serviceName": "bad", "name": "m"}),
                         dict(bad=lambda b: (400, {"error": "no"})), 2),
    "retry_503": (_seq({"serviceName": "flaky", "name": "m"}), None, 2),
    **{f"fault_{f}": (_seq({"serviceName": "dead", "name": "dead-step"}),
                      {"dead": (lambda f: lambda b: f)(f)}, 2) for f in FAULTS},
}


def _backends(name, backends):
    if name != "retry_503":
        return backends
    state = {"n": 0}

    def flaky(body):
        state["n"] += 1
        if state["n"] == 1:
            return 503, {"error": "busy"}, {"Retry-After": "0"}
        return 200, {"finally": body}
    return {"flaky": flaky}


@pytest.mark.parametrize("name", sorted(CASES))
def test_nodes_match_the_jax_router(name):
    nodes, backends, retries = CASES[name]
    payload = {"kind": "dog", "x": 1}
    jcalls, tcalls = [], []
    jclock, tclock = JFakeClock(), FakeClock()
    want = _outcome(_jax_router(nodes, _backends(name, backends), retries, jcalls, jclock),
                    payload)
    before = metrics.RETRY_ATTEMPTS.labels(component="graph").get()
    got = _outcome(_port_router(nodes, _backends(name, backends), retries, tcalls, tclock),
                   payload)
    assert got == want
    assert [h for h, _ in tcalls] == [h for h, _ in jcalls]
    assert (metrics.RETRY_ATTEMPTS.labels(component="graph").get() - before
            == len(jclock.sleeps) == len(tclock.sleeps))


def test_breaker_opens_and_splitter_routes_around_it():
    """A dead backend: 502 naming the step until the breaker's volume
    (5), then the instant 503 "circuit open" with no call; a splitter
    then picks only the live step."""
    dead = {"dead": lambda b: "connect", "a": lambda b: (200, {"svc": "a"})}
    seq = _seq({"serviceName": "dead", "name": "dead-step"})
    split = {"root": {"routerType": "Splitter", "steps": [
        {"serviceName": "dead", "name": "m", "weight": 99},
        {"serviceName": "a", "name": "m", "weight": 1}]}}
    results = []
    for make, clock in ((_jax_router, JFakeClock()), (_port_router, FakeClock())):
        calls = []
        router = make(seq, dead, 0, calls, clock)
        outs = _outcome(router, {}, runs=7)
        n_calls = len(calls)
        router.nodes = split
        picks = _outcome(router, {}, runs=5)
        results.append((outs, n_calls, picks))
    assert results[1] == results[0]
    outs, n_calls, picks = results[1]
    assert [o[1] for o in outs] == [502] * 5 + [503] * 2 and n_calls == 5
    assert "circuit open for backend dead" in outs[-1][2]
    assert picks == [("ok", {"svc": "a"})] * 5


# ---------------- the HTTP surface ----------------


async def _port_call(port, method, path, body=None, headers=None):
    client = hc.AsyncHTTPClient()
    try:
        raw = b"" if body is None else (body if isinstance(body, bytes)
                                         else json.dumps(body).encode())
        res = await client.request(method, f"http://127.0.0.1:{port}{path}",
                                   dict(headers or {}), raw)
        return res.status, json.loads(bytes(res.body)), res.headers
    finally:
        await client.aclose()


SURFACE = [("POST", "/", {"x": 1}), ("POST", "/", b"not json"), ("GET", "/healthz", None),
           ("POST", "/", {"fail": True})]


def test_http_surface_matches_the_jax_router():
    def backend(body):
        return (500, {"error": "boom"}) if body.get("fail") else (200, {"ok": True, "got": body})

    nodes = _seq({"serviceName": "a", "name": "m"})

    async def main():
        jr = _jax_router(nodes, {"a": backend}, 0, [], JFakeClock())
        tr = _port_router(nodes, {"a": backend}, 0, [], FakeClock(), host="127.0.0.1", port=0)
        port = await tr.start()
        out = []
        try:
            async with TestClient(TestServer(jr.create_application())) as jc:
                for method, path, body in SURFACE:
                    data = body if isinstance(body, bytes) else json.dumps(body).encode()
                    res = await jc.request(method, path, data=None if body is None else data)
                    want = (res.status, json.loads(await res.read()))
                    got = await _port_call(port, method, path, body)
                    out.append((path, want, got[:2]))
        finally:
            await tr.stop()
        return out

    for path, want, got in asyncio.run(main()):
        assert got == want, path


def test_deadline_and_trace_per_hop():
    """`x-request-deadline: 0` -> 504 before any call; otherwise each step
    carries the remaining budget and a child traceparent of the caller's
    trace (a fresh span per step), and the answer echoes x-request-id."""
    calls = []
    nodes = _seq({"serviceName": "a", "name": "m"}, {"serviceName": "b", "name": "m"})

    async def main():
        router = _port_router(nodes, OK_A, 0, calls, FakeClock(), host="127.0.0.1", port=0)
        port = await router.start()
        try:
            expired = await _port_call(port, "POST", "/", {"x": 1},
                                       {"x-request-deadline": "0", "x-request-id": "r0"})
            n_after_expired = len(calls)
            caller = tracing.TraceContext.new_root()
            ok = await _port_call(port, "POST", "/", {"x": 1}, {
                "x-request-deadline": "5", "traceparent": caller.to_header(),
                "x-request-id": "rid-7"})
            fresh = await _port_call(port, "POST", "/", {"x": 1})
        finally:
            await router.stop()
        return expired, n_after_expired, caller, ok, fresh

    expired, n_after_expired, caller, ok, fresh = asyncio.run(main())
    assert expired[0] == 504 and "request deadline exceeded" in expired[1]["error"]
    assert n_after_expired == 0 and expired[2]["x-request-id"] == "r0"
    assert ok[0] == 200 and ok[2]["x-request-id"] == "rid-7"
    hops = [h for _, h in calls[:2]]
    ctxs = [tracing.TraceContext.parse(h["traceparent"]) for h in hops]
    assert all(c.trace_id == caller.trace_id for c in ctxs)
    assert len({caller.span_id, *(c.span_id for c in ctxs)}) == 3
    assert all(0 < float(h["x-request-deadline"]) <= 5.0 for h in hops)
    assert all(h["x-request-id"] == "rid-7" for h in hops)
    # no caller trace: the router starts one, shared by both steps
    roots = {tracing.TraceContext.parse(h["traceparent"]).trace_id for _, h in calls[2:]}
    assert len(roots) == 1 and fresh[2]["x-request-id"].startswith("req-")


TRACEPARENTS = ["00-" + "a" * 32 + "-" + "b" * 16 + "-01", "00-" + "a" * 32 + "-" + "b" * 16,
                "00-" + "0" * 32 + "-" + "b" * 16 + "-01", "00-xyz-" + "b" * 16 + "-01",
                "0-" + "a" * 32 + "-" + "b" * 16 + "-01", "", None,
                " 00-" + "A" * 32 + "-" + "b" * 16 + "-00 ", "00-" + "a" * 32 + "-" + "b" * 16 + "-"]


@pytest.mark.parametrize("header", TRACEPARENTS, ids=range(len(TRACEPARENTS)))
def test_traceparent_parse_matches_jax(header):
    want = JTraceContext.parse(header)
    got = tracing.TraceContext.parse(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id, got.flags, got.to_header()) == (
            want.trace_id, want.span_id, want.flags, want.to_header())


# ---------------- the REST client ----------------


def _client(responses, calls, retries=3, protocol="v1"):
    """A client over an in-memory transport answering `responses` in turn
    (a status tuple, or an exception to raise)."""
    it = iter(responses)

    async def transport(method, url, headers, body):
        calls.append((url, dict(headers), bytes(body)))
        out = next(it)
        if isinstance(out, Exception):
            raise out
        status, payload, headers_out = out
        return hc.Response(status, headers_out, json.dumps(payload).encode())

    return InferenceRESTClient(RESTConfig(transport=transport, retries=retries,
                                          protocol=protocol, clock=FakeClock()))


def test_client_retries_under_one_trace_and_carries_the_checkpoint():
    ckpt = GenerationCheckpoint(request_id="r", prompt_ids=[1, 2], generated=[3])
    calls = []
    client = _client([(503, {"error": "draining", "checkpoint": ckpt.to_dict()},
                       {"retry-after": "2"}),
                      hc.ConnectError("refused"),
                      (200, {"predictions": [1]}, {})], calls)
    before = metrics.RETRY_ATTEMPTS.labels(component="rest").get()
    out = asyncio.run(client.infer("http://h:1", {"instances": [[1]]}, model_name="m"))
    assert out == {"predictions": [1]}
    assert metrics.RETRY_ATTEMPTS.labels(component="rest").get() - before == 2
    assert [c[0] for c in calls] == ["http://h:1/v1/models/m:predict"] * 3
    ctxs = [tracing.TraceContext.parse(c[1]["traceparent"]) for c in calls]
    assert len({c.trace_id for c in ctxs}) == 1 and len({c.span_id for c in ctxs}) == 3
    assert CHECKPOINT_HEADER not in calls[0][1]
    assert calls[2][1][CHECKPOINT_HEADER] == ckpt.to_header()
    assert client._clock.sleeps[0] >= 2.0  # Retry-After floors the backoff


def test_client_errors():
    calls = []
    # a timeout after sending is not retried; an error status is raised
    with pytest.raises(hc.ReadTimeout):
        asyncio.run(_client([hc.ReadTimeout("slow")], calls).infer(
            "http://h:1", {"instances": []}, model_name="m"))
    assert len(calls) == 1
    with pytest.raises(InferenceError) as e:
        asyncio.run(_client([(500, {"error": "boom"}, {})], []).infer(
            "http://h:1", {"instances": []}, model_name="m"))
    assert e.value.reason == "HTTP 500: boom" and e.value.status == "500"
    # connect failures until the attempts run out
    calls = []
    with pytest.raises(hc.ConnectTimeout):
        asyncio.run(_client([hc.ConnectTimeout("x")] * 3, calls, retries=2).infer(
            "http://h:1", {"instances": []}, model_name="m"))
    assert len(calls) == 3

    # an expired deadline: 504 before anything is sent
    from kserve_tpu_torch.resilience import Deadline, deadline_scope

    async def expired():
        with deadline_scope(Deadline.after(0.0)):
            return await _client([], calls).infer("http://h:1", {}, model_name="m")
    calls = []
    with pytest.raises(InferenceError) as e:
        asyncio.run(expired())
    assert e.value.status == "504" and not calls


URLS = [("http://h:1", "m", "v1", "infer"), ("h:1/", "m", "v2", "infer"),
        ("http://h/v1/models/x:predict", None, "v1", "infer"),
        ("http://h", "m", "v1", "explain"), ("http://h", "m", "v2", "explain"),
        ("http://h", None, "v1", "infer"), ("http://h", None, "v2", "infer")]


@pytest.mark.parametrize("base,model,protocol,verb", URLS, ids=range(len(URLS)))
def test_urls_match_the_jax_client(base, model, protocol, verb):
    want_client = jclient_mod.InferenceRESTClient(jclient_mod.RESTConfig(protocol=protocol))
    got_client = InferenceRESTClient(RESTConfig(protocol=protocol))
    try:
        want = want_client._construct_url(base, model, verb)
    except Exception as e:  # noqa: BLE001 — the JAX client's error is compared
        want = type(e).__name__
    try:
        got = got_client._construct_url(base, model, verb)
    except Exception as e:  # noqa: BLE001
        got = type(e).__name__
    assert got == want
    asyncio.run(want_client.close())


# ---------------- transformer forwarding ----------------


class Predictor(Model):
    """Doubles its V1 instances or V2 input; explains with their sum; keeps
    the headers it was called with."""

    def __init__(self, name):
        super().__init__(name)
        self.ready = True
        self.seen = []

    async def predict(self, payload, headers=None, response_headers=None):
        self.seen.append(dict(headers or {}))
        if isinstance(payload, InferRequest):
            x = payload.inputs[0].as_numpy()
            out = InferInput("out", list(x.shape), "FP32")
            out.set_data_from_numpy((x * 2).astype(np.float32),
                                    binary_data=payload.inputs[0].raw_data is not None)
            return InferResponse(response_id=payload.id, model_name=self.name,
                                 infer_outputs=[out])
        return {"predictions": (np.asarray(payload["instances"]) * 2).tolist()}

    async def explain(self, payload, headers=None):
        return {"explanations": float(np.sum(payload["instances"]))}


def _v2_request(binary):
    inp = InferInput("x", [2, 2], "FP32")
    inp.set_data_from_numpy(np.array([[1, 2], [3, 4]], np.float32), binary_data=binary)
    return InferRequest(model_name="m", infer_inputs=[inp], request_id="q")


def test_transformer_forwards_v1_v2_and_explain():
    async def main():
        predictor = Predictor("m")
        pserver = RESTServer(ModelRepository({"m": predictor}), "127.0.0.1", 0)
        pport = await pserver.start()
        out = {}
        try:
            for protocol in ("v1", "v2"):
                t = Model("m", PredictorConfig(predictor_host=f"127.0.0.1:{pport}",
                                               predictor_protocol=protocol))
                t.ready = True
                tserver = RESTServer(ModelRepository({"m": t}), "127.0.0.1", 0)
                tport = await tserver.start()
                try:
                    if protocol == "v1":
                        body = {"instances": [[1, 2], [3, 4]]}
                        for verb in ("predict", "explain"):
                            out[verb] = [await _port_call(
                                port, "POST", f"/v1/models/m:{verb}", body,
                                {"x-request-id": "rid-1", "x-b3-traceid": "b3"})
                                for port in (pport, tport)]
                    else:
                        for binary in (False, True):
                            direct = InferenceRESTClient(RESTConfig(protocol="v2"))
                            out[f"v2_{binary}"] = [
                                await direct.infer(f"http://127.0.0.1:{port}",
                                                   _v2_request(binary), model_name="m")
                                for port in (pport, tport)]
                            await direct.close()
                finally:
                    await tserver.stop()
                    await t._rest_client.close()
        finally:
            await pserver.stop()
        return out, predictor.seen

    out, seen = asyncio.run(main())
    for verb in ("predict", "explain"):
        direct, forwarded = out[verb]
        assert forwarded[:2] == direct[:2] and direct[0] == 200, verb
    assert out["explain"][0][1] == {"explanations": 10.0}
    for binary in (False, True):
        direct, forwarded = out[f"v2_{binary}"]
        np.testing.assert_array_equal(forwarded.outputs[0].as_numpy(),
                                      direct.outputs[0].as_numpy())
        np.testing.assert_array_equal(direct.outputs[0].as_numpy(), [[2, 4], [6, 8]])
    # the forwarded call passed x-request-id and x-b3-traceid on
    assert seen[1]["x-request-id"] == "rid-1" and seen[1]["x-b3-traceid"] == "b3"


def test_transformer_without_host_or_over_grpc_raises():
    with pytest.raises(NotImplementedError, match="Could not find predictor_host."):
        asyncio.run(Model("m").predict({"instances": []}))
    with pytest.raises(NotImplementedError, match="Could not find predictor_host."):
        asyncio.run(Model("m").explain({"instances": []}))
    grpc = Model("m", PredictorConfig(predictor_host="h:1", predictor_protocol="grpc-v2"))
    with pytest.raises(NotImplementedError, match="gRPC"):
        asyncio.run(grpc.predict({"instances": []}))


def test_health_reads_against_a_port_server():
    async def main():
        server = RESTServer(ModelRepository({"m": Predictor("m")}), "127.0.0.1", 0)
        port = await server.start()
        base = f"http://127.0.0.1:{port}"
        try:
            out = []
            for protocol in ("v1", "v2"):
                c = InferenceRESTClient(RESTConfig(protocol=protocol))
                out += [await c.is_server_live(base), await c.is_server_ready(base),
                        await c.is_model_ready(base, "m")]
                with pytest.raises(InferenceError):
                    await c.is_model_ready(base, "nope")
                await c.close()
            return out
        finally:
            await server.stop()

    # V1 has no server-ready route: the client reads `/`, which carries no
    # "ready" key, so it answers False (the JAX client's reading)
    assert asyncio.run(main()) == [True, False, True, True, True, True]


def test_retry_policy_of_the_router_is_the_jax_one():
    r = trouter.GraphRouter({"nodes": {}}, retries=2)
    want = jrouter.GraphRouter({"nodes": {}}, retries=2, client=httpx.AsyncClient())
    for k in ("max_attempts", "base_backoff_s", "max_backoff_s", "retryable_statuses"):
        assert getattr(r.retry_policy, k) == getattr(want.retry_policy, k)
    assert isinstance(r.retry_policy, RetryPolicy) and r.timeout == want.timeout


def test_transformer_forwards_text_to_an_encoder():
    """V1 instances and a V2 BYTES input forwarded to a tiny encoder on
    the CPU answer what a direct call answers."""
    from kserve_tpu_torch.models import bert
    from kserve_tpu_torch.runtimes.encoder_server import TorchEncoderModel

    texts = ["a fine review", "the worst kernel", "é"]
    v2 = {"id": "g", "inputs": [{"name": "text", "shape": [3], "datatype": "BYTES",
                                 "data": texts}]}

    async def main():
        enc = TorchEncoderModel("bert", config=bert.BertConfig.tiny(), task="classification",
                                random_weights=True, max_length=64, device="cpu")
        enc.load()
        eserver = RESTServer(ModelRepository({"bert": enc}), "127.0.0.1", 0)
        eport = await eserver.start()
        out = []
        try:
            for protocol, path, body in (("v1", "/v1/models/bert:predict", {"instances": texts}),
                                         ("v2", "/v2/models/bert/infer", v2)):
                t = Model("bert", PredictorConfig(predictor_host=f"127.0.0.1:{eport}",
                                                  predictor_protocol=protocol))
                t.load()
                tserver = RESTServer(ModelRepository({"bert": t}), "127.0.0.1", 0)
                tport = await tserver.start()
                try:
                    out.append([await _port_call(p, "POST", path, body) for p in (eport, tport)])
                finally:
                    await tserver.stop()
                    await t._rest_client.close()
        finally:
            await eserver.stop()
        return out

    (v1_direct, v1_via), (v2_direct, v2_via) = asyncio.run(main())
    assert v1_via[:2] == v1_direct[:2] and v1_direct[0] == 200
    assert len(v1_direct[1]["predictions"]) == 3
    assert v2_direct[0] == v2_via[0] == 200
    assert ([o["data"] for o in v2_via[1]["outputs"]]
            == [o["data"] for o in v2_direct[1]["outputs"]])
