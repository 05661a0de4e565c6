"""Request telemetry of the PyTorch port against the JAX package on the
CPU: RequestTimeline / TimelineRecorder fed the same mark sequences
(to_dict() and snapshot() equal exactly), engines on the mixed, spec and
legacy routes serving the same prompts (each timeline's token count,
stamp order, events and terminal reason, and the token counters, equal
to the JAX engine's), and the server's GET /metrics (parsed with
prometheus_client, names, types, labels and buckets equal to
kserve_tpu/metrics.py) and GET /admin/telemetry (the JAX payload
keys)."""

import asyncio
import http.client
import json
import random
import threading

import jax
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from kserve_tpu import metrics as jm
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.observability import timeline as jt
from kserve_tpu_torch import metrics as tm
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.observability import timeline as tt

REASONS = ["stop", "length", "cancelled", "preempted", "error", None]


def _script(rng: random.Random, n_requests: int):
    """Random mark sequences: (request id, [(method, args), ...])."""
    out = []
    for r in range(n_requests):
        t = rng.uniform(0, 10)
        marks = [("mark_received", (t,))]
        steps = [("mark_admitted",), ("mark_prefill_start",),
                 ("mark_prefill_end",)] + [("mark_token",)] * rng.randrange(0, 12)
        for name, *_ in steps:
            t += rng.uniform(0, 0.05)
            marks.append((name, (t,)))
            if rng.random() < 0.1:
                marks.append(("add_event", (t, "preempt")))
        t += rng.uniform(0, 0.05)
        marks.append(("mark_finished", (t, rng.choice(REASONS))))
        out.append((f"req-{r}", marks))
    return out


def _replay(mod, script, steps, chunks):
    rec = mod.TimelineRecorder(max_timelines=16, max_samples=64)
    tls = []
    for rid, marks in script:
        tl = mod.RequestTimeline(rid, model_name="m")
        tl.n_prompt_tokens = len(rid)
        for name, args in marks:
            getattr(tl, name)(*args)
        rec.observe(tl)
        tls.append(tl)
    for s in steps:
        rec.record_step(s)
    for c in chunks:
        rec.record_prefill_chunk(c)
    return rec, tls


def test_timeline_and_recorder_match_jax():
    rng = random.Random(0)
    script = _script(rng, 40)
    steps = [rng.uniform(0, 0.1) for _ in range(100)]
    chunks = [rng.uniform(0, 0.5) for _ in range(30)]
    jrec, jtls = _replay(jt, script, steps, chunks)
    trec, ttls = _replay(tt, script, steps, chunks)
    for a, b in zip(jtls, ttls):
        assert b.to_dict() == a.to_dict()
    for max_recent in (0, 5, 32):
        assert trec.snapshot(max_recent) == jrec.snapshot(max_recent)
    for xs in ([], [0.3], [5, 1, 4, 2, 3]):
        assert tt.percentiles(xs) == jt.percentiles(xs)


def test_itl_overflow_matches_jax():
    timelines = []
    for mod in (jt, tt):
        tl = mod.RequestTimeline("r")
        tl.mark_received(0.0)
        for k in range(mod.MAX_ITL_SAMPLES + 50):
            tl.mark_token(0.001 * k)
        tl.mark_finished(10.0, "length")
        timelines.append(tl.to_dict())
    assert timelines[0] == timelines[1]


# ---------------------------------------------------------------- engines

PS = 8
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=96, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
ROUTES = {"mixed": dict(), "spec": dict(spec_decode_k=2),
          "legacy": dict(use_ragged=False)}
# 45 tokens > the largest bucket: a chunked prefill
PROMPT_LENGTHS = (5, 12, 45)


def _engines(route: str):
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    label = f"telemetry-{route}"
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False, **ROUTES[route], **ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0, metrics_label=label)
    tengine = LLMEngine(tcfg, EngineConfig(**ROUTES[route], **ENGINE),
                        ByteTokenizer(512), params=tparams, rng_seed=0,
                        device="cpu", metrics_label=label)
    return jengine, tengine, label


async def _serve(engine, params_cls, prompts):
    async def one(ids):
        params = params_cls(temperature=0.0, max_tokens=9, ignore_eos=True)
        return [o.token_id async for o in engine.generate(ids, params)]

    await engine.start()
    try:
        return await asyncio.wait_for(
            asyncio.gather(*[one(p) for p in prompts]), timeout=120)
    finally:
        await engine.stop()


def _shape(tl) -> tuple:
    """What must agree across the two engines: counts, terminal reason,
    the order of the stamps and the events."""
    d = tl.to_dict()
    order = [k for k in ("received", "admitted", "prefill_start", "prefill_end",
                         "first_token_at", "finished_at")
             if d[k] is not None]
    stamps = [d[k] for k in order]
    assert stamps == sorted(stamps), d
    return (d["n_prompt_tokens"], d["n_generated"], d["finish_reason"],
            tuple(order), len(tl.itls), tuple(e["name"] for e in d["events"]))


def _counters(label: str) -> dict:
    """The token counters of one model label: {name: (JAX, port)}."""
    return {name: (getattr(jm, name).labels(model_name=label)._value.get(),
                   getattr(tm, name).labels(model_name=label).get())
            for name in ("GENERATED_TOKENS", "PROMPT_TOKENS")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_timelines_match_jax_engine(route):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, n).tolist() for n in PROMPT_LENGTHS]
    jengine, tengine, label = _engines(route)
    want = asyncio.run(_serve(jengine, js.SamplingParams, prompts))
    got = asyncio.run(_serve(tengine, ts.SamplingParams, prompts))
    assert got == want
    jshapes = sorted(_shape(t) for t in jengine.telemetry.timelines)
    tshapes = sorted(_shape(t) for t in tengine.telemetry.timelines)
    assert tshapes == jshapes
    assert [s[1] for s in tshapes] == [9, 9, 9]
    tsnap, jsnap = tengine.telemetry_snapshot(), jengine.telemetry_snapshot()
    assert sorted(tsnap) == sorted(jsnap)
    assert tsnap["counts"]["finished"] == jsnap["counts"]["finished"] == 3
    assert tsnap["ttft_s"]["n"] == 3 and tsnap["itl_s"]["n"] == 3 * 8
    assert tsnap["decode_step_s"]["n"] > 0
    counters = _counters(label)
    for name, (jax_value, port_value) in counters.items():
        assert port_value == jax_value, name
    assert counters["PROMPT_TOKENS"][1] == sum(PROMPT_LENGTHS)


def test_cancelled_request_is_recorded():
    _, tengine, _ = _engines("mixed")

    async def run():
        await tengine.start()
        try:
            stream = tengine.generate(
                [1, 2, 3], ts.SamplingParams(temperature=0.0, max_tokens=50,
                                             ignore_eos=True))
            async for out in stream:
                if out.num_generated >= 2:
                    break
            await stream.aclose()
        finally:
            await tengine.stop()

    asyncio.run(run())
    (tl,) = tengine.telemetry.timelines
    assert tl.finish_reason == "cancelled" and tl.n_generated >= 2
    snap = tengine.telemetry_snapshot()
    assert snap["counts"]["aborted"] == 1 and snap["ttft_s"] == {"n": 0}


# ---------------------------------------------------------------- server

SERVER_ARGS = ["--model_name=tiny-telemetry", "--model_config=tiny",
               "--random_weights", "--device=cpu", "--kv_dtype=float32",
               "--http_port=0", "--max_model_len=256", "--kv_pages=128",
               "--max_prefill_len=64"]
PORTED = [jm.GENERATED_TOKENS, jm.PROMPT_TOKENS, jm.ENGINE_BATCH_OCCUPANCY,
          jm.ENGINE_QUEUE_DEPTH, jm.ENGINE_KV_PAGES_FREE, jm.ENGINE_PREEMPTIONS,
          jm.REQUEST_TTFT, jm.REQUEST_ITL, jm.REQUEST_QUEUE_WAIT, jm.REQUEST_E2E,
          jm.ENGINE_STEP_DURATION, jm.ENGINE_PREFILL_CHUNK_DURATION,
          jm.SPEC_TOKENS, jm.ENGINE_STARTUP]


def test_metrics_and_telemetry_routes():
    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    model = build_model(build_arg_parser().parse_args(SERVER_ARGS))
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    try:
        assert srv.listening.wait(60), "server did not start"
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/openai/v1/completions", body=json.dumps({
            "model": "tiny-telemetry", "prompt": "hello", "max_tokens": 6,
            "temperature": 0, "ignore_eos": True}))
        assert conn.getresponse().read()
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        ctype, raw = resp.getheader("Content-Type"), resp.read().decode()
        conn.request("GET", "/admin/telemetry")
        tele = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.request_stop()
        thread.join(30)
    assert not thread.is_alive()
    assert ctype.startswith("text/plain; version=0.0.4")
    families = {f.name: f for f in text_string_to_metric_families(raw)}
    for metric in PORTED:
        fam = families[metric._name]
        assert fam.type == metric._type, metric._name
        assert fam.documentation == metric._documentation, metric._name
        for sample in fam.samples:
            assert set(sample.labels) - {"le"} == set(metric._labelnames)
        if metric._type == "histogram":
            les = [s.labels["le"] for s in fam.samples
                   if s.name.endswith("_bucket")]
            want = [str(b) if b != float("inf") else "+Inf"
                    for b in metric._upper_bounds]
            assert [float(x) for x in les[:len(want)]] == [float(x) for x in want]
    # one request served: 6 tokens, the first of them the prefill's sample
    def value(name, **labels):
        for fam in families.values():
            for s in fam.samples:
                if s.name == name and all(s.labels.get(k) == v
                                          for k, v in labels.items()):
                    return s.value
        raise KeyError(name)
    mine = {"model_name": "tiny-telemetry"}
    assert value("engine_generated_tokens_total", **mine) == 5
    assert value("request_ttft_seconds_count", **mine) == 1
    assert value("request_inter_token_seconds_count", **mine) == 5
    assert value("engine_startup_seconds_count", phase="weights", **mine) == 1
    # the JAX payload: {"models": {name: snapshot}, "profiler": status}
    assert sorted(tele) == ["models", "profiler"]
    snap = tele["models"]["tiny-telemetry"]
    want_keys = set(jt.TimelineRecorder().snapshot()) | {
        "queue_depth", "prefix_cache_hits", "preemptions"}
    assert set(snap) == want_keys
    assert snap["counts"]["finished"] == 1 and snap["ttft_s"]["n"] == 1
    assert snap["recent"][0]["n_generated"] == 6
