"""Prefill/decode disaggregation in the PyTorch port (kserve_tpu_torch/
protocol/pd.py, the engine's prefill_detached / generate_injected, the
server's --role) against the JAX package's (tests/test_pd_disagg.py),
on the CPU with the tiny float32 config and the same weights:

- the wire: serialize_kv gives the JAX package's meta and bytes on the
  same f32 and bf16 KV, each side reads the other's, a layout mismatch
  raises;
- injected KV: a JAX prefill_detached payload fed to the port's
  generate_injected gives the JAX generate_injected's greedy stream and a
  monolithic generate's, on the mixed and the legacy routes, with the
  first token through the detokenizer, and preempted injected lanes
  re-prefill to the same streams;
- detached prefill: the port's KV equals the JAX one within 2e-5, with
  the same first token; zeroed KV changes the output;
- batching and refusals: concurrent detached prefills share one prefill
  call and give their pages back; a mismatched shape raises before the
  run loop; int8 KV, logprobs and an over-long prompt are refused; stop()
  fails queued waiters;
- the server pair: a decode-role server over a prefill-role one answers
  as a role-both server does, refuses logprobs and relays the peer's
  400; the flags the control plane synthesizes parse."""

import asyncio
import http.client
import json
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.protocol import pd as jpd
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.protocol import pd as tpd
from kserve_tpu_torch.runtimes import generative_server as gs

# tests/test_pd_disagg.py make_engine's shape
CFG = dict(max_batch_size=4, page_size=8, num_pages=64, max_pages_per_seq=8,
           max_prefill_len=32, prefill_buckets=(16, 32), dtype="float32")
PROMPT = [5, 6, 7, 8, 9]
GREEDY = dict(max_tokens=10, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_engine(models, **kw):
    jcfg, _, jparams, _ = models
    return jeng.LLMEngine(jcfg, jeng.EngineConfig(use_pallas=False, **dict(CFG, **kw)),
                          JaxByteTokenizer(512), params=jparams, rng_seed=0)


def _engine(models, **kw):
    _, tcfg, _, tparams = models
    return LLMEngine(tcfg, EngineConfig(**dict(CFG, **kw)), ByteTokenizer(512),
                     params=tparams, rng_seed=0, device="cpu")


async def _collect(gen):
    return [o async for o in gen]


def _run(engine, fn):
    """Start `engine`, await fn(engine), stop it; fn's result."""
    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(fn(engine), 120)
        finally:
            await engine.stop()
    return asyncio.run(main())


@pytest.fixture(scope="module")
def jax_pd(models):
    """The JAX package's P/D reference on PROMPT: its detached prefill's
    (first token, KV), the greedy stream a JAX decoder makes of it, and
    a monolithic JAX generate's."""
    params = js.SamplingParams(**GREEDY)

    async def main(e):
        first, kv = await e.prefill_detached(PROMPT, params)
        mono = await _collect(e.generate(PROMPT, params))
        injected = await _collect(e.generate_injected(PROMPT, params, kv, first))
        return first, kv, mono, injected

    first, kv, mono, injected = _run(_jax_engine(models), main)
    return first, np.asarray(kv), [o.token_id for o in mono], [
        o.token_id for o in injected]


# ---------------------------------------------------------------- the wire


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_is_the_jax_wire(dtype):
    gen = torch.Generator().manual_seed(3)
    kv = torch.randn((2, 3, 2, 2, 8, 16), generator=gen).to(getattr(torch, dtype))
    if dtype == "bfloat16":
        kv.view(-1)[:3] = torch.tensor([-0.0, 3.0e38, 1e-40])
        as_np = kv.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    else:
        as_np = kv.numpy()
    meta, payload = tpd.serialize_kv(kv, 17)
    jmeta, jpayload = jpd.serialize_kv(as_np, 17)
    assert meta == jmeta and bytes(payload) == jpayload
    # each side reads the other's
    back, first = tpd.deserialize_kv(jmeta, jpayload)
    assert first == 17 and back.dtype == kv.dtype
    assert torch.equal(back.view(torch.uint8), kv.view(torch.uint8))
    jback, jfirst = jpd.deserialize_kv(meta, bytes(payload))
    assert jfirst == 17 and jback.tobytes() == as_np.tobytes()
    assert jback.dtype == as_np.dtype and jback.shape == as_np.shape
    skewed = json.dumps(dict(json.loads(meta), layout="page-major-v1"))
    with pytest.raises(RuntimeError, match="layout"):
        tpd.deserialize_kv(skewed, bytes(payload))
    with pytest.raises(RuntimeError, match="layout"):
        jpd.deserialize_kv(skewed, bytes(payload))


def test_sampling_params_travel_both_ways():
    p = ts.SamplingParams(temperature=0.7, top_k=5, max_tokens=9, stop=["x"],
                          seed=3, repetition_penalty=1.1)
    wire = tpd.sampling_params_to_dict(p)
    assert wire == jpd.sampling_params_to_dict(js.SamplingParams(**wire))
    assert tpd.sampling_params_from_dict(dict(wire, unknown=1)) == p


# ---------------------------------------------------------------- engines


@pytest.mark.parametrize("route", ["mixed", "legacy"])
def test_jax_payload_injected_matches_jax(models, jax_pd, route):
    """A JAX prefill peer's payload, through the wire, decoded by the port
    on either route: the JAX decoder's stream and the monolithic one."""
    first, kv, mono, injected = jax_pd
    assert injected == mono
    meta, payload = jpd.serialize_kv(kv, first)
    tkv, tfirst = tpd.deserialize_kv(meta, payload)
    engine = _engine(models, use_ragged=route == "mixed")
    outs = _run(engine, lambda e: _collect(e.generate_injected(
        PROMPT, ts.SamplingParams(**GREEDY), tkv, tfirst, request_id="pd-1")))
    assert [o.token_id for o in outs] == mono
    assert outs[0].token_id == first and outs[0].num_generated == 1
    assert outs[0].text_delta == ByteTokenizer(512).decode([first])
    assert outs[-1].finished and outs[-1].finish_reason == "length"
    tl_ = engine.telemetry.snapshot()
    assert tl_["counts"]["finished"] == 1 and tl_["ttft_s"]["n"] == 1
    # the prompt's pages went back
    assert engine.allocator.free_pages == CFG["num_pages"] - 1


def test_port_detached_prefill_matches_jax(models, jax_pd):
    jfirst, jkv, mono, _ = jax_pd
    params = ts.SamplingParams(**GREEDY)

    async def both(e):
        first, kv = await e.prefill_detached(PROMPT, params)
        # the port's payload decoded by the port; and zeroed KV
        good = await _collect(e.generate_injected(PROMPT, params, kv, first))
        bad = await _collect(e.generate_injected(
            PROMPT, params, torch.zeros_like(kv), first))
        return first, kv, good, bad

    first, kv, good, bad = _run(_engine(models), both)
    assert first == jfirst and kv.dtype == torch.float32 and kv.shape == jkv.shape
    n = len(PROMPT)

    def valid(a):  # token slots of the prompt: (P, ps) -> positions
        L, P, two, nkv, ps, d = a.shape
        return a.transpose(0, 2, 1, 4, 3, 5).reshape(L, two, P * ps, nkv, d)[:, :, :n]

    np.testing.assert_allclose(valid(kv.numpy()), valid(jkv), atol=2e-5, rtol=2e-5)
    assert [o.token_id for o in good] == mono
    assert [o.token_id for o in bad] != mono
    # the port's payload feeds a JAX decoder too
    meta, payload = tpd.serialize_kv(kv, first)
    jkv2, jfirst2 = jpd.deserialize_kv(meta, bytes(payload))
    got = _run(_jax_engine(models), lambda e: _collect(e.generate_injected(
        PROMPT, js.SamplingParams(**GREEDY), jkv2, jfirst2)))
    assert [o.token_id for o in got] == mono


def test_preempted_injected_lanes_reprefill(models):
    """Two injected lanes on 7 usable pages, 44 tokens each: the newer is
    preempted and re-prefilled as any other lane, and both streams equal
    a roomy monolithic engine's."""
    params = ts.SamplingParams(max_tokens=44, temperature=0.0, ignore_eos=True)
    prompts = [[1, 2, 3, 4], [9, 10, 11, 12]]

    async def mono(e):
        return await asyncio.gather(*[_collect(e.generate(p, params)) for p in prompts])

    want = [[o.token_id for o in s] for s in _run(_engine(models), mono)]

    async def pd(e):
        got = []
        for p in prompts:
            got.append(await e.prefill_detached(p, params))
        return got

    payloads = _run(_engine(models), pd)
    squeezed = _engine(models, num_pages=8, max_prefill_len=16,
                       prefill_buckets=(16,), steps_per_sync=4)

    async def inject(e):
        return await asyncio.gather(*[
            _collect(e.generate_injected(p, params, kv, first))
            for p, (first, kv) in zip(prompts, payloads)])

    got = [[o.token_id for o in s] for s in _run(squeezed, inject)]
    assert squeezed.preemption_count > 0
    assert got == want


def test_concurrent_detached_prefills_batch_and_release(models):
    """tests/test_pd_disagg.py TestDetachedBatching: concurrent callers
    share one prefill call, each gets its own row, and every page goes
    back."""
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    params = ts.SamplingParams(max_tokens=4, temperature=0.0)

    async def main(e):
        seq = [await e.prefill_detached(p, params) for p in prompts]
        before = e.legacy_dispatches["prefill"]
        conc = await asyncio.gather(*[e.prefill_detached(p, params) for p in prompts])
        return seq, conc, e.legacy_dispatches["prefill"] - before

    engine = _engine(models)
    seq, conc, calls = _run(engine, main)
    assert calls == 1
    for p, (f_seq, kv_seq), (f_conc, kv_conc) in zip(prompts, seq, conc):
        assert f_seq == f_conc
        flat = lambda a: a.numpy().transpose(0, 2, 1, 4, 3, 5).reshape(  # noqa: E731
            a.shape[0], 2, -1, a.shape[3], a.shape[5])[:, :, :len(p)]
        np.testing.assert_allclose(flat(kv_seq), flat(kv_conc), rtol=1e-5, atol=1e-6)
    assert engine.allocator.free_pages == CFG["num_pages"] - 1


def test_mismatched_kv_refused_before_the_run_loop(models):
    """A version-skewed peer's KV fails its request at submit, and the
    engine goes on serving (tests/test_pd_disagg.py:378)."""
    async def main(e):
        with pytest.raises(ValueError, match="incompatible"):
            e.generate_injected([1, 2, 3], ts.SamplingParams(max_tokens=4),
                                np.zeros((1, 2, 1, 2, 8, 16), np.float32), 7)
        with pytest.raises(ValueError, match="vocabulary"):
            e.generate_injected([1, 2, 3], ts.SamplingParams(max_tokens=4),
                                torch.zeros((2, 1, 2, 2, 8, 16)), 10 ** 6)
        return await _collect(e.generate([1, 2, 3], ts.SamplingParams(max_tokens=4)))

    outs = _run(_engine(models), main)
    assert outs[-1].finished


@pytest.mark.parametrize("case", ["int8_prefill", "int8_inject", "logprobs",
                                  "too_long", "not_started"])
def test_refusals(models, case):
    params = ts.SamplingParams(max_tokens=4)
    if case == "int8_prefill":
        with pytest.raises(NotImplementedError, match="quantized"):
            asyncio.run(_engine(models, kv_quant="int8").prefill_detached([1, 2], params))
    elif case == "int8_inject":
        with pytest.raises(NotImplementedError, match="quantized"):
            _engine(models, kv_quant="int8").generate_injected(
                [1, 2], params, torch.zeros((2, 1, 2, 2, 8, 16)), 3)
    elif case == "logprobs":
        with pytest.raises(ValueError, match="logprobs"):
            asyncio.run(_engine(models).prefill_detached(
                [1, 2], ts.SamplingParams(max_tokens=4, logprobs=2)))
    elif case == "too_long":
        with pytest.raises(ValueError, match="max_prefill_len"):
            asyncio.run(_engine(models).prefill_detached(list(range(1, 40)), params))
    else:
        with pytest.raises(RuntimeError, match="not started"):
            asyncio.run(_engine(models).prefill_detached([1, 2], params))


def test_stop_fails_queued_detached_waiters(models):
    """stop() fails the waiters of queued detached prefills and of the one
    running (kserve_tpu/engine/engine.py:759-769)."""
    engine = _engine(models, prefill_batch=1)
    gate = threading.Event()
    run_prefill = engine._run_prefill

    def held(*args):
        assert gate.wait(30)
        return run_prefill(*args)

    engine._run_prefill = held

    async def main():
        await engine.start()
        waiters = [asyncio.ensure_future(engine.prefill_detached(
            [1, 2, i + 3], ts.SamplingParams(max_tokens=2))) for i in range(3)]
        t0 = asyncio.get_running_loop().time()
        while not engine._detached_inflight:
            assert asyncio.get_running_loop().time() - t0 < 30
            await asyncio.sleep(0.005)
        stopper = asyncio.ensure_future(engine.stop())
        await asyncio.sleep(0.05)
        done = [w.done() for w in waiters]
        gate.set()
        await stopper
        errors = [w.exception() for w in waiters]
        return done, errors

    try:
        done, errors = asyncio.run(main())
    finally:
        gate.set()
    assert done == [True, True, True]
    assert all(isinstance(e, RuntimeError) and "stopped" in str(e) for e in errors)
    assert engine.allocator.free_pages == CFG["num_pages"] - 1


# ---------------------------------------------------------------- servers

SERVER = ["--model_config=tiny", "--random_weights", "--device=cpu",
          "--kv_dtype=float32", "--http_port=0", "--max_model_len=256",
          "--kv_pages=128", "--max_prefill_len=64", "--model_name=tiny"]


def _serve(argv):
    model = gs.build_model(gs.build_arg_parser().parse_args(argv))
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60), "server did not start"
    return model, srv, thread


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def pair():
    p = _serve(SERVER + ["--role=prefill"])
    d = _serve(SERVER + ["--role=decode",
                         f"--prefill_url=http://127.0.0.1:{p[1].port}"])
    yield p, d
    for _, srv, thread in (d, p):
        srv.request_stop()
        thread.join(30)


def test_decode_role_answers_as_a_monolithic_server(pair):
    (pmodel, psrv, _), (dmodel, dsrv, _) = pair
    body = {"model": "tiny", "prompt": "hello disaggregated world",
            "max_tokens": 8, "temperature": 0, "ignore_eos": True}
    # the prefill-role server still answers completions: the reference
    status, mono = _post(psrv.port, "/openai/v1/completions", body)
    assert status == 200
    before = pmodel.engine.legacy_dispatches["prefill"]
    status, disagg = _post(dsrv.port, "/openai/v1/completions", body)
    assert status == 200, disagg
    assert json.loads(disagg)["choices"][0]["text"] == json.loads(mono)["choices"][0]["text"]
    assert json.loads(disagg)["usage"] == json.loads(mono)["usage"]
    assert pmodel.engine.legacy_dispatches["prefill"] == before + 1
    # a streamed chat through the pair
    status, sse = _post(dsrv.port, "/openai/v1/chat/completions", {
        "model": "tiny", "stream": True, "max_tokens": 5, "temperature": 0,
        "ignore_eos": True, "messages": [{"role": "user", "content": "hi"}]})
    events = [line[6:] for line in sse.splitlines() if line.startswith("data: ")]
    assert status == 200 and events[-1] == "[DONE]" and len(events) == 5 + 2
    assert pmodel.engine.allocator.free_pages + len(pmodel.engine._prefix_cache) == 127


def test_decode_role_refusals(pair):
    (_, psrv, _), (_, dsrv, _) = pair
    status, body = _post(dsrv.port, "/openai/v1/completions", {
        "model": "tiny", "prompt": "hi", "max_tokens": 4, "logprobs": 2})
    assert status == 400 and "disaggregation" in body
    # over the prefill peer's max_prefill_len: its 400 is relayed
    status, body = _post(dsrv.port, "/openai/v1/completions", {
        "model": "tiny", "prompt": "x" * 80, "max_tokens": 4})
    assert status == 400 and "max_prefill_len" in body
    status, body = _post(psrv.port, "/v1/prefill/tiny", {"prompt_ids": []})
    assert status == 400
    status, body = _post(psrv.port, "/v1/prefill/nope", {"prompt_ids": [1]})
    assert status == 400


def test_prefill_route_answers_the_jax_wire(pair):
    (pmodel, psrv, _), _ = pair
    conn = http.client.HTTPConnection("127.0.0.1", psrv.port, timeout=60)
    try:
        conn.request("POST", "/v1/prefill/tiny", body=json.dumps({
            "prompt_ids": [3, 4, 5], "params": {"temperature": 0.0, "max_tokens": 2}}))
        resp = conn.getresponse()
        data = resp.read()
        meta = resp.getheader(tpd.KV_META_HEADER)
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "application/octet-stream"
        assert int(resp.getheader("Content-Length")) == len(data)
    finally:
        conn.close()
    kv, first = jpd.deserialize_kv(meta, data)  # the JAX package reads it
    assert kv.shape == (2, 1, 2, 2, 16, 16) and kv.dtype == np.float32
    assert 0 <= first < 512


def test_control_plane_flags_parse(monkeypatch, tmp_path):
    """The flags kserve_tpu/controlplane/llmisvc.py:205-211 synthesizes for
    a prefill/decode pair parse in the port's build_arg_parser, and a
    decode role without a URL is refused."""
    from kserve_tpu.controlplane.crds import LLMInferenceService
    from kserve_tpu.controlplane.llmisvc import LLMISVCReconciler

    llm = LLMInferenceService.model_validate({
        "apiVersion": "serving.kserve.io/v1alpha2", "kind": "LLMInferenceService",
        "metadata": {"name": "pd", "namespace": "default"},
        "spec": {"model": {"uri": f"file://{tmp_path}", "name": "llm"},
                 "workload": {"maxBatchSize": 4}, "prefill": {}}})
    objects, _ = LLMISVCReconciler().reconcile(llm)
    argv = {}
    for obj in objects:
        if obj["kind"] == "Deployment":
            role = obj["metadata"]["labels"].get("kserve.io/component")
            main = next(c for c in obj["spec"]["template"]["spec"]["containers"]
                        if c["name"] == "main")
            argv[role] = [a for a in main["args"] if a.startswith("--")]
    monkeypatch.setattr(gs, "TorchGenerativeModel", lambda name, mc, ec, **kw: (ec, kw))
    got = {}
    for role, args in argv.items():
        ec, kw = gs.build_model(gs.build_arg_parser().parse_args(args))
        got[role] = (kw["role"], kw["prefill_url"], ec.tp, ec.max_batch_size)
    assert got == {"prefill": ("prefill", None, 1, 8),
                   "decode": ("decode", "http://pd-kserve-prefill.default:80", 1, 4)}
    monkeypatch.undo()
    with pytest.raises(ValueError, match="prefill_url"):
        gs.TorchGenerativeModel("m", tl.LlamaConfig.tiny(), random_weights=True,
                                device="cpu", role="decode")


def test_lora_adapter_passes_through_both_roles(models, tmp_path):
    """An adapter request prefilled detached and decoded from the injected
    KV gives the adapter's monolithic stream (kserve_tpu/protocol/pd.py
    carries the adapter's name); its pages enter no prefix cache."""
    from test_torch_lora import write_peft_adapter

    _, tcfg, _, _ = models
    adapter = write_peft_adapter(tmp_path / "a", tcfg, seed=5)

    def engine():
        e = _engine(models)
        return LLMEngine(tcfg, e.config, ByteTokenizer(512), params=e.params,
                         rng_seed=0, device="cpu", lora_adapters={"a": adapter})

    params = ts.SamplingParams(**GREEDY)
    prompt = list(range(3, 22))  # two full pages and a tail

    async def mono(e):
        base = await _collect(e.generate(prompt, params))
        tuned = await _collect(e.generate(prompt, params, adapter="a"))
        return [o.token_id for o in base], [o.token_id for o in tuned]

    base, tuned = _run(engine(), mono)
    assert base != tuned

    async def pd(e):
        first, kv = await e.prefill_detached(prompt, params, adapter="a")
        out = await _collect(e.generate_injected(prompt, params, kv, first,
                                                 adapter="a"))
        return [o.token_id for o in out], len(e._prefix_cache)

    got, cached = _run(engine(), pd)
    assert got == tuned and cached == 0


def test_roles_run_on_cuda_unless_asked(monkeypatch):
    """A prefill or decode role without --device runs on cuda: without a
    card it raises, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for role in (["--role=prefill"],
                 ["--role=decode", "--prefill_url=http://127.0.0.1:9"]):
        args = gs.build_arg_parser().parse_args(
            ["--model_config=tiny", "--random_weights", *role])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            gs.build_model(args)
