"""The PyTorch port's lifecycle layer against the JAX package on the CPU:
the replica state machine and the drain-grace parser on one table of
call scripts and values, checkpoint wire forms in both directions,
checkpoint validation on one table, and the engines: the port and the
JAX engine on the same tiny float32 Llama, drained with an already
expired budget at the same routed-token count (steps_per_sync=1), give
equal checkpoints on the mixed and the legacy routes; every checkpoint,
from either package, resumed on a fresh port engine, splices into the
JAX engine's uninterrupted stream token for token (greedy and seeded);
and a resumed request preempted again during its re-prefill streams as
the JAX engine's does, on both routes (ROADMAP C, the open check)."""

import asyncio
import math

import jax
import numpy as np
import pytest

from kserve_tpu import lifecycle as jlc
from kserve_tpu import resilience as jres
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import build_compiled
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch import lifecycle as tlc
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.metrics import GENERATION_CHECKPOINTS, GENERATION_RESUMES
from kserve_tpu_torch.models import llama as tl

# ---------------- the state machine and the grace parser ----------------

# call scripts: ("ready"), ("drain", grace or None), ("advance", s),
# ("escalate"), ("finish"); each step records the state, the budget left
# and whether it expired
SCRIPTS = {
    "happy_path": [("ready",), ("drain", 10.0), ("advance", 4.0), ("finish",)],
    "forward_only": [("ready",), ("drain", 5.0), ("ready",), ("drain", 99.0)],
    "shared_budget": [("ready",), ("drain", None), ("advance", 4.0), ("drain", 1.0)],
    "escalate_in_place": [("ready",), ("drain", 30.0), ("advance", 1.0),
                          ("escalate",), ("finish",)],
    "escalate_before_drain": [("escalate",), ("drain", 10.0), ("ready",)],
    "drain_while_starting": [("drain", 2.0), ("advance", 3.0), ("finish",),
                             ("ready",)],
}
GRACE_VALUES = ["30", "0", "2.5", "-1", "inf", "-inf", "nan", "abc", "", None,
                7, 1e9]


def _run_script(pkg, clock_cls, script):
    clock = clock_cls()
    seen = []
    lc = pkg.ReplicaLifecycle(clock=clock, drain_grace_s=12.0,
                              on_transition=seen.append)
    out = [(lc.state, lc.ready, lc.accepting)]
    for step in script:
        op = step[0]
        if op == "ready":
            lc.mark_ready()
        elif op == "drain":
            lc.begin_drain(step[1])
        elif op == "advance":
            clock.advance(step[1])
        elif op == "escalate":
            lc.escalate()
        elif op == "finish":
            lc.finish_drain()
        d = lc.drain_deadline
        out.append((lc.state, lc.ready, lc.accepting,
                    None if d is None else (round(d.remaining(), 9), d.expired)))
    return out, seen


@pytest.mark.parametrize(
    "case", [f"script:{k}" for k in SCRIPTS] + [f"grace:{v!r}" for v in GRACE_VALUES])
def test_lifecycle_matches_jax(case, monkeypatch):
    """The same call scripts drive both ReplicaLifecycles through the same
    states, readiness, admission and budgets; normalize_drain_grace and
    drain_grace_from_env answer the same on every value."""
    kind, _, key = case.partition(":")
    if kind == "script":
        assert (_run_script(tlc, tres.FakeClock, SCRIPTS[key])
                == _run_script(jlc, jres.FakeClock, SCRIPTS[key]))
        return
    value = GRACE_VALUES[[repr(v) for v in GRACE_VALUES].index(key)]
    got, want = tlc.normalize_drain_grace(value), jlc.normalize_drain_grace(value)
    assert got == want or (got is not None and math.isnan(got) and math.isnan(want))
    env = {} if value is None else {"KSERVE_TPU_DRAIN_GRACE": value}
    assert tlc.drain_grace_from_env(env) == jlc.drain_grace_from_env(env)
    assert tlc.ReplicaDrainingError().retry_after_s == 1.0
    assert tlc.STATES == jlc.STATES


# ---------------- checkpoint wire forms and validation ----------------

def _ckpt_dict(**over):
    base = dict(request_id="r1", prompt_ids=[1, 2, 3], generated=[4, 5],
                sampling={"temperature": 0.7, "top_p": 0.9, "top_k": 5,
                          "min_p": 0.0, "repetition_penalty": 1.0,
                          "frequency_penalty": 0.0, "presence_penalty": 0.0,
                          "max_tokens": 12, "min_tokens": 0, "ignore_eos": True,
                          "stop": ["\n"], "seed": 42, "logprobs": None},
                adapter=None, model_name="m", deadline_remaining_s=3.5,
                reason="drain")
    base.update(over)
    return base


def test_checkpoint_wire_forms_cross_packages():
    """JAX to_header -> port from_header -> the same to_dict, and back;
    capture from each package's SamplingParams writes the same JSON; the
    wire schema matches both SamplingParams dataclasses."""
    import dataclasses

    j = jlc.GenerationCheckpoint.from_dict(_ckpt_dict())
    t = tlc.GenerationCheckpoint.from_header(j.to_header())
    assert t.to_dict() == j.to_dict()
    assert t.to_header() == j.to_header() and t.to_json() == j.to_json()
    back = jlc.GenerationCheckpoint.from_header(t.to_header())
    assert back.to_dict() == j.to_dict()
    # unknown keys dropped on both sides; a malformed header is None
    extra = dict(_ckpt_dict(), future_field=1)
    assert (tlc.GenerationCheckpoint.from_dict(extra).to_dict()
            == jlc.GenerationCheckpoint.from_dict(extra).to_dict())
    for bad in ("", "not base64!", "e30=", None):  # e30= is "{}"
        assert tlc.GenerationCheckpoint.from_header(bad) is None
        assert jlc.GenerationCheckpoint.from_header(bad) is None
    kw = dict(temperature=0.5, top_k=3, max_tokens=9, seed=7, stop=["x"])
    jd = tres.Deadline(10.0, tres.FakeClock(4.0))
    cap_t = tlc.GenerationCheckpoint.capture(
        "q", [1, 2], [3], ts.SamplingParams(**kw), model_name="m",
        deadline=jd, reason="stall")
    cap_j = jlc.GenerationCheckpoint.capture(
        "q", [1, 2], [3], js.SamplingParams(**kw), model_name="m",
        deadline=jres.Deadline(10.0, jres.FakeClock(4.0)), reason="stall")
    assert cap_t.to_header() == cap_j.to_header()
    assert cap_t.deadline_remaining_s == 6.0 and cap_t.tokens_salvaged == 1
    names = {f.name for f in dataclasses.fields(ts.SamplingParams)}
    schema = (set(tlc.GenerationCheckpoint._SAMPLING_FLOATS)
              | set(tlc.GenerationCheckpoint._SAMPLING_INTS)
              | set(tlc.GenerationCheckpoint._SAMPLING_OPT_INTS)
              | {"ignore_eos", "stop"})
    assert schema == names == {f.name for f in dataclasses.fields(js.SamplingParams)}
    assert cap_t.sampling_params() == ts.SamplingParams(**kw)
    for name in ("CHECKPOINT_HEADER", "CHECKPOINT_HEADER_MAX_BYTES",
                 "CHECKPOINT_FIELD_SIZE_LIMIT", "CHECKPOINT_HEADER_SAFE_BYTES"):
        assert getattr(tlc, name) == getattr(jlc, name)
    err = tlc.GenerationPreempted(cap_t)
    assert err.reason == "stall" and err.checkpoint is cap_t


VALIDATE_CASES = {
    "ok": _ckpt_dict(),
    "string_ids": _ckpt_dict(prompt_ids=[1, "2"]),
    "float_ids": _ckpt_dict(generated=[1.5]),
    "bool_ids": _ckpt_dict(prompt_ids=[True, 2]),
    "numpy_ids": _ckpt_dict(prompt_ids=[np.int64(3), 4]),
    "empty_prompt": _ckpt_dict(prompt_ids=[]),
    "out_of_vocab": _ckpt_dict(prompt_ids=[1, 512]),
    "negative_id": _ckpt_dict(generated=[-1]),
    "int32_overflow": _ckpt_dict(sampling={"max_tokens": 2 ** 31}),
    "int32_min": _ckpt_dict(sampling={"seed": -(2 ** 31)}),
    "bad_float": _ckpt_dict(sampling={"temperature": "hot"}),
    "numeric_string": _ckpt_dict(sampling={"temperature": "0.5", "top_k": "3"}),
    "float_int": _ckpt_dict(sampling={"top_k": 2.0}),
    "unknown_keys": _ckpt_dict(sampling={"max_tokens": 4, "beam": 3, "x": None}),
    "stop_not_list": _ckpt_dict(sampling={"stop": "\n"}),
    "stop_not_strings": _ckpt_dict(sampling={"stop": ["a", 1]}),
    "stop_none": _ckpt_dict(sampling={"stop": None, "seed": None}),
    "sampling_not_object": _ckpt_dict(sampling=[1]),
    "ignore_eos_truthy": _ckpt_dict(sampling={"ignore_eos": 1}),
}


def _validated(pkg, data):
    ckpt = pkg.GenerationCheckpoint.from_dict(dict(data))
    try:
        return ("ok", ckpt.validate(vocab_size=512).to_dict())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_matches_jax(case):
    """validate() accepts and rejects the same checkpoints, with the same
    normalized fields or the same message."""
    data = VALIDATE_CASES[case]
    assert _validated(tlc, data) == _validated(jlc, data)


# ---------------- engines: drain and resume against the JAX engine ----------------

ENGINE = dict(max_batch_size=2, page_size=8, num_pages=64, max_pages_per_seq=8,
              max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=1,
              dtype="float32")
# three requests, two slots: the third is queued when the drain comes;
# the second samples with a seed
REQUESTS = [("a", [5, 6, 7, 8, 9], dict(temperature=0.0)),
            ("b", list(range(20, 31)), dict(temperature=0.8, seed=42)),
            ("c", [40, 41, 42], dict(temperature=0.0))]
MAX_TOKENS = 24
DRAIN_AT = 6  # tokens of request "a" routed when the drain comes


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port_engine(models, **cfg):
    _, tcfg, _, tparams = models
    return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, **cfg)), ByteTokenizer(512),
                     params=tparams, rng_seed=0, device="cpu",
                     metrics_label="lc", checkpoint_label="tiny")


_JAX_PROGRAMS = {}


def _jax_engine(models, **cfg):
    """A JAX engine; engines of one config share one jitted program set,
    so only the first of them compiles."""
    jcfg, _, jparams, _ = models

    def make(programs=None):
        return jeng.LLMEngine(
            jcfg, jeng.EngineConfig(use_pallas=False, **dict(ENGINE, **cfg)),
            JaxByteTokenizer(512), params=jparams, rng_seed=0,
            checkpoint_label="tiny", compiled_programs=programs)

    key = tuple(sorted(cfg.items()))
    if key not in _JAX_PROGRAMS:
        probe = make()  # resolves the config's defaults and the mesh
        _JAX_PROGRAMS[key] = build_compiled(jcfg, probe.config, probe.mesh)
    return make(_JAX_PROGRAMS[key])


def _requests(route):
    """The requests; on the legacy route "a" asks for logprobs (the
    iteration then runs the legacy programs)."""
    out = []
    for rid, prompt, kw in REQUESTS:
        kw = dict(kw, max_tokens=MAX_TOKENS, ignore_eos=True)
        if route == "legacy" and rid == "a":
            kw["logprobs"] = 2
        out.append((rid, prompt, kw))
    return out


def _drive(engine, sp_cls, deadline_cls, preempted_cls, requests, drain_at=None):
    """Run `requests` concurrently; with `drain_at`, the consumer of the
    first drains the engine with an expired budget as soon as it holds
    that many tokens (before the run loop dispatches again).  Returns
    ({rid: tokens}, {rid: checkpoint}, the drain's checkpoints)."""
    streams = {rid: [] for rid, _, _ in requests}
    caught, drained = {}, []

    async def one(rid, prompt, kw):
        try:
            async for out in engine.generate(prompt, sp_cls(**kw), request_id=rid):
                if out.token_id >= 0:
                    streams[rid].append(out.token_id)
                if (drain_at is not None and rid == requests[0][0]
                        and len(streams[rid]) == drain_at and not drained):
                    drained.extend(await engine.drain(deadline_cls.after(0.0)))
        except preempted_cls as e:
            caught[rid] = e.checkpoint

    async def main():
        await engine.start()
        try:
            await asyncio.wait_for(asyncio.gather(
                *[one(rid, p, kw) for rid, p, kw in requests]), 120)
        finally:
            await engine.stop()

    asyncio.run(main())
    return streams, caught, drained


def _resume_all(engine, checkpoints):
    """Resume every checkpoint on `engine` concurrently: {request id: the
    continuation's tokens}."""

    async def one(ckpt):
        return [o.token_id async for o in engine.resume_generation(ckpt)
                if o.token_id >= 0]

    async def main():
        await engine.start()
        try:
            outs = await asyncio.wait_for(
                asyncio.gather(*[one(c) for c in checkpoints]), 120)
        finally:
            await engine.stop()
        return {c.request_id: o for c, o in zip(checkpoints, outs)}

    return asyncio.run(main())


@pytest.fixture(scope="module")
def drained(models):
    """Per route: the JAX engine's uninterrupted streams, and both
    engines' drains at the same routed-token count."""
    out = {}
    for route in ("mixed", "legacy"):
        reqs = _requests(route)
        full, _, _ = _drive(_jax_engine(models), js.SamplingParams, jres.Deadline,
                            jlc.GenerationPreempted, reqs)
        before = GENERATION_CHECKPOINTS.labels(model_name="lc", reason="drain").get()
        tengine = _port_engine(models)
        port = _drive(tengine, ts.SamplingParams, tres.Deadline,
                      tlc.GenerationPreempted, reqs, DRAIN_AT)
        jax_run = _drive(_jax_engine(models), js.SamplingParams, jres.Deadline,
                         jlc.GenerationPreempted, reqs, DRAIN_AT)
        counted = (GENERATION_CHECKPOINTS.labels(model_name="lc", reason="drain").get()
                   - before)
        out[route] = dict(full=full, port=port, jax=jax_run, engine=tengine,
                          counted=counted)
    return out


@pytest.mark.parametrize("route", ["mixed", "legacy"])
def test_drain_checkpoints_equal_jax_engine(drained, route):
    """Both engines drained after DRAIN_AT tokens of "a": the same
    checkpoints (prompt, generated, sampling, model, reason), the queued
    request's with no tokens, each stream's tokens a prefix of the JAX
    engine's uninterrupted stream and equal to its checkpoint."""
    run = drained[route]
    (t_streams, t_caught, t_ckpts) = run["port"]
    (j_streams, j_caught, j_ckpts) = run["jax"]
    assert [c.request_id for c in t_ckpts] == [c.request_id for c in j_ckpts] == [
        "c", "a", "b"]  # the queued one first, then the seated slots
    for t, j in zip(t_ckpts, j_ckpts):
        td, jd = t.to_dict(), j.to_dict()
        assert td["deadline_remaining_s"] is None and jd["deadline_remaining_s"] is None
        assert td == jd
    by_id = {c.request_id: c for c in t_ckpts}
    assert by_id["c"].generated == []
    assert len(by_id["a"].generated) == DRAIN_AT
    assert len(by_id["b"].generated) == DRAIN_AT
    for rid in ("a", "b", "c"):
        assert t_caught[rid].to_dict() == by_id[rid].to_dict()
        assert t_streams[rid] == by_id[rid].generated == j_streams[rid]
        assert run["full"][rid][:len(t_streams[rid])] == t_streams[rid]
    engine = run["engine"]
    assert engine.checkpointed_count == 3 and run["counted"] == 3
    assert engine.draining
    assert engine.allocator.free_pages + engine._prefix_cache.pages_held_alone() == (
        engine.config.num_pages - 1)
    snap = engine.telemetry_snapshot()
    assert snap["counts"]["preempted"] == 3
    assert {tl["finish_reason"] for tl in snap["recent"]} == {"preempted"}


@pytest.mark.parametrize("route", ["mixed", "legacy"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_resume_splices_into_jax_stream(models, drained, route, source):
    """Every checkpoint (the JAX package's through its header form),
    resumed on a fresh port engine: checkpointed tokens + continuation ==
    the JAX engine's uninterrupted stream, greedy and seeded alike."""
    run = drained[route]
    ckpts = run[source][2]
    if source == "jax":
        ckpts = [tlc.GenerationCheckpoint.from_header(c.to_header()) for c in ckpts]
    engine = _port_engine(models)
    before = GENERATION_RESUMES.labels(model_name="lc").get()
    cont = _resume_all(engine, ckpts)
    assert engine.resume_count == len(ckpts) == 3
    assert GENERATION_RESUMES.labels(model_name="lc").get() - before == 3
    for ckpt in ckpts:
        spliced = ckpt.generated + cont[ckpt.request_id]
        assert len(spliced) == MAX_TOKENS
        assert spliced == run["full"][ckpt.request_id], ckpt.request_id


def test_resume_admission_is_strict(models):
    """resume_generation refuses, before any stream: another model's
    checkpoint, bad ids, a checkpoint with nothing left, a spent budget,
    an adapter's checkpoint; and a draining engine refuses new work."""
    engine = _port_engine(models)

    def ck(**over):
        return tlc.GenerationCheckpoint.from_dict(_ckpt_dict(
            **{"model_name": "tiny", "deadline_remaining_s": None, **over}))

    with pytest.raises(ValueError, match="identical weights"):
        engine.resume_generation(ck(model_name="other"))
    with pytest.raises(ValueError, match="integer token ids"):
        engine.resume_generation(ck(prompt_ids=[1, "x"]))
    with pytest.raises(ValueError, match="nothing left to resume"):
        engine.resume_generation(ck(generated=list(range(12))))
    with pytest.raises(tres.DeadlineExceededError):
        engine.resume_generation(ck(deadline_remaining_s=0.0))
    # no adapter is served: a checkpoint taken under one is refused, as
    # the JAX engine refuses an adapter it has not loaded
    with pytest.raises(ValueError, match="unknown LoRA adapter") as got:
        engine.resume_generation(ck(adapter="sql-lora"))
    with pytest.raises(ValueError) as want:
        _jax_engine(models).resume_generation(jlc.GenerationCheckpoint.from_dict(
            _ckpt_dict(model_name="tiny", deadline_remaining_s=None,
                       adapter="sql-lora")))
    assert str(got.value) == str(want.value)
    assert engine.resume_count == 0
    engine._draining = True
    with pytest.raises(tlc.ReplicaDrainingError):
        engine.generate([1, 2], ts.SamplingParams(max_tokens=2))
    with pytest.raises(tlc.ReplicaDrainingError):
        engine.resume_generation(ck())


# ---------------- a resume preempted again during its re-prefill ----------------

# 8 pages (7 usable) x 8 tokens; two 4-token prompts decode while the
# resumed request re-prefills prompt + generated[:-1] (24 tokens: two
# 16-token chunks on the mixed route, three 8-token ones on the legacy
# route, whose first decode dispatch runs before the resume's second
# chunk): the decode lanes outgrow the cache before its last chunk runs,
# so the prefilling resume is the victim
SQUEEZED = dict(max_batch_size=4, page_size=8, num_pages=8, max_pages_per_seq=8,
                max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=4,
                dtype="float32")
SQUEEZED_ROUTE = {"mixed": dict(use_ragged=True),
                  "legacy": dict(use_ragged=False, max_prefill_len=8,
                                 prefill_buckets=(8,))}
SQUEEZED_PROMPTS = ([1, 2, 3, 4], [9, 10, 11, 12])
RESUMED = dict(request_id="again", prompt_ids=list(range(30, 50)),
               generated=[60, 61, 62, 63, 64],
               sampling=dict(temperature=0.0, max_tokens=10, ignore_eos=True),
               model_name="tiny")


def _squeezed_run(engine, sp_cls, ckpt_cls):
    async def fresh(prompt):
        params = sp_cls(max_tokens=44, ignore_eos=True, temperature=0.0)
        return [o.token_id async for o in engine.generate(prompt, params)]

    async def resumed():
        ckpt = ckpt_cls.from_dict(dict(RESUMED))
        return [o.token_id async for o in engine.resume_generation(ckpt)
                if o.token_id >= 0]

    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(asyncio.gather(
                *[fresh(p) for p in SQUEEZED_PROMPTS], resumed()), 120)
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("route", ["mixed", "legacy"])
def test_resume_preempted_during_reprefill_matches_jax(models, route):
    """The resumed request is preempted while its re-prefill is still
    prefilling, re-admitted later with its resume state, and finishes:
    every stream equals the JAX engine's on the same cache, and the
    resume's continuation equals one on a roomy engine."""
    cfg = dict(SQUEEZED, **SQUEEZED_ROUTE[route])
    engine = _port_engine(models, **cfg)
    victims = []
    preempt_prefilling = engine._preempt_prefilling

    def spy(slot):
        req = slot.prefilling["req"]
        victims.append((req.prompt_ids, req.resume is not None))
        preempt_prefilling(slot)

    engine._preempt_prefilling = spy
    got = _squeezed_run(engine, ts.SamplingParams, tlc.GenerationCheckpoint)
    assert (RESUMED["prompt_ids"], True) in victims, victims
    assert [len(s) for s in got] == [44, 44, 5]
    jengine = _jax_engine(models, **cfg)
    want = _squeezed_run(jengine, js.SamplingParams, jlc.GenerationCheckpoint)
    assert jengine.preemption_count > 0
    assert got == want
    roomy = _port_engine(models, **dict(cfg, num_pages=64))
    assert _resume_all(roomy, [tlc.GenerationCheckpoint.from_dict(dict(RESUMED))])[
        "again"] == got[2]
