"""The PyTorch port's resilience layer against the JAX package on the CPU:
request deadlines (the header table, the contextvar scope), load
shedding (one depth sequence, one path table, the env knobs), the fault
plan, and the gray-failure watchdog on one FakeClock script; then the
engine: a queued request whose deadline dies is failed with
DeadlineExceededError, a FaultPlan wedge at "engine.fetch" wedges both
engines alike (liveness false), and a confirmed stall self-drains with
reason "stall" into a checkpoint that resumes token-exactly."""

import asyncio
import threading

import jax
import numpy as np
import pytest

from kserve_tpu import resilience as jres
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine import types as jtypes
from kserve_tpu.engine import watchdog as jwd
from kserve_tpu.engine.compiled import build_compiled
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch import lifecycle as tlc
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine import types as ttypes
from kserve_tpu_torch.engine import watchdog as twd
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.metrics import DEADLINE_REJECTED, GENERATION_CHECKPOINTS
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.runtimes.generative_server import TorchGenerativeModel

# ---------------- deadlines ----------------

HEADERS = ["", "abc", "-1", "0", "1.5", "inf", "nan", None, " 2 ", "1e3", "-0"]


def _deadline_view(pkg, value):
    clock = pkg.FakeClock(100.0)
    d = pkg.Deadline.from_header(value, clock)
    if d is None:
        return None
    view = [d.remaining(), d.expired, d.to_header()]
    clock.advance(1.0)
    view += [d.remaining(), d.expired, d.to_header()]
    return [("nan" if isinstance(v, float) and v != v else v) for v in view]


@pytest.mark.parametrize("value", HEADERS, ids=repr)
def test_deadline_from_header_matches_jax(value):
    """Deadline.from_header over one table: the same budget, expiry and
    header form now and a second later."""
    assert _deadline_view(tres, value) == _deadline_view(jres, value)


def test_deadline_scope_and_error():
    assert tres.DEADLINE_HEADER == jres.DEADLINE_HEADER == "x-request-deadline"
    assert tres.current_deadline() is None
    outer = tres.Deadline.after(5.0)
    with tres.deadline_scope(outer):
        assert tres.current_deadline() is outer
        with tres.deadline_scope(None):
            assert tres.current_deadline() is None
        assert tres.current_deadline() is outer
    assert tres.current_deadline() is None
    err = tres.DeadlineExceededError()
    assert isinstance(err, TimeoutError) and str(err) == str(jres.DeadlineExceededError())


# ---------------- load shedding ----------------

DEPTHS = [0, 1, 3, 4, 5, 4, 3, 2, 3, 4, 9, 1, 0, 4, 3]
PATHS = ["/openai/v1/completions", "/openai/v1/chat/completions", "/openai/x",
         "/v1/models/m:predict", "/v1/models/m:explain", "/v2/models/m/infer",
         "/v1/timeseries/forecast", "/v1/prefill/m", "/v2/health/ready",
         "/metrics", "/admin/drain", "/v1/internal/scheduler/state",
         "/v2/repository/models/m/load", "/openai"]


@pytest.mark.parametrize("watermark", [4, 0, -1, 1])
def test_load_shedder_matches_jax(watermark):
    """The hysteresis band over one depth sequence: the same decisions,
    states and counts (and on_shed calls)."""

    def run(pkg):
        calls = []
        shedder = pkg.LoadShedder(pkg.ShedConfig(queue_watermark=watermark),
                                  on_shed=lambda: calls.append(1))
        out = [(shedder.should_shed(d), shedder.shedding, shedder.shed_count)
               for d in DEPTHS]
        return out, len(calls), shedder.enabled, shedder.retry_after_s

    assert run(tres) == run(jres)


def test_inference_paths_and_env_match_jax():
    assert ([tres.is_inference_path(p) for p in PATHS]
            == [jres.shedding.is_inference_path(p) for p in PATHS])
    env = {"KSERVE_TPU_SHED_WATERMARK": "7",
           "KSERVE_TPU_SHED_RESUME_FRACTION": "0.5",
           "KSERVE_TPU_SHED_RETRY_AFTER_S": "2.5"}
    for e in (env, {}):
        assert tres.ShedConfig.from_env(e).__dict__ == jres.ShedConfig.from_env(e).__dict__


def test_fault_plan_matches_jax():
    """One seeded plan, one call sequence: the same injections."""

    def run(pkg):
        plan = pkg.FaultPlan([
            pkg.FaultSpec("engine.fetch", "wedge", after=2, count=2),
            pkg.FaultSpec("engine.preempt", "preempt", probability=0.5),
            pkg.FaultSpec("engine", "replica_crash", count=1)], seed=3)
        out = []
        for i in range(20):
            spec = plan.decide("engine.fetch" if i % 3 else "engine.preempt")
            out.append(None if spec is None else spec.kind)
        return out, plan.log

    assert run(tres) == run(jres)


# ---------------- the watchdog on one FakeClock script ----------------

class _Task:
    def __init__(self, started):
        self._wd_started_s = started
        self.cancelled = False

    def done(self):
        return self.cancelled

    def cancel(self):
        self.cancelled = True


# steps: ("busy", bool), ("advance", s), ("tick",), ("progress",),
# ("fetch",), ("fetched",)
WATCHDOG_SCRIPT = (
    [("busy", False), ("advance", 5.0), ("tick",), ("busy", True), ("tick",),
     ("advance", 0.9), ("tick",), ("advance", 0.2), ("tick",), ("progress",),
     ("tick",), ("advance", 1.1), ("tick",), ("busy", False), ("tick",),
     ("busy", True), ("fetch",), ("advance", 1.2), ("tick",), ("advance", 0.5),
     ("tick",), ("advance", 0.6), ("tick",), ("fetched",), ("progress",),
     ("advance", 5.0), ("tick",), ("progress",), ("tick",)])


def _watchdog_run(mod, clock_cls):
    clock = clock_cls()
    busy = [False]
    confirmed = []
    tasks = [_Task(0.0), _Task(4.0)]
    wd = mod.EngineWatchdog(
        mod.WatchdogConfig(interval_s=0.25, suspect_after_s=1.0,
                           confirm_after_s=1.0, task_stall_s=6.0),
        clock=clock, busy=lambda: busy[0], on_confirmed=confirmed.append,
        tasks=lambda: tasks)
    out = []
    for step in WATCHDOG_SCRIPT:
        op = step[0]
        if op == "busy":
            busy[0] = step[1]
        elif op == "advance":
            clock.advance(step[1])
        elif op == "tick":
            wd.tick()
        elif op == "progress":
            wd.note_progress()
        elif op == "fetch":
            wd.fetch_started()
        elif op == "fetched":
            wd.fetch_done()
        out.append((wd.state, wd.reason, wd.snapshot(),
                    [t.cancelled for t in tasks], list(confirmed)))
    return out


def test_watchdog_matches_jax():
    """The same script of ticks, progress and fetch stamps on a FakeClock
    gives the JAX watchdog's states, reasons, snapshots, task reaping and
    confirm calls, step by step."""
    got = _watchdog_run(twd, tres.FakeClock)
    assert got == _watchdog_run(jwd, jres.FakeClock)
    assert got[-1][0] == twd.WATCHDOG_CONFIRMED  # the script reaches it
    assert twd.WATCHDOG_STATES == jwd.WATCHDOG_STATES
    for env in ({}, {"KSERVE_TPU_WATCHDOG": "on"}, {"KSERVE_TPU_WATCHDOG": "0"},
                {"KSERVE_TPU_WATCHDOG": " Yes "}):
        assert (twd.watchdog_enabled_from_env(env)
                == jwd.watchdog_enabled_from_env(env))
    tcfg, jcfg = ttypes.EngineConfig(), jtypes.EngineConfig()
    for name in ("step_deadline_s", "watchdog", "watchdog_interval_s",
                 "watchdog_suspect_s", "watchdog_confirm_s",
                 "watchdog_task_stall_s", "watchdog_salvage_grace_s"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


def test_watchdog_task_runs_and_stops():
    async def main():
        clock = tres.FakeClock()
        wd = twd.EngineWatchdog(twd.WatchdogConfig(interval_s=0.5), clock=clock,
                                busy=lambda: True, on_confirmed=lambda r: None)
        wd.start()
        for _ in range(30):
            await asyncio.sleep(0)
        wd.stop()
        return clock.sleeps, wd.state

    sleeps, state = asyncio.run(main())
    assert sleeps and set(sleeps) == {0.5}
    assert state == twd.WATCHDOG_CONFIRMED  # 15 s of virtual time, no progress


def test_deadline_fetcher_times_out_and_relays():
    fetcher = ttypes._DeadlineFetcher()
    try:
        assert fetcher.fetch(lambda: 3, 5.0) == 3
        with pytest.raises(ZeroDivisionError):
            fetcher.fetch(lambda: 1 / 0, 5.0)
        assert asyncio.run(fetcher.fetch_async(lambda: 4, 5.0)) == 4
        gate = threading.Event()
        with pytest.raises(TimeoutError):
            fetcher.fetch(gate.wait, 0.05)
        gate.set()
    finally:
        fetcher.close()
    with pytest.raises(RuntimeError, match="engine stopped"):
        fetcher.fetch(lambda: 1, 1.0)


# ---------------- engines ----------------

ENGINE = dict(max_batch_size=1, page_size=8, num_pages=64, max_pages_per_seq=8,
              max_prefill_len=16, prefill_buckets=(16,), steps_per_sync=1,
              dtype="float32")


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port(models, label="res", clock=None, **cfg):
    _, tcfg, _, tparams = models
    return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, **cfg)), ByteTokenizer(512),
                     params=tparams, rng_seed=0, device="cpu",
                     metrics_label=label, checkpoint_label="tiny", clock=clock)


_JAX_PROGRAMS = {}


def _jax(models, **cfg):
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


def _expired_in_queue(engine, sp_cls, res):
    """One request decodes in the only slot; a second, whose deadline (on
    a FakeClock) dies while it waits, is failed from the queue.  Returns
    (the first's token count, the second's error type)."""
    clock = res.FakeClock(0.0)

    async def main():
        await engine.start()
        try:
            first = engine.generate([5, 6, 7], sp_cls(max_tokens=30, ignore_eos=True,
                                                      temperature=0.0))
            tokens = [(await first.__anext__()).token_id]
            with res.deadline_scope(res.Deadline(10.0, clock)):
                second = engine.generate([8, 9], sp_cls(max_tokens=4))
            waiting = asyncio.ensure_future(second.__anext__())
            while engine.queue_depth == 0:
                await asyncio.sleep(0)
            clock.advance(20.0)
            err = None
            try:
                await asyncio.wait_for(waiting, 60)
            except res.DeadlineExceededError as e:
                err = e
            tokens += [o.token_id async for o in first]
            return len(tokens), type(err).__name__, engine.queue_depth
        finally:
            await engine.stop()

    return asyncio.run(main())


def test_queued_request_deadline_expires_like_jax(models):
    """The queued request gets DeadlineExceededError (504 upstream) and
    deadline_rejected{component="engine"} moves by one, while the seated
    one completes; the JAX engine does the same."""
    before = DEADLINE_REJECTED.labels(component="engine").get()
    got = _expired_in_queue(_port(models), ts.SamplingParams, tres)
    assert DEADLINE_REJECTED.labels(component="engine").get() - before == 1
    assert got == (30, "DeadlineExceededError", 0)
    assert _expired_in_queue(_jax(models), js.SamplingParams, jres) == got
    # an already expired budget is refused at admission
    engine = _port(models)
    with tres.deadline_scope(tres.Deadline.after(-1.0)):
        with pytest.raises(tres.DeadlineExceededError):
            engine.generate([1], ts.SamplingParams(max_tokens=2))
    assert DEADLINE_REJECTED.labels(component="engine").get() - before == 2


def _wedged_run(engine, sp_cls, plan):
    engine.fault_plan = plan
    tokens = []

    async def main():
        await engine.start()
        try:
            async for out in engine.generate([5, 6, 7], sp_cls(
                    max_tokens=12, ignore_eos=True, temperature=0.0)):
                tokens.append(out.token_id)
        except Exception as e:  # noqa: BLE001 — the type is what is compared
            return type(e).__name__
        finally:
            await engine.stop()

    return asyncio.run(main()), tokens, engine.wedged


def test_fault_plan_wedge_flips_liveness_like_jax(models):
    """A wedge at the third "engine.fetch": the stream fails with
    EngineWedgedError after the same tokens as the JAX engine's, the
    engine reads wedged, engine_wedged is set and the model's liveness is
    false."""
    engine = _port(models, label="wedge")
    got = _wedged_run(engine, ts.SamplingParams,
                      tres.FaultPlan([tres.FaultSpec("engine.fetch", "wedge", after=2)]))
    want = _wedged_run(_jax(models), js.SamplingParams,
                       jres.FaultPlan([jres.FaultSpec("engine.fetch", "wedge", after=2)]))
    assert got == want
    assert got[0] == "EngineWedgedError" and got[2] is True and len(got[1]) == 2
    model = TorchGenerativeModel("wedge", models[1], random_weights=True, device="cpu")
    model.engine = engine
    assert asyncio.run(model.live()) is False
    from kserve_tpu_torch.metrics import ENGINE_WEDGED

    assert ENGINE_WEDGED.labels(model_name="wedge").get() == 1


def test_confirmed_stall_self_drains_with_reason_stall(models):
    """The worker wedges (a device call blocks) mid-generation with the
    watchdog on: it suspects, confirms (fetch_stalled), calls the server's
    hook and self-drains; the stream ends in GenerationPreempted with a
    "stall" checkpoint of every token it showed, the engine refuses new
    work, and a healthy engine resumes the checkpoint token for token."""
    # budgets far above a tiny CPU dispatch, also on a loaded machine
    engine = _port(models, watchdog=True, watchdog_interval_s=0.05,
                   watchdog_suspect_s=0.5, watchdog_confirm_s=0.5)
    gate = threading.Event()
    dispatch = engine._dispatch
    calls = [0]

    def wedging(plan):
        calls[0] += 1
        if calls[0] == 5:
            gate.wait(60)
        return dispatch(plan)

    engine._dispatch = wedging
    hook = []
    engine.on_stall_confirmed = hook.append
    before = GENERATION_CHECKPOINTS.labels(model_name="res", reason="stall").get()
    params = ts.SamplingParams(max_tokens=16, ignore_eos=True, temperature=0.0)
    shown, caught = [], {}

    async def main():
        await engine.start()
        try:
            async for out in engine.generate([60, 61, 62], params, request_id="g1"):
                shown.append(out.token_id)
        except tlc.GenerationPreempted as e:
            caught["ckpt"] = e.checkpoint
        state = engine.scheduler_state()["watchdog"]
        with pytest.raises(tlc.ReplicaDrainingError):
            engine.generate([1, 2], params)
        gate.set()
        await engine.stop()
        return state

    state = asyncio.run(asyncio.wait_for(main(), 60))
    ckpt = caught["ckpt"]
    assert ckpt.reason == "stall" and ckpt.generated == shown and len(shown) == 4
    assert hook == ["fetch_stalled"] and engine.draining
    assert state["state"] == "stall_confirmed" and state["reason"] == "fetch_stalled"
    assert state["confirmed_total"] == 1 and state["suspected_total"] >= 1
    assert GENERATION_CHECKPOINTS.labels(model_name="res", reason="stall").get() - before == 1
    healthy = _port(models)

    async def resume():
        await healthy.start()
        try:
            return [o.token_id async for o in healthy.resume_generation(ckpt)]
        finally:
            await healthy.stop()

    async def reference():
        ref = _port(models)
        await ref.start()
        try:
            return [o.token_id async for o in ref.generate([60, 61, 62], params)]
        finally:
            await ref.stop()

    assert shown + asyncio.run(resume()) == asyncio.run(reference())


def test_watchdog_window_opens_at_start(models):
    """Time between construction and start (on the card: the kernel build)
    is not a stall: start() stamps progress before the watchdog ticks."""
    clock = tres.FakeClock(0.0)
    engine = _port(models, clock=clock, watchdog=True)
    clock.advance(100.0)

    async def main():
        await engine.start()
        try:
            assert engine._watchdog._last_progress == 100.0
            engine._watchdog.tick()
            return engine.scheduler_state()["watchdog"]
        finally:
            await engine.stop()

    assert asyncio.run(main())["suspected_total"] == 0


def test_aot_warmup_runs_before_ready_and_is_not_traffic(models):
    """aot_warmup (auto on CUDA, asked for here) drives one generation
    through the loop inside start(): it leaves no dispatch count, timeline,
    held page or prefix entry behind, the watchdog's window opens after it,
    and the first request's greedy stream is the JAX engine's."""
    engine = _port(models, label="warm", aot_warmup=True, watchdog=True)
    free0 = engine.allocator.free_pages

    async def stream(eng, params):
        await eng.start()
        try:
            left = (eng.steps, eng.dense_steps, sum(eng.legacy_dispatches.values()),
                    eng.telemetry_snapshot()["counts"], len(eng._prefix_cache),
                    eng.allocator.free_pages) if eng is engine else None
            return left, [o.token_id async for o in eng.generate([60, 61, 62], params)]
        finally:
            await eng.stop()

    left, got = asyncio.run(stream(engine, ts.SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True)))
    steps, dense, legacy, counts, prefix_entries, free = left
    assert (steps, dense, legacy, prefix_entries, free) == (0, 0, 0, 0, free0)
    assert not any(counts.values()), counts
    assert {"compile", "ready"} <= set(engine.startup_phases)
    assert engine.scheduler_state()["watchdog"]["suspected_total"] == 0
    _, want = asyncio.run(stream(_jax(models), js.SamplingParams(
        max_tokens=6, temperature=0.0, ignore_eos=True)))
    assert got == want and len(got) == 6
