"""The port's autoscaler (kserve_tpu_torch/autoscale, api/http_transport.py,
controlplane/gvk.py) against the JAX package's, on the CPU.

Exact equality throughout (no tolerance: the policies are integer and
float arithmetic on the same inputs in the same order):

- signals: `from_dict` / `to_dict` / `demand` of seeded fleet dicts, and
  `ArrivalHistory`'s rate and slope over a seeded arrival stream;
- policies: seeded streams of ~200 snapshots through the JAX and the port
  policies give the same `ScalingDecision.to_dict()` sequences, the
  replica count following the decisions; the streams reach idle-to-zero,
  a held wake, cooldowns, hysteresis steps and (predictive) periodic
  prewarm and burst slope;
- `HoldQueue` and `AutoscalerLoop` driven by the same scripts on
  `FakeClock`: the same outcomes, order and stats; clamping, the demand
  wake, a failing tick failing `run()`, the metrics under the JAX names
  and labels (parsed by prometheus_client);
- `HTTPCluster` and `DeploymentActuator` against the JAX stub apiserver:
  the same objects, statuses and `APIError`s as the JAX `HTTPCluster`;
- `EPPSignalSource` against the port's EPP, staleness included, and the
  CLI's flags and its exit code when the loop fails."""

import asyncio
import dataclasses
import json
import ssl
import sys
import threading
from unittest import mock

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families

from kserve_tpu import autoscale as ja
from kserve_tpu import metrics as jmetrics
from kserve_tpu import resilience as jres
from kserve_tpu.api import http_transport as jht
from kserve_tpu.autoscale import __main__ as jcli
from kserve_tpu.autoscale.actuator import DeploymentActuator as JDeploymentActuator
from kserve_tpu.controlplane.apiserver import start_apiserver
from kserve_tpu_torch import autoscale as ta
from kserve_tpu_torch import metrics as tmetrics
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.api import http_transport as tht
from kserve_tpu_torch.autoscale import __main__ as tcli
from kserve_tpu_torch.controlplane import gvk as tgvk
from kserve_tpu_torch.scheduler import epp as tepp
from kserve_tpu_torch.scheduler.picker import EndpointPicker as TPicker

# ---------------------------------------------------------------- signals


def _replica_state(rng, i):
    s = {"url": f"http://r{i}:80", "healthy": bool(rng.random() < 0.8),
         "lifecycle": str(rng.choice(["READY", "DRAINING", "ready", None])),
         "queue_depth": int(rng.integers(0, 9)), "inflight": int(rng.integers(0, 5))}
    if rng.random() < 0.5:
        s["shed"] = {"count": int(rng.integers(0, 20)), "shedding": bool(rng.random() < 0.3)}
    else:
        s["sheds_total"], s["shedding"] = int(rng.integers(0, 20)), bool(rng.random() < 0.3)
    if rng.random() < 0.6:
        s["telemetry"] = {"ttft_p99_s": float(rng.uniform(0.1, 3)),
                          "itl_p99_s": float(rng.uniform(0.01, 0.2))}
    if rng.random() < 0.3:
        s["health"] = {"status": str(rng.choice(["healthy", "degraded", "quarantined"]))}
    if rng.random() < 0.2:
        s["prefix_store"] = {"resident": int(rng.integers(0, 40))}
    return s


@pytest.mark.parametrize("seed", range(4))
def test_signals_dicts_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        states = [_replica_state(rng, i) for i in range(int(rng.integers(0, 5)))]
        kw = dict(arrival_rate_per_s=float(rng.choice([0.0, rng.uniform(0, 9)])),
                  arrival_slope_per_s2=float(rng.uniform(-2, 2)),
                  shed_rate_per_s=float(rng.uniform(0, 1)),
                  held_requests=int(rng.choice([0, 0, 3])))
        at = float(rng.uniform(0, 1e4))
        j = ja.FleetSignals.from_replica_states(states, at, **kw)
        t = ta.FleetSignals.from_replica_states(states, at, **kw)
        assert t.to_dict() == j.to_dict()
        assert t.demand == j.demand
        # the wire form, with keys of a later version, rebuilds alike
        wire = json.loads(json.dumps(j.to_dict()))
        wire["future_field"] = 1
        for r in wire["replicas"]:
            r["novel"] = "x"
        tj, tt = ja.FleetSignals.from_dict(wire), ta.FleetSignals.from_dict(wire)
        assert tt.to_dict() == tj.to_dict() == j.to_dict()
        assert tt.demand == tj.demand
    # demand's four sources, one at a time
    for field in ("held_requests", "queue_depth", "inflight", "arrival_rate_per_s"):
        assert ta.FleetSignals(**{field: 1}).demand and ja.FleetSignals(**{field: 1}).demand
    assert not ta.FleetSignals(ready_replicas=3).demand


def test_arrival_history_matches_jax():
    """The rate and slope the EPP exports under `fleet`, over a seeded
    stream of bursts and gaps, read at every arrival and past the window."""
    rng = np.random.default_rng(19)
    gaps = np.concatenate([rng.exponential(0.05, 300), rng.exponential(2.0, 40),
                           rng.exponential(0.01, 200)])
    j = ja.ArrivalHistory(bucket_s=0.5, window_s=30.0)
    t = ta.ArrivalHistory(bucket_s=0.5, window_s=30.0)
    now = 0.0
    for gap, n in zip(gaps, rng.integers(1, 4, gaps.size)):
        now += float(gap)
        j.record(now, int(n))
        t.record(now, int(n))
        assert t.rate(now) == j.rate(now)
        assert t.slope(now) == j.slope(now)
    for later in (now + 5.0, now + 29.0, now + 200.0):
        assert (t.rate(later), t.slope(later)) == (j.rate(later), j.slope(later))
    assert t.total == j.total


# ---------------------------------------------------------------- policies

MAX_REPLICAS = 5
REACTIVE = dict(queue_high_per_replica=4.0, queue_low_per_replica=1.0,
                idle_to_zero_s=6.0, up_cooldown_s=2.0, down_cooldown_s=4.0,
                ttft_p99_slo_s=2.0)
PREDICTIVE = dict(slope_up_per_s2=3.0, burst_rate_per_s=10.0, min_period_s=5.0,
                  period_tolerance_frac=0.2, min_intervals=2, prewarm_lead_s=3.0,
                  prewarm_hold_s=4.0, prewarm_replicas=MAX_REPLICAS + 1)


def _policy(mod, kind):
    if kind == "reactive":
        return mod.ReactivePolicy(mod.ReactiveConfig(**REACTIVE))
    if kind == "reactive-default":
        return mod.ReactivePolicy()
    return mod.PredictivePolicy(reactive=mod.ReactivePolicy(mod.ReactiveConfig(**REACTIVE)),
                                config=mod.PredictiveConfig(**PREDICTIVE))


def _snapshot(rng, t, current, segment):
    """One fleet snapshot of a `segment` (idle | held | load | shed | ttft |
    burst) with `current` replicas, some perhaps not ready yet."""
    ready = current if rng.random() < 0.8 else int(rng.integers(0, current + 1))
    kw = dict(at_s=t, ready_replicas=ready, total_replicas=MAX_REPLICAS)
    # a periodic burst every 20 s of virtual time (the learner's food)
    rate = 12.0 if (t % 20.0) < 2.0 else 0.0
    if segment == "idle":
        pass
    elif segment == "held":
        kw.update(ready_replicas=0, held_requests=int(rng.integers(1, 14)))
    elif segment == "load":
        kw.update(queue_depth=int(rng.integers(0, 10 * max(ready, 1) + 1)),
                  inflight=int(rng.integers(0, 3 * max(ready, 1) + 1)))
        rate = max(rate, float(rng.uniform(0.5, 4)))
    elif segment == "shed":
        kw.update(shed_rate_per_s=float(rng.uniform(0, 1)), inflight=1)
    elif segment == "ttft":
        kw.update(ttft_p99_s=float(rng.uniform(0.5, 4)), inflight=1)
    elif segment == "burst":
        # below the learner's burst rate: onsets stay periodic
        rate = max(rate, float(rng.uniform(1, 9)))
        kw.update(arrival_slope_per_s2=float(rng.uniform(0, 6)))
    kw["arrival_rate_per_s"] = rate
    return kw


def _stream_decisions(kind, seed, n=200):
    rng = np.random.default_rng(seed)
    jp, tp = _policy(ja, kind), _policy(ta, kind)
    current, t, out = 0, 0.0, []
    segments = ["idle", "held", "load", "shed", "ttft", "burst"]
    segment, left = "idle", 0
    for _ in range(n):
        if left == 0:
            segment, left = str(rng.choice(segments)), int(rng.integers(4, 16))
        left -= 1
        t += float(rng.choice([0.5, 1.0, 1.0, 2.0]))
        kw = _snapshot(rng, t, current, segment)
        want = jp.decide(ja.FleetSignals(**kw), current)
        got = tp.decide(ta.FleetSignals(**kw), current)
        assert got.to_dict() == want.to_dict(), (t, segment, kw)
        assert got.signals.to_dict() == want.signals.to_dict()
        out.append(want.to_dict())
        current = max(0, min(MAX_REPLICAS, want.target))
    if kind == "predictive":
        assert tp.detector.onsets == jp.detector.onsets
    return out


@pytest.mark.parametrize("kind", ["reactive", "reactive-default", "predictive"])
def test_policy_decision_streams_match_jax(kind):
    reasons = set()
    for seed in range(3):
        reasons |= {d["reason"] for d in _stream_decisions(kind, seed)}
    # the streams reached the paths they are meant to hold equal
    want = {"hold_demand", "cooldown", "low_load", "queue_depth", "steady", "shed_rate"}
    if kind != "reactive-default":
        # the default 10 s idle window outlasts the streams' idle spells
        want |= {"idle_zero", "ttft_slo"}
    if kind == "predictive":
        want |= {"periodic_prewarm", "burst_slope"}
    assert want <= reasons, sorted(reasons)


def test_vocabulary_and_refusal_match_jax():
    assert ta.REASONS == ja.REASONS and ta.ACTIONS == ja.ACTIONS
    assert dataclasses.asdict(ta.ReactiveConfig()) == dataclasses.asdict(ja.ReactiveConfig())
    assert (dataclasses.asdict(ta.PredictiveConfig())
            == dataclasses.asdict(ja.PredictiveConfig()))
    with pytest.raises(ValueError):
        ta.ScalingDecision(at_s=0.0, current=1, target=2, reason="vibes",
                           signals=ta.FleetSignals())


# ---------------------------------------------------------------- hold queue


async def _hold_script(mod, res, script):
    """Run one hold-queue script on a FakeClock; returns the trace of
    outcomes (in the order they happened), the stats, the held count at
    each `on_hold` and the sleeps asked of the clock.  `spawn` starts a
    holder task, `yield` lets every task run one step (a FakeClock sleep
    ends one step after it starts: a hold's timer fires only when the
    script yields twice), `direct` awaits a hold that ends at once."""
    clock = res.FakeClock()
    fired = []
    q = mod.HoldQueue(clock=clock, max_holds=2, default_hold_s=60.0, retry_after_s=3.0,
                      on_hold=lambda: fired.append(q.held))
    trace, tasks = [], []

    async def holder(name, deadline_s):
        dl = None if deadline_s is None else res.Deadline.after(deadline_s, clock)
        try:
            await q.hold(dl)
            trace.append((name, "replayed"))
        except mod.HoldExpiredError:
            trace.append((name, "expired"))
        except mod.HoldOverflowError as exc:
            trace.append((name, "overflow", exc.retry_after_s))
        except RuntimeError as exc:
            trace.append((name, "failed", str(exc)))

    for step in script:
        op = step[0]
        if op == "spawn":
            tasks.append(asyncio.ensure_future(holder(step[1], step[2])))
        elif op == "direct":
            await holder(step[1], step[2])
        elif op == "yield":
            await asyncio.sleep(0)
        elif op == "advance":
            clock.advance(step[1])
        elif op == "release":
            trace.append(("release_all", q.release_all()))
        elif op == "fail":
            trace.append(("fail_all", q.fail_all(RuntimeError("wake failed"))))
        elif op == "held":
            trace.append(("held", q.held))
    await asyncio.gather(*tasks)
    return trace, dict(q.stats), fired, list(clock.sleeps)


HOLD_SCRIPTS = {
    "fifo": [("spawn", "a", None), ("spawn", "b", None), ("yield",), ("held",),
             ("release",)],
    "expired_upfront": [("direct", "a", -1.0), ("held",)],
    "deadline_not_default": [("spawn", "a", 2.0)],
    "overflow": [("spawn", "a", None), ("spawn", "b", None), ("yield",), ("held",),
                 ("direct", "c", None), ("release",)],
    "overflow_evicts_expired": [("spawn", "a", 5.0), ("spawn", "b", None), ("yield",),
                                ("advance", 6.0), ("spawn", "c", None), ("yield",),
                                ("held",), ("release",)],
    "fail_all": [("spawn", "a", None), ("spawn", "b", None), ("yield",), ("fail",),
                 ("spawn", "c", None), ("yield",), ("release",)],
}
HOLD_WANT = {
    "fifo": [("held", 2), ("release_all", 2), ("a", "replayed"), ("b", "replayed")],
    "expired_upfront": [("a", "expired"), ("held", 0)],
    "deadline_not_default": [("a", "expired")],
    "overflow": [("held", 2), ("c", "overflow", 3.0), ("release_all", 2),
                 ("a", "replayed"), ("b", "replayed")],
    # c finds the queue full: it evicts a (past its deadline) and b (past
    # the default budget once the first timers' sleeps moved the clock)
    "overflow_evicts_expired": [("held", 1), ("release_all", 1), ("a", "expired"),
                                ("b", "expired"), ("c", "replayed")],
    "fail_all": [("fail_all", 2), ("release_all", 1), ("a", "failed", "wake failed"),
                 ("b", "failed", "wake failed"), ("c", "replayed")],
}


@pytest.mark.parametrize("name", sorted(HOLD_SCRIPTS))
def test_hold_queue_scripts_match_jax(name):
    want = asyncio.run(_hold_script(ja, jres, HOLD_SCRIPTS[name]))
    got = asyncio.run(_hold_script(ta, tres, HOLD_SCRIPTS[name]))
    assert got == want
    assert got[0] == HOLD_WANT[name]
    if name == "deadline_not_default":
        assert got[3] == [2.0]  # the budget is the deadline's, not the default


# ---------------------------------------------------------------- the loop


def _sig(mod, at_s=0.0, ready=1, queue=0, held=0, total=None):
    return mod.FleetSignals(at_s=at_s, ready_replicas=ready,
                            total_replicas=ready if total is None else total,
                            queue_depth=queue, held_requests=held)


def _actuator(mod, current):
    class Act(mod.ReplicaActuator):
        def __init__(self):
            self.current, self.calls = current, []

        async def current_replicas(self):
            return self.current

        async def scale_to(self, n):
            self.calls.append(n)
            self.current = n

    return Act()


async def _loop_script(mod, res):
    """Clamping, a demand wake mid-interval, decision counts and the last
    decisions' dicts."""
    clock = res.FakeClock()
    act = _actuator(mod, 1)
    loop = mod.AutoscalerLoop(
        mod.ReactivePolicy(mod.ReactiveConfig(queue_high_per_replica=1.0, max_step_up=10,
                                              up_cooldown_s=0.0)),
        lambda: _sig(mod, at_s=clock.now(), ready=act.current, queue=100),
        act, clock=clock, min_replicas=1, max_replicas=3)
    first = await loop.tick()
    clamped = (act.calls[:], first.to_dict())
    # idle at zero until a hold parks and pokes the loop
    clock2 = res.FakeClock()
    act2 = _actuator(mod, 0)
    held = {"n": 0}
    loop2 = mod.AutoscalerLoop(
        mod.ReactivePolicy(),
        lambda: _sig(mod, at_s=clock2.now(), ready=0, held=held["n"], total=2),
        act2, clock=clock2, interval_s=3600.0, max_replicas=2)
    task = asyncio.ensure_future(loop2.run())
    for _ in range(6):
        await asyncio.sleep(0)
    before = act2.calls[:]
    held["n"] = 4
    loop2.notify_demand()
    for _ in range(8):
        await asyncio.sleep(0)
    loop2.stop()
    for _ in range(8):
        await asyncio.sleep(0)
    assert task.done()
    return (clamped, before, act2.calls[:], loop2.decision_counts(),
            [d.to_dict() for d in loop2.decisions], loop2.ticks)


def test_loop_scripts_match_jax():
    want = asyncio.run(_loop_script(ja, jres))
    got = asyncio.run(_loop_script(ta, tres))
    assert got == want
    (calls, first), before, after, counts, _, _ = got
    assert calls == [3] and first["target"] == 3 and first["reason"] == "queue_depth"
    assert before == [] and after and after[0] == 1
    assert counts.get("scale_up:hold_demand") == 1


def test_loop_failures_surface_from_run():
    clock = tres.FakeClock()

    def bad_signals():
        raise RuntimeError("scrape exploded")

    loop = ta.AutoscalerLoop(ta.ReactivePolicy(), bad_signals, _actuator(ta, 1),
                             clock=clock)
    with pytest.raises(RuntimeError, match="scrape exploded"):
        asyncio.run(loop.run())

    class Broken(ta.ReplicaActuator):
        async def current_replicas(self):
            return 0

        async def scale_to(self, n):
            raise OSError("apiserver down")

    loop = ta.AutoscalerLoop(ta.ReactivePolicy(), lambda: _sig(ta, ready=0, held=2),
                             Broken(), clock=clock)
    with pytest.raises(OSError, match="apiserver down"):
        asyncio.run(loop.run())
    with pytest.raises(ValueError):
        ta.AutoscalerLoop(ta.ReactivePolicy(), bad_signals, Broken(), min_replicas=3,
                          max_replicas=2)


def _families(text):
    return {f.name: f for f in text_string_to_metric_families(text)}


def test_metrics_match_jax_names_and_labels():
    clock = tres.FakeClock()
    loop = ta.AutoscalerLoop(
        ta.ReactivePolicy(ta.ReactiveConfig(queue_high_per_replica=1.0, up_cooldown_s=0.0,
                                            ttft_p99_slo_s=None)),
        lambda: ta.FleetSignals(at_s=clock.now(), ready_replicas=1, total_replicas=1,
                                queue_depth=50, ttft_p99_s=0.5),
        _actuator(ta, 1), clock=clock, max_replicas=4)
    child = tmetrics.AUTOSCALER_DECISIONS.labels(action="scale_up", reason="queue_depth")
    before = child.get()
    asyncio.run(loop.tick())
    assert child.get() == before + 1
    tmetrics.GATEWAY_HOLDS.labels(outcome="replayed").inc()
    ours = _families(tmetrics.generate_latest().decode())
    pairs = ((tmetrics.AUTOSCALER_DECISIONS, jmetrics.AUTOSCALER_DECISIONS),
             (tmetrics.AUTOSCALER_TARGET_REPLICAS, jmetrics.AUTOSCALER_TARGET_REPLICAS),
             (tmetrics.AUTOSCALER_SIGNAL, jmetrics.AUTOSCALER_SIGNAL),
             (tmetrics.GATEWAY_HOLDS, jmetrics.GATEWAY_HOLDS))
    for metric, jax_metric in pairs:
        # prometheus_client names a counter's family without "_total"
        fam = ours[jax_metric._name]
        assert (fam.type, fam.documentation) == (jax_metric._type,
                                                 jax_metric._documentation)
        assert metric.labelnames == tuple(jax_metric._labelnames)
    samples = {(s.name, tuple(sorted(s.labels.items()))): s.value
               for s in ours["autoscaler_signal"].samples}
    assert samples[("autoscaler_signal", (("signal", "queue_depth"),))] == 50
    assert samples[("autoscaler_signal", (("signal", "ttft_p99_s"),))] == 0.5
    assert ours["autoscaler_target_replicas"].samples[0].value == 3


# ---------------------------------------------------------------- the apiserver


@pytest.fixture(scope="module")
def apiserver():
    server = start_apiserver()
    yield server
    server.stop()


def _strip(obj):
    """An object less what the server stamps per write (and its namespace)."""
    if isinstance(obj, list):
        return [_strip(o) for o in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        if k in ("resourceVersion", "uid", "creationTimestamp", "namespace",
                 "generation", "managedFields", "selfLink"):
            continue
        out[k] = _strip(v)
    return out


def _cluster_script(ht, actuator_cls, base_url, ns):
    """The same operations through one package's HTTPCluster; returns what
    each answered (stamps stripped)."""
    c = ht.HTTPCluster(base_url)
    c.wait_ready(timeout=10)
    out = []
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "cm", "namespace": ns, "labels": {"app": "x"}},
          "data": {"k": "v"}}
    out.append(("create", _strip(c.create(cm))))
    try:
        c.create(cm)
        out.append(("create again", "no error"))
    except ht.APIError as exc:
        out.append(("create again", exc.status))
    cm["data"]["k"] = "v2"
    out.append(("apply", _strip(c.apply(cm))))
    got = c.get("ConfigMap", "cm", ns)
    got["data"]["k"] = "v3"
    out.append(("replace", _strip(c.replace(got))))
    stale = dict(got, metadata=dict(got["metadata"]))
    try:
        c.replace(stale)  # the resourceVersion moved on: a conflict
        out.append(("replace stale", "no error"))
    except ht.APIError as exc:
        out.append(("replace stale", exc.status))
    out.append(("get", _strip(c.get("ConfigMap", "cm", ns))))
    out.append(("get missing", c.get("ConfigMap", "nope", ns)))
    out.append(("list", _strip(c.list("ConfigMap", ns))))
    out.append(("list selected", _strip(c.list("ConfigMap", ns, label_selector="app=y"))))
    dep = {"apiVersion": "apps/v1", "kind": "Deployment",
           "metadata": {"name": "m-kserve", "namespace": ns},
           "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "m"}}}}
    c.apply(dep)
    c.update_status("Deployment", "m-kserve", ns, {"readyReplicas": 1})
    c.update_status("Deployment", "gone", ns, {"readyReplicas": 1})  # 404: logged
    out.append(("status", _strip(c.get("Deployment", "m-kserve", ns))))
    act = actuator_cls(c, "m-kserve", ns, pods_per_replica=2)
    out.append(("current", asyncio.run(act.current_replicas())))
    asyncio.run(act.scale_to(3))
    out.append(("scaled", c.get("Deployment", "m-kserve", ns)["spec"]["replicas"]))
    out.append(("current after", asyncio.run(act.current_replicas())))
    try:
        asyncio.run(actuator_cls(c, "absent", ns).current_replicas())
    except RuntimeError as exc:
        out.append(("absent", str(exc)))
    with pytest.raises(ValueError):
        actuator_cls(c, "m-kserve", ns, pods_per_replica=0)
    events = []
    for ev in c.watch("ConfigMap", ns, timeout_seconds=1):
        events.append((ev[0], ev[1]["metadata"]["name"]))
        break
    out.append(("watch", events))
    crd = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
           "metadata": {"name": f"widgets{ns}.example.com"},
           "spec": {"group": "example.com", "scope": "Namespaced",
                    "names": {"kind": f"Widget{ns.title()}", "plural": f"widgets{ns}"},
                    "versions": [{"name": "v1", "served": True, "storage": True}]}}
    c.apply(crd)
    assert not c.has_kind(f"Widget{ns.title()}")
    c.refresh_discovery()
    out.append(("discovered", c.has_kind(f"Widget{ns.title()}")))
    try:
        c.get("NoSuchKind", "x", ns)
    except KeyError as exc:
        out.append(("unknown kind", str(exc)))
    out.append(("delete", c.delete("ConfigMap", "cm", ns)))
    out.append(("delete again", c.delete("ConfigMap", "cm", ns)))
    return out


def test_http_cluster_and_actuator_match_jax(apiserver):
    want = _cluster_script(jht, JDeploymentActuator, apiserver.base_url, "jaxns")
    got = _cluster_script(tht, ta.DeploymentActuator, apiserver.base_url, "portns")
    # the CRD kinds carry the namespace's name: compare them apart
    for (wk, wv), (gk, gv) in zip(want, got):
        assert wk == gk
        if wk not in ("absent",):
            assert gv == wv, wk
    absent = dict(got)["absent"]
    assert absent == "deployment portns/absent not found"
    assert dict(got)["current"] == 1 and dict(got)["scaled"] == 6
    assert dict(got)["create again"] == 409 and dict(got)["replace stale"] == 409
    assert tgvk.BUILTIN_RESOURCES == dict(jht.BUILTIN_RESOURCES)


def test_apply_yaml_and_pyyaml_guard(apiserver, tmp_path):
    path = tmp_path / "objs.yaml"
    path.write_text("apiVersion: v1\nkind: ConfigMap\nmetadata:\n  name: y1\n"
                    "  namespace: yamlns\ndata: {a: '1'}\n---\n"
                    "apiVersion: v1\nkind: ConfigMap\nmetadata:\n  name: y2\n"
                    "  namespace: yamlns\n")
    (tmp_path / "kustomization.yaml").write_text("resources: []\n")
    got = tht.HTTPCluster(apiserver.base_url).apply_yaml(str(tmp_path))
    assert [o["metadata"]["name"] for o in got] == ["y1", "y2"]
    assert list(tht.iter_yaml_documents(str(path))) == list(
        __import__("kserve_tpu.controlplane.objects", fromlist=["x"])
        .iter_yaml_documents(str(path)))
    with mock.patch.dict(sys.modules, {"yaml": None}):
        with pytest.raises(ImportError, match="PyYAML"):
            tht.HTTPCluster(apiserver.base_url).apply_yaml(str(path))


def test_http_cluster_retries_429_then_raises(monkeypatch):
    """An apiserver's 429 is retried under the RetryPolicy (Retry-After
    honoured), then raised as APIError, as in the JAX transport."""
    import http.server

    hits = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            body = b'{"message": "slow down"}'
            self.send_response(429)
            self.send_header("Retry-After", "0")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        before = tmetrics.RETRY_ATTEMPTS.labels(component="cluster").get()
        c = tht.HTTPCluster(f"http://127.0.0.1:{srv.server_port}")
        c.retry_policy = tres.RetryPolicy(max_attempts=3, base_backoff_s=0.0,
                                          max_backoff_s=0.0)
        with pytest.raises(tht.APIError) as exc:
            c.get("ConfigMap", "x")
        assert exc.value.status == 429 and exc.value.message == "slow down"
        assert len(hits) == 3
        assert tmetrics.RETRY_ATTEMPTS.labels(component="cluster").get() == before + 2
    finally:
        srv.shutdown()


def test_in_cluster_credentials(tmp_path, monkeypatch):
    import certifi

    (tmp_path / "token").write_text("sekrit\n")
    (tmp_path / "ca.crt").write_bytes(open(certifi.where(), "rb").read())
    monkeypatch.setattr(tht.HTTPCluster, "SA_DIR", str(tmp_path))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    c = tht.HTTPCluster("", in_cluster=True)
    assert c.base_url == "https://10.0.0.1:6443" and c.token == "sekrit"
    assert c._ssl_ctx.verify_mode == ssl.CERT_REQUIRED and c._ssl_ctx.check_hostname


def test_tls_unverified_only_when_asked(tmp_path, monkeypatch):
    """In-cluster config without ca.crt is refused (the token would go out
    over unverified TLS); an explicit https master without a CA bundle is
    not verified, and says so."""
    (tmp_path / "token").write_text("sekrit\n")
    monkeypatch.setattr(tht.HTTPCluster, "SA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ca.crt"):
        tht.HTTPCluster("", in_cluster=True)
    with mock.patch.object(tht.logger, "warning") as warn:
        c = tht.HTTPCluster("https://10.0.0.1:6443", token="t")
        assert c._ssl_ctx.verify_mode == ssl.CERT_NONE
        assert "not verified" in warn.call_args[0][0]
        warn.reset_mock()
        assert tht.HTTPCluster("http://127.0.0.1:1")._ssl_ctx is None
        warn.assert_not_called()


# ---------------------------------------------------------------- EPP source and CLI


class _EPP:
    """The port's EPP over no replica, on its own loop in a thread."""

    def __init__(self):
        self.server = tepp.EPPServer(TPicker([]), host="127.0.0.1", port=0)
        self.ready = threading.Event()
        self.thread = threading.Thread(target=asyncio.run, args=(self._run(),),
                                       daemon=True)
        self.thread.start()
        assert self.ready.wait(30)
        self.url = f"http://127.0.0.1:{self.server.port}"

    async def _run(self):
        self.loop = asyncio.get_running_loop()
        self.stop_event = asyncio.Event()
        await self.server.start()
        self.ready.set()
        await self.stop_event.wait()
        await self.server.stop()
        await self.server.close()

    def stop(self):
        self.loop.call_soon_threadsafe(self.stop_event.set)
        self.thread.join(30)


def test_epp_signal_source_and_staleness():
    epp = _EPP()
    for _ in range(3):
        epp.server.arrivals.record(epp.server.picker.clock.now())

    async def scrape(stale_s):
        src = tcli.EPPSignalSource(epp.url, stale_s=stale_s)
        jsrc = jcli.EPPSignalSource(epp.url, stale_s=stale_s)
        try:
            got, want = await src(), await jsrc()
            epp.stop()
            again = await src()  # the EPP is gone: the last good snapshot
            await asyncio.sleep(stale_s + 0.05)
            with pytest.raises(Exception) as exc:
                await src()
            return got, want, again, exc.value
        finally:
            await src.close()
            await jsrc.close()

    got, want, again, exc = asyncio.run(scrape(0.3))
    assert isinstance(got, ta.FleetSignals)
    assert dataclasses.replace(got, at_s=0.0) == ta.FleetSignals.from_dict(
        dataclasses.replace(want, at_s=0.0).to_dict())
    assert got.arrival_rate_per_s > 0 and got.demand
    assert again is got
    from kserve_tpu_torch.protocol.http_client import HTTPError

    assert isinstance(exc, (HTTPError, OSError))


def test_cli_flags_match_jax_and_a_failed_loop_exits_1():
    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    assert flags(tcli.build_arg_parser()) == flags(jcli.build_arg_parser())
    args = tcli.build_arg_parser().parse_args(
        ["--epp-url", "http://x", "--deployment", "d", "--policy", "reactive",
         "--queue-high", "3"])
    assert isinstance(tcli.build_policy(args), ta.ReactivePolicy)
    assert tcli.build_policy(args).config.queue_high_per_replica == 3.0
    args.policy = "predictive"
    assert isinstance(tcli.build_policy(args), ta.PredictivePolicy)
    # nothing listens: the first scrape fails with no snapshot to re-serve
    dead = "http://127.0.0.1:9"
    assert tcli.main(["--epp-url", dead, "--deployment", "d", "--master", dead]) == 1
