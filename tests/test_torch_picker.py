"""The port's endpoint picker (scheduler/picker.py), fleet health
(scheduler/health.py), latency predictor (scheduler/latency.py) and
autoscaling signals (autoscale/signals.py) against the JAX package's.

Both sides take the same seeded numpy sequence of events, each on its own
FakeClock: replica state payloads (queue depths, free pages, prefix
digests, latency windows, watchdog and lifecycle states, peer bad-page
counts, persist-resident digests), picks with token ids or text (canary
allowed or not), HTTP errors, transport failures, successes, canary
outcomes with latencies, latency observations, replica-set changes and
clock advances.  Picks and canary flags are equal at every step; the
snapshots, health scores, transitions, predictions and fleet signals
agree to 1e-12.  extract_affinity is compared on a table of OpenAI chat,
completions and /pick payloads."""

import math

import numpy as np
import pytest

from kserve_tpu.autoscale import signals as jsignals
from kserve_tpu.resilience import BreakerRegistry as JBreakerRegistry
from kserve_tpu.resilience import FakeClock as JFakeClock
from kserve_tpu.scheduler import epp as jepp
from kserve_tpu.scheduler import health as jhealth
from kserve_tpu.scheduler import latency as jlatency
from kserve_tpu.scheduler import picker as jpicker
from kserve_tpu.scheduler import prefix as jprefix
from kserve_tpu_torch.autoscale import signals as tsignals
from kserve_tpu_torch.resilience import BreakerRegistry as TBreakerRegistry
from kserve_tpu_torch.resilience import FakeClock as TFakeClock
from kserve_tpu_torch.scheduler import epp as tepp
from kserve_tpu_torch.scheduler import health as thealth
from kserve_tpu_torch.scheduler import latency as tlatency
from kserve_tpu_torch.scheduler import picker as tpicker
from kserve_tpu_torch.scheduler import prefix as tprefix

TOL = 1e-12
URLS = [f"http://replica-{i}:8080" for i in range(4)]
PAGE = 16


def _close(a, b, path="") -> None:
    """Equal structures, floats within TOL."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (path, a, b)
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= TOL * max(1.0, abs(a)), (
            path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


class Side:
    """One package's picker stack on its own clock."""

    def __init__(self, picker_mod, health_mod, latency_mod, signals_mod, clock_cls,
                 breakers_cls):
        self.clock = clock_cls(100.0)
        self.predictor = latency_mod.LatencyPredictor()
        self.breakers = breakers_cls(clock=self.clock)
        self.health = health_mod.FleetHealth(
            health_mod.HealthConfig(reprobe_interval_s=3.0, canary_timeout_s=6.0),
            clock=self.clock)
        self.picker = picker_mod.EndpointPicker(
            URLS[:3], latency_predictor=self.predictor, latency_weight=4.0,
            breakers=self.breakers, clock=self.clock, health=self.health)
        self.signals = signals_mod
        self.arrivals = signals_mod.ArrivalHistory(bucket_s=0.5, window_s=30.0)
        self.sheds = signals_mod.RateTracker(min_interval_s=1.0)

    def view(self) -> dict:
        now = self.clock.now()
        snap = self.picker.snapshot()
        urls = sorted(self.picker.replicas)
        fleet = self.signals.FleetSignals.from_replica_states(
            snap, now, arrival_rate_per_s=self.arrivals.rate(now),
            arrival_slope_per_s2=self.arrivals.slope(now),
            shed_rate_per_s=self.sheds.update(
                sum(s["sheds_total"] for s in snap), now))
        return {
            "snapshot": snap,
            "scores": [self.health.score(u) for u in urls],
            "status": [self.health.status(u) for u in urls],
            "transitions": list(self.health.transitions),
            "errors": [self.picker.decayed_errors(self.picker.replicas[u]) for u in urls],
            "predict": [(self.predictor.predict_ttft(u, 300, 2),
                         self.predictor.predict_tpot(u),
                         self.predictor.predict_total(u, 300, 2, 32)) for u in urls],
            "latency": self.predictor.snapshot(),
            "fleet": fleet.to_dict(),
        }


def _sides():
    return (Side(jpicker, jhealth, jlatency, jsignals, JFakeClock, JBreakerRegistry),
            Side(tpicker, thealth, tlatency, tsignals, TFakeClock, TBreakerRegistry))


PREFIXES = [list(range(1000 * k, 1000 * k + 80)) for k in range(5)]
TEXTS = [("system prompt number %d " % k) * 12 for k in range(4)]


def _state(rng) -> dict:
    """One replica's /v1/internal/scheduler/state payload."""
    digests = []
    for k in rng.choice(len(PREFIXES), size=int(rng.integers(0, 3)), replace=False):
        n = int(rng.integers(1, 6))
        digests += [d.hex() for d in tprefix.token_prefix_digests(
            PREFIXES[k], PAGE, for_lookup=False)[:n]]
    model = {"queue_depth": int(rng.integers(0, 6)), "page_size": PAGE,
             "prefix_digests": digests, "wedged": bool(rng.random() < 0.03),
             "free_pages": int(rng.integers(0, 500))}
    if rng.random() < 0.7:
        model["watchdog"] = {"state": str(rng.choice(
            ["ok"] * 8 + ["stall_suspected", "stall_confirmed"]))}
    if rng.random() < 0.4:
        model["prefix_store"] = {"resident": int(rng.integers(0, 40)),
                                 "hits": {"host": int(rng.integers(0, 9))}}
    if rng.random() < 0.3:
        k = int(rng.integers(0, len(PREFIXES)))
        model["peer_pages"] = {"generation": int(rng.integers(0, 5)), "digests": [
            d.hex() for d in tprefix.token_prefix_digests(PREFIXES[k], PAGE)]}
    if rng.random() < 0.3:
        model["peer"] = {"bad_pages": {str(rng.choice(URLS)): int(rng.integers(0, 4))}}
    slow = rng.random() < 0.15
    return {
        "queue_depth": model["queue_depth"], "free_pages": model["free_pages"],
        "inflight": int(rng.integers(0, 8)),
        "models": {"m": model},
        "lifecycle": str(rng.choice(["READY"] * 9 + ["DRAINING"])),
        "shed": {"count": int(rng.integers(0, 20)), "shedding": bool(rng.random() < 0.1)},
        "telemetry": {"ttft_p99_s": float(rng.uniform(0.1, 0.4) * (8 if slow else 1)),
                      "itl_p99_s": float(rng.uniform(0.01, 0.03) * (8 if slow else 1))},
    }


def _event(rng, step: int):
    kind = rng.choice(["state"] * 6 + ["pick"] * 6 + ["advance"] * 3 + [
        "http_error", "failure", "success", "canary", "latency", "arrival", "replicas"])
    url = str(rng.choice(URLS))
    if kind == "state":
        return ("state", url, _state(rng))
    if kind == "pick":
        if rng.random() < 0.5:
            k = int(rng.integers(0, len(PREFIXES)))
            ids = PREFIXES[k][:int(rng.integers(17, 80))] + [int(rng.integers(0, 9))]
            return ("pick", ids, None, bool(rng.random() < 0.8))
        k = int(rng.integers(0, len(TEXTS)))
        return ("pick", None, TEXTS[k] + "tail %d" % int(rng.integers(0, 50)),
                bool(rng.random() < 0.8))
    if kind == "advance":
        return ("advance", float(rng.exponential(1.5)))
    if kind == "canary":
        return ("canary", url, bool(rng.random() < 0.7), float(rng.uniform(0.05, 3.0)),
                float(rng.uniform(0.005, 0.2)))
    if kind == "latency":
        return ("latency", url, int(rng.integers(10, 2000)), int(rng.integers(0, 8)),
                float(rng.uniform(0.05, 2.0)), int(rng.integers(1, 64)),
                float(rng.uniform(2.0, 9.0)))
    if kind == "replicas":
        keep = sorted(rng.choice(URLS, size=int(rng.integers(2, 5)), replace=False))
        return ("replicas", [str(u) for u in keep])
    return (str(kind), url)


def _apply(side: Side, ev) -> object:
    p = side.picker
    kind = ev[0]
    if kind == "state":
        p.observe_state(ev[1], ev[2])
    elif kind == "pick":
        r, canary = p.pick_ex(prompt_ids=ev[1], prompt_text=ev[2], allow_canary=ev[3])
        return (r.url if r is not None else None, canary)
    elif kind == "advance":
        side.clock.advance(ev[1])
    elif kind == "http_error":
        p.observe_http_error(ev[1])
    elif kind == "failure":
        p.observe_failure(ev[1])
    elif kind == "success":
        p.observe_success(ev[1])
    elif kind == "canary":
        p.observe_canary(ev[1], ev[2], ttft_s=ev[3], tpot_s=ev[4])
    elif kind == "latency":
        side.predictor.observe(ev[1], ev[2], ev[3], ev[4], n_tokens=ev[5], total_s=ev[6])
    elif kind == "arrival":
        side.arrivals.record(side.clock.now())
    elif kind == "replicas":
        p.set_replicas(ev[1])
    return None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_picker_health_latency_and_signals_match_jax(seed):
    rng = np.random.default_rng(seed)
    jside, tside = _sides()
    picks = canaries = quarantines = 0
    for step in range(300):
        ev = _event(rng, step)
        want, got = _apply(jside, ev), _apply(tside, ev)
        assert got == want, (step, ev[:2], want, got)
        if ev[0] == "pick":
            picks += 1
            canaries += bool(want[1])
        _close(jside.view(), tside.view(), f"step {step} {ev[0]}")
        quarantines = sum(t[2] == "quarantine" for t in jside.health.transitions)
    # the sequence reached the paths it is meant to hold equal
    assert picks >= 60 and quarantines >= 1 and canaries >= 1, (picks, quarantines, canaries)


PAYLOADS = [
    {"model": "m", "prompt": "hello there"},
    {"model": "m", "prompt": [1, 2, 3]},
    {"model": "m", "prompt": ["a", "b"]},
    {"model": "m", "prompt": []},
    {"prompt_ids": [5, 6, 7]},
    {"prompt_ids": "nope", "prompt": "text"},
    {"model": "m", "messages": [{"role": "system", "content": "be brief"},
                                {"role": "user", "content": "hi"}]},
    {"messages": [{"role": "user", "content": [{"type": "text", "text": "a"},
                                               {"type": "image_url"}, "x"]}]},
    {"messages": ["not a dict", {"content": None}]},
    {"messages": "not a list", "prompt": "p"},
    {},
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=range(len(PAYLOADS)))
def test_extract_affinity_matches_jax(payload):
    assert tepp.extract_affinity(payload) == jepp.extract_affinity(payload)


def test_prefix_digests_match_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 15, 16, 17, 64, 129):
        seq = [int(x) for x in rng.integers(0, 1 << 31, size=n)]
        for lookup in (True, False):
            assert tprefix.token_prefix_digests(seq, 16, lookup) == \
                jprefix.token_prefix_digests(seq, 16, lookup)
    for text in ("", "x" * 63, "x" * 64, "héllo wörld " * 40, TEXTS[0]):
        assert tprefix.text_prefix_digests(text) == jprefix.text_prefix_digests(text)
