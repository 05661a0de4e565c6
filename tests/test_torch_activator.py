"""The port's scale-to-zero activator (kserve_tpu_torch/activator.py)
against the JAX package's, on the CPU.

The seven scenarios of tests/test_scale_to_zero.py::TestActivatorDataPath
run against both activators over the same fake backend (a standard-library
server that listens only once "scaled up") and the same aiohttp client:
the same statuses, Retry-After values, error bodies, /activator/stats,
replay order (holds leave the queue in the order they entered) and
checkpoint headers.  Beyond the JAX scenarios: a large
x-generation-checkpoint passes through the port's activator both ways,
and, end to end, a completion sent to the port's activator at zero wakes
a tiny port replica behind the port's EPP (scale_up starts its server)
and returns the greedy tokens of the JAX engine over the same weights
(tl.params_from_jax), exactly."""

import asyncio
import json
import threading
import types

import aiohttp
import jax
import numpy as np
import pytest

import chip_smoke
from kserve_tpu import activator as jact
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu_torch import activator as tact
from kserve_tpu_torch.engine.engine import EngineConfig
from kserve_tpu_torch.model_server import ModelServer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.protocol.http_client import ConnectError
from kserve_tpu_torch.protocol.rest.http_server import HTTPServer
from kserve_tpu_torch.resilience import BreakerConfig, BreakerRegistry
from kserve_tpu_torch.runtimes.generative_server import TorchGenerativeModel
from kserve_tpu_torch.scheduler.epp import EPPServer
from kserve_tpu_torch.scheduler.picker import EndpointPicker

IMPLS = ("jax", "port")


class FakeBackend(HTTPServer):
    """A model server pod that is not listening until it is scaled up."""

    def __init__(self, port: int = 0, echo_checkpoint: bool = False):
        super().__init__("127.0.0.1", port)
        self.requests, self.checkpoint_headers = [], []
        self.echo_checkpoint = echo_checkpoint

    async def _respond(self, method, path, query, headers, body, writer, keep_alive):
        if (method, path) == ("GET", "/v2/health/ready"):
            return await self._send_json(writer, 200, {"ready": True}, keep_alive)
        if method == "POST" and path.endswith(":predict"):
            self.requests.append(json.loads(body))
            ckpt = headers.get("x-generation-checkpoint")
            self.checkpoint_headers.append(ckpt)
            extra = {"x-generation-checkpoint": ckpt} if self.echo_checkpoint and ckpt else {}
            return await self._send_json(writer, 200, {"predictions": [1, 2, 3]},
                                         keep_alive, extra)
        return await self._send_json(writer, 404, {"error": "not found"}, keep_alive)


async def _reserved_port() -> int:
    probe = FakeBackend()
    port = await probe.start()
    await probe.stop()
    return port


def _activator(impl, backend_url, **kw):
    if impl == "jax":
        return jact.Activator(backend_url, port=0, **kw)
    return tact.Activator(backend_url, port=0, **kw)


def _record_hold_order(act):
    """Wrap the activator's hold queue: the order holds enter it and the
    order they leave it released (FIFO replay means the two are equal)."""
    entered, released, original = [], [], act.holds.hold

    async def hold(deadline=None):
        n = len(entered)
        entered.append(n)
        await original(deadline)
        released.append(n)

    act.holds.hold = hold
    return entered, released


async def _post(session, port, i=0, headers=None, body=None):
    async with session.post(f"http://127.0.0.1:{port}/v1/models/m:predict",
                            json=body if body is not None else {"i": i},
                            headers=headers or {}) as resp:
        return resp.status, dict(resp.headers), await resp.read()


async def _stats(session, port):
    async with session.get(f"http://127.0.0.1:{port}/activator/stats") as resp:
        return await resp.json()


# ---------------------------------------------------------------- scenarios


async def wakes_and_is_served(impl):
    port = await _reserved_port()
    backend = FakeBackend(port)
    scale_ups = []

    async def scale_up():
        scale_ups.append(1)
        await backend.start()

    act = _activator(impl, f"http://127.0.0.1:{port}", scale_up=scale_up,
                     poll_interval=0.05, wake_timeout=10)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            first = await _post(session, act_port, body={"instances": [[1.0]]})
            second = await _post(session, act_port, body={"instances": [[2.0]]})
            stats = await _stats(session, act_port)
        assert stats["cold_start_s"] is not None
        stats["cold_start_s"] = "set"
        return {"statuses": [first[0], second[0]], "body": json.loads(first[2]),
                "scale_ups": len(scale_ups), "backend": backend.requests, "stats": stats}
    finally:
        await act.stop()
        await backend.stop()


async def expired_deadline_504(impl):
    act = _activator(impl, "http://127.0.0.1:1", scale_up=None, poll_interval=0.05,
                     wake_timeout=30)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            status, _, body = await _post(session, act_port,
                                          headers={"x-request-deadline": "0.15"})
        return {"status": status, "body": json.loads(body), "stats": dict(act.stats)}
    finally:
        await act.stop()


async def overflow_503(impl):
    act = _activator(impl, "http://127.0.0.1:1", scale_up=None, poll_interval=0.05,
                     wake_timeout=30, max_holds=1)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            t1 = asyncio.ensure_future(_post(session, act_port,
                                             headers={"x-request-deadline": "0.5"}))
            await asyncio.sleep(0.1)  # let it park
            status, headers, body = await _post(session, act_port)
            first = await t1
        return {"status": status, "retry_after": headers.get("Retry-After"),
                "body": json.loads(body), "first": first[0],
                "stats": dict(act.stats)}
    finally:
        await act.stop()


async def failed_wake(impl):
    act = _activator(impl, "http://127.0.0.1:1", scale_up=None, poll_interval=0.05,
                     wake_timeout=0.2, hold_timeout_s=5.0)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            cohort = await asyncio.gather(*[_post(session, act_port) for _ in range(3)])
            after = await _post(session, act_port)
        return {"statuses": [c[0] for c in cohort],
                "bodies": [json.loads(c[2]) for c in cohort],
                "poison": after[0], "retry_after": after[1].get("Retry-After"),
                "stats": dict(act.stats)}
    finally:
        await act.stop()


async def flip_after_wake(impl):
    """The wake succeeds, the held request replays, but the backend is
    gone again (a watchdog flipped it): the request holds again, the
    second wake fails (504), a follow-up in the poison window gets 503."""
    wakes, flipped = [], {"n": 0}

    async def scale_up():
        wakes.append(1)

    act = _activator(impl, "http://127.0.0.1:1", scale_up=scale_up, poll_interval=0.02,
                     wake_timeout=0.3, hold_timeout_s=10.0)

    async def scripted_ready():
        return flipped["n"] == 0 and len(wakes) >= 1

    act._backend_is_ready = scripted_ready
    if impl == "jax":
        async def flipping_proxy(request, body):
            flipped["n"] += 1
            raise aiohttp.ClientConnectorError(
                types.SimpleNamespace(ssl=None, host="b", port=1, is_ssl=False),
                OSError("watchdog flipped readiness"))
    else:
        async def flipping_proxy(*args):
            flipped["n"] += 1
            raise ConnectError("connect to b:1: watchdog flipped readiness")
    act._proxy = flipping_proxy
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            status, _, body = await asyncio.wait_for(_post(session, act_port), 10.0)
            status2, headers2, _ = await asyncio.wait_for(_post(session, act_port), 10.0)
        return {"status": status, "body": json.loads(body), "wakes": len(wakes),
                "flipped": flipped["n"], "poison": status2,
                "retry_after": headers2.get("Retry-After"), "stats": dict(act.stats)}
    finally:
        await act.stop()


async def replay_order_and_checkpoints(impl):
    port = await _reserved_port()
    backend = FakeBackend(port)

    async def scale_up():
        await asyncio.sleep(0.1)
        await backend.start()

    act = _activator(impl, f"http://127.0.0.1:{port}", scale_up=scale_up,
                     poll_interval=0.05, wake_timeout=10)
    entered, released = _record_hold_order(act)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            results = await asyncio.gather(*[
                _post(session, act_port, i, {"x-generation-checkpoint": f"ckpt-{i}"})
                for i in range(3)])
        pairs = sorted((b["i"], c) for b, c in zip(backend.requests,
                                                    backend.checkpoint_headers))
        return {"statuses": [r[0] for r in results], "pairs": pairs,
                "entered": entered, "released": released,
                "replayed": act.stats["replayed"]}
    finally:
        await act.stop()
        await backend.stop()


async def concurrent_cold_share_one_wake(impl):
    port = await _reserved_port()
    backend = FakeBackend(port)
    scale_ups = []

    async def scale_up():
        scale_ups.append(1)
        await asyncio.sleep(0.2)  # pod boot latency
        await backend.start()

    act = _activator(impl, f"http://127.0.0.1:{port}", scale_up=scale_up,
                     poll_interval=0.05, wake_timeout=10)
    act_port = await act.start()
    try:
        async with aiohttp.ClientSession() as session:
            results = await asyncio.gather(*[
                _post(session, act_port, body={"instances": [[float(i)]]})
                for i in range(4)])
        return {"statuses": [r[0] for r in results], "scale_ups": len(scale_ups),
                "buffered": act.stats["buffered"], "replayed": act.stats["replayed"]}
    finally:
        await act.stop()
        await backend.stop()


SCENARIOS = {
    "wakes_and_is_served": (wakes_and_is_served, lambda r: (
        r["statuses"] == [200, 200] and r["body"] == {"predictions": [1, 2, 3]}
        and r["scale_ups"] == 1 and r["backend"] == [{"instances": [[1.0]]},
                                                     {"instances": [[2.0]]}]
        and r["stats"]["buffered"] == 1 and r["stats"]["proxied"] == 2)),
    "expired_deadline_504": (expired_deadline_504, lambda r: (
        r["status"] == 504 and "deadline" in r["body"]["error"]
        and r["stats"]["expired"] == 1 and r["stats"]["replayed"] == 0)),
    "overflow_503": (overflow_503, lambda r: (
        r["status"] == 503 and r["retry_after"] == "7.5" and r["first"] == 504
        and r["stats"]["overflow"] == 1)),
    "failed_wake": (failed_wake, lambda r: (
        r["statuses"] == [504] * 3 and r["stats"]["wake_failed"] == 3
        and r["poison"] == 503 and r["retry_after"] == "0.05")),
    "flip_after_wake": (flip_after_wake, lambda r: (
        r["status"] == 504 and r["wakes"] == 2 and r["flipped"] == 1
        and r["stats"]["wake_failed"] == 1 and r["stats"]["buffered"] == 3
        and r["poison"] == 503 and r["retry_after"] is not None)),
    "replay_order_and_checkpoints": (replay_order_and_checkpoints, lambda r: (
        r["statuses"] == [200] * 3 and r["replayed"] == 3
        and r["pairs"] == [(i, f"ckpt-{i}") for i in range(3)]
        and r["released"] == r["entered"] == [0, 1, 2])),
    "concurrent_cold_share_one_wake": (concurrent_cold_share_one_wake, lambda r: (
        r["statuses"] == [200] * 4 and r["scale_ups"] == 1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    scenario, expected = SCENARIOS[name]
    got = {impl: asyncio.run(scenario(impl)) for impl in IMPLS}
    assert got["port"] == got["jax"]
    assert expected(got["port"]), got["port"]


def test_large_checkpoint_header_rides_through_both_ways():
    """A resume's x-generation-checkpoint of 200 KB (far past aiohttp's
    8,190-byte default) goes to the backend and its echo comes back."""
    async def run():
        port = await _reserved_port()
        backend = FakeBackend(port, echo_checkpoint=True)
        await backend.start()
        act = _activator("port", f"http://127.0.0.1:{port}", poll_interval=0.05,
                         wake_timeout=10)
        act_port = await act.start()
        ckpt = "c" * 200_000
        try:
            async with aiohttp.ClientSession(max_field_size=300_000,
                                             max_line_size=300_000) as session:
                status, headers, _ = await _post(session, act_port, 0,
                                                 {"x-generation-checkpoint": ckpt})
            return status, headers.get("x-generation-checkpoint"), backend.checkpoint_headers
        finally:
            await act.stop()
            await backend.stop()

    status, echoed, seen = asyncio.run(run())
    assert status == 200 and seen == ["c" * 200_000] and echoed == "c" * 200_000


class AcceptingBackend(FakeBackend):
    """An EPP over replicas that may all be down: it always accepts, and
    answers 503 for readiness and for work while `up` is False."""

    up = False

    async def _respond(self, method, path, query, headers, body, writer, keep_alive):
        if not self.up:
            return await self._send_json(writer, 503, {"error": "no healthy replica"},
                                         keep_alive)
        return await super()._respond(method, path, query, headers, body, writer,
                                      keep_alive)


def test_scaled_to_zero_holds_behind_an_accepting_backend():
    """A backend that accepts in its zero window refuses no connect: its
    503 is relayed until `scaled_to_zero()` puts the activator back in hold
    mode, after which the next request wakes it (one scale_up) and is
    replayed."""
    async def run():
        backend = AcceptingBackend()
        await backend.start()
        scale_ups = []

        async def scale_up():
            scale_ups.append(1)
            backend.up = True

        act = tact.Activator(f"http://127.0.0.1:{backend.port}", scale_up=scale_up,
                             poll_interval=0.05, wake_timeout=10, port=0)
        act_port = await act.start()
        try:
            async with aiohttp.ClientSession() as session:
                cold = await _post(session, act_port, 0)
                backend.up = False
                relayed = await _post(session, act_port, 1)
                act.scaled_to_zero()
                woken = await _post(session, act_port, 2)
                stats = await _stats(session, act_port)
            return cold[0], relayed[0], woken[0], len(scale_ups), stats, backend.requests
        finally:
            await act.stop()
            await backend.stop()

    cold, relayed, woken, scale_ups, stats, served = asyncio.run(run())
    assert (cold, relayed, woken) == (200, 503, 200)
    assert scale_ups == 2 and served == [{"i": 0}, {"i": 2}]
    assert stats["buffered"] == stats["replayed"] == 2


def test_flags_match_jax():
    import argparse

    def flags(main_mod):
        captured = {}

        def fake_parse(self, argv=None, namespace=None):
            captured.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = fake_parse
        try:
            with pytest.raises(SystemExit):
                main_mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return captured

    assert flags(tact) == flags(jact)


# ---------------------------------------------------------------- end to end

ENGINE = dict(max_batch_size=4, page_size=8, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
PROMPT = [7, 300, 41, 5, 260, 99, 13, 470, 21]
MAX_TOKENS = 10


def _jax_tokens(jcfg, jparams):
    engine = jeng.LLMEngine(jcfg, jeng.EngineConfig(**ENGINE), JaxByteTokenizer(512),
                            params=jparams, rng_seed=0)

    async def run():
        await engine.start()
        try:
            params = js.SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS,
                                       ignore_eos=True)
            return [o.token_id async for o in engine.generate(PROMPT, params)]
        finally:
            await engine.stop()

    return asyncio.run(run())


def test_activator_epp_replica_end_to_end(tmp_path):
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    want = _jax_tokens(jcfg, jparams)
    # every id decodes to its own text, so equal texts are equal ids
    chip_smoke._write_mixtral_tokenizer(str(tmp_path), tcfg.vocab_size)
    model = TorchGenerativeModel("tiny", tcfg, EngineConfig(**ENGINE), random_weights=True,
                                 device="cpu", model_dir=str(tmp_path))
    model.load = lambda: tparams
    model.weights_stats = {"seconds": 0.0}
    want_text = model.tokenizer.decode(want)

    async def run():
        replica_port = await _reserved_port()
        server = ModelServer(http_port=replica_port, host="127.0.0.1")
        thread = threading.Thread(target=server.start, args=([model],), daemon=True)
        starts = []

        async def scale_up():
            starts.append(1)
            thread.start()

        # a replica down since the EPP started opens its breaker on the
        # failed polls; a short open window lets the woken one take picks
        # at once (ROADMAP C21)
        picker = EndpointPicker([f"http://127.0.0.1:{replica_port}"], poll_interval_s=0.05,
                                breakers=BreakerRegistry(BreakerConfig(open_for_s=0.3)))
        epp = EPPServer(picker, host="127.0.0.1", port=0)
        await epp.start()
        await picker.start_polling()
        act = tact.Activator(f"http://127.0.0.1:{epp.port}", scale_up=scale_up,
                             poll_interval=0.05, wake_timeout=60, port=0)
        act_port = await act.start()
        try:
            async with aiohttp.ClientSession() as session:
                async with session.post(
                        f"http://127.0.0.1:{act_port}/openai/v1/completions",
                        json={"model": "tiny", "prompt": PROMPT, "max_tokens": MAX_TOKENS,
                              "temperature": 0, "ignore_eos": True}) as resp:
                    status, body = resp.status, await resp.json()
                stats = await _stats(session, act_port)
            return status, body, stats, len(starts)
        finally:
            await act.stop()
            await epp.stop()
            await epp.close()
            if thread.is_alive():
                server.request_stop()
                await asyncio.to_thread(thread.join, 30)

    status, body, stats, starts = asyncio.run(run())
    assert status == 200 and starts == 1
    assert body["usage"]["completion_tokens"] == MAX_TOKENS
    assert body["choices"][0]["text"] == want_text
    assert stats["buffered"] == 1 and stats["replayed"] == 1 and stats["cold_start_s"] > 0
