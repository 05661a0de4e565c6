"""Mixture-of-Experts of the PyTorch port against the JAX package on the
CPU, in float32: `moe_mlp` (kserve_tpu_torch/models/moe.py) within 1e-5
of kserve_tpu/models/moe.py, with a router whose columns tie for every
token (the lower expert index must win, as jax.lax.top_k picks it); the
four model entry points of a tiny MoE Llama (4 experts, top 2) within
1e-4 x max|logit|, ties included; greedy engine streams equal to the JAX
engine's on `mixed`, spec (K=3), the legacy route with logprobs and int8
KV pages; a drain checkpoint of an MoE stream resumed token-exactly by
the other package; and int8 weights and LoRA over MoE refused, as in the
JAX package.  (The Mixtral-form checkpoint loaders are
tests/test_torch_moe_checkpoint.py.)"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu import lifecycle as jlc
from kserve_tpu import resilience as jres
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import build_compiled
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.models import moe as jm
from kserve_tpu.models import quant as jq
from kserve_tpu_torch import lifecycle as tlc
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.models import moe as tm
from kserve_tpu_torch.models import quant as tq

PS = 8
MOE = dict(n_experts=4, n_experts_per_tok=2, dtype="float32")
# moe_mlp alone: one router product, softmax and three expert products in
# float32 (~1e-9 observed against outputs of ~1e-2)
MLP_TOL = dict(atol=1e-5, rtol=1e-5)
# whole-model float32 logits through 2 layers: another summation order
# only (~1e-6 relative observed)
LOGIT_REL_TOL = 1e-4
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
MAX_TOKENS = 8


def _tied_router(rng, h: int) -> np.ndarray:
    """[h, 4] router whose logits are (2a, a, a, -a) for a = x @ c: for
    every token experts 1 and 2 tie for the second slot (behind expert 0
    when a > 0, behind expert 3 when a < 0), so top-2 must keep expert 1.
    Scaling by 2 and negating are exact, so the tie is exact."""
    c = (rng.standard_normal(h) * 0.05).astype(np.float32)
    return np.stack([2 * c, c, c, -c], axis=1)


@pytest.mark.parametrize("router", ["random", "ties"])
def test_moe_mlp_matches_jax(router):
    cfg = jm.MoEConfig(n_experts=4, top_k=2, hidden_size=64, intermediate_size=96)
    params = jax.tree.map(np.asarray, jm.init_moe_params(cfg, jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)
    if router == "ties":
        params["router"] = _tied_router(rng, cfg.hidden_size)
    x = rng.standard_normal((3, 7, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jm.moe_mlp(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg))
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tcfg = tm.MoEConfig(**vars(cfg))
    got = tm.moe_mlp(tparams, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
    # the selection itself: the reference's top-k indices carry weight
    logits = tm.router_logits(tparams, torch.from_numpy(x).reshape(-1, 64))
    _, jsel = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    weights = tm.combine_weights(logits, 2)
    assert ((weights > 0).sum(-1) == 2).all()
    np.testing.assert_array_equal(
        np.sort(np.asarray(jsel), -1),
        np.sort(torch.nonzero(weights > 0)[:, 1].reshape(-1, 2).numpy(), -1))
    if router == "ties":
        assert torch.equal(logits[:, 1], logits[:, 2])
        assert (weights[:, 1] > 0).all() and (weights[:, 2] == 0).all()


def test_init_moe_params_shapes_and_generator():
    cfg = tm.MoEConfig(n_experts=3, top_k=2, hidden_size=16, intermediate_size=24)
    draw = lambda: tm.init_moe_params(  # noqa: E731
        cfg, torch.Generator().manual_seed(5), "cpu", dtype=torch.bfloat16)
    a, b = draw(), draw()
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "router": (16, 3), "w_gate": (3, 16, 24), "w_up": (3, 16, 24),
        "w_down": (3, 24, 16)}
    assert all(v.dtype == torch.bfloat16 and torch.equal(v, b[k]) for k, v in a.items())


@pytest.fixture(scope="module")
def models():
    """(JAX config, port config, JAX params, port params) of a tiny MoE
    Llama: 2 layers of 4 experts, top 2."""
    jcfg, tcfg = jl.LlamaConfig.tiny(**MOE), tl.LlamaConfig.tiny(**MOE)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tl.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _with_router(models, router):
    """`models` with every layer's router tied (see _tied_router) when
    `router` is "ties"."""
    if router == "random":
        return models
    jcfg, tcfg, jparams, _ = models
    rng = np.random.RandomState(4)
    jparams = dict(jparams, layers=[
        dict(layer, router=jnp.asarray(_tied_router(rng, jcfg.hidden_size)))
        for layer in jparams["layers"]])
    return jcfg, tcfg, jparams, tl.params_from_jax(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _pages(tcfg, num_pages):
    kv = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
              head_dim=tcfg.head_dim, page_size=PS, num_pages=num_pages,
              dtype="float32")
    return jax_init_kv_pages(JaxKVConfig(**kv)), init_kv_pages(KVCacheConfig(**kv),
                                                                device="cpu")


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_REL_TOL * float(np.abs(want).max()))


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_and_params_match_jax(models):
    jcfg, tcfg, jparams, tparams = models
    for field in tcfg.__dataclass_fields__:
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    for j, t in zip(jparams["layers"], tparams["layers"]):
        assert sorted(j) == sorted(t)
        np.testing.assert_array_equal(t["router"].numpy(), np.asarray(j["router"]))
        np.testing.assert_array_equal(t["w_down"].numpy(), np.asarray(j["w_down"]))
    # the port's own random init has the reference's keys and shapes
    own = tl.init_params(tcfg, seed=1, device="cpu")
    for a, b in zip(own["layers"], tparams["layers"]):
        assert {k: tuple(v.shape) for k, v in a.items()} == {
            k: tuple(v.shape) for k, v in b.items()}
    assert tuple(own["layers"][0]["w_gate"].shape) == (4, 64, 128)


@pytest.mark.parametrize("router", ["random", "ties"])
def test_forward_ragged_and_decode_match_jax(models, router):
    jcfg, tcfg, jparams, tparams = _with_router(models, router)
    jpages, tpages = _pages(tcfg, 1 + 2 * 4)
    rng = np.random.RandomState(11)
    p0, p1 = rng.randint(0, 512, 13).tolist(), rng.randint(0, 512, 6).tolist()
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    packed = [i32(p0 + [0] * 3 + p1 + [0] * 2),
              i32([0] * 13 + [-1] * 3 + [1] * 6 + [-1] * 2),
              i32(list(range(13)) + [0] * 3 + list(range(6)) + [0] * 2),
              i32([0, 16]), i32([13, 6]), i32([0, 0])]
    table = (1 + np.arange(8, dtype=np.int32)).reshape(2, 4)
    last = i32([12, 21])
    jfwd = jax.jit(lambda p, packed, pages, table, last: jl.forward_ragged(
        p, jcfg, *packed, pages, table, PS, last))
    jdec = jax.jit(lambda p, tokens, pos, pages, table, active: jl.decode_step(
        p, jcfg, tokens, pos, pages, table, active, PS))
    jout, jpages = jfwd(jparams, [_j(a) for a in packed], jpages, _j(table), _j(last))
    tout, _ = tl.forward_ragged(tparams, tcfg, *map(_t, packed), tpages, _t(table),
                                PS, _t(last))
    _close(tout, jout)
    tokens, pos, active = i32([5, 9]), i32([13, 6]), np.asarray([True, True])
    jd, _ = jdec(jparams, _j(tokens), _j(pos), jpages, _j(table), _j(active))
    td, _ = tl.decode_step(tparams, tcfg, _t(tokens), _t(pos), tpages, _t(table),
                           _t(active), PS)
    _close(td, jd)


@pytest.mark.parametrize("router", ["random", "ties"])
def test_prefill_and_prefill_chunk_match_jax(models, router):
    """A batched prefill of two prompts, then a chunk of each on top."""
    jcfg, tcfg, jparams, tparams = _with_router(models, router)
    W = 4
    jpages, tpages = _pages(tcfg, 1 + 2 * W)
    rng = np.random.RandomState(9)
    table = (1 + np.arange(2 * W, dtype=np.int32)).reshape(2, W)
    tokens = rng.randint(0, 512, (2, 16)).astype(np.int32)
    valid = np.asarray([11, 16], np.int32)
    jprefill = jax.jit(lambda p, *a: jl.prefill(p, jcfg, *a, PS))
    jchunk = jax.jit(lambda p, *a: jl.prefill_chunk(p, jcfg, *a, PS))
    jl0, jpages = jprefill(jparams, _j(tokens), _j(valid), jpages, _j(table))
    tl0, tpages = tl.prefill(tparams, tcfg, _t(tokens), _t(valid), tpages,
                             _t(table), PS)
    _close(tl0, jl0)
    chunk = rng.randint(0, 512, (2, 8)).astype(np.int32)
    cvalid = np.asarray([8, 5], np.int32)
    jl1, _ = jchunk(jparams, _j(chunk), _j(valid), _j(cvalid), jpages, _j(table))
    tl1, _ = tl.prefill_chunk(tparams, tcfg, _t(chunk), _t(valid), _t(cvalid),
                              tpages, _t(table), PS)
    _close(tl1, jl1)


# ---------------------------------------------------------------- engines

_JAX_PROGRAMS = {}


def _jax_engine(models, **cfg):
    """A JAX engine; engines of one config share one jitted program set,
    so only the first of them compiles."""
    jcfg, _, jparams, _ = models

    def make(programs=None):
        return jeng.LLMEngine(
            jcfg, jeng.EngineConfig(use_pallas=False, **dict(ENGINE, **cfg)),
            JaxByteTokenizer(512), params=jparams, rng_seed=0,
            checkpoint_label="moe", compiled_programs=programs)

    key = tuple(sorted(cfg.items()))
    if key not in _JAX_PROGRAMS:
        probe = make()  # resolves the config's defaults and the mesh
        _JAX_PROGRAMS[key] = build_compiled(jcfg, probe.config, probe.mesh,
                                            spec_k=probe.config.spec_decode_k)
    return make(_JAX_PROGRAMS[key])


def _port_engine(models, **cfg):
    _, tcfg, _, tparams = models
    return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, **cfg)), ByteTokenizer(512),
                     params=tparams, rng_seed=0, device="cpu",
                     checkpoint_label="moe")


def _serve(engine, sp_cls, prompts, logprobs_at=None, max_tokens=MAX_TOKENS):
    """[(token, logprob)] streams of greedy `prompts`, concurrently; the
    one at index `logprobs_at` asks for logprobs."""

    async def one(i, prompt):
        kw = dict(temperature=0.0, max_tokens=max_tokens, ignore_eos=True)
        if i == logprobs_at:
            kw["logprobs"] = 2
        return [(o.token_id, o.logprob) async for o in
                engine.generate(prompt, sp_cls(**kw))]

    async def main():
        await engine.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)]), 120)
        finally:
            await engine.stop()

    return asyncio.run(main())


# the legacy route is the whole engine on the legacy programs, with one
# request asking for logprobs
ROUTES = {"mixed": {}, "spec": {"spec_decode_k": 3},
          "legacy": {"use_ragged": False}, "int8_kv": {"kv_quant": "int8"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_greedy_streams_match_jax(models, route):
    """Four greedy prompts (one chunked over two steps): the port engine's
    streams equal the JAX engine's token for token, logprobs within
    float32 rounding."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, n).tolist() for n in (5, 20, 45, 9)]
    lp_at = 0 if route == "legacy" else None
    want = _serve(_jax_engine(models, **ROUTES[route]), js.SamplingParams, prompts,
                  lp_at)
    tengine = _port_engine(models, **ROUTES[route])
    got = _serve(tengine, ts.SamplingParams, prompts, lp_at)
    assert [[t for t, _ in s] for s in got] == [[t for t, _ in s] for s in want]
    assert all(len(s) == MAX_TOKENS for s in got)
    if route == "legacy":
        np.testing.assert_allclose([lp for _, lp in got[0]], [lp for _, lp in want[0]],
                                   atol=1e-4)
        assert tengine.legacy_dispatches["decode_lp"] > 0 and tengine.steps == 0
    elif route == "spec":
        assert tengine.dense_steps > 0


DRAIN_PROMPT = [7, 3, 99, 41, 5, 18, 200, 64, 12]
DRAIN_AT = 5
DRAIN_TOKENS = 24


def _drain(engine, sp_cls, deadline_cls, preempted_cls):
    """One greedy MoE stream, drained with an expired budget once it holds
    DRAIN_AT tokens: (tokens seen, the checkpoint)."""
    seen, caught = [], []

    async def main():
        await engine.start()
        try:
            async for out in engine.generate(DRAIN_PROMPT, sp_cls(
                    temperature=0.0, max_tokens=DRAIN_TOKENS, ignore_eos=True)):
                if out.token_id >= 0:
                    seen.append(out.token_id)
                if len(seen) == DRAIN_AT and not caught:
                    caught.extend(await engine.drain(deadline_cls.after(0.0)))
        except preempted_cls:
            pass
        finally:
            await engine.stop()

    asyncio.run(main())
    (ckpt,) = caught
    return seen, ckpt


def _resume(engine, checkpoint):
    async def main():
        await engine.start()
        try:
            return [o.token_id async for o in engine.resume_generation(checkpoint)
                    if o.token_id >= 0]
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("drained_by", ["port", "jax"])
def test_drain_checkpoint_resumes_in_the_other_package(models, drained_by):
    """An MoE stream drained mid-generation by one package resumes on the
    other's engine and splices into the uninterrupted stream."""
    full = [t for t, _ in _serve(_jax_engine(models), js.SamplingParams,
                                 [DRAIN_PROMPT], max_tokens=DRAIN_TOKENS)[0]]
    if drained_by == "port":
        seen, ckpt = _drain(_port_engine(models), ts.SamplingParams, tres.Deadline,
                            tlc.GenerationPreempted)
        rest = _resume(_jax_engine(models),
                       jlc.GenerationCheckpoint.from_dict(ckpt.to_dict()))
    else:
        seen, ckpt = _drain(_jax_engine(models), js.SamplingParams, jres.Deadline,
                            jlc.GenerationPreempted)
        rest = _resume(_port_engine(models),
                       tlc.GenerationCheckpoint.from_dict(ckpt.to_dict()))
    # tokens already routed when the drain came still reach the stream
    assert DRAIN_AT <= len(seen) < DRAIN_TOKENS and list(ckpt.generated) == seen
    assert seen + rest == full and len(full) == DRAIN_TOKENS


# ---------------------------------------------------------------- refusals

def test_int8_weights_over_moe_refused_as_in_jax(models):
    jcfg, tcfg, _, tparams = models
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        tl.init_params(tcfg, device="cpu", weight_quant="int8")
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        jl.init_params(jcfg, jax.random.PRNGKey(0), weight_quant="int8")
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        tq.quantize_params(tparams, tcfg)
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        jq.quantize_params(models[2], jcfg)
    cfg = dict(ENGINE, weight_quant="int8")
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512), params=tparams,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="weight_quant over MoE experts"):
        LLMEngine(tcfg, EngineConfig(**cfg), ByteTokenizer(512), device="cpu")


def test_lora_over_moe_refused_as_in_jax(models, tmp_path):
    jcfg, tcfg, jparams, tparams = models
    adapters = {"a": str(tmp_path)}  # refused before any adapter is read
    with pytest.raises(NotImplementedError, match="LoRA over MoE layers"):
        LLMEngine(tcfg, EngineConfig(**ENGINE), ByteTokenizer(512), params=tparams,
                  device="cpu", lora_adapters=adapters)
    with pytest.raises(NotImplementedError, match="LoRA over MoE layers"):
        jeng.LLMEngine(jcfg, jeng.EngineConfig(use_pallas=False, **ENGINE),
                       JaxByteTokenizer(512), params=jparams,
                       lora_adapters=adapters)


def test_profile_script_ranges_the_moe_parts():
    """scripts/torch_profile_mixed.py --moe names each part of the MoE MLP
    (router product, top-k, expert products, combine) with a profiler
    range while it profiles, and leaves models/moe.py as it was."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_profile_mixed.py"
    spec = importlib.util.spec_from_file_location("torch_profile_mixed", path)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    cfg = tm.MoEConfig(n_experts=4, top_k=2, hidden_size=16, intermediate_size=24)
    params = tm.init_moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(5, 16, generator=torch.Generator().manual_seed(1))
    plain = {fn: getattr(tm, fn) for fn in prof.MOE_PARTS.values()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.moe_ranges():
            got = tm.moe_mlp(params, x, cfg)
    assert {fn: getattr(tm, fn) for fn in plain} == plain
    assert torch.equal(got, tm.moe_mlp(params, x, cfg))
    ranges = {ev.key for ev in p.key_averages() if ev.key.startswith("moe.")}
    assert ranges == {f"moe.{part}" for part in prof.MOE_PARTS}
