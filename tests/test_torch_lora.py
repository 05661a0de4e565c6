"""Multi-adapter LoRA of the PyTorch port against the JAX package.

Three HF PEFT adapters (ranks 4, 2 and 3 over different projection sets,
one on all seven) are written by the port's safetensors writer.  Held
against kserve_tpu on the CPU in float32: load_peft_adapter and
stack_adapters exactly; lora_delta within float32 rounding, with rows of
id -1 exactly zero; forward_ragged / decode_step logits with adapters
mixed per token, over plain and int8 weights, within 1e-4 x max|logit|;
greedy engine streams of a batch mixing base and adapter requests equal
to the JAX engine's on the `mixed`, spec and legacy (logprobs) routes and
over int8 KV pages; the prefix cache's hit and register counts with
adapter requests; and a drain checkpoint taken under an adapter, resumed
token-exactly by either package.  Also: base lanes bit-equal with
adapters loaded, a mixed batch equal to isolated runs, an unknown adapter
refused, preemption keeping the adapter, and the server's
--lora_adapters, /openai/v1/models listing and `model` selection."""

import asyncio
import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu import lifecycle as jlc
from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import build_compiled
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.models import lora as jlora
from kserve_tpu.models import quant as jq
from kserve_tpu_torch import lifecycle as tlc
from kserve_tpu_torch import resilience as tres
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.models import lora as tlora
from kserve_tpu_torch.models.safetensors_io import save_file

PS = 8
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
# float32 logits through 2 layers with adapters: another summation order
# only (~1e-6 relative observed)
LOGIT_REL_TOL = 1e-4
MAX_TOKENS = 8

_DIMS = {"q_proj": ("self_attn", "h", "q"), "k_proj": ("self_attn", "h", "kv"),
         "v_proj": ("self_attn", "h", "kv"), "o_proj": ("self_attn", "q", "h"),
         "gate_proj": ("mlp", "h", "f"), "up_proj": ("mlp", "h", "f"),
         "down_proj": ("mlp", "f", "h")}


def write_peft_adapter(path, config, seed, r=4, alpha=8,
                       targets=("q_proj", "v_proj", "up_proj"),
                       dtype=torch.float32):
    """A seeded HF PEFT adapter directory for `config`, written by the
    port's safetensors writer (`dtype` tensors, PEFT names and layouts:
    lora_A [r, in], lora_B [out, r])."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "target_modules": list(targets)}, f)
    size = {"h": config.hidden_size, "q": config.n_heads * config.head_dim,
            "kv": config.n_kv_heads * config.head_dim,
            "f": config.intermediate_size}
    tensors = {}
    for i in range(config.n_layers):
        for proj in targets:
            module, d_in, d_out = _DIMS[proj]
            prefix = f"base_model.model.model.layers.{i}.{module}.{proj}"
            tensors[f"{prefix}.lora_A.weight"] = torch.from_numpy(
                rng.randn(r, size[d_in]).astype(np.float32) * 0.5).to(dtype)
            tensors[f"{prefix}.lora_B.weight"] = torch.from_numpy(
                rng.randn(size[d_out], r).astype(np.float32) * 0.5).to(dtype)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX config, port config, JAX params, port params, adapter dirs):
    one tiny float32 model without adapters on either side."""
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    root = tmp_path_factory.mktemp("adapters")
    dirs = {
        "style-a": write_peft_adapter(root / "a", tcfg, seed=1),
        "style-b": write_peft_adapter(root / "b", tcfg, seed=2, r=2,
                                      targets=("q_proj", "o_proj", "down_proj")),
        "style-c": write_peft_adapter(root / "c", tcfg, seed=3, r=3, alpha=3,
                                      targets=tuple(_DIMS)),
    }
    return jcfg, tcfg, jparams, tparams, dirs


def _with_lora(jparams, jcfg, dirs):
    """JAX params with the adapters' stacks on their layers, as the JAX
    engine attaches them."""
    ids, stacks = jlora.stack_adapters(dirs, jcfg.n_layers, dtype=jcfg.dtype)
    layers = [dict(layer, lora=stack) if stack else dict(layer)
              for layer, stack in zip(jparams["layers"], stacks)]
    return ids, dict(jparams, layers=layers)


def test_load_peft_adapter_matches_jax(models, tmp_path):
    _, tcfg, _, _, dirs = models
    # and bfloat16 and float16 files whose alpha/r (16/12) neither holds
    bf16, fp16 = (write_peft_adapter(tmp_path / str(dt), tcfg, seed=4, r=12,
                                     alpha=16, dtype=dt)
                  for dt in (torch.bfloat16, torch.float16))
    for path in [*dirs.values(), bf16, fp16]:
        want_cfg, want = jlora.load_peft_adapter(path)
        got_cfg, got = tlora.load_peft_adapter(path)
        assert got_cfg == want_cfg
        assert sorted(got) == sorted(want)
        for i in want:
            assert sorted(got[i]) == sorted(want[i])
            for proj, (A, B) in want[i].items():
                np.testing.assert_array_equal(got[i][proj][0].float().numpy(),
                                              np.asarray(A, np.float32))
                np.testing.assert_array_equal(got[i][proj][1].float().numpy(),
                                              np.asarray(B, np.float32))
    _, want = jlora.stack_adapters({"x": bf16}, tcfg.n_layers, dtype="bfloat16")
    _, got = tlora.stack_adapters({"x": bf16}, tcfg.n_layers, dtype="bfloat16",
                                  device="cpu")
    for proj in want[0]:
        for k in ("A", "B"):
            np.testing.assert_array_equal(got[0][proj][k].float().numpy(),
                                          np.asarray(want[0][proj][k], np.float32))


def test_stack_adapters_match_jax(models):
    jcfg, tcfg, _, _, dirs = models
    want_ids, want = jlora.stack_adapters(dirs, jcfg.n_layers, dtype="float32")
    got_ids, got = tlora.stack_adapters(dirs, tcfg.n_layers, dtype="float32",
                                        device="cpu")
    assert got_ids == want_ids == {"style-a": 0, "style-b": 1, "style-c": 2}
    assert len(got) == len(want) == tcfg.n_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == sorted(tlora.TARGETS)
        for proj in w:
            for k in ("A", "B"):
                assert g[proj][k].dtype == torch.float32
                np.testing.assert_array_equal(g[proj][k].numpy(),
                                              np.asarray(w[proj][k]))
    # a projection no adapter touches is left out
    only_a = {"style-a": dirs["style-a"]}
    _, sparse = tlora.stack_adapters(only_a, tcfg.n_layers, dtype="float32",
                                     device="cpu")
    assert sorted(sparse[0]) == ["w_up", "wq", "wv"]


def test_lora_delta_matches_jax_and_base_rows_are_zero(models):
    jcfg, tcfg, _, _, dirs = models
    _, jstack = jlora.stack_adapters(dirs, jcfg.n_layers, dtype="float32")
    _, tstack = tlora.stack_adapters(dirs, tcfg.n_layers, dtype="float32",
                                     device="cpu")
    rng = np.random.RandomState(4)
    ids = np.asarray([0, -1, 2, 1, -1, 2, 0], np.int32)
    for proj, d_in in (("wq", 64), ("w_down", 128)):
        x = rng.randn(len(ids), d_in).astype(np.float32)
        onehot = (torch.from_numpy(ids)[:, None] == torch.arange(3)).float()
        got = tlora.lora_delta(tstack[0], proj, torch.from_numpy(x), onehot)
        # the JAX function over the same tokens as [T, 1, in] rows with a
        # per-token one-hot (its forward_ragged's layout)
        want = jlora.lora_delta(jstack[0], proj, jnp.asarray(x)[:, None, :],
                                jax.nn.one_hot(jnp.asarray(ids), 3))[:, 0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(got[torch.from_numpy(ids < 0)],
                           torch.zeros((2, got.shape[1])))
        assert got[torch.from_numpy(ids >= 0)].abs().max() > 0
    assert tlora.lora_delta(tstack[0], "wk", torch.zeros(1, 64), None) is None
    assert tlora.lora_delta({}, "wq", torch.zeros(1, 64), onehot) is None


def _pages(tcfg, num_pages):
    kv = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
              head_dim=tcfg.head_dim, page_size=PS, num_pages=num_pages,
              dtype="float32")
    return jax_init_kv_pages(JaxKVConfig(**kv)), init_kv_pages(KVCacheConfig(**kv),
                                                                device="cpu")


def _ragged_plan(lens, seed):
    """Three lanes' whole prompts packed at 8-aligned offsets, lane i on
    pages 1 + 4i .. 4 + 4i."""
    rng = np.random.RandomState(seed)
    tok, seq, pos, q_start, last = [], [], [], [], []
    for i, n in enumerate(lens):
        q_start.append(len(tok))
        pad = -n % 8
        tok += rng.randint(0, 512, n).tolist() + [0] * pad
        seq += [i] * n + [-1] * pad
        pos += list(range(n)) + [0] * pad
        last.append(q_start[-1] + n - 1)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    table = (1 + np.arange(4 * len(lens), dtype=np.int32)).reshape(len(lens), 4)
    return ([i32(tok), i32(seq), i32(pos), i32(q_start), i32(lens),
             i32([0] * len(lens))], table, i32(last))


@pytest.mark.parametrize("weights", ["plain", "int8"])
def test_forward_ragged_adapters_per_token_match_jax(models, weights):
    """Lanes on adapters 0 and 2 beside a base lane in one packed buffer,
    then one decode step, over plain or int8 base weights (LoRA stacks
    stay float32 over int8 weights, as in the JAX package)."""
    jcfg, tcfg, jparams, _, dirs = models
    if weights == "int8":
        jparams = jq.quantize_params(jparams, jcfg)
    _, jparams = _with_lora(jparams, jcfg, dirs)
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    assert tparams["layers"][0]["lora"]["wq"]["A"].shape == (3, 64, 4)
    ids = np.asarray([0, -1, 2], np.int32)
    jpages, tpages = _pages(tcfg, 13)
    packed, table, last = _ragged_plan([11, 6, 9], seed=7)
    jfwd = jax.jit(lambda p, packed, pages, table, last, ids: jl.forward_ragged(
        p, jcfg, *packed, pages, table, PS, last, adapter_ids=ids))
    jdec = jax.jit(lambda p, tokens, pos, pages, table, active, ids: jl.decode_step(
        p, jcfg, tokens, pos, pages, table, active, PS, adapter_ids=ids))
    jout, jpages = jfwd(jparams, [jnp.asarray(a) for a in packed], jpages,
                        jnp.asarray(table), jnp.asarray(last), jnp.asarray(ids))
    tout, _ = tl.forward_ragged(tparams, tcfg, *map(torch.from_numpy, packed),
                                tpages, torch.from_numpy(table), PS,
                                torch.from_numpy(last),
                                adapter_ids=torch.from_numpy(ids))
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=LOGIT_REL_TOL * scale)
    tokens, pos = np.asarray([3, 4, 5], np.int32), np.asarray([11, 6, 9], np.int32)
    active = np.ones(3, bool)
    jd, _ = jdec(jparams, jnp.asarray(tokens), jnp.asarray(pos), jpages,
                 jnp.asarray(table), jnp.asarray(active), jnp.asarray(ids))
    td, _ = tl.decode_step(tparams, tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(pos), tpages, torch.from_numpy(table),
                           torch.from_numpy(active), PS,
                           adapter_ids=torch.from_numpy(ids))
    scale = float(np.abs(np.asarray(jd)).max())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=LOGIT_REL_TOL * scale)


def test_base_lanes_bit_equal_with_adapters_loaded(models):
    """A base lane's logits in a dispatch mixing adapters equal, bit for
    bit, those of the same dispatch with every lane on the base model and
    those of the weights without adapters."""
    _, tcfg, _, tparams, dirs = models
    _, stacks = tlora.stack_adapters(dirs, tcfg.n_layers, dtype="float32",
                                     device="cpu")
    lora = dict(tparams, layers=[dict(layer, lora=stack) for layer, stack
                                 in zip(tparams["layers"], stacks)])
    packed, table, last = _ragged_plan([11, 6, 9], seed=8)

    def logits(params, ids):
        _, pages = _pages(tcfg, 13)
        out, _ = tl.forward_ragged(
            params, tcfg, *map(torch.from_numpy, packed), pages,
            torch.from_numpy(table), PS, torch.from_numpy(last),
            adapter_ids=None if ids is None else torch.tensor(ids, dtype=torch.int32))
        return out

    mixed = logits(lora, [0, -1, 2])
    all_base = logits(lora, [-1, -1, -1])
    no_ids = logits(lora, None)
    plain = logits(tparams, None)
    assert torch.equal(mixed[1], all_base[1]) and torch.equal(mixed[1], plain[1])
    assert torch.equal(all_base, plain) and torch.equal(no_ids, plain)
    assert not torch.equal(mixed[0], plain[0]) and not torch.equal(mixed[2], plain[2])


# (request id, prompt length, adapter): a base lane between adapter lanes,
# one prompt over the 32-token bucket (chunked over two steps)
REQUESTS = [("a", 5, "style-a"), ("b", 20, None), ("c", 45, "style-b"),
            ("d", 9, "style-c")]


def _prompts(seed=1):
    rng = np.random.RandomState(seed)
    return {rid: rng.randint(0, 256, n).tolist() for rid, n, _ in REQUESTS}


def _port_engine(models, lora=True, **cfg):
    _, tcfg, _, tparams, dirs = models
    return LLMEngine(tcfg, EngineConfig(**dict(ENGINE, **cfg)), ByteTokenizer(512),
                     params=tparams, rng_seed=0, device="cpu",
                     checkpoint_label="tiny", lora_adapters=dirs if lora else None)


_JAX_PROGRAMS = {}


def _jax_engine(models, **cfg):
    """A JAX engine with the adapters loaded; engines of one config share
    one jitted program set, so only the first of them compiles."""
    jcfg, _, jparams, _, dirs = models

    def make(programs=None):
        return jeng.LLMEngine(
            jcfg, jeng.EngineConfig(use_pallas=False, **dict(ENGINE, **cfg)),
            JaxByteTokenizer(512), params=jparams, rng_seed=0,
            checkpoint_label="tiny", lora_adapters=dirs,
            compiled_programs=programs)

    key = tuple(sorted(cfg.items()))
    if key not in _JAX_PROGRAMS:
        probe = make()  # resolves the config's defaults and the mesh
        _JAX_PROGRAMS[key] = build_compiled(jcfg, probe.config, probe.mesh,
                                            spec_k=probe.config.spec_decode_k)
    return make(_JAX_PROGRAMS[key])


def _serve(engine, sp_cls, requests, logprobs_rid=None, sequential=False):
    """{request id: [(token, logprob)]} of `requests` ((rid, prompt,
    adapter)), concurrent unless `sequential`, greedy."""

    async def one(rid, prompt, adapter):
        kw = dict(temperature=0.0, max_tokens=MAX_TOKENS, ignore_eos=True)
        if rid == logprobs_rid:
            kw["logprobs"] = 2
        return [(o.token_id, o.logprob) async for o in
                engine.generate(prompt, sp_cls(**kw), adapter=adapter)]

    async def main():
        await engine.start()
        try:
            if sequential:
                return [await asyncio.wait_for(one(*r), 120) for r in requests]
            return await asyncio.wait_for(
                asyncio.gather(*[one(*r) for r in requests]), 120)
        finally:
            await engine.stop()

    return dict(zip([r[0] for r in requests], asyncio.run(main())))


# the legacy route is the whole engine on the legacy programs (its
# request "a" asks for logprobs); "int8" is int8 KV pages under int8
# weights, the adapters' stacks staying float32
ROUTES = {"mixed": {}, "spec": {"spec_decode_k": 2}, "legacy": {"use_ragged": False},
          "int8": {"kv_quant": "int8", "weight_quant": "int8"}}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_adapter_streams_match_jax(models, route):
    """Base and adapter requests concurrently: greedy streams equal to the
    JAX engine's (on the legacy route request "a", on an adapter, asks for
    logprobs; they agree within float32 rounding)."""
    prompts = _prompts()
    reqs = [(rid, prompts[rid], adapter) for rid, _, adapter in REQUESTS]
    lp_rid = "a" if route == "legacy" else None
    want = _serve(_jax_engine(models, **ROUTES[route]), js.SamplingParams, reqs, lp_rid)
    tengine = _port_engine(models, **ROUTES[route])
    got = _serve(tengine, ts.SamplingParams, reqs, lp_rid)
    for rid, _, _ in REQUESTS:
        assert [t for t, _ in got[rid]] == [t for t, _ in want[rid]], rid
        assert len(got[rid]) == MAX_TOKENS
    if lp_rid is not None:
        np.testing.assert_allclose([lp for _, lp in got["a"]],
                                   [lp for _, lp in want["a"]], atol=1e-4)
        assert tengine.legacy_dispatches["decode_lp"] > 0 and tengine.steps == 0
    if route == "spec":
        assert tengine.dense_steps > 0


def test_mixed_batch_equals_isolated_runs_and_base_engine(models):
    """Adapter math does not leak across lanes: each request alone gives
    what it gives in the batch, and a base request on an engine with
    adapters loaded gives the base engine's stream."""
    prompts = _prompts(seed=5)
    reqs = [(rid, prompts[rid], adapter) for rid, _, adapter in REQUESTS]
    together = _serve(_port_engine(models), ts.SamplingParams, reqs)
    alone = _serve(_port_engine(models), ts.SamplingParams, reqs, sequential=True)
    assert together == alone
    base = _serve(_port_engine(models, lora=False), ts.SamplingParams,
                  [("b", prompts["b"], None)])
    assert base["b"] == together["b"]
    assert together["a"] != together["b"]


def test_unknown_adapter_refused_as_in_jax(models):
    engine = _port_engine(models)
    assert engine.adapter_ids == {"style-a": 0, "style-b": 1, "style-c": 2}
    with pytest.raises(ValueError, match="unknown LoRA adapter") as got:
        engine.generate([1, 2], ts.SamplingParams(max_tokens=2), adapter="nope")
    with pytest.raises(ValueError) as want:
        _jax_engine(models).generate([1, 2], js.SamplingParams(max_tokens=2),
                                     adapter="nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="loaded: none"):
        _port_engine(models, lora=False).generate(
            [1, 2], ts.SamplingParams(max_tokens=2), adapter="style-a")


def test_preemption_resume_keeps_adapter(models):
    """A preempted adapter request resumes on its adapter: the squeezed
    engine's streams equal a roomy engine's."""
    rng = np.random.RandomState(9)
    reqs = [(rid, rng.randint(0, 256, 4).tolist(), "style-a") for rid in "pq"]

    def run(num_pages):
        engine = _port_engine(models, num_pages=num_pages)

        async def one(prompt, adapter):
            params = ts.SamplingParams(temperature=0.0, max_tokens=44,
                                       ignore_eos=True)
            return [o.token_id async for o in
                    engine.generate(prompt, params, adapter=adapter)]

        async def main():
            await engine.start()
            try:
                return await asyncio.wait_for(
                    asyncio.gather(*[one(p, a) for _, p, a in reqs]), 120)
            finally:
                await engine.stop()

        return asyncio.run(main()), engine.preemption_count

    want, _ = run(64)
    got, preempted = run(8)
    assert preempted > 0
    assert got == want


@pytest.mark.parametrize("route", ["mixed", "legacy"])
def test_adapter_requests_leave_prefix_counts_as_jax(models, route):
    """Requests sharing a 24-token (3-page) prefix, one after another:
    base, adapter, base, the same adapter again, another adapter.  Only
    base requests look up and register pages, so the hits and the cached
    pages equal the JAX engine's."""
    rng = np.random.RandomState(13)
    shared = rng.randint(0, 256, 24).tolist()
    tails = [rng.randint(0, 256, 5).tolist() for _ in range(5)]
    adapters = [None, "style-a", None, "style-a", "style-b"]
    reqs = [(str(i), shared + tails[i if i != 3 else 1], a)
            for i, a in enumerate(adapters)]
    cfg = {"use_ragged": False} if route == "legacy" else {}
    jengine = _jax_engine(models, **cfg)
    tengine = _port_engine(models, **cfg)
    want = _serve(jengine, js.SamplingParams, reqs, sequential=True)
    got = _serve(tengine, ts.SamplingParams, reqs, sequential=True)
    assert [[t for t, _ in got[r]] for r, *_ in reqs] == \
        [[t for t, _ in want[r]] for r, *_ in reqs]
    assert tengine.prefix_cache_hits == jengine.prefix_cache_hits == 3
    assert len(tengine._prefix_cache) == len(jengine._prefix_cache)


def test_drain_checkpoint_under_adapter_resumes_in_either_package(models):
    """A port engine drained mid-generation on an adapter: the checkpoint
    names the adapter, and resumed on a fresh port engine and on the JAX
    engine it splices into the uninterrupted stream token for token."""
    prompt = _prompts()["c"]
    params = dict(temperature=0.0, max_tokens=24, ignore_eos=True)
    engine = _port_engine(models)
    seen, caught = [], []

    async def drained():
        await engine.start()
        try:
            async for out in engine.generate(prompt, ts.SamplingParams(**params),
                                             adapter="style-b"):
                seen.append(out.token_id)
                if len(seen) == 6:
                    caught.extend(await engine.drain(tres.Deadline.after(0.0)))
        except tlc.GenerationPreempted:
            pass
        finally:
            await engine.stop()

    asyncio.run(drained())
    (ckpt,) = caught
    assert ckpt.adapter == "style-b" and list(ckpt.generated) == seen

    async def uninterrupted(engine):
        await engine.start()
        try:
            return [o.token_id async for o in engine.generate(
                prompt, ts.SamplingParams(**params), adapter="style-b")]
        finally:
            await engine.stop()

    full = asyncio.run(uninterrupted(_port_engine(models)))

    async def resume(engine, checkpoint):
        await engine.start()
        try:
            return [o.token_id async for o in engine.resume_generation(checkpoint)
                    if o.token_id >= 0]
        finally:
            await engine.stop()

    port = asyncio.run(resume(_port_engine(models), ckpt))
    jax_ckpt = jlc.GenerationCheckpoint.from_dict(ckpt.to_dict())
    jax_side = asyncio.run(resume(_jax_engine(models), jax_ckpt))
    assert seen + port == full
    assert seen + jax_side == full
    assert len(full) == 24
    # a base engine has no such adapter: the resume is refused
    with pytest.raises(ValueError, match="unknown LoRA adapter 'style-b'"):
        _port_engine(models, lora=False).resume_generation(ckpt)


@pytest.fixture(scope="module")
def lora_server(models):
    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    *_, dirs = models
    flag = ",".join(f"{n}={d}" for n, d in sorted(dirs.items()))
    model = build_model(build_arg_parser().parse_args(
        ["--model_name=tiny", "--model_config=tiny", "--random_weights",
         "--device=cpu", "--kv_dtype=float32", "--http_port=0",
         "--max_model_len=256", "--kv_pages=128", "--max_prefill_len=64",
         f"--lora_adapters={flag}"]))
    assert model.lora_adapters == dirs
    assert model.aliases == ("style-a", "style-b", "style-c")
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    assert srv.listening.wait(60), "server did not start"
    srv.model = model
    yield srv
    srv.request_stop()
    thread.join(30)
    assert not thread.is_alive()


def _request(srv, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.request("GET" if body is None else "POST", path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_server_lists_adapters_and_model_selects_them(lora_server):
    status, body = _request(lora_server, "/openai/v1/models")
    assert status == 200
    assert [m["id"] for m in json.loads(body)["data"]] == [
        "tiny", "style-a", "style-b", "style-c"]
    engine = lora_server.model.engine
    seen = []
    generate = engine.generate

    def spy(*args, **kw):
        seen.append(kw.get("adapter"))
        return generate(*args, **kw)

    engine.generate = spy
    try:
        base = dict(prompt=[5, 6, 7, 8], max_tokens=6, temperature=0,
                    ignore_eos=True, logprobs=1)
        outs = {}
        for name in ("tiny", "style-a", "style-c"):
            status, body = _request(lora_server, "/openai/v1/completions",
                                    dict(base, model=name))
            assert status == 200, body
            outs[name] = json.loads(body)["choices"][0]["logprobs"]["token_logprobs"]
        for path, stream in (("/openai/v1/completions", True),
                             ("/openai/v1/chat/completions", False),
                             ("/openai/v1/chat/completions", True)):
            body = {"model": "style-b", "max_tokens": 3, "temperature": 0,
                    "ignore_eos": True, "stream": stream}
            if "chat" in path:
                body["messages"] = [{"role": "user", "content": "hi"}]
            else:
                body["prompt"] = "hi"
            status, text = _request(lora_server, path, body)
            assert status == 200, text
            if stream:
                assert text.rstrip().endswith("data: [DONE]")
    finally:
        engine.generate = generate
    assert seen == [None, "style-a", "style-c", "style-b", "style-b", "style-b"]
    assert outs["style-a"] != outs["tiny"] and outs["style-c"] != outs["tiny"]
    # a name that is neither the model nor an adapter is not served here
    status, _ = _request(lora_server, "/openai/v1/completions",
                         {"model": "nope", "prompt": "hi", "max_tokens": 2})
    assert status == 404


def test_server_refuses_unknown_adapter_checkpoint_with_400(lora_server):
    ckpt = tlc.GenerationCheckpoint(
        request_id="r1", prompt_ids=[1, 2, 3], generated=[4],
        sampling={"temperature": 0.0, "max_tokens": 6, "ignore_eos": True},
        adapter="nope", model_name="tiny")
    status, body = _request(
        lora_server, "/openai/v1/completions",
        {"model": "tiny", "prompt": "hi", "max_tokens": 6},
        headers={tlc.CHECKPOINT_HEADER: ckpt.to_header()})
    assert status == 400 and "unknown LoRA adapter 'nope'" in body
    # the same checkpoint on a loaded adapter resumes
    ckpt.adapter = "style-a"
    status, body = _request(
        lora_server, "/openai/v1/completions",
        {"model": "style-a", "prompt": "hi", "max_tokens": 6},
        headers={tlc.CHECKPOINT_HEADER: ckpt.to_header()})
    assert status == 200, body
    assert json.loads(body)["usage"]["completion_tokens"] == 6
