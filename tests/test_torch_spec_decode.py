"""Speculative decoding (`mixed_decode`) of the PyTorch port against the
JAX package on the CPU.

- `dense_stride_for` and the dense-packing checks equal JAX's.
- The port's plain ragged attention on dense-packed input equals the
  JAX dense-stride Pallas kernel in interpret mode (atol 2e-4, as the JAX
  package's own dense-kernel test: f32 both sides, summation order only).
- `make_mixed_decode` equals JAX's `mixed_decode` program on the same
  weights, pages and draft table: tokens, emit counts, the table and the
  carry exactly, the written KV within 1e-5 (f32 summation order).  The
  port runs once at JAX's packing and once at stride 4 with 8-token
  alignment: the packing changes no output.
- Engines: greedy and seeded streams with spec on equal spec off and the
  JAX spec engine; the chain engages under concurrency; a request landing
  on max_model_len finishes; the server serves with --spec_decode_k.

Float32 and tiny shapes throughout.  Every async test runs under its own
asyncio.wait_for limit.
"""

import asyncio
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import program_defs
from kserve_tpu.engine.kvcache import KVCacheConfig as JaxKVConfig
from kserve_tpu.engine.kvcache import init_kv_pages as jax_init_kv_pages
from kserve_tpu.engine.kvcache import write_ragged_kv as jax_write_ragged_kv
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.ops.attention import dense_stride_for as jax_dense_stride_for
from kserve_tpu.ops.pallas_paged_attention import ragged_paged_attention_pallas
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import make_mixed_decode
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.engine.types import spec_decode_k_from_env
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.ops import attention as attn

PS = 8
NKV, NQ, D = 2, 8, 128
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=128, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")
LIMIT_S = 120  # per async test


def _models():
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


# ---------------------------------------------------------------- packing


def test_dense_stride_for_matches_jax():
    for align in (1, 8):
        for width in range(1, 18):
            assert attn.dense_stride_for(width, align) == jax_dense_stride_for(width, align)
    with pytest.raises(ValueError):
        attn.dense_stride_for(0, 8)


def _dense_case(Kp, sp, B=8, seed=0, d=D):
    """tests/test_ragged_attention.py:_dense_case at this file's shapes
    (head_dim d): every third lane inactive, the slices' K/V written by
    the JAX package's write_ragged_kv."""
    rng = np.random.RandomState(seed)
    T, W = B * sp, 8
    pages = rng.randn(1 + B * W, 2, NKV, PS, d).astype(np.float32)
    table = np.zeros((B, W), np.int32)
    kv_start = rng.randint(0, 12, B).astype(np.int32)
    q_len = np.asarray([0 if i % 3 == 2 else Kp for i in range(B)], np.int32)
    used = 1
    for i in range(B):
        for p in range(-(-(int(kv_start[i]) + Kp) // PS)):
            table[i, p] = used
            used += 1
    q = np.zeros((T, NQ, d), np.float32)
    tok_seq = np.full((T,), -1, np.int32)
    tok_pos = np.zeros((T,), np.int32)
    for i in range(B):
        for j in range(int(q_len[i])):
            q[i * sp + j] = rng.randn(NQ, d)
            tok_seq[i * sp + j] = i
            tok_pos[i * sp + j] = kv_start[i] + j
    pages = np.array(jax_write_ragged_kv(
        jnp.asarray(pages), jnp.asarray(rng.randn(T, NKV, d).astype(np.float32)),
        jnp.asarray(rng.randn(T, NKV, d).astype(np.float32)), jnp.asarray(table),
        jnp.asarray(tok_seq), jnp.asarray(tok_pos), PS))
    return dict(q=q, kv_pages=pages, page_table=table,
                q_start=(np.arange(B) * sp).astype(np.int32), q_len=q_len,
                kv_start=kv_start)


@pytest.mark.parametrize("Kp,sp,window,d", [(2, 2, 0, D), (3, 4, 0, D),
                                            (3, 4, 5, D), (4, 4, 5, 256)],
                         ids=["k1_sp2", "k2_sp4", "k2_sp4_window5",
                              "k3_sp4_window5_d256"])
def test_plain_dense_packing_matches_pallas_interpret(Kp, sp, window, d):
    case = _dense_case(Kp, sp, seed=Kp + sp + window, d=d)
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    got = attn.ragged_paged_attention(
        t["q"], t["kv_pages"], t["page_table"], t["q_start"], t["q_len"],
        t["kv_start"], window=window, dense_stride=sp).numpy()
    want = np.asarray(ragged_paged_attention_pallas(
        *[jnp.asarray(case[k]) for k in ("q", "kv_pages", "page_table", "q_start",
                                          "q_len", "kv_start")],
        window=jnp.asarray(window, jnp.int32), interpret=True, dense_stride=sp))
    np.testing.assert_allclose(got, want, atol=2e-4)
    # stride padding and inactive lanes are exactly zero
    valid = np.zeros(case["q"].shape[0], bool)
    for i, n in enumerate(case["q_len"]):
        valid[i * sp:i * sp + n] = True
    assert np.all(got[~valid] == 0.0)


def test_dense_packing_errors_match_jax():
    case = {k: torch.from_numpy(v) for k, v in _dense_case(3, 4).items()}
    args = [case[k] for k in ("q", "kv_pages", "page_table", "q_start", "q_len",
                              "kv_start")]
    with pytest.raises(ValueError, match="dense_stride 3 must divide RAGGED_BQ=8"):
        attn.ragged_paged_attention(*args, dense_stride=3)
    short = [args[0][:-8]] + args[1:]
    with pytest.raises(ValueError, match=r"dense packing expects T == B\*stride"):
        attn.ragged_paged_attention(*short, dense_stride=4)
    jargs = [jnp.asarray(a.numpy()) for a in short]
    with pytest.raises(ValueError, match=r"dense packing expects T == B\*stride"):
        ragged_paged_attention_pallas(*jargs, interpret=True, dense_stride=4)


# ---------------------------------------------------------------- program


def _program_inputs(B=4, W=4, V=512, seed=0):
    """Four lanes decoding from histories of a few tokens (three live, one
    dead), a bigram table partly learned, pages of random K/V."""
    rng = np.random.RandomState(seed)
    table = np.full((B, V), -1, np.int32)
    for i in range(B):
        src = rng.randint(0, V, 40)
        table[i, src] = rng.randint(0, V, 40)
    tokens = rng.randint(0, V, B).astype(np.int32)
    # lane 0 repeats itself, so its drafts are accepted under greedy
    table[0, tokens[0]] = tokens[0]
    return dict(
        tokens=tokens,
        pos=np.asarray([5, 9, 3, 0], np.int32),
        page_table=(1 + np.arange(B * W, dtype=np.int32)).reshape(B, W),
        live=np.asarray([True, True, True, False]),
        capacity=np.asarray([W * PS, W * PS, 12, 0], np.int32),
        counters=np.asarray([1, 4, 2, 0], np.int32),
        draft_table=table,
    )


@pytest.mark.parametrize("k_drafts", [0, 2])
def test_mixed_decode_matches_jax_program(k_drafts):
    jcfg, tcfg, jparams, tparams = _models()
    B, W = 4, 4
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    jec = jeng.EngineConfig(use_pallas=False, **ENGINE)
    jfn = jax.jit(program_defs(jcfg, jec, mesh, spec_k=k_drafts)["mixed_decode"][0])
    inp = _program_inputs()
    kvc = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
               head_dim=tcfg.head_dim, page_size=PS, num_pages=1 + B * W,
               dtype="float32")
    rng = np.random.RandomState(3)
    page_init = [rng.randn(*p.shape).astype(np.float32)
                 for p in jax_init_kv_pages(JaxKVConfig(**kvc))]
    params = [dict(temperature=0.0), dict(temperature=0.0),
              dict(temperature=0.9, top_k=40, seed=11), dict(temperature=0.0)]
    jtable = inp["draft_table"] if k_drafts else np.zeros((B, 1), np.int32)
    jout = jfn(jparams, *[jnp.asarray(inp[k]) for k in ("tokens", "pos")],
               [jnp.asarray(p) for p in page_init],
               *[jnp.asarray(inp[k]) for k in ("page_table", "live", "capacity",
                                                "counters")],
               jnp.asarray(jtable),
               js.SamplingState.from_params([js.SamplingParams(**p) for p in params]),
               jax.random.PRNGKey(1), jnp.full((B,), -1, jnp.int32))
    jtoks, jn, jpages, jtab, jtok, jpos, jcnt = [
        (np.asarray(x) if not isinstance(x, list) else [np.asarray(p) for p in x])
        for x in jout]
    assert jn.sum() > 0

    # JAX's packing (align 1: stride K+1), then stride 4 at 8-token alignment
    for align in (1, 8):
        fn = make_mixed_decode(tcfg, EngineConfig(**ENGINE), k_drafts, align)
        pages = [torch.from_numpy(p.copy()) for p in page_init]
        table = None
        if k_drafts:
            table = torch.from_numpy(
                np.concatenate([inp["draft_table"], np.full((1, 512), -1, np.int32)]))
        toks, n, pages, table, (tok, pos, cnt) = fn(
            tparams, inp["tokens"], inp["pos"], pages, inp["page_table"],
            inp["live"], inp["capacity"], inp["counters"], table,
            ts.SamplingState.from_params([ts.SamplingParams(**p) for p in params], device="cpu"),
            torch.Generator().manual_seed(0))
        live = inp["live"]
        # the unseeded batch noise differs (torch.Generator vs the JAX key):
        # every row here is greedy or seeded, so all tokens are exact
        np.testing.assert_array_equal(toks.numpy()[:, live], jtoks[:, live])
        np.testing.assert_array_equal(n.numpy(), jn)
        np.testing.assert_array_equal(tok.numpy()[live], jtok[live])
        np.testing.assert_array_equal(pos.numpy(), jpos)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        if k_drafts:
            np.testing.assert_array_equal(table.numpy()[:B], jtab)
        for tp, jp in zip(pages, jpages):
            # f32 K/V of the same math: summation order only
            np.testing.assert_allclose(tp.numpy()[1:], jp[1:], atol=1e-5, rtol=1e-5)
    if k_drafts:
        assert jn[:, 0].max() > 1  # lane 0's repetition was accepted


# ---------------------------------------------------------------- engines


def _engine(spec_k=None, **overrides):
    _, tcfg, _, tparams = _models()
    cfg = dict(ENGINE, **overrides)
    return LLMEngine(tcfg, EngineConfig(spec_decode_k=spec_k, **cfg),
                     ByteTokenizer(512), params=tparams, rng_seed=0, device="cpu")


async def _collect(engine, prompt, max_tokens=16, **params):
    params.setdefault("temperature", 0.0)
    cls = js.SamplingParams if isinstance(engine, jeng.LLMEngine) else ts.SamplingParams
    sp = cls(max_tokens=max_tokens, ignore_eos=True, **params)
    return [o.token_id async for o in engine.generate(prompt, sp)]


async def _run(engine, coro_fn):
    await engine.start()
    try:
        return await asyncio.wait_for(coro_fn(engine), LIMIT_S)
    finally:
        await engine.stop()


def _serial(prompts, max_tokens=16, **params):
    async def fn(engine):
        return [await _collect(engine, p, max_tokens, **params) for p in prompts]
    return fn


PROMPTS = ([5, 6, 7, 8], [9, 3, 4], [40] * 12)  # tests/test_spec_decode.py:138


def test_engine_greedy_streams_match_spec_off_and_jax():
    jcfg, _, jparams, _ = _models()
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False,
                                spec_decode_k=2, **ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    want = asyncio.run(_run(jengine, _serial(PROMPTS)))
    off = asyncio.run(_run(_engine(), _serial(PROMPTS)))
    spec = _engine(spec_k=2)
    got = asyncio.run(_run(spec, _serial(PROMPTS)))
    assert got == off == want
    assert spec.spec_stats["drafted"] > 0
    assert spec.spec_stats["accepted"] > 0  # the repetitive prompt
    s = spec.spec_stats
    assert s["drafted"] == s["accepted"] + s["rejected"]
    assert spec.dense_steps > 0


def test_engine_k0_drafts_nothing():
    off = asyncio.run(_run(_engine(), _serial(PROMPTS[:1])))
    dense = _engine(spec_k=0)
    got = asyncio.run(_run(dense, _serial(PROMPTS[:1])))
    assert got == off
    assert dense.spec_stats["drafted"] == 0 and dense.dense_steps > 0


def test_engine_concurrent_chained_streams_match_spec_off():
    prompts = [[7, 7, 3 + i] for i in range(4)]
    off = asyncio.run(_run(_engine(), _serial(prompts, max_tokens=40)))

    async def concurrent(engine):
        return list(await asyncio.gather(
            *[_collect(engine, p, max_tokens=40) for p in prompts]))

    spec = _engine(spec_k=3)
    assert asyncio.run(_run(spec, concurrent)) == off
    assert spec.chained_dispatches > 0


def test_engine_seeded_stream_matches_spec_off_and_jax():
    jcfg, _, jparams, _ = _models()
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(use_pallas=False, **ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    seeded = dict(temperature=0.8, seed=42)
    want = asyncio.run(_run(jengine, _serial([[3, 4, 5]], 12, **seeded)))
    off = asyncio.run(_run(_engine(), _serial([[3, 4, 5]], 12, **seeded)))
    got = asyncio.run(_run(_engine(spec_k=2), _serial([[3, 4, 5]], 12, **seeded)))
    assert got == off == want


def test_engine_kv_ceiling_falls_back_to_mixed():
    """prompt 4 + max_tokens 20 lands exactly on max_model_len 24: the
    last rounds cannot fit K+1 = 5, so the plain mixed path finishes."""
    off = asyncio.run(_run(_engine(max_pages_per_seq=3),
                           _serial([[5, 6, 7, 8]], 20)))
    spec = _engine(spec_k=4, max_pages_per_seq=3)
    got = asyncio.run(_run(spec, _serial([[5, 6, 7, 8]], 20)))
    assert got == off and len(got[0]) == 20
    assert spec.dense_steps > 0 and spec.steps > 0


def test_spec_config_checks():
    with pytest.raises(ValueError, match="spec_decode_k must be >= 0"):
        _engine(spec_k=-1)


def test_spec_decode_k_from_env(monkeypatch):
    monkeypatch.delenv("KSERVE_TPU_SPEC_DECODE_K", raising=False)
    assert spec_decode_k_from_env() is None
    for raw, want in (("4", 4), ("0", 0), ("nope", None), ("-3", None)):
        monkeypatch.setenv("KSERVE_TPU_SPEC_DECODE_K", raw)
        assert spec_decode_k_from_env() == want


def test_server_with_spec_decode_serves_a_completion():
    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model

    args = build_arg_parser().parse_args([
        "--model_name=tiny", "--model_config=tiny", "--random_weights",
        "--device=cpu", "--kv_dtype=float32", "--http_port=0",
        "--max_model_len=128", "--kv_pages=64", "--max_prefill_len=32",
        "--max_batch_size=4", "--spec_decode_k", "2"])
    model = build_model(args)
    assert model.engine_config.spec_decode_k == 2
    srv = ModelServer(http_port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.start, args=([model],), daemon=True)
    thread.start()
    try:
        assert srv.listening.wait(60), "server did not start"
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/openai/v1/completions", body=json.dumps({
            "model": "tiny", "prompt": "ab ab ab ab", "max_tokens": 9,
            "temperature": 0, "ignore_eos": True}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        assert body["usage"]["completion_tokens"] == 9
        assert body["choices"][0]["finish_reason"] == "length"
        assert model.engine.dense_steps > 0
    finally:
        srv.request_stop()
        thread.join(30)
    assert not thread.is_alive()
