"""Sampling penalties and logprobs of the PyTorch port against the JAX
package: `apply_penalties` and `compute_logprobs`, then the legacy
programs that use them (`sample_first`, the `decode` family), program for
program against the JAX program of the same name.

All inputs come from a numpy seed and run in float32.  Logits are random
normals, so no two values tie: torch.topk and lax.top_k may order ties
differently, and these inputs have none.  Greedy and seeded rows give
the same tokens (seeded rows draw JAX's own threefry stream); unseeded
sampled rows draw from another generator on each side and are not
compared."""

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
from kserve_tpu.models import llama as jl
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import LegacyPrograms
from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
from kserve_tpu_torch.engine.types import EngineConfig
from kserve_tpu_torch.models import llama as tl

V = 512
# logprobs of the same f32 logits: log_softmax in two libraries
LP_TOL = dict(atol=1e-5, rtol=0)
PS = 8
ENGINE = dict(max_batch_size=3, page_size=PS, num_pages=32, max_pages_per_seq=8,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32", max_logprobs=5)
# greedy, seeded sampled, greedy; each penalty on some row
ROWS = [
    dict(temperature=0.0, repetition_penalty=1.3, logprobs=5),
    dict(temperature=0.8, seed=11, frequency_penalty=0.5, presence_penalty=0.2,
         logprobs=2),
    dict(temperature=0.0, presence_penalty=0.7, repetition_penalty=0.8),
]


def _states(rows):
    return (js.SamplingState.from_params([js.SamplingParams(**r) for r in rows]),
            ts.SamplingState.from_params([ts.SamplingParams(**r) for r in rows],
                                         device="cpu"))


@pytest.mark.parametrize("with_prompt", [False, True], ids=["output_only", "prompt"])
def test_apply_penalties_matches_jax(with_prompt):
    rng = np.random.RandomState(0)
    B = len(ROWS)
    logits = rng.randn(B, V).astype(np.float32) * 3
    counts = rng.randint(0, 3, (B, V)).astype(np.int32) * (rng.rand(B, V) < 0.1)
    counts = counts.astype(np.int32)
    prompt = rng.rand(B, V) < 0.05 if with_prompt else None
    jstate, tstate = _states(ROWS)
    want = js.apply_penalties(
        jnp.asarray(logits), jnp.asarray(counts), jstate.repetition_penalty,
        jstate.frequency_penalty, jstate.presence_penalty,
        None if prompt is None else jnp.asarray(prompt))
    got = ts.apply_penalties(
        torch.from_numpy(logits), torch.from_numpy(counts),
        tstate.repetition_penalty, tstate.frequency_penalty,
        tstate.presence_penalty,
        None if prompt is None else torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    # a row with the default penalties comes back bit for bit
    default = ts.SamplingState.from_params([ts.SamplingParams()], device="cpu")
    same = ts.apply_penalties(
        torch.from_numpy(logits[:1]), torch.from_numpy(counts[:1]),
        default.repetition_penalty, default.frequency_penalty,
        default.presence_penalty,
        None if prompt is None else torch.from_numpy(prompt[:1]))
    np.testing.assert_array_equal(same.numpy(), logits[:1])


def test_compute_logprobs_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, V).astype(np.float32) * 4
    sampled = rng.randint(0, V, 6).astype(np.int32)
    k = 7
    want = js.compute_logprobs(jnp.asarray(logits), jnp.asarray(sampled), k)
    got = ts.compute_logprobs(torch.from_numpy(logits), torch.from_numpy(sampled), k)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # ids exact
    assert got[2].dtype == torch.int32 and (got[0] <= 0).all()


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params): the same tiny
    f32 weights on both sides."""
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    tcfg = tl.LlamaConfig.tiny(dtype="float32")
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


def _program(jcfg, name):
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    fn, _ = program_defs(jcfg, jeng.EngineConfig(**ENGINE), mesh)[name]
    return jax.jit(fn)


def _lp_close(got, want, live=None):
    """(lp, top_vals, top_ids) of the port against JAX's, at the `live`
    entries (all by default).  A lane that sat a step out (past its page
    capacity) attends to nothing there: the port's attention is exactly 0
    and JAX's is unspecified (ROADMAP C5), and the engine drops that
    step's output, so only live steps are compared."""
    sel = (lambda x: x) if live is None else (lambda x: x[live])
    np.testing.assert_allclose(sel(got[0].numpy()), sel(np.asarray(want[0])),
                               **LP_TOL)
    np.testing.assert_allclose(sel(got[1].numpy()), sel(np.asarray(want[1])),
                               **LP_TOL)
    np.testing.assert_array_equal(sel(got[2].numpy()), sel(np.asarray(want[2])))


@pytest.mark.parametrize("name", ["sample_first", "sample_first_lp"])
def test_sample_first_matches_jax_program(models, name):
    """The first token after a chunked prefill: the prompt counts as seen
    by the repetition penalty; greedy and seeded rows exact."""
    rng = np.random.RandomState(2)
    logits = rng.randn(len(ROWS), V).astype(np.float32) * 3
    in_prompt = rng.rand(len(ROWS), V) < 0.05
    jstate, tstate = _states(ROWS)
    want = _program(models[0], name)(jnp.asarray(logits), jstate,
                                     jax.random.PRNGKey(0), jnp.asarray(in_prompt))
    got = LegacyPrograms(models[2], EngineConfig(**ENGINE)).get(name)(
        torch.from_numpy(logits), tstate, torch.Generator(), in_prompt)
    if name == "sample_first_lp":
        _lp_close(got[1], want[1])
        got, want = got[0], want[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _prefilled(models, rows):
    """Both sides' caches after the same `prefill` call over three prompts
    (lane i owns pages 1 + i*W ..), its first tokens, and the inputs."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.RandomState(3)
    lens = [10, 6, 9]
    W = ENGINE["max_pages_per_seq"]
    tokens = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.randint(0, V, n)
    valid = np.asarray(lens + [0], np.int32)
    page_ids = np.zeros((4, W), np.int32)
    page_ids[:3] = (1 + np.arange(3 * W, dtype=np.int32)).reshape(3, W)
    kvc = dict(n_layers=tcfg.n_layers, n_kv_heads=tcfg.n_kv_heads,
               head_dim=tcfg.head_dim, page_size=PS, num_pages=1 + 3 * W,
               dtype="float32")
    jpages = jax_init_kv_pages(JaxKVConfig(**kvc))
    tpages = init_kv_pages(KVCacheConfig(**kvc), device="cpu")
    rows4 = rows + [dict(temperature=0.0)]
    jstate, tstate = _states(rows4)
    jfirst, jpages = _program(jcfg, "prefill")(
        jparams, jnp.asarray(tokens), jnp.asarray(valid), jpages,
        jnp.asarray(page_ids), jstate, jax.random.PRNGKey(0),
        jnp.full((4,), -1, jnp.int32))
    tfirst, tpages = LegacyPrograms(tcfg, EngineConfig(**ENGINE)).get("prefill")(
        tparams, tokens, valid, tpages, page_ids, tstate, torch.Generator())
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    return dict(tokens=tokens[:3], lens=lens, first=tfirst.numpy()[:3],
                page_table=page_ids[:3], jpages=jpages, tpages=tpages)


@pytest.mark.parametrize("name", ["decode", "decode_lp", "decode_penalized",
                                  "decode_penalized_lp"])
def test_decode_programs_match_jax_program(models, name):
    """steps_per_sync decode steps after a batched prefill: lane 1 runs out
    of page capacity after two steps and holds its token; tokens exact
    (greedy and seeded), logprobs within 1e-5, top ids and the penalized
    forms' device counts exact."""
    pre = _prefilled(models, ROWS)
    jcfg, jparams, tcfg, tparams = models
    lens = np.asarray(pre["lens"], np.int32)
    B = len(lens)
    capacity = np.full(B, ENGINE["max_pages_per_seq"] * PS, np.int32)
    capacity[1] = lens[1] + 2
    active = np.ones(B, bool)
    counters = np.ones(B, np.int32)
    prompt = np.zeros((B, V), bool)
    counts = np.zeros((B, V), np.int32)
    for i in range(B):
        prompt[i, pre["tokens"][i, :lens[i]]] = True
        counts[i, pre["first"][i]] += 1
    jstate, tstate = _states(ROWS)
    penalized = "penalized" in name
    extra_j = (jnp.asarray(prompt), jnp.asarray(counts)) if penalized else ()
    jout = _program(jcfg, name)(
        jparams, jnp.asarray(pre["first"]), jnp.asarray(lens), pre["jpages"],
        jnp.asarray(pre["page_table"]), jnp.asarray(active),
        jnp.asarray(capacity), jnp.asarray(counters), jstate,
        jax.random.PRNGKey(1), jnp.full((B,), -1, jnp.int32), *extra_j)
    extra_t = (torch.from_numpy(prompt), torch.from_numpy(counts.copy())) if penalized else ()
    tout = LegacyPrograms(tcfg, EngineConfig(**ENGINE)).get(name)(
        tparams, pre["first"], lens, pre["tpages"], pre["page_table"], active,
        capacity, counters, tstate, torch.Generator(), *extra_t)
    if penalized:
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert int(tout[2].sum()) == counts.sum() + 4 + 2 + 4  # live steps
    jtok, ttok = jout[0], tout[0]
    if name.endswith("_lp"):
        live = np.ones((ENGINE["steps_per_sync"], B), bool)
        live[2:, 1] = False
        _lp_close(ttok[1:], jtok[1:], live)
        jtok, ttok = jtok[0], ttok[0]
    ttok, jtok = ttok.numpy(), np.asarray(jtok)
    assert ttok.shape == (ENGINE["steps_per_sync"], B)
    np.testing.assert_array_equal(ttok, jtok)
    # past its capacity lane 1 holds its last token
    assert (ttok[2:, 1] == ttok[1, 1]).all()
