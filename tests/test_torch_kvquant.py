"""int8 KV cache (kv_quant="int8") of the PyTorch port against the JAX
package on the CPU.

- quantize_rows / dequantize_rows and the tuple-cache scatters are
  bit-equal to JAX's: the same f32 division, round half to even and clip.
- The port's plain ragged, dense and decode versions over (int8 pages,
  scales) dequantize in f32, as the Pallas kernels do: against
  ragged_paged_attention_pallas(..., interpret=True) they differ by
  summation order only (f32, atol/rtol 2e-5; the dense packing 2e-4, as
  the JAX package's own dense test), at head_dim 128, 64 and 256.
- The JAX XLA gathers round dequantized rows to bf16 (ROADMAP §C), so the
  port is held to them at the JAX package's own int8 tolerance, atol 2e-2
  (tests/test_ragged_attention.py:245-252).
- forward_ragged over the int8 cache equals JAX's forward_ragged with the
  Pallas kernel in interpret mode within 1e-4 (f32 logits through 2
  layers); the `mixed` program and the engine emit JAX's int8 greedy
  tokens on these seeds; spec-on equals spec-off over the int8 cache.

Float32 and tiny shapes throughout.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kserve_tpu.engine import engine as jeng
from kserve_tpu.engine import kvcache as jkv
from kserve_tpu.engine import sampling as js
from kserve_tpu.engine.compiled import program_defs
from kserve_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from kserve_tpu.models import llama as jl
from kserve_tpu.ops import attention as jax_attn
from kserve_tpu.ops.pallas_paged_attention import ragged_paged_attention_pallas
from kserve_tpu.parallel import sharding as shd
from kserve_tpu_torch.engine import kvcache as kv
from kserve_tpu_torch.engine import sampling as ts
from kserve_tpu_torch.engine.compiled import make_mixed
from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
from kserve_tpu_torch.models import llama as tl
from kserve_tpu_torch.ops import attention as attn
from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

PS, NKV, NQ = 8, 2, 8
KERNEL_TOL = dict(atol=2e-5, rtol=2e-5)  # f32 dequant both sides
DENSE_TOL = dict(atol=2e-4)  # as tests/test_ragged_attention.py's dense test
XLA_TOL = dict(atol=2e-2)  # the XLA gathers dequantize to bf16
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)  # as tests/test_torch_llama.py
ENGINE = dict(max_batch_size=4, page_size=PS, num_pages=64, max_pages_per_seq=16,
              max_prefill_len=32, prefill_buckets=(16, 32), steps_per_sync=4,
              dtype="float32")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal_to_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(6, NKV, 16).astype(np.float32) * 3.0
    x[1, 0] = 0.0  # all-zero row: the 1e-8 scale floor
    # absmax 127 -> scale exactly 1: exact .5 ties, rounded half to even
    x[2, 1] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -126.5] + [0.0] * 8
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = kv.quantize_rows(tx)
    jq, js_ = jkv.quantize_rows(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    assert s[1, 0] == np.float32(1e-8) and not q[1, 0].any()
    np.testing.assert_array_equal(q[2, 1, :8].numpy(), [127, 2, -4, 0, 2, 0, 126, -126])
    for out in ("float32", "bfloat16"):
        got = kv.dequantize_rows(q, s, getattr(torch, out)).float().numpy()
        want = np.asarray(jkv.dequantize_rows(jq, js_, getattr(jnp, out)), np.float32)
        np.testing.assert_array_equal(got, want)


def _tuple_cache(seed, P=12, D=16):
    rng = np.random.RandomState(seed)
    pages = rng.randint(-127, 128, (P, 2, NKV, PS, D)).astype(np.int8)
    scales = rng.rand(P, 2, NKV, PS).astype(np.float32)
    return pages, scales


def _assert_cache_equal(got, want, base, written, null_slots):
    """Pages and scales equal JAX's off the null page (which duplicate
    padding row wins is unspecified on both sides); pages outside
    `written` untouched; the null page changed at `null_slots` only."""
    for g, w, b in zip(got, want, base):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[1:], w[1:])
        untouched = [p for p in range(1, len(b)) if p not in written]
        np.testing.assert_array_equal(g[untouched], b[untouched])
        other = [s for s in range(PS) if s not in null_slots]
        np.testing.assert_array_equal(g[0, :, :, other], b[0, :, :, other])


def test_write_ragged_kv_int8_bit_equal_to_jax():
    rng = np.random.RandomState(1)
    T = 16
    table = np.asarray([[3, 5, 0], [7, 0, 0], [9, 10, 11]], np.int32)
    seq = np.asarray([0] * 6 + [-1, -1] + [2] * 4 + [-1] * 4, np.int32)
    pos = np.asarray(list(range(5, 11)) + [0, 0] + list(range(16, 20)) + [0] * 4,
                     np.int32)
    k = rng.randn(T, NKV, 16).astype(np.float32)
    v = rng.randn(T, NKV, 16).astype(np.float32)
    base = _tuple_cache(2)
    cache = (_t(base[0].copy()), _t(base[1].copy()))
    got = kv.write_ragged_kv(cache, _t(k), _t(v), _t(table), _t(seq), _t(pos), PS)
    assert got is cache  # written in place
    want = jkv.write_ragged_kv(
        tuple(jnp.asarray(b) for b in base), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(seq), jnp.asarray(pos), PS)
    _assert_cache_equal(got, want, base, written=(3, 5, 11), null_slots=(0,))
    # the padding rows (k[6], k[7], ...) landed on the null page's slot 0
    assert not np.array_equal(got[1].numpy()[0, :, :, 0], base[1][0, :, :, 0])


def test_append_token_kv_int8_bit_equal_and_inactive_to_null_page():
    rng = np.random.RandomState(3)
    table = np.asarray([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    pos = np.asarray([3, 9, 15, 40], np.int32)
    active = np.asarray([True, True, False, False])
    k = rng.randn(4, NKV, 16).astype(np.float32)
    v = rng.randn(4, NKV, 16).astype(np.float32)
    base = _tuple_cache(4)
    got = kv.append_token_kv((_t(base[0].copy()), _t(base[1].copy())), _t(k),
                             _t(v), _t(table), _t(pos), _t(active), PS)
    want = jkv.append_token_kv(
        tuple(jnp.asarray(b) for b in base), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(active), PS)
    # the inactive lanes at positions 15 and 40 write the null page only
    _assert_cache_equal(got, want, base, written=(1, 4), null_slots=(7, 0))
    qk, sk = kv.quantize_rows(_t(k[0]))
    np.testing.assert_array_equal(got[0][1, 0, :, 3].numpy(), qk.numpy())
    np.testing.assert_array_equal(got[1][1, 0, :, 3].numpy(), sk.numpy())


def test_init_kv_scales_layout():
    cfg = kv.KVCacheConfig(n_layers=2, n_kv_heads=NKV, head_dim=16,
                           page_size=PS, num_pages=5)
    scales = kv.init_kv_scales(cfg, device="cpu")
    want = jkv.init_kv_scales(jkv.KVCacheConfig(
        n_layers=2, n_kv_heads=NKV, head_dim=16, page_size=PS, num_pages=5))
    assert len(scales) == 2
    for s, w in zip(scales, want):
        assert s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), np.asarray(w))


# ---------------------------------------------------------------- attention

# Every ragged case packs into one shape (4 lanes of 4 pages, 32 rows), so
# each jitted JAX function compiles once per set of static knobs.
B_MAX, W_MAX, T_MAX = 4, 4, 32
RAGGED_CASES = {  # tests/test_ragged_attention.py:173-178, plus window/softcap
    "mixed": dict(lanes=[(10, 1), (8, 5), (0, 7), (0, 0)]),
    "pure_prefill": dict(lanes=[(0, 7), (0, 12), (0, 3)]),
    "chunked": dict(lanes=[(8, 8), (16, 5), (0, 1)]),
    "window": dict(lanes=[(30, 1), (20, 9), (0, 7)], window=6),
    "softcap_scale": dict(lanes=[(10, 1), (3, 1), (17, 1), (1, 1)],
                          softcap=6.0, scale=0.21),
    # head_dim 256 with Gemma-2's softcap and scale
    "window_d256": dict(lanes=[(30, 1), (20, 9), (0, 7)], window=6, d=256,
                        softcap=50.0, scale=0.0625),
}
STATIC = ("logit_softcap", "scale")
_pallas = jax.jit(functools.partial(ragged_paged_attention_pallas, interpret=True),
                  static_argnames=STATIC + ("dense_stride",))
_xla_ragged = jax.jit(jax_attn.ragged_paged_attention_xla, static_argnames=STATIC)
_xla_decode = jax.jit(jax_attn.paged_attention_xla, static_argnames=STATIC)


def _quantized(pages_f32):
    """f32 pages [P, 2, nkv, ps, d] -> the int8 tuple cache (numpy)."""
    q, s = kv.quantize_rows(_t(pages_f32))
    return q.numpy(), s.numpy()


def _ragged_int8(lanes, d=128, seed=0):
    rng = np.random.RandomState(seed)
    lanes = lanes + [(0, 0)] * (B_MAX - len(lanes))
    q_start, off = [], 0
    for _, qn in lanes:
        q_start.append(off)
        off += -(-qn // RAGGED_BQ) * RAGGED_BQ
    assert off <= T_MAX
    table = np.zeros((B_MAX, W_MAX), np.int32)
    for i, (h, qn) in enumerate(lanes):
        n = -(-(h + qn) // PS)
        table[i, :n] = 1 + i * W_MAX + np.arange(n)
    pages = rng.randn(1 + B_MAX * W_MAX, 2, NKV, PS, d).astype(np.float32)
    return dict(
        q=rng.randn(T_MAX, NQ, d).astype(np.float32), kv_pages=_quantized(pages),
        page_table=table, q_start=np.asarray(q_start, np.int32),
        q_len=np.asarray([q for _, q in lanes], np.int32),
        kv_start=np.asarray([h for h, _ in lanes], np.int32))


def _torch_args(case):
    return [tuple(_t(a) for a in v) if isinstance(v, tuple) else _t(v)
            for v in case.values()]


def _jax_args(case):
    return [tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
            else jnp.asarray(v) for v in case.values()]


@pytest.mark.parametrize("name", sorted(RAGGED_CASES))
def test_ragged_int8_plain_matches_pallas_interpret_and_xla(name):
    spec = RAGGED_CASES[name]
    case = _ragged_int8(spec["lanes"], d=spec.get("d", 128), seed=len(name))
    kw = dict(logit_softcap=spec.get("softcap", 0.0), scale=spec.get("scale"))
    window = spec.get("window", 0)
    got = attn.ragged_paged_attention(*_torch_args(case), window=window, **kw).numpy()
    jwin = jnp.asarray(window, jnp.int32)  # 0 = full attention on both
    pallas = np.asarray(_pallas(*_jax_args(case), window=jwin, **kw))
    np.testing.assert_allclose(got, pallas, **KERNEL_TOL)
    xla = np.asarray(_xla_ragged(*_jax_args(case), window=jwin, **kw))
    np.testing.assert_allclose(got, xla, **XLA_TOL)


@pytest.mark.parametrize("Kp,sp,d", [(4, 4, 128), (2, 2, 128), (4, 4, 256)],
                         ids=["k3_sp4", "k1_sp2", "k3_sp4_d256"])
def test_dense_int8_plain_matches_pallas_interpret(Kp, sp, d):
    """The spec-verify packing over int8 pages; every third lane has
    q_len 0 and reads nothing."""
    rng = np.random.RandomState(Kp + d)
    B, W = 8, 4
    kv_start = rng.randint(0, 12, B).astype(np.int32)
    q_len = np.asarray([0 if i % 3 == 2 else Kp for i in range(B)], np.int32)
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    case = dict(
        q=rng.randn(B * sp, NQ, d).astype(np.float32),
        kv_pages=_quantized(rng.randn(1 + B * W, 2, NKV, PS, d).astype(np.float32)),
        page_table=table, q_start=(np.arange(B) * sp).astype(np.int32),
        q_len=q_len, kv_start=kv_start)
    got = attn.ragged_paged_attention(*_torch_args(case), dense_stride=sp).numpy()
    want = np.asarray(_pallas(*_jax_args(case), window=jnp.asarray(0, jnp.int32),
                              dense_stride=sp))
    np.testing.assert_allclose(got, want, **DENSE_TOL)
    valid = np.zeros(B * sp, bool)
    for i, n in enumerate(q_len):
        valid[i * sp:i * sp + n] = True
    assert np.all(got[~valid] == 0.0)


@pytest.mark.parametrize("d", [128, 64, 256])
def test_decode_int8_plain_matches_xla(d):
    """paged_attention_xla's int8 branch (bf16 dequant) is the JAX
    function the decode kernel's int8 instance computes; the plain version
    equals the same gather over f32-dequantized pages to summation order."""
    rng = np.random.RandomState(d)
    lens = np.asarray([37, 1, 0, 30], np.int32)
    W = 4
    pages = _quantized(rng.randn(1 + 4 * W, 2, NKV, PS, d).astype(np.float32))
    table = (1 + np.arange(4 * W, dtype=np.int32)).reshape(4, W)
    q = rng.randn(4, NQ, d).astype(np.float32)
    got = attn.paged_attention(_t(q), tuple(_t(p) for p in pages), _t(table),
                               _t(lens), window=5).numpy()
    jargs = (jnp.asarray(q), tuple(jnp.asarray(p) for p in pages),
             jnp.asarray(table), jnp.asarray(lens))
    live = lens > 0
    win = jnp.asarray(5, jnp.int32)
    np.testing.assert_allclose(got[live], np.asarray(_xla_decode(*jargs, window=win))[live],
                               **XLA_TOL)
    deq = jnp.asarray(kv.dequantize_rows(_t(pages[0]), _t(pages[1])).numpy())
    oracle = np.asarray(_xla_decode(jargs[0], deq, *jargs[2:], window=win))
    np.testing.assert_allclose(got[live], oracle[live], **KERNEL_TOL)
    assert np.all(got[~live] == 0.0)


# ---------------------------------------------------------------- model


def _models(**overrides):
    jcfg = jl.LlamaConfig.tiny(dtype="float32", **overrides)
    tcfg = tl.LlamaConfig.tiny(dtype="float32", **overrides)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, tl.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _caches(cfg, num_pages):
    pages = np.zeros((num_pages, 2, cfg.n_kv_heads, PS, cfg.head_dim), np.int8)
    scales = np.ones(pages.shape[:4], np.float32)
    return ([(jnp.asarray(pages), jnp.asarray(scales))] * cfg.n_layers,
            [(_t(pages.copy()), _t(scales.copy())) for _ in range(cfg.n_layers)])


def test_forward_ragged_int8_matches_jax_pallas_interpret():
    """Two packed steps (a prompt chunk beside a whole prompt, then the
    chunk's tail beside a decode token) through the port's int8 cache and
    through JAX's forward_ragged with the int8 Pallas kernel in interpret
    mode.  The written caches agree to one int8 step where the two
    libraries' f32 K/V round to different sides of a quantization edge."""
    jcfg, tcfg, jparams, tparams = _models()
    jpages, tpages = _caches(tcfg, 1 + 3 * 4)
    rng = np.random.RandomState(7)
    p0, p1 = rng.randint(0, 512, 18).tolist(), rng.randint(0, 512, 6).tolist()
    table = (1 + np.arange(12, dtype=np.int32)).reshape(3, 4)

    def pallas(q, pages, table, q_start, q_len, kv_start, window):
        return ragged_paged_attention_pallas(
            q, pages, table, q_start, q_len, kv_start, window=window, interpret=True)

    jfwd = jax.jit(lambda params, packed, pages, last: jl.forward_ragged(
        params, jcfg, *packed, pages, jnp.asarray(table), PS, last,
        attention_fn=pallas))
    for lanes in ({0: (0, p0[:13]), 1: (0, p1)}, {0: (13, p0[13:]), 1: (6, [7])}):
        tok, seq, pos, q_start, q_len, kv_start, last = [], [], [], [], [], [], []
        for i in range(3):
            h, ids = lanes.get(i, (0, []))
            q_start.append(len(tok))
            q_len.append(len(ids))
            kv_start.append(h)
            last.append(len(tok) + len(ids) - 1 if ids else 0)
            pad = -len(ids) % RAGGED_BQ
            tok += list(ids) + [0] * pad
            seq += [i] * len(ids) + [-1] * pad
            pos += list(range(h, h + len(ids))) + [0] * pad
        pad = 24 - len(tok)  # both steps in one shape: one compile
        tok, seq, pos = tok + [0] * pad, seq + [-1] * pad, pos + [0] * pad
        packed = [np.asarray(a, np.int32) for a in (tok, seq, pos, q_start, q_len,
                                                     kv_start)]
        last = np.asarray(last, np.int32)
        jout, jpages = jfwd(jparams, [jnp.asarray(a) for a in packed], jpages,
                            jnp.asarray(last))
        tout, tpages = tl.forward_ragged(
            tparams, tcfg, *[_t(a) for a in packed], tpages, _t(table), PS, _t(last))
        np.testing.assert_allclose(tout.numpy()[:2], np.asarray(jout)[:2], **LOGIT_TOL)
    for (jp, js_), (tp, ts_) in zip(jpages, tpages):
        assert np.abs(tp.numpy()[1:].astype(int) - np.asarray(jp)[1:]).max() <= 1
        np.testing.assert_allclose(ts_.numpy()[1:], np.asarray(js_)[1:], rtol=1e-5)


def test_mixed_program_int8_matches_jax():
    """One `mixed` dispatch (two prompts, then 3 decode steps) over the
    int8 cache: the port's greedy tokens equal the JAX program's."""
    jcfg, tcfg, jparams, tparams = _models()
    mesh = shd.create_mesh(tp=1, dp=1, sp=1, pp=1)
    jmixed = jax.jit(program_defs(
        jcfg, jeng.EngineConfig(kv_quant="int8", **ENGINE), mesh)["mixed"][0])
    tmixed = make_mixed(tcfg, EngineConfig(kv_quant="int8", **ENGINE))
    B, W = 2, 4
    jpages, tpages = _caches(tcfg, 1 + B * W)
    rng = np.random.RandomState(0)
    p0, p1 = rng.randint(0, 512, 10).tolist(), rng.randint(0, 512, 6).tolist()
    tok = p0 + [0] * 6 + p1 + [0] * 2
    arr = lambda x: np.asarray(x, np.int32)  # noqa: E731
    plan = [arr(tok), arr([0] * 10 + [-1] * 6 + [1] * 6 + [-1] * 2),
            arr(list(range(10)) + [0] * 6 + list(range(6)) + [0] * 2),
            arr([0, 16]), arr([10, 6]), arr([0, 0]), arr([9, 21])]
    after = [(1 + np.arange(B * W, dtype=np.int32)).reshape(B, W),
             np.ones(B, bool), arr([-1, -1]), arr([10, 6]), arr([1, 1]),
             arr([W * PS] * B), arr([0, 0])]
    jout, _ = jmixed(
        jparams, *[jnp.asarray(a) for a in plan], jpages,
        *[jnp.asarray(a) for a in after],
        js.SamplingState.from_params([js.SamplingParams(temperature=0.0)] * B),
        jax.random.PRNGKey(1), jnp.full((B,), -1, jnp.int32))
    tout, tpages = tmixed(
        tparams, *plan, tpages, *after,
        ts.SamplingState.from_params([ts.SamplingParams(temperature=0.0)] * B, device="cpu"),
        torch.Generator())
    assert isinstance(tpages[0], tuple) and tpages[0][0].dtype == torch.int8
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


# ---------------------------------------------------------------- engines


async def _streams(engine, prompts, params_cls, spec=False):
    async def one(ids):
        params = params_cls(temperature=0.0, max_tokens=12, ignore_eos=True)
        return [o.token_id async for o in engine.generate(ids, params)]

    await engine.start()
    try:
        return await asyncio.wait_for(asyncio.gather(*[one(p) for p in prompts]), 120)
    finally:
        await engine.stop()


PROMPTS = ([5, 6, 7, 8], [9, 3, 4] * 7, [40] * 12)


def _engine(tcfg, tparams, **overrides):
    return LLMEngine(tcfg, EngineConfig(kv_quant="int8", **dict(ENGINE, **overrides)),
                     ByteTokenizer(512), params=tparams, rng_seed=0, device="cpu")


def test_engine_int8_greedy_streams_match_jax_and_spec_on():
    """Concurrent greedy streams (one prompt chunked past the 16-token
    bucket) of the port's int8 engine equal the JAX int8 engine's, and
    with speculative decoding on (K = 2) they equal spec off."""
    jcfg, tcfg, jparams, tparams = _models()
    jengine = jeng.LLMEngine(
        jcfg, jeng.EngineConfig(kv_quant="int8", **ENGINE),
        JaxByteTokenizer(512), params=jparams, rng_seed=0)
    want = asyncio.run(_streams(jengine, PROMPTS, js.SamplingParams))
    off = _engine(tcfg, tparams)
    assert isinstance(off.kv_pages[0], tuple)
    assert off.kv_pages[0][0].dtype == torch.int8
    assert off.kv_pages[0][1].shape == (ENGINE["num_pages"], 2, tcfg.n_kv_heads, PS)
    got = asyncio.run(_streams(off, PROMPTS, ts.SamplingParams))
    assert got == want
    spec = _engine(tcfg, tparams, spec_decode_k=2)
    assert asyncio.run(_streams(spec, PROMPTS, ts.SamplingParams)) == got
    assert spec.dense_steps > 0 and spec.spec_stats["accepted"] > 0


def test_unknown_kv_quant_raises_like_jax():
    _, tcfg, _, _ = _models()
    msg = "unknown kv_quant 'fp8'; supported: none, int8"
    with pytest.raises(ValueError, match=msg):
        LLMEngine(tcfg, EngineConfig(kv_quant="fp8", **ENGINE), ByteTokenizer(512),
                  device="cpu")
    jcfg = jl.LlamaConfig.tiny(dtype="float32")
    with pytest.raises(ValueError, match=msg):
        jeng.LLMEngine(jcfg, jeng.EngineConfig(kv_quant="fp8", **ENGINE),
                       JaxByteTokenizer(512))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_server_args_build_the_cache(kv_quant):
    """--kv_quant parses and the server's engine builds the matching cache
    on the CPU: plain pages, or (int8 pages, f32 scales) per layer."""
    from kserve_tpu_torch.runtimes.generative_server import build_arg_parser, build_model

    args = build_arg_parser().parse_args([
        "--model_config=tiny", "--random_weights", "--device=cpu",
        "--kv_dtype=float32", "--kv_pages=16", "--max_model_len=64",
        "--max_prefill_len=32", f"--kv_quant={kv_quant}"])
    model = build_model(args)
    assert model.engine_config.kv_quant == kv_quant
    engine = LLMEngine(model.model_config, model.engine_config, model.tokenizer,
                       device="cpu")
    layer = engine.kv_pages[0]
    assert len(engine.kv_pages) == model.model_config.n_layers
    if kv_quant == "none":
        assert torch.is_tensor(layer) and layer.dtype == torch.float32
    else:
        pages, scales = layer
        assert pages.dtype == torch.int8 and scales.dtype == torch.float32
        assert scales.shape == pages.shape[:4] and bool((scales == 1).all())
