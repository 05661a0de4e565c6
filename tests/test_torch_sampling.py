"""Sampling of the PyTorch port against the JAX package's sample_tokens.

Greedy rows are exact.  The top-k, top-p and min-p masks must be exactly
those of sample_tokens's mask steps (which are inline in the JAX function,
so `_jax_masked` below replays those lines on jnp), and every token the
JAX sampler draws under many keys must lie inside the port's unmasked set.
Seeded rows draw from JAX's own stream, fold_in(PRNGKey(seed), counter):
the port's threefry words equal jax.random.bits exactly, its uniforms
equal JAX's exactly, and its seeded tokens equal the JAX sampler's token
for token (the Gumbel noise differs from JAX's by the ulps of two log
implementations, 1e-6 relative, which no sampled case here is close to)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kserve_tpu.engine import sampling as js
from kserve_tpu_torch.engine import sampling as ts

V = 64
ROWS = [
    dict(temperature=0.0),
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.0, top_p=0.6),
    dict(temperature=1.3, min_p=0.2),
    dict(temperature=0.9, top_k=20, top_p=0.8, min_p=0.05),
    dict(temperature=1.0),
]


def _logits(seed=0):
    return np.random.RandomState(seed).randn(len(ROWS), V).astype(np.float32) * 3


def _states():
    jp = [js.SamplingParams(**r) for r in ROWS]
    tp = [ts.SamplingParams(**r) for r in ROWS]
    return js.SamplingState.from_params(jp), ts.SamplingState.from_params(tp, device="cpu")


def _jax_masked(logits, state):
    """The mask steps of kserve_tpu.engine.sampling.sample_tokens (:114-149)."""
    Vn = logits.shape[-1]
    scaled = logits / jnp.maximum(state.temperature, 1e-6)[:, None]
    sorted_logits = jnp.sort(scaled, axis=-1)[:, ::-1]
    kth_idx = jnp.clip(jnp.clip(state.top_k, 0, Vn) - 1, 0, Vn - 1)
    kth_val = jnp.take_along_axis(sorted_logits, kth_idx[:, None], axis=1)
    scaled = jnp.where((state.top_k > 0)[:, None] & (scaled < kth_val), -jnp.inf, scaled)
    probs_sorted = jax.nn.softmax(jnp.sort(scaled, axis=-1)[:, ::-1], axis=-1)
    cumprobs = jnp.cumsum(probs_sorted, axis=-1)
    cutoff_count = jnp.sum(cumprobs - probs_sorted < state.top_p[:, None], axis=-1)
    cutoff_idx = jnp.clip(cutoff_count - 1, 0, Vn - 1)
    cutoff_val = jnp.take_along_axis(
        jnp.sort(scaled, axis=-1)[:, ::-1], cutoff_idx[:, None], axis=1)
    scaled = jnp.where((state.top_p < 1.0)[:, None] & (scaled < cutoff_val),
                       -jnp.inf, scaled)
    probs = jax.nn.softmax(scaled, axis=-1)
    max_prob = probs.max(axis=-1, keepdims=True)
    return jnp.where((state.min_p > 0.0)[:, None]
                     & (probs < state.min_p[:, None] * max_prob), -jnp.inf, scaled)


def test_greedy_rows_exact():
    logits = _logits(1)
    jstate, tstate = _states()
    jtok = np.asarray(js.sample_tokens(jnp.asarray(logits), jstate,
                                       jax.random.PRNGKey(0)))
    ttok = ts.sample_tokens(torch.from_numpy(logits), tstate,
                            torch.Generator().manual_seed(0)).numpy()
    assert ttok[0] == jtok[0] == logits[0].argmax()
    greedy = ts.SamplingState.from_params([ts.SamplingParams(temperature=0.0)] * 6, device="cpu")
    assert greedy.all_greedy
    np.testing.assert_array_equal(
        ts.sample_tokens(torch.from_numpy(logits), greedy).numpy(),
        logits.argmax(-1))


def test_masks_equal_jax_mask_steps():
    logits = _logits(2)
    jstate, tstate = _states()
    want = np.asarray(_jax_masked(jnp.asarray(logits), jstate))
    got = ts.masked_logits(torch.from_numpy(logits), tstate).numpy()
    # the masks (which tokens survive) are exactly equal
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    # surviving values are logits / temperature on both sides (f32 divide)
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    assert np.isneginf(got[1]).sum() == V - 5  # top_k=5


def test_jax_samples_lie_in_port_support():
    logits = _logits(3)
    jstate, tstate = _states()
    keep = ~np.isneginf(ts.masked_logits(torch.from_numpy(logits), tstate).numpy())
    keys = jax.random.split(jax.random.PRNGKey(4), 48)
    draws = np.asarray(jax.vmap(
        lambda k: js.sample_tokens(jnp.asarray(logits), jstate, k))(keys))
    for row in range(len(ROWS)):
        assert keep[row, draws[:, row]].all(), row
    gen = torch.Generator().manual_seed(5)
    for _ in range(16):
        tok = ts.sample_tokens(torch.from_numpy(logits), tstate, gen).numpy()
        assert keep[np.arange(len(ROWS)), tok].all()


def test_seeded_row_reproducible_across_batch_positions():
    logits = np.random.RandomState(6).randn(4, V).astype(np.float32)
    row = logits[1].copy()
    seeded = ts.SamplingParams(temperature=1.0, seed=1234)
    free = ts.SamplingParams(temperature=1.0)
    a = ts.SamplingState.from_params([free, seeded, free, free], device="cpu")
    batch_b = np.stack([logits[0], logits[2], logits[3], row])
    b = ts.SamplingState.from_params([free, free, free, seeded], device="cpu")
    for counter in range(6):
        ta = ts.sample_tokens(torch.from_numpy(logits), a,
                              torch.Generator().manual_seed(counter),
                              torch.tensor([0, counter, 0, 0]))
        tb = ts.sample_tokens(torch.from_numpy(batch_b), b,
                              torch.Generator().manual_seed(99 + counter),
                              torch.tensor([0, 0, 0, counter]))
        assert int(ta[1]) == int(tb[3])


KEYS = [(0, 0), (7, 3), (42, 11), (2**31 - 1, 123456)]


def test_threefry_bits_and_uniforms_equal_jax():
    """Bit for bit: the key of fold_in(PRNGKey(seed), counter), the 32-bit
    words of jax.random.bits, and the uniforms gumbel's "low" mode draws
    (jax.random.uniform(minval=tiny)); the Gumbel values within 1e-6."""
    seed = torch.tensor([s for s, _ in KEYS])
    counter = torch.tensor([c for _, c in KEYS])
    k1, k2 = ts.seeded_keys(seed, counter)
    bits = ts.uniform_bits(k1, k2, 300).numpy().astype(np.uint32)
    tiny = float(np.finfo(np.float32).tiny)
    uniform = ts.seeded_uniform(seed, counter, 300).numpy()
    gumbel = ts.seeded_gumbel(seed, counter, 300).numpy()
    for i, (s, c) in enumerate(KEYS):
        key = jax.random.fold_in(jax.random.PRNGKey(s), c)
        np.testing.assert_array_equal(
            [int(k1[i]), int(k2[i])], np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(
            bits[i], np.asarray(jax.random.bits(key, (300,), jnp.uint32)))
        np.testing.assert_array_equal(
            uniform[i],
            np.asarray(jax.random.uniform(key, (300,), jnp.float32, tiny, 1.0)))
        np.testing.assert_allclose(
            gumbel[i], np.asarray(jax.random.gumbel(key, (300,), jnp.float32)),
            rtol=1e-6, atol=1e-6)


def test_seeded_tokens_equal_jax_sampler():
    """72 (seed, counter, row) cases, every row seeded, with temperature,
    top-k, top-p and min-p: token for token equal to the JAX sampler."""
    rng = np.random.RandomState(8)
    cases = 0
    for trial in range(12):
        logits = (rng.randn(len(ROWS), V) * 3).astype(np.float32)
        seeds = rng.randint(0, 2**31 - 1, len(ROWS))
        counters = rng.randint(0, 5000, len(ROWS)).astype(np.int32)
        rows = [dict(r, temperature=max(r["temperature"], 0.6), seed=int(s))
                for r, s in zip(ROWS, seeds)]
        jstate = js.SamplingState.from_params([js.SamplingParams(**r) for r in rows])
        tstate = ts.SamplingState.from_params([ts.SamplingParams(**r) for r in rows], device="cpu")
        want = np.asarray(js.sample_tokens(
            jnp.asarray(logits), jstate, jax.random.PRNGKey(trial),
            jnp.asarray(counters)))
        got = ts.sample_tokens(torch.from_numpy(logits), tstate,
                               torch.Generator().manual_seed(trial),
                               torch.from_numpy(counters)).numpy()
        np.testing.assert_array_equal(got, want)
        cases += len(ROWS)
    assert cases >= 64
