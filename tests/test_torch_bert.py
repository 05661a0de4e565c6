"""The port's BERT encoder (kserve_tpu_torch/models/bert.py) against the
JAX package's (kserve_tpu/models/bert.py) on the CPU, in f32: encode,
embed, classify and fill_mask_logits on the same numpy inputs from a
seed and the same weights (carried across by params_from_jax), at `tiny`
and at head_dim 64, with a padded row and an all-padding row, held to
atol 1e-5; ids past the vocabulary and positions past the table read the
last row, as a JAX gather clamps; load_hf_weights bit-equal to the JAX
loader's on a safetensors file the test writes."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kserve_tpu.models import bert as jbert
from kserve_tpu_torch.models import bert as tbert
from kserve_tpu_torch.models import safetensors_io as sio

ATOL = 1e-5  # f32: the same products in another summation order
CONFIGS = {
    "tiny": dict(),
    "head_dim_64": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256),
}


FNS = ("encode", "embed", "classify", "fill_mask_logits")


def _weights(overrides, seed=0):
    jcfg = jbert.BertConfig.tiny(**overrides)
    jparams = jbert.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tbert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                    device="cpu")
    return jcfg, jparams, tbert.BertConfig.tiny(**overrides), tparams


def _inputs(T=24, vocab=128, seed=0):
    """Four rows: full, padded after 9 tokens, all padding, pair-typed."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(4, T)).astype(np.int32)
    mask = np.ones((4, T), np.int32)
    mask[1, 9:] = 0
    mask[2, :] = 0
    types = np.zeros((4, T), np.int32)
    types[3, T // 2:] = 1
    return ids, mask, types


def _both(overrides, ids, mask, types):
    """{fn: (JAX's output, the port's)} for the four functions, the JAX
    ones in one jitted program (eager JAX compiles every op apart)."""
    jcfg, jparams, tcfg, tparams = _weights(overrides)

    @jax.jit
    def reference(p, i, m, t):
        return (jbert.encode(p, jcfg, i, m, t), jbert.embed(p, jcfg, i, m),
                jbert.classify(p, jcfg, i, m, t), jbert.fill_mask_logits(p, jcfg, i, m))

    want = reference(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
    i, m, t = (torch.tensor(a, dtype=torch.long) for a in (ids, mask, types))
    got = (tbert.encode(tparams, tcfg, i, m, t), tbert.embed(tparams, tcfg, i, m),
           tbert.classify(tparams, tcfg, i, m, t), tbert.fill_mask_logits(tparams, tcfg, i, m))
    return {fn: (np.asarray(w), g.numpy()) for fn, w, g in zip(FNS, want, got)}


@functools.lru_cache(maxsize=None)
def _outputs(config):
    return _both(CONFIGS[config], *_inputs())


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("fn", FNS)
def test_outputs_match_jax(fn, config):
    want, got = _outputs(config)[fn]
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()  # the all-padding row is uniform, not NaN
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_out_of_range_ids_and_positions_read_the_last_row():
    """The byte tokenizer's ids (bytes >= 128, BOS 257, EOS 258) past tiny's
    vocabulary of 128, and a bucket of 80 past its 64 positions: JAX's
    gathers clamp to the last row, and so does the port."""
    ids = np.array([list("é ü ß".encode()) + [257, 258] + [0] * 70,
                    [128, 200, 255, 256] + [5] * 76], np.int32)
    mask = np.ones_like(ids)
    mask[0, 12:] = 0
    for fn, (want, got) in _both({}, ids, mask, np.zeros_like(ids)).items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=fn)
    # the clamp is the last row: id 258 reads what id 127 reads
    _, _, tcfg, tparams = _weights({})
    a = tbert.encode(tparams, tcfg, torch.tensor([[258, 3]]), torch.ones(1, 2))
    b = tbert.encode(tparams, tcfg, torch.tensor([[127, 3]]), torch.ones(1, 2))
    assert torch.equal(a, b)


def test_init_params_is_seeded_with_the_reference_layout():
    cfg = tbert.BertConfig.tiny()
    a = tbert.init_params(cfg, seed=3, device="cpu")
    b = tbert.init_params(cfg, seed=3, device="cpu")
    c = tbert.init_params(cfg, seed=4, device="cpu")
    ja = jbert.init_params(jbert.BertConfig.tiny(), jax.random.PRNGKey(0))
    flat_a, tree_a = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda t: t.numpy(), a))
    flat_j, tree_j = jax.tree_util.tree_flatten(ja)
    assert tree_a == tree_j
    for x, y in zip(flat_a, flat_j):
        assert x.shape == y.shape and x.dtype == np.float32
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    assert not torch.equal(a["word_embeddings"], c["word_embeddings"])
    std = float(a["layers"][0]["ffn_in"]["w"].std())
    assert 0.015 < std < 0.025


def test_from_hf_config_matches_jax_and_ignores_num_labels():
    cfg = {"vocab_size": 99, "hidden_size": 16, "num_hidden_layers": 1,
           "num_attention_heads": 2, "intermediate_size": 32, "num_labels": 5}
    want = jbert.BertConfig.from_hf_config(cfg)
    got = tbert.BertConfig.from_hf_config(cfg)
    assert vars(got) == vars(want)
    assert got.num_labels == 2


@pytest.mark.parametrize("heads", ["all", "encoder_only"])
def test_load_hf_weights_bit_equal_to_jax(tmp_path, heads):
    """A BERT checkpoint (`bert.` prefix, Linear weights [out, in]) split
    over two shards; without the pooler, classifier and MLM heads both
    loaders fill the reference's zero / unit defaults."""
    cfg = tbert.BertConfig.tiny()
    tensors = tbert.hf_tensors(tbert.init_params(cfg, seed=1, device="cpu"))
    if heads == "encoder_only":
        tensors = {k: v for k, v in tensors.items()
                   if not k.startswith(("bert.pooler", "classifier", "cls."))}
    names = sorted(tensors)
    half = len(names) // 2
    sio.save_file({k: tensors[k] for k in names[:half]},
                  str(tmp_path / "model-00001-of-00002.safetensors"))
    sio.save_file({k: tensors[k] for k in names[half:]},
                  str(tmp_path / "model-00002-of-00002.safetensors"))
    got = tbert.load_hf_weights(str(tmp_path), cfg, device="cpu")
    want = jbert.load_hf_weights(str(tmp_path), jbert.BertConfig.tiny())
    flat_g, tree_g = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda t: t.numpy(), got))
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    if heads == "all":
        drawn = tbert.init_params(cfg, seed=1, device="cpu")
        for g, d in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(drawn)):
            assert torch.equal(g, d)


def test_layer_norm_matches_jax():
    from kserve_tpu.ops.norms import layer_norm as jln
    from kserve_tpu_torch.ops.norms import layer_norm as tln

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 5, 48)) * 4 + 1).astype(np.float32)
    w = rng.normal(size=48).astype(np.float32)
    b = rng.normal(size=48).astype(np.float32)
    want = np.asarray(jln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tln(torch.tensor(x), torch.tensor(w), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
