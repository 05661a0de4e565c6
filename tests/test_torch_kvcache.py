"""Paged KV cache of the PyTorch port against the JAX package: scatters
write the same bits to the same (page, slot) places, padding goes to the
null page only, and the page allocator keeps its refcount contract."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kserve_tpu.engine import kvcache as jkv
from kserve_tpu_torch.engine import kvcache as kv

PS, NKV, D, P = 8, 2, 16, 12


def _pages(seed):
    return np.random.RandomState(seed).randn(P, 2, NKV, PS, D).astype(np.float32)


def test_write_ragged_kv_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    T = 16
    table = np.asarray([[3, 5, 0], [7, 0, 0], [9, 10, 11]], np.int32)
    # lane 0: positions 5..10 (crosses a page), lane 2: 16..19, padding -1
    seq = np.asarray([0] * 6 + [-1, -1] + [2] * 4 + [-1] * 4, np.int32)
    pos = np.asarray(list(range(5, 11)) + [0, 0] + list(range(16, 20)) + [0] * 4,
                     np.int32)
    k = rng.randn(T, NKV, D).astype(np.float32)
    v = rng.randn(T, NKV, D).astype(np.float32)
    base = _pages(1)
    got = kv.write_ragged_kv(
        torch.from_numpy(base.copy()), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(seq), torch.from_numpy(pos),
        PS).numpy()
    want = np.asarray(jkv.write_ragged_kv(
        jnp.asarray(base), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(seq), jnp.asarray(pos), PS))
    # exact: a scatter copies values, both sides f32.  Page 0 takes every
    # padding row (which duplicate wins is unspecified on both sides)
    np.testing.assert_array_equal(got[1:], want[1:])
    untouched = [p for p in range(1, P) if p not in (3, 5, 11)]
    np.testing.assert_array_equal(got[untouched], base[untouched])
    # the padding rows landed on the null page, slot 0, and nowhere else
    assert not np.array_equal(got[0], base[0])
    np.testing.assert_array_equal(got[0, :, :, 1:], base[0, :, :, 1:])


def test_append_token_kv_bit_equal_and_inactive_to_null_page():
    rng = np.random.RandomState(2)
    B = 4
    table = np.asarray([[1, 2], [3, 4], [5, 6], [7, 8]], np.int32)
    pos = np.asarray([3, 9, 15, 40], np.int32)  # lane 3 is far past its table
    active = np.asarray([True, True, False, False])
    k = rng.randn(B, NKV, D).astype(np.float32)
    v = rng.randn(B, NKV, D).astype(np.float32)
    base = _pages(3)
    got = kv.append_token_kv(
        torch.from_numpy(base.copy()), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(active),
        PS).numpy()
    want = np.asarray(jkv.append_token_kv(
        jnp.asarray(base), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(active), PS))
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[1, :, :, 3], np.stack([k[0], v[0]]))
    np.testing.assert_array_equal(got[4, :, :, 1], np.stack([k[1], v[1]]))
    # inactive lanes wrote nowhere but the null page
    np.testing.assert_array_equal(got[5:], base[5:])


def test_init_kv_pages_layout():
    cfg = kv.KVCacheConfig(n_layers=3, n_kv_heads=NKV, head_dim=D, page_size=PS,
                           num_pages=P, dtype="bfloat16")
    pages = kv.init_kv_pages(cfg, device="cpu")
    assert len(pages) == 3
    assert pages[0].shape == (P, 2, NKV, PS, D) and pages[0].dtype == torch.bfloat16
    assert all(int(p.count_nonzero()) == 0 for p in pages)


def test_page_allocator_refcounts_and_double_free():
    a = kv.PageAllocator(6)
    assert a.free_pages == 5  # page 0 reserved
    pages = a.allocate(3)
    assert 0 not in pages and len(set(pages)) == 3
    a.share(pages[:1])
    a.free(pages)
    assert a.free_pages == 4  # the shared page keeps one reference
    a.free(pages[:1])
    assert a.free_pages == 5
    a.free(pages)  # double free: must not list a page twice
    assert a.free_pages == 5
    assert sorted(a.allocate(5)) == [1, 2, 3, 4, 5]
    with pytest.raises(MemoryError):
        a.allocate(1)
    a.free([0])  # the null page is never freed
    assert a.free_pages == 0
    assert kv.pages_needed(17, 8) == jkv.pages_needed(17, 8) == 3


def test_helpers_default_to_cuda_and_raise_without_a_card(monkeypatch):
    """init_params, params_from_jax, init_kv_pages, init_kv_scales and
    SamplingState.from_params put their tensors on CUDA unless given a
    device (the JAX package puts arrays on its accelerator by default);
    with no card they raise instead of falling back to the CPU."""
    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState
    from kserve_tpu_torch.models import llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = kv.KVCacheConfig(n_layers=1, n_kv_heads=NKV, head_dim=D,
                           page_size=PS, num_pages=2, dtype="float32")
    mc = llama.LlamaConfig.tiny()
    calls = [
        lambda: kv.init_kv_pages(cfg),
        lambda: kv.init_kv_scales(cfg),
        lambda: llama.init_params(mc),
        lambda: llama.params_from_jax({}, mc),
        lambda: SamplingState.from_params([SamplingParams()]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()
    assert kv.init_kv_pages(cfg, device="cpu")[0].device.type == "cpu"
