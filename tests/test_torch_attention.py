"""Attention, norms and rope of the PyTorch port against the JAX package
on the CPU.

The port's plain ragged and decode attention (what the CUDA kernels are
held against on the card) must match the Pallas kernels in interpret mode
and the XLA gather versions, over the ragged compositions the engine's
mixed program produces, at head_dim 128, 64 and 256 (Gemma-2's, with its
8 q / 4 kv heads where the case says so).  Both sides run in float32 on
the same numpy inputs, so differences are summation order only:
atol/rtol 2e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kserve_tpu.ops import attention as jax_attn
from kserve_tpu.ops import norms as jax_norms
from kserve_tpu.ops import rotary as jax_rotary
from kserve_tpu.ops.pallas_paged_attention import (
    paged_attention_pallas,
    ragged_paged_attention_pallas,
)
from kserve_tpu_torch.ops import attention as attn
from kserve_tpu_torch.ops import norms, rotary
from kserve_tpu_torch.ops import paged_attention_cuda as K
from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

PS = 16
NKV = 2
NQ = 8  # GQA group 4, as Llama-3-8B
TOL = dict(atol=2e-5, rtol=2e-5)  # f32 both sides; summation order only

CASES = {
    "mixed": [(10, 1), (8, 5), (0, 7), (0, 0)],
    "pure_prefill": [(0, 7), (0, 12), (0, 3)],
    "pure_decode": [(10, 1), (3, 1), (17, 1), (1, 1)],
    "chunked": [(16, 8), (16, 5), (0, 1)],
    "inactive_lane": [(5, 1), (0, 0), (0, 0)],
}
# the same packings at head_dim 256 and Gemma-2-2B's GQA group 2
D256_CASES = {"mixed_d256": CASES["mixed"], "chunked_d256": CASES["chunked"]}
GEMMA_NQ = 4  # with NKV = 2: group 2, as gemma2-2b's 8 q / 4 kv heads


def _align(n):
    return -(-n // RAGGED_BQ) * RAGGED_BQ


def _ragged_case(lanes, d=128, seed=0, nq=NQ):
    """Packed queries at 8-aligned offsets and random pages, every lane on
    its own pages (page 0 the null page)."""
    rng = np.random.RandomState(seed)
    B = len(lanes)
    W = max(-(-(h + q) // PS) for h, q in lanes) or 1
    q_start, off = [], 0
    for _, qn in lanes:
        q_start.append(off)
        off += _align(qn)
    T = max(off, RAGGED_BQ)
    pages = rng.randn(1 + B * W, 2, NKV, PS, d).astype(np.float32)
    table = np.zeros((B, W), np.int32)
    for i, (h, qn) in enumerate(lanes):
        n = -(-(h + qn) // PS)
        table[i, :n] = 1 + i * W + np.arange(n)
    return dict(
        q=rng.randn(T, nq, d).astype(np.float32), kv_pages=pages,
        page_table=table, q_start=np.asarray(q_start, np.int32),
        q_len=np.asarray([q for _, q in lanes], np.int32),
        kv_start=np.asarray([h for h, _ in lanes], np.int32))


def _port_ragged(case, **kw):
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    return attn.ragged_paged_attention(
        t["q"], t["kv_pages"], t["page_table"], t["q_start"], t["q_len"],
        t["kv_start"], **kw).numpy()


def _jax_args(case):
    return (jnp.asarray(case["q"]), jnp.asarray(case["kv_pages"]),
            jnp.asarray(case["page_table"]), jnp.asarray(case["q_start"]),
            jnp.asarray(case["q_len"]), jnp.asarray(case["kv_start"]))


@pytest.mark.parametrize("name", sorted(CASES) + sorted(D256_CASES))
def test_ragged_plain_matches_pallas_interpret_and_xla(name):
    if name in D256_CASES:
        case = _ragged_case(D256_CASES[name], d=256, seed=len(name), nq=GEMMA_NQ)
    else:
        case = _ragged_case(CASES[name], seed=len(name))
    got = _port_ragged(case)
    pallas = np.asarray(ragged_paged_attention_pallas(
        *_jax_args(case), window=jnp.asarray(0, jnp.int32), interpret=True))
    xla = np.asarray(jax_attn.ragged_paged_attention_xla(*_jax_args(case)))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, xla, **TOL)
    # rows outside every slice are exactly zero (the kernel contract)
    valid = np.zeros(case["q"].shape[0], bool)
    for s, n in zip(case["q_start"], case["q_len"]):
        valid[s:s + n] = True
    assert np.all(got[~valid] == 0.0)


def test_ragged_sliding_window():
    case = _ragged_case([(30, 1), (20, 9), (0, 14)], seed=3)
    got = _port_ragged(case, window=6)
    want = np.asarray(ragged_paged_attention_pallas(
        *_jax_args(case), window=jnp.asarray(6, jnp.int32), interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    # head_dim 256 at Gemma-2's group 2, with its softcap and scale: the
    # Pallas kernel and the XLA gather
    case = _ragged_case([(30, 1), (20, 9), (0, 14)], d=256, seed=4, nq=GEMMA_NQ)
    kw = dict(logit_softcap=50.0, scale=0.0625)
    got = _port_ragged(case, window=6, **kw)
    win = jnp.asarray(6, jnp.int32)
    want = np.asarray(ragged_paged_attention_pallas(
        *_jax_args(case), window=win, interpret=True, **kw))
    np.testing.assert_allclose(got, want, **TOL)
    xla = np.asarray(jax_attn.ragged_paged_attention_xla(
        *_jax_args(case), window=win, **kw))
    np.testing.assert_allclose(got, xla, **TOL)


def test_ragged_softcap_and_scale_override():
    case = _ragged_case(CASES["chunked"], seed=5)
    got = _port_ragged(case, logit_softcap=8.0, scale=0.17)
    want = np.asarray(jax_attn.ragged_paged_attention_xla(
        *_jax_args(case), logit_softcap=8.0, scale=0.17))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(ragged_paged_attention_pallas(
        *_jax_args(case), window=jnp.asarray(0, jnp.int32), logit_softcap=8.0,
        scale=0.17, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)


def _slice_owner(q_start, q_len, row):
    """The lane whose slice holds packed row `row`, or -1: the rule each CTA
    of the port's ragged kernels applies by scanning q_start/q_len (csrc
    ragged_paged_attention.cu slice_owner) in place of the JAX package's
    block metadata.  A host statement of the rule, not the CUDA code: the
    device code is held to it on the card by chip_smoke.py's ragged cases
    (tile_edges_*, mixed, pure_decode)."""
    for i, (s, n) in enumerate(zip(q_start, q_len)):
        if n > 0 and s <= row < s + n:
            return i
    return -1


def test_ragged_metadata_matches_jax():
    """The block-owner rule of the port's ragged kernels (as `_slice_owner`
    states it; the CUDA code runs only on the card) and the port's token
    metadata against the JAX package's."""
    from kserve_tpu.ops.pallas_paged_attention import _ragged_block_metadata

    case = _ragged_case(CASES["mixed"], seed=9)
    G = case["q"].shape[0] // RAGGED_BQ
    jseq, jqoff = _ragged_block_metadata(
        jnp.asarray(case["q_start"]), jnp.asarray(case["q_len"]), G, RAGGED_BQ)
    seq = [_slice_owner(case["q_start"], case["q_len"], g * RAGGED_BQ)
           for g in range(G)]
    qoff = [g * RAGGED_BQ - case["q_start"][s] if s >= 0 else 0
            for g, s in enumerate(seq)]
    np.testing.assert_array_equal(seq, np.asarray(jseq))
    np.testing.assert_array_equal(qoff, np.asarray(jqoff))
    tseq, tloc, tvalid = attn.ragged_token_metadata(
        torch.from_numpy(case["q_start"]), torch.from_numpy(case["q_len"]),
        case["q"].shape[0])
    jtseq, jtloc, jtvalid = jax_attn.ragged_token_metadata(
        jnp.asarray(case["q_start"]), jnp.asarray(case["q_len"]), case["q"].shape[0])
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jtseq))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jtvalid))
    valid = tvalid.numpy()
    np.testing.assert_array_equal(tloc.numpy()[valid], np.asarray(jtloc)[valid])


_DECODE_LANES = ([37, 1, 0, 64], 4)
# lanes on both sides of the split kernel's 128-key chunks and one that
# fills its table (W * PS = 2048 keys)
_SPLIT_EDGE_LANES = ([127, 128, 129, 2048], 128)
# the same at head_dim 256, whose chunks are 64 keys
_SPLIT_EDGE_LANES_D256 = ([63, 64, 65, 1024], 64)


@pytest.mark.parametrize("d,softcap,lanes", [
    pytest.param(128, 0.0, _DECODE_LANES, id="128-0.0"),
    pytest.param(128, 30.0, _DECODE_LANES, id="128-30.0"),
    pytest.param(64, 0.0, _DECODE_LANES, id="64-0.0"),
    pytest.param(64, 20.0, _DECODE_LANES, id="64-20.0"),
    pytest.param(128, 0.0, _SPLIT_EDGE_LANES, id="128-0.0-split_edges"),
    pytest.param(64, 20.0, _SPLIT_EDGE_LANES, id="64-20.0-split_edges"),
    pytest.param(256, 50.0, _DECODE_LANES, id="256-50.0"),
    pytest.param(256, 0.0, _SPLIT_EDGE_LANES_D256, id="256-0.0-split_edges"),
])
def test_decode_plain_matches_pallas_interpret(d, softcap, lanes):
    """d=64 goes through the JAX package's packed two-tokens-per-row
    kernel.  An inactive lane (seq_len 0) is exactly zero in the port (as
    in its CUDA kernel); the JAX kernel returns an unspecified value there
    (the mean of the null page when the lane shares a block with active
    ones), which every caller discards, so only active lanes compare.  The
    split-edge lanes sit at the CUDA kernel's split boundaries; this plain
    version is what chip_smoke.py holds that kernel to on the card."""
    rng = np.random.RandomState(d + int(softcap))
    lens = np.asarray(lanes[0], np.int32)
    W = lanes[1]
    pages = rng.randn(1 + len(lens) * W, 2, NKV, PS, d).astype(np.float32)
    table = (1 + np.arange(len(lens) * W, dtype=np.int32)).reshape(len(lens), W)
    q = rng.randn(len(lens), NQ, d).astype(np.float32)
    got = attn.paged_attention(
        torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(table),
        torch.from_numpy(lens), logit_softcap=softcap).numpy()
    want = np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
        jnp.asarray(lens), logit_softcap=softcap, interpret=True))
    live = lens > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.all(got[~live] == 0.0)


def test_decode_window_and_scale_match_xla():
    """At head_dim 128, and at 256 with Gemma-2's group 2, softcap 50 and
    scale 256^-0.5."""
    rng = np.random.RandomState(11)
    lens = np.asarray([50, 3, 20], np.int32)
    W = 4
    table = (1 + np.arange(3 * W, dtype=np.int32)).reshape(3, W)
    for d, nq, softcap, scale in ((128, NQ, 5.0, 0.2), (256, GEMMA_NQ, 50.0, 0.0625)):
        pages = rng.randn(1 + 3 * W, 2, NKV, PS, d).astype(np.float32)
        q = rng.randn(3, nq, d).astype(np.float32)
        got = attn.paged_attention(
            torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(table),
            torch.from_numpy(lens), logit_softcap=softcap, scale=scale,
            window=7).numpy()
        want = np.asarray(jax_attn.paged_attention_xla(
            jnp.asarray(q), jnp.asarray(pages), jnp.asarray(table),
            jnp.asarray(lens), softcap, scale=scale,
            window=jnp.asarray(7, jnp.int32)))
        np.testing.assert_allclose(got, want, **TOL)


def test_rms_norms_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        **TOL)
    np.testing.assert_allclose(
        norms.rms_norm_plus_one(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_norms.rms_norm_plus_one(jnp.asarray(x), jnp.asarray(w))),
        **TOL)


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
])
def test_rope_matches_jax(scaling):
    """Phases reach angles of up to ~3000 rad: f32 sin/cos of the two
    libraries differ by a few ulps of the angle, hence atol 1e-4."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 128).astype(np.float32)
    pos = rng.randint(0, 3000, size=(2, 6)).astype(np.int32)
    got = rotary.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            500000.0, scaling).numpy()
    want = np.asarray(jax_rotary.apply_rope(
        jnp.asarray(x), jnp.asarray(pos), 500000.0, scaling))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        rotary.rope_frequencies(128, 500000.0, scaling).numpy(),
        np.asarray(jax_rotary.rope_frequencies(128, 500000.0, scaling)),
        rtol=1e-6)


def _random_packing(rng, B):
    """Lane lengths drawn around the tile edges (0, 1, 8, 9, 16, 17, ...)
    packed in lane order at RAGGED_BQ-aligned offsets, with whole padding
    blocks between some slices and at the end: (T, q_start, q_len)."""
    lens = rng.choice([0, 1, 7, 8, 9, 15, 16, 17, 63, 64, 65], size=B)
    q_start, off = [], 0
    for n in lens:
        off += RAGGED_BQ * rng.randint(0, 2)
        q_start.append(off)
        off += _align(int(n))
    T = max(off + RAGGED_BQ * rng.randint(0, 3), RAGGED_BQ)
    return T, np.asarray(q_start), lens


@pytest.mark.parametrize("group,d", [
    pytest.param(g, d, id=f"{g}-d{d}") for d in (128, 256)
    for g in (1, 2, 3, 4, 8, 16, 128, 256)])
def test_ragged_launch_plan_covers_every_tile(group, d):
    """Brute force over random packings: the grid of `ragged_launch_plan`
    holds every (lane, tile) of the prefix count, its slabs cover every
    (token, head) row of each tile exactly once, and the CTAs x < tiles
    reach every 8-token block to zero its padding rows (block x at d <= 128;
    blocks x, x + tiles, .. at d=256).  The tile rule here is the contract
    the CUDA tile_of implements, not that code: chip_smoke.py's
    tile_edges_* cases hold the kernel to it on the card.  The plan depends
    on head_dim: 64 query rows per CTA at d <= 128 (4 warps of mma.sync),
    128 at d=256 (two wgmma warpgroups), whose tile count is also bounded
    by the lanes (8 G / tq + B); group 2 at d=256 is gemma2-2b's plan."""
    nkv = 2
    rng = np.random.RandomState(group + d)
    for _ in range(60):
        T, q_start, q_len = _random_packing(rng, rng.randint(1, 10))
        B = len(q_len)
        plan = K.ragged_launch_plan(T, B, group * nkv, nkv, 1024, d)
        tq, rows = plan.tq, plan.rows
        assert rows == (K.WGMMA_ROWS if d > 128 else K.TC_ROWS)
        assert tq & (tq - 1) == 0
        assert tq * group <= rows or tq == 1
        assert (plan.slabs - 1) * rows < tq * group <= plan.slabs * rows
        tiles = [(i, t) for i, n in enumerate(q_len) for t in range(-(-n // tq))]
        assert len(tiles) <= plan.tiles
        G = T // RAGGED_BQ
        zeroers = [x for b in range(G) for x in range(plan.tiles)
                   if (x == b if d <= 128 else x % plan.tiles == b % plan.tiles)]
        assert len(zeroers) == G
        covered = []
        for i, t in tiles:
            for z in range(plan.slabs):
                for rr in range(z * rows, min((z + 1) * rows, tq * group)):
                    j = t * tq + rr // group
                    if j < q_len[i]:
                        covered.append((q_start[i] + j, rr % group))
        want = [(s + j, hh) for s, n in zip(q_start, q_len)
                for j in range(n) for hh in range(group)]
        assert sorted(covered) == sorted(want)


def _wgmma_ctas(plan, group, q_start, q_len, kv_start, window, keys):
    """The d=256 ragged kernel's CTAs (x, z) for one kv head, restating the
    arithmetic of csrc/ragged_paged_attention.cu (w256::ragged_kernel_wgmma):
    tile x of the prefix count (the lane's last tiles first), slab and
    split of z, the tile's key range from its first query's window to its
    last query split evenly into runs of at most chunk keys, and the
    consumer warpgroups with a query row.  CTAs that find no keys are left
    out.  Pure Python: the kernel is held to it on the card by
    chip_smoke.py's d=256 ragged cases."""
    kt, tq = K.WGMMA_KT, plan.tq
    tiles = [(i, t) for i, n in enumerate(q_len) for t in range(-(-n // tq))]
    ctas = []
    for x, (s, tix) in enumerate(tiles[:plan.tiles]):
        qn, kv0 = int(q_len[s]), int(kv_start[s])
        j0 = (-(-qn // tq) - 1 - tix) * tq
        rows_tile = tq * group
        for z in range(plan.slabs * plan.splits):
            slab, split = z % plan.slabs, z // plan.slabs
            r0 = slab * plan.rows
            j_lo = j0 + r0 // group
            if r0 >= rows_tile or j_lo >= qn:
                continue
            j_hi = min(j0 + (min(rows_tile, r0 + plan.rows) - 1) // group, qn - 1)
            hi = min(kv0 + j_hi + 1, keys)
            lo = (max(0, kv0 + j_lo - window + 1) if window > 0 else 0) // kt * kt
            n_all = -(-(hi - lo) // kt)
            nsp = -(-n_all // (plan.chunk // kt))
            if split >= nsp:
                continue
            t0, t1 = split * n_all // nsp, (split + 1) * n_all // nsp
            half = r0 + K.WGMMA_WG_ROWS
            rows = [(int(q_start[s]) + j0 + rr // group, rr % group, kv0 + j0 + rr // group)
                    for rr in range(r0, min(r0 + plan.rows, rows_tile))
                    if j0 + rr // group < qn]
            ctas.append(dict(
                x=x, z=z, rows=rows, nsp=nsp,
                key_tiles=[lo + kt * t for t in range(t0, t1)],
                n_wg=2 if half < rows_tile and j0 + half // group < qn else 1,
                wg1_rows=sum(1 for rr in range(half, min(r0 + plan.rows, rows_tile))
                             if j0 + rr // group < qn)))
    return ctas


def _sees(pos, key, window):
    return key <= pos and (window <= 0 or pos - key < window)


@pytest.fixture
def small_ragged_chunk():
    """Splits of 128 keys (two tiles), so that short lanes split as the
    4,000-key Gemma-2 lanes do at the defaults."""
    saved = K.RAGGED_MIN_CHUNK, K.RAGGED_MAX_CHUNK
    K.RAGGED_MIN_CHUNK = K.RAGGED_MAX_CHUNK = 128
    K.ragged_launch_plan.cache_clear()
    yield
    K.RAGGED_MIN_CHUNK, K.RAGGED_MAX_CHUNK = saved
    K.ragged_launch_plan.cache_clear()


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 40, 200])
def test_ragged_wgmma_plan_covers_every_visible_key(group, window,
                                                    small_ragged_chunk):
    """Brute force over random packings at d=256 (lanes up to 1,100 cached
    tokens, 16-token pages, splits of at least 128 keys): over the grid's
    (tile, split) CTAs every (query row, visible key) pair is covered
    exactly once; no CTA loads a key tile that none of its rows sees; a
    CTA's second warpgroup is active exactly when it has a query row; every
    8-token block's padding rows are zeroed by exactly one CTA per kv head
    and no row is both zeroed and computed; and the plan reads shapes only
    (T, B, heads, W * page_size, d), no per-lane lengths."""
    import inspect

    assert list(inspect.signature(K.ragged_launch_plan).parameters) == [
        "T", "B", "nq", "nkv", "keys", "d"]
    nkv, ps, kt = 2, 16, K.WGMMA_KT
    rng = np.random.RandomState(10 * group + window)
    split_seen = 0
    for _ in range(12):
        T, q_start, q_len = _random_packing(rng, rng.randint(1, 7))
        kv_start = rng.randint(0, 1100, size=len(q_len))
        W = max(-(-(int(h) + int(n)) // ps) for h, n in zip(kv_start, q_len)) + 1
        B, keys = len(q_len), W * ps
        plan = K.ragged_launch_plan(T, B, group * nkv, nkv, keys, 256)
        assert plan.chunk % kt == 0 and plan.chunk >= K.RAGGED_MIN_CHUNK
        assert plan.chunk <= max(K.RAGGED_MAX_CHUNK, -(-keys // K.SPLIT_MAX_SPLITS) + kt)
        assert 1 <= plan.splits <= K.SPLIT_MAX_SPLITS
        ctas = _wgmma_ctas(plan, group, q_start, q_len, kv_start, window, keys)
        # per row: the key tiles of the CTAs holding it, disjoint, covering
        # its visible keys [first, pos]
        per_row = {}
        for cta in ctas:
            assert cta["nsp"] <= plan.splits and cta["key_tiles"]
            split_seen += cta["nsp"] > 1
            assert (cta["n_wg"] == 2) == (cta["wg1_rows"] > 0)
            for k0 in cta["key_tiles"]:
                assert 0 <= k0 < keys
                assert any(_sees(pos, k, window) for _, _, pos in cta["rows"]
                           for k in range(k0, k0 + kt)), "a wholly masked tile"
            for p, hh, pos in cta["rows"]:
                per_row.setdefault((p, hh, pos), []).extend(cta["key_tiles"])
        want = {(int(s) + j, hh, int(h) + j) for s, n, h in zip(q_start, q_len, kv_start)
                for j in range(n) for hh in range(group)}
        assert set(per_row) == want
        for (_, _, pos), k0s in per_row.items():
            assert len(set(k0s)) == len(k0s), "a key tile walked twice for a row"
            have = {k for k0 in k0s for k in range(k0, k0 + kt)}
            first = max(0, pos - window + 1) if window else 0
            assert set(range(first, pos + 1)) <= have
        # padding rows: block b by CTA (b mod tiles, h, z = 0), per kv head
        G = T // RAGGED_BQ
        for b in range(G):
            assert [x for x in range(plan.tiles) if x == b % plan.tiles] == [b % plan.tiles]
        computed = {p for p, _, _ in want}
        slices = {int(s) + j for s, n in zip(q_start, q_len) for j in range(n)}
        zeroed = {r for r in range(T) if r not in slices}
        assert computed == slices and not computed & zeroed
        assert computed | zeroed == set(range(T))
    if window == 0 or window > K.RAGGED_MIN_CHUNK:  # runs longer than a split
        assert split_seen, "no tile was split: the test would not reach the merge"


def test_ragged_wgmma_plan_fills_the_card():
    """At chip_smoke.py's timed `prefill_chunk_d256` (Gemma-2-2B's 8 q /
    4 kv heads at d=256, window 4,096, lanes (3700, 1024), (4500, 1),
    (57, 1), (4300, 1), 16-token pages) at least 132 CTAs (an H100's SMs)
    have keys to read, and none walks more than twice the mean work per
    CTA, counted as key tiles and as key tiles times active warpgroups."""
    lanes = [(3700, 1024), (4500, 1), (57, 1), (4300, 1)]
    q_start, off = [], 0
    for _, n in lanes:
        q_start.append(off)
        off += _align(n)
    W = -(-max(h + n for h, n in lanes) // 16)
    plan = K.ragged_launch_plan(off, len(lanes), 8, 4, W * 16, 256)
    ctas = _wgmma_ctas(plan, 2, q_start, [n for _, n in lanes],
                       [h for h, _ in lanes], 4096, W * 16)
    assert plan.chunk == K.RAGGED_MAX_CHUNK  # 4,736 keys: the longest splits
    assert 4 * len(ctas) >= 132
    for work in ([len(c["key_tiles"]) for c in ctas],
                 [len(c["key_tiles"]) * c["n_wg"] for c in ctas]):
        assert max(work) <= 2 * sum(work) / len(work)


def test_ragged_wgmma_plan_splits_by_the_work():
    """The d=256 ragged plan's split length follows the grid's work at its
    longest over an H100's 132 SMs, between RAGGED_MIN_CHUNK and
    RAGGED_MAX_CHUNK: the first 1,024-token chunk of a Gemma-2 prompt (a
    bound of 17 tiles x 4 kv heads of up to 16 key tiles) splits at 576
    keys (its longest tiles in two runs of 8 key tiles), a chunk at
    ~4,700 cached tokens at 2,048, and 8 decode lanes of up to 4,096 keys
    at 1,024; a table of 128k keys keeps SPLIT_MAX_SPLITS."""
    first = K.ragged_launch_plan(1024, 1, 8, 4, 1024, 256)
    assert (first.tiles, first.chunk, first.splits) == (17, 576, 2)
    chunk = K.ragged_launch_plan(1048, 4, 8, 4, 4736, 256)
    assert (chunk.chunk, chunk.splits) == (2048, 3)
    decode = K.ragged_launch_plan(64, 8, 8, 4, 4096, 256)
    assert (decode.tiles, decode.chunk, decode.splits) == (8, 1024, 4)
    long = K.ragged_launch_plan(1024, 8, 8, 4, 131072, 256)
    assert long.splits <= K.SPLIT_MAX_SPLITS and long.chunk == 4096


def _s256_lane(kv0, qn, W, ps, window):
    """(lo, hi, n): a lane's key range and its n tiles of S256_KT keys
    from lo, as s256::lane_range derives them (qn 0: no tile)."""
    kt = K.S256_KT
    hi = min(kv0 + qn, W * ps) if qn > 0 else 0
    lo = (max(0, kv0 - window + 1) if window > 0 else 0) // kt * kt
    return lo, hi, (-(-(hi - lo) // kt) if hi > lo else 0)


def _s256_partition(plan, lanes, nkv, W, ps, window):
    """The d=256 dense / decode CTA's partition, restated from
    s256::split_kv_cta: on a cost axis every (lane, kv head, slab) pair in
    pair order takes its n key tiles and then A = plan.chunk positions
    for its epilogue; CTA i of R = min(G, C) (G = plan.splits, C the
    positions in all) walks [i C / R, (i + 1) C / R) from the lane its
    warp scan finds, one segment per pair whose tiles it covers (tiles
    [ta, tb) of the pair's n), and owner(t) names the run that holds
    position t.  lanes: (kv0, qn) each.  Returns (the lanes' ranges, the
    tiles N in all, the positions C in all, per CTA its segments)."""
    G, pp, A = plan.splits, nkv * plan.slabs, plan.chunk
    ranges = [_s256_lane(kv0, qn, W, ps, window) for kv0, qn in lanes]
    cost = [(n + A) * pp if n else 0 for _, _, n in ranges]
    C = sum(cost)
    R = min(G, C)

    def owner(t):
        return ((t + 1) * R - 1) // C

    ctas = []
    for i in range(G):
        T0, T1 = (i * C // R, (i + 1) * C // R) if i < R else (C, C)
        segs = []
        b = c = 0
        if T0 < T1:  # the scan: the lane whose positions hold T0
            while not c <= T0 < c + cost[b]:
                c += cost[b]
                b += 1
        t = T0
        while t < T1:
            while t >= c + cost[b]:
                c += cost[b]
                b += 1
            n = ranges[b][2]
            k = (t - c) // (n + A)
            P0 = c + k * (n + A)
            if t - P0 >= n:  # the pair's epilogue share
                t = P0 + n + A
                continue
            h, zs = divmod(k, plan.slabs)
            segs.append(dict(pair=(b * nkv + h) * plan.slabs + zs, b=b, ta=t - P0,
                             tb=min(n, T1 - P0), first=owner(P0),
                             runs=owner(P0 + n - 1) - owner(P0) + 1))
            t = P0 + segs[-1]["tb"]
        ctas.append(segs)
    return ranges, sum(n for _, _, n in ranges) * pp, C, ctas


def _check_s256_partition(plan, lanes, nkv, rows, W, ps, window):
    """Every key of every live pair's range, which holds every key its
    queries see, is in exactly one CTA's run; a pair's runs are the CTAs
    first .. first + runs - 1 that its partials count; lanes with no
    query have no pair; each partial's slot (pair + CTA) is unique and
    inside the scratch, each ticket too; the slabs cover the rows; the
    runs' work (tiles plus A per segment) stays within ceil(C / R) + A.
    Returns the work per CTA."""
    kt = K.S256_KT
    ranges, N, C, ctas = _s256_partition(plan, lanes, nkv, W, ps, window)
    slots, splits, srows, width = K.split_scratch_shape(len(lanes), nkv, plan, 256)
    assert (splits, srows, width) == (1, K.S256_ROWS, 258)
    assert (plan.slabs - 1) * K.S256_ROWS < rows <= plan.slabs * K.S256_ROWS
    parts, ctas_of, used = {}, {}, set()
    sizes = [sum(sg["tb"] - sg["ta"] for sg in segs) for segs in ctas]
    assert sum(sizes) == N
    # a run's work, its tiles plus A per segment, stays within its share of
    # the positions and one pair's A
    R = min(plan.splits, C)
    for sz, segs in zip(sizes, ctas):
        assert sz + plan.chunk * len(segs) <= -(-C // max(R, 1)) + plan.chunk
    for i, segs in enumerate(ctas):
        for sg in segs:
            parts.setdefault(sg["pair"], []).append((sg["ta"], sg["tb"]))
            ctas_of.setdefault(sg["pair"], []).append((i, sg["first"], sg["runs"]))
            slot = sg["pair"] + i
            assert slot < slots and slot not in used
            used.add(slot)
    for b, (kv0, qn) in enumerate(lanes):
        lo, hi, n = ranges[b]
        for j in range(qn):  # the keys query j sees lie in [lo, hi)
            assert lo <= (max(0, kv0 + j - window + 1) if window else 0)
            assert kv0 + j < hi or kv0 + j >= W * ps
        assert n == 0 or lo + (n - 1) * kt < hi <= lo + n * kt
        for p in range((b * nkv) * plan.slabs, (b * nkv + nkv) * plan.slabs):
            if n == 0:
                assert p not in parts
                continue
            # the tiles [0, n) back to back, each in one run
            bounds = [0] + [tb for _, tb in parts[p]]
            assert [ta for ta, _ in parts[p]] == bounds[:-1] and bounds[-1] == n
            first, runs = ctas_of[p][0][1:]
            assert [i for i, _, _ in ctas_of[p]] == list(range(first, first + runs))
            assert all((f, r) == (first, runs) for _, f, r in ctas_of[p])
            assert p < slots  # its ticket
    return [sz + plan.chunk * len(segs) for sz, segs in zip(sizes, ctas)]


@pytest.mark.parametrize("sp,group,d", [
    pytest.param(1, 4, 128, id="1-4"), pytest.param(2, 4, 128, id="2-4"),
    pytest.param(4, 4, 128, id="4-4"), pytest.param(4, 8, 128, id="4-8"),
    pytest.param(4, 2, 128, id="4-2"), pytest.param(2, 1, 128, id="2-1"),
    pytest.param(4, 2, 256, id="4-2-d256"), pytest.param(1, 2, 256, id="1-2-d256"),
    pytest.param(2, 2, 256, id="2-2-d256"), pytest.param(4, 4, 256, id="4-4-d256"),
])
def test_dense_launch_plan_covers_every_split(sp, group, d):
    """Brute force over random lanes (inactive ones, long ones, windows).
    At d <= 128: the splits of every lane's key range fit the grid of
    `dense_launch_plan` and cover the range once; the slabs cover the
    lane's sp * group rows; the scratch holds a partial per (lane, kv head,
    slab, split).  The key range and split bounds here restate the CUDA
    split CTA's (lo, hi, nsp) arithmetic (tc::split_kv_slab).  At d=256:
    batches of 1-160 lanes through the persistent CTA's partition
    (_check_s256_partition).  The kernels are held to them on the card by
    chip_smoke.py's split8_*, one_live_*, k1_sp2_d256 and window-edge
    dense cases."""
    nkv = 2
    rng = np.random.RandomState(sp * 10 + group + d)
    for W, ps in [(1, 16), (2, 8), (7, 16), (126, 16), (128, 16), (512, 16), (4096, 16)]:
        plan = K.dense_launch_plan(W, ps, sp, group * nkv, nkv, d)
        keys = W * ps

        def lane():
            qn = int(rng.randint(0, sp + 1))
            return int(rng.randint(0, max(keys - qn, 0) + 1)), qn

        if d > 128:
            assert (plan.chunk, plan.splits) == (K.S256_PAIR_COST, K.S256_CTAS)
            for B in (1, 8, 37, 160):
                lanes = [lane() for _ in range(B)]
                for window in (0, 1, 96, 1000):
                    _check_s256_partition(plan, lanes, nkv, sp * group, W, ps, window)
            continue
        assert plan.chunk % K.TC_KT == 0
        assert plan.chunk >= K.DENSE_MIN_CHUNK
        assert 1 <= plan.splits <= K.SPLIT_MAX_SPLITS
        assert ((plan.slabs - 1) * K.SPLIT_ROWS < sp * group
                <= plan.slabs * K.SPLIT_ROWS)
        assert K.split_scratch_shape(5, nkv, plan, d) == (
            5 * nkv * plan.slabs, plan.splits, K.SPLIT_ROWS, d + 2)
        for _ in range(100):
            kv0, qn = lane()
            window = int(rng.choice([0, 1, 96, 1000]))
            hi = min(kv0 + qn, keys) if qn else 0
            lo = (max(0, kv0 - window + 1) if window else 0) // K.TC_KT * K.TC_KT
            nsp = -(-(hi - lo) // plan.chunk) if hi > lo else 0
            assert nsp <= plan.splits
            got = [k for z in range(nsp)
                   for k in range(lo + z * plan.chunk, min(lo + (z + 1) * plan.chunk, hi))]
            assert got == list(range(lo, hi))
            # every key a query of the lane sees lies in [lo, hi)
            for j in range(qn):
                first = max(0, kv0 + j - window + 1) if window else 0
                assert lo <= first and kv0 + j < hi


def test_dense_launch_plan_fills_the_card_on_the_timed_round():
    """The chunk puts >= 2 CTAs on every one of an H100's 132 SMs in
    chip_smoke.py's timed verify round (8 lanes, Llama-3-8B's 8 kv heads,
    K + 1 = 4 at stride 4, 16-token pages)."""
    history = [310, 1024, 57, 0, 1999, 1500, 130, 777]
    live = [h + 4 for i, h in enumerate(history) if i not in (3, 5)]
    W = -(-max(live) // 16)
    plan = K.dense_launch_plan(W, 16, 4, 32, 8, 128)
    ctas = 8 * plan.slabs * sum(-(-n // plan.chunk) for n in live)
    assert ctas >= 2 * 132


def _decode_splits(seq_len, window, W, ps, plan):
    """The d <= 128 decode kernel's key range and splits for one lane, as
    tc::split_kv_slab computes them at stride 1 (one query token at
    seq_len - 1, none when seq_len is 0): (lo, hi, [(s_lo, s_hi), ...])."""
    qn, kv0 = int(seq_len > 0), seq_len - 1
    hi = min(kv0 + qn, W * ps) if qn else 0
    lo = (max(0, kv0 - window + 1) if window else 0) // K.TC_KT * K.TC_KT
    nsp = -(-(hi - lo) // plan.chunk) if hi > lo else 0
    return lo, hi, [(lo + z * plan.chunk, min(lo + (z + 1) * plan.chunk, hi))
                    for z in range(min(nsp, plan.splits))], nsp


@pytest.mark.parametrize("group,d", [
    pytest.param(1, 128, id="1"), pytest.param(4, 128, id="4"),
    pytest.param(8, 128, id="8"), pytest.param(16, 128, id="16"),
    pytest.param(32, 128, id="32"), pytest.param(2, 256, id="2-d256"),
    pytest.param(16, 256, id="16-d256"),
])
def test_decode_launch_plan_covers_every_split(group, d):
    """Brute force over random lengths (with 0, 1, chunk - 1, chunk,
    chunk + 1 and W * ps) and windows (0, 1, 96, 1000).  At d <= 128:
    every lane's splits fit the grid of `decode_launch_plan`, cover its
    key range once and each hold at most one chunk; the range holds every
    key the query sees; the slabs cover the group's rows; the scratch
    holds a partial per (lane, kv head, slab, split).  The arithmetic
    restates the CUDA split CTA's (tc::split_kv_slab at stride 1).  At
    d=256: batches of those lengths, 1-160 lanes, through the persistent
    CTA's partition (_check_s256_partition).  The kernels are held to
    them on the card by chip_smoke.py's split8, one_live, split_edges,
    window_across_split, window_edge and b160 decode cases."""
    nkv, ps = 2, 16
    rng = np.random.RandomState(group + d)
    for W in (1, 7, 128, 512, 4096):
        plan = K.decode_launch_plan(W, ps, group * nkv, nkv, d)
        keys = W * ps
        edges = [0, 1, plan.chunk - 1, plan.chunk, plan.chunk + 1, keys]
        lens = [n for n in edges if n <= keys] + list(rng.randint(0, keys + 1, 60))
        if d > 128:
            assert (plan.chunk, plan.splits) == (K.S256_PAIR_COST, K.S256_CTAS)
            for B in (1, 8, 66, 160):
                batch = [int(n) for n in rng.choice(lens, B)]
                for window in (0, 1, 96, 1000):
                    _check_s256_partition(plan, [(n - 1, int(n > 0)) for n in batch], nkv,
                                          group, W, ps, window)
            continue
        assert plan.chunk % K.TC_KT == 0
        assert plan.chunk >= K.DECODE_MIN_CHUNK
        assert 1 <= plan.splits <= K.SPLIT_MAX_SPLITS
        assert plan.splits * plan.chunk >= keys
        assert (plan.slabs - 1) * K.SPLIT_ROWS < group <= plan.slabs * K.SPLIT_ROWS
        assert K.split_scratch_shape(3, nkv, plan, d) == (
            3 * nkv * plan.slabs, plan.splits, K.SPLIT_ROWS, d + 2)
        for seq_len in lens:
            for window in (0, 1, 96, 1000):
                lo, hi, splits, nsp = _decode_splits(int(seq_len), window, W, ps, plan)
                assert nsp <= plan.splits
                assert (seq_len == 0) == (nsp == 0)
                # back to back from lo to hi, each 1..chunk keys: every key
                # of [lo, hi) once
                bounds = [lo] + [b for _, b in splits]
                assert [a for a, _ in splits] == bounds[:-1] and bounds[-1] == hi
                assert all(0 < b - a <= plan.chunk for a, b in splits)
                if seq_len:  # the keys the query sees lie in [lo, hi)
                    first = max(0, seq_len - window) if window else 0
                    assert lo <= first and seq_len <= hi


def test_decode_launch_plan_fills_the_card():
    """At least 2 CTAs with keys to read on every one of an H100's 132 SMs
    in chip_smoke.py's timed decode case (8 lanes of 2048, 1, 17, 300,
    1500, 0, 911 and 64 tokens; Llama-3-8B's 32 q / 8 kv heads, 16-token
    pages)."""
    lens = [2048, 1, 17, 300, 1500, 0, 911, 64]
    W = -(-max(lens) // 16)
    plan = K.decode_launch_plan(W, 16, 32, 8, 128)
    ctas = 8 * plan.slabs * sum(_decode_splits(n, 0, W, 16, plan)[3] for n in lens)
    assert ctas >= 2 * 132


@pytest.mark.parametrize("kernel", ["decode", "dense"])
def test_s256_plan_spreads_the_timed_gemma2_shapes_evenly(kernel):
    """On chip_smoke.py's timed Gemma-2-2B shapes (8 q / 4 kv heads,
    window 4,096, 16-token pages) every one of the 132 CTAs has tiles and
    none has more work (tiles plus S256_PAIR_COST per pair it holds) than
    its share of the cost axis and one pair's cost: the decode step of lanes 6,000, 1,
    17, 300, 4,500, 0, 911 and 64 (612 tiles), and the verify round
    k3_sp4_d256 (K + 1 = 4 at stride 4, lanes 3 and 5 without queries; 684
    tiles)."""
    if kernel == "decode":
        lens = [6000, 1, 17, 300, 4500, 0, 911, 64]
        lanes = [(n - 1, int(n > 0)) for n in lens]
        W = -(-max(lens) // 16)
        plan = K.decode_launch_plan(W, 16, 8, 4, 256)
        rows, tiles = 2, 612
    else:
        history = [310, 5000, 57, 0, 1999, 1500, 130, 4500]
        lanes = [(h, 0 if i in (3, 5) else 4) for i, h in enumerate(history)]
        W = -(-(max(history) + 4) // 16)
        plan = K.dense_launch_plan(W, 16, 4, 8, 4, 256)
        rows, tiles = 8, 684
    work = _check_s256_partition(plan, lanes, 4, rows, W, 16, 4096)
    _, N, C, ctas = _s256_partition(plan, lanes, 4, W, 16, 4096)
    assert N == tiles and all(ctas)
    assert max(work) <= -(-C // 132) + plan.chunk


@pytest.mark.parametrize("args,plan", [
    ((128, 16, 32, 8, 128), (128, 16, 1)), ((375, 16, 32, 8, 128), (192, 32, 1)),
    ((128, 16, 16, 8, 64), (128, 16, 1)), ((4096, 16, 32, 8, 128), (2048, 32, 1)),
    ((2, 8, 8, 8, 64), (128, 1, 1)),
])
def test_decode_plans_below_d256_unchanged(args, plan):
    """The d 64/128 decode plans (tc::split_kv_slab) keep their values:
    the d=256 CTA took nothing from them."""
    assert tuple(K.decode_launch_plan(*args)) == plan


@pytest.mark.parametrize("args,plan", [
    ((128, 16, 4, 32, 8, 128), (128, 16, 1)), ((313, 16, 4, 32, 8, 128), (192, 27, 1)),
    ((128, 16, 2, 16, 8, 64), (128, 16, 1)), ((4096, 16, 1, 32, 8, 128), (2048, 32, 1)),
])
def test_dense_plans_below_d256_unchanged(args, plan):
    """The d 64/128 dense plans keep their values."""
    assert tuple(K.dense_launch_plan(*args)) == plan


def test_profile_classes_the_decode_kernels():
    """scripts/torch_profile_mixed.py sums device time by kernel class
    from the kernels' symbol names: both decode kernels (the split-KV
    tensor-core one and the f32 one) count as decode attention, not as
    the dense kernel whose CTA they share."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_profile_mixed.py"
    spec = importlib.util.spec_from_file_location("torch_profile_mixed", path)
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    for name, cls in [
        ("void (anonymous namespace)::paged_decode_kernel_tc<__nv_bfloat16, 128>"
         "(__nv_bfloat16 const*, ...)", "decode_attention"),
        ("void (anonymous namespace)::paged_decode_kernel_tc<signed char, 64>"
         "(__nv_bfloat16 const*, ...)", "decode_attention"),
        ("void (anonymous namespace)::paged_decode_kernel<float, float, 128>"
         "(float const*, ...)", "decode_attention"),
        ("void (anonymous namespace)::dense_ragged_kernel_tc<__nv_bfloat16, 128>"
         "(__nv_bfloat16 const*, ...)", "dense_attention"),
        ("void (anonymous namespace)::ragged_kernel_tc<__nv_bfloat16, 128>"
         "(__nv_bfloat16 const*, ...)", "ragged_attention"),
        ("void (anonymous namespace)::w256::ragged_kernel_wgmma<signed char>"
         "(CUtensorMap_st, ...)", "ragged_attention"),
        ("void (anonymous namespace)::paged_decode_kernel_s256<signed char>"
         "(CUtensorMap_st, ...)", "decode_attention"),
        ("void (anonymous namespace)::dense_ragged_kernel_s256<__nv_bfloat16>"
         "(CUtensorMap_st, ...)", "dense_attention"),
    ]:
        assert prof._classify(name) == cls, name


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself (the dispatchers route CPU tensors)."""
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    case = {k: torch.from_numpy(v) for k, v in _ragged_case(CASES["mixed"]).items()}
    with pytest.raises(ValueError, match="CUDA"):
        K.ragged_paged_attention_cuda(**case)
    with pytest.raises(ValueError, match="CUDA"):
        K.paged_decode_attention_cuda(
            case["q"][:4], case["kv_pages"], case["page_table"],
            torch.ones(4, dtype=torch.int32))
    B = case["page_table"].shape[0]
    with pytest.raises(ValueError, match="CUDA"):
        K.dense_ragged_paged_attention_cuda(
            case["q"][: B * 2], case["kv_pages"], case["page_table"],
            case["q_len"].clamp(max=2), case["kv_start"], 2)
    # a head_dim no instance takes raises before any launch, on every
    # wrapper (on the card as here)
    case96 = {k: torch.from_numpy(v) for k, v in
              _ragged_case(CASES["mixed"], d=96).items()}
    with pytest.raises(ValueError, match="head_dim"):
        K.ragged_paged_attention_cuda(**case96)
    with pytest.raises(ValueError, match="head_dim"):
        K.paged_decode_attention_cuda(
            case96["q"][:4], case96["kv_pages"], case96["page_table"],
            torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="head_dim"):
        K.dense_ragged_paged_attention_cuda(
            case96["q"][: B * 2], case96["kv_pages"], case96["page_table"],
            case96["q_len"].clamp(max=2), case96["kv_start"], 2)
    assert set(K.LAUNCHES) == {
        f"{name}{suffix}" for suffix in ("", "_int8")
        for name in ("ragged_paged_attention", "paged_decode_attention",
                     "dense_ragged_paged_attention")}
    assert not any(K.LAUNCHES.values())
