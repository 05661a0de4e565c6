"""Profile one `mixed` engine step of the PyTorch port (kserve_tpu_torch)
on one GPU: where a step's time goes at Llama-3-8B shape, or with --moe at
Mixtral-8x7B's.

    python3 scripts/torch_profile_mixed.py [--batch 8] [--context 512] [--spec_k 3]
        [--kv_quant int8] [--weight_quant int8] [--lora N] [--moe]
        [--plans decode,prefill_mix,spec_greedy,spec_sampled] [--package-root DIR]

Two plans run through kserve_tpu_torch.engine.compiled.make_mixed with
seeded random weights (greedy sampling, steps_per_sync decode steps):
  decode       every lane decodes one token at `--context` cached tokens
  prefill_mix  lane 0 carries a `--chunk`-token prompt chunk, the others
               decode as above
and two through make_mixed_decode (speculative decoding, `--spec_k`
drafts per lane per round, steps_per_sync rounds, every lane at
`--context` cached tokens, an empty draft table):
  spec_greedy   every lane greedy
  spec_sampled  one lane seeded and sampled (temperature, top-k/p, min-p),
                the others greedy: the sampler's sort and threefry run
With `--kv_quant int8` the cache is (int8 pages, f32 row scales), as the
engine keeps it with --kv_quant int8, and attention runs the kernels'
int8 instances.  With `--weight_quant int8` the weights are int8 with
f32 per-channel scales (drawn int8, as the engine's --weight_quant int8
draws them).  With `--lora N` every layer carries N random rank-16 LoRA
adapters on all seven projections (stacked as the engine stacks PEFT
adapters) and lane i runs adapter i mod (N + 1) - 1 (-1: the base
model), so base and adapter lanes share each dispatch.  With `--moe` the
model is Mixtral-8x7B at full width and 16 of its 32 layers (8 experts,
top 2, the dense-masked MoE MLP of models/moe.py; decode and prefill_mix
by default), and the profiled run also splits out the device time of the
MoE MLP's four parts (router product, top-k, expert products, combine)
under record_function ranges.  `--plans` picks plans.  For each: wall time of the step (host clock around the
call and the token fetch), the host's enqueue time, and from
torch.profiler the device time by kernel class and the device idle share
(1 - busy / wall), with the launches of each kernel by name.  JSON lines
on stdout; needs CUDA.  --package-root DIR profiles the kserve_tpu_torch
of another tree (e.g. an unpacked `git archive` of another commit) with
this script's plans and counting.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSES = (
    ("dense_attention", ("dense_ragged_kernel",)),
    ("ragged_attention", ("ragged_kernel",)),
    ("decode_attention", ("paged_decode_kernel",)),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")),
    ("kv_scatter_gather", ("index", "scatter", "gather")),
    ("sort", ("sort", "radix")),
)


def _classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_other"


def lora_stacks(mc, n: int, rank: int = 16, seed: int = 3):
    """n random rank-`rank` adapters on all seven projections of every
    layer of `mc`, as models/lora.stack_adapters lays them out on the card:
    {proj: {"A": [n, in, r], "B": [n, r, out]}} in the model dtype."""
    h, f = mc.hidden_size, mc.intermediate_size
    q, kv = mc.n_heads * mc.head_dim, mc.n_kv_heads * mc.head_dim
    dims = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
            "w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape):
        return (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
            mc.torch_dtype)

    return [{proj: {"A": rand(n, d_in, rank), "B": rand(n, rank, d_out)}
             for proj, (d_in, d_out) in dims.items()}
            for _ in range(mc.n_layers)]


# the MoE MLP's parts (models/moe.py), each under a record_function range
# of the same name in the profiled run of --moe
MOE_PARTS = {"router": "router_logits", "top_k": "combine_weights",
             "experts": "expert_outputs", "combine": "combine"}


class moe_ranges:
    """Inside the block, each MoE part runs under a record_function range
    named "moe.<part>" (models/moe.py's functions wrapped for the block)."""

    def __enter__(self):
        from kserve_tpu_torch.models import moe

        self._moe, self._plain = moe, {fn: getattr(moe, fn) for fn in MOE_PARTS.values()}
        for part, fn in MOE_PARTS.items():
            setattr(moe, fn, self._wrap(f"moe.{part}", self._plain[fn]))

    @staticmethod
    def _wrap(name, fn):
        def ranged(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return ranged

    def __exit__(self, *exc):
        for fn, plain in self._plain.items():
            setattr(self._moe, fn, plain)


def profile_step(run, steps: int, iters: int = 3, moe: bool = False) -> dict:
    """Time `run` (a dispatch returning device tensors) warm: the wall of
    its best of `iters` runs to the fetched tokens and the host's enqueue,
    then one run under torch.profiler: device time by kernel class, the
    device idle share (1 - busy / wall) and the launches of each kernel;
    with `moe`, that run's MoE parts under moe_ranges and their kernels'
    device time."""
    def step():
        t0 = time.perf_counter()
        out = run()
        t1 = time.perf_counter()
        for t in out:
            t.cpu()
        return t1 - t0, time.perf_counter() - t0

    with torch.inference_mode():
        step()  # warm-up: cuBLAS heuristics, kernel library build
        runs = [step() for _ in range(iters)]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            if moe:
                with moe_ranges():
                    prof_host, prof_wall = step()
            else:
                prof_host, prof_wall = step()
    by_class, top, launches, by_name, moe_ms = {}, [], 0, {}, {}
    for ev in prof.key_averages():
        if ev.key.startswith("moe."):
            # a range: its CPU side sums the device time of the kernels
            # launched inside it (its GPU-side twin spans idle gaps too)
            if ev.device_type == torch.autograd.DeviceType.CPU:
                moe_ms[ev.key[4:]] = ev.device_time_total / 1e3
            continue
        # kernels only: CPU-side ops (aten::mm, ...) also report the
        # device time of the kernels they launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        cls = _classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        launches += ev.count
        by_name[ev.key] = by_name.get(ev.key, 0) + ev.count
        top.append((dev_us / 1e3, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    wall = min(r[1] for r in runs) * 1e3
    extra = {"moe_device_ms": moe_ms} if moe else {}
    return {
        "wall_ms": wall, "wall_ms_per_step": wall / steps,
        "host_enqueue_ms": min(r[0] for r in runs) * 1e3,
        "profiled_wall_ms": prof_wall * 1e3,
        "device_busy_ms": busy, "kernel_launches": launches,
        "launches_per_step": launches / steps,
        "device_idle_share": max(0.0, 1 - busy / (prof_wall * 1e3)),
        "device_ms_by_class": by_class,
        "top_kernels": [{"ms": t, "calls": c, "name": n} for t, c, n in top[:12]],
        "launches_by_kernel": by_name,
        **extra,
    }


def _plan(lanes, B, W, ps, bq):
    """lanes {i: (kv_start, n_tokens)} packed at multiples of bq tokens;
    every lane joins the decode loop."""
    tok, seq, pos = [], [], []
    z = lambda: np.zeros(B, np.int32)  # noqa: E731
    q_start, q_len, kv_start, last = z(), z(), z(), z()
    scan_pos0, step0_emits, capacity = z(), z(), z()
    for i, (h, n) in sorted(lanes.items()):
        q_start[i], q_len[i], kv_start[i] = len(tok), n, h
        last[i] = len(tok) + n - 1
        pad = -n % bq
        tok += [1] * n + [0] * pad
        seq += [i] * n + [-1] * pad
        pos += list(range(h, h + n)) + [0] * pad
        scan_pos0[i], step0_emits[i], capacity[i] = h + n, 1, W * ps
    T = max(len(tok), bq)
    arr = lambda x: np.asarray(x + [0] * (T - len(x)), np.int32)  # noqa: E731
    seq += [-1] * (T - len(seq))
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    return (arr(tok), np.asarray(seq, np.int32), arr(pos), q_start, q_len,
            kv_start, last, table, np.ones(B, bool), np.full(B, -1, np.int32),
            scan_pos0, step0_emits, capacity, np.zeros(B, np.int32))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--context", type=int, default=512)
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--steps_per_sync", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--spec_k", type=int, default=3)
    p.add_argument("--kv_quant", default="none", choices=("none", "int8"))
    p.add_argument("--weight_quant", default="none", choices=("none", "int8"))
    p.add_argument("--lora", type=int, default=0,
                   help="random rank-16 adapters on every projection")
    p.add_argument("--moe", action="store_true",
                   help="Mixtral-8x7B's width at 16 layers (8 experts, top 2)")
    p.add_argument("--plans", default=None,
                   help="default: decode,prefill_mix,spec_greedy,spec_sampled "
                        "(with --moe: decode,prefill_mix)")
    p.add_argument("--package-root", default=REPO,
                   help="import kserve_tpu_torch from this directory")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.moe and (args.lora or args.weight_quant != "none"):
        # the engine refuses both over MoE layers, as the JAX engine does
        raise SystemExit("--moe takes neither --lora nor --weight_quant")
    if args.plans is None:
        args.plans = ("decode,prefill_mix" if args.moe
                      else "decode,prefill_mix,spec_greedy,spec_sampled")
    sys.path.insert(0, os.path.abspath(args.package_root))
    from kserve_tpu_torch.engine.compiled import make_mixed, make_mixed_decode
    from kserve_tpu_torch.engine.kvcache import (
        KVCacheConfig,
        init_kv_pages,
        init_kv_scales,
    )
    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState
    from kserve_tpu_torch.engine.types import EngineConfig
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "package": os.path.dirname(llama.__file__)}), flush=True)

    if args.moe:
        # Mixtral-8x7B's published widths, 16 of its 32 layers
        mc = llama.LlamaConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            n_layers=16, n_heads=32, n_kv_heads=8, rope_theta=1e6,
            max_position_embeddings=32768, n_experts=8, n_experts_per_tok=2)
    else:
        mc = llama.LlamaConfig.llama3_8b()
    ps, B = 16, args.batch
    max_advance = args.steps_per_sync * (args.spec_k + 1)
    W = -(-(max(args.context, args.chunk) + max_advance + 1) // ps)
    ec = EngineConfig(max_batch_size=B, page_size=ps, steps_per_sync=args.steps_per_sync)
    params = llama.init_params(mc, seed=1, device="cuda",
                               **({"weight_quant": args.weight_quant}
                                  if args.weight_quant != "none" else {}))
    adapters = {}
    if args.lora:
        params["layers"] = [dict(layer, lora=stack) for layer, stack in zip(
            params["layers"], lora_stacks(mc, args.lora))]
        adapters = {"adapter_ids": np.asarray(
            [i % (args.lora + 1) - 1 for i in range(B)], np.int32)}
    kv_config = KVCacheConfig(
        n_layers=mc.n_layers, n_kv_heads=mc.n_kv_heads, head_dim=mc.head_dim,
        page_size=ps, num_pages=1 + B * W,
        dtype="int8" if args.kv_quant == "int8" else mc.dtype)
    pages = init_kv_pages(kv_config, "cuda")
    if args.kv_quant == "int8":
        pages = list(zip(pages, init_kv_scales(kv_config, "cuda")))
    mixed = make_mixed(mc, ec)
    mixed_decode = make_mixed_decode(mc, ec, args.spec_k, RAGGED_BQ)
    greedy = SamplingState.from_params([SamplingParams(temperature=0.0)] * B, "cuda")
    sampled = SamplingState.from_params(
        [SamplingParams(temperature=0.8, top_k=50, top_p=0.9, min_p=0.01, seed=7)]
        + [SamplingParams(temperature=0.0)] * (B - 1), "cuda")
    gen = torch.Generator(device="cuda")
    table = (1 + np.arange(B * W, dtype=np.int32)).reshape(B, W)
    plans = {
        "decode": {i: (args.context, 1) for i in range(B)},
        "prefill_mix": {0: (0, args.chunk),
                        **{i: (args.context, 1) for i in range(1, B)}},
        "spec_greedy": greedy,
        "spec_sampled": sampled,
    }
    wanted = args.plans.split(",")
    for name, lanes in plans.items():
        if name not in wanted:
            continue
        if name.startswith("spec"):
            state = lanes
            drafts = torch.full((B + 1, mc.vocab_size), -1, dtype=torch.int32,
                                device="cuda")

            def run():
                # [rounds, B, K+1] tokens and [rounds, B] emit counts
                return mixed_decode(
                    params, np.ones(B, np.int32), np.full(B, args.context, np.int32),
                    pages, table, np.ones(B, bool), np.full(B, W * ps, np.int32),
                    np.zeros(B, np.int32), drafts, state, gen, **adapters)[:2]
        else:
            plan = _plan(lanes, B, W, ps, RAGGED_BQ)
            state = greedy

            def run():
                return mixed(params, *plan[:7], pages, *plan[7:], state, gen,
                             **adapters)[:1]

        print(json.dumps({
            "plan": name, "moe": args.moe, "n_layers": mc.n_layers,
            "kv_quant": args.kv_quant,
            "weight_quant": args.weight_quant, "lora_adapters": args.lora,
            "batch": B, "context": args.context,
            "chunk": args.chunk if name == "prefill_mix" else 0,
            "spec_k": args.spec_k if name.startswith("spec") else None,
            "steps_per_sync": args.steps_per_sync,
            **profile_step(run, args.steps_per_sync, args.iters, moe=args.moe),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
