"""Chip smoke test of the PyTorch/CUDA port (kserve_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  device   card name and power limit (nvidia-smi), torch/CUDA versions
  build    compiles csrc/*.cu into build/kserve_tpu_torch/ (nvcc, sm_90a)
  kernels  every CUDA kernel of the main path against its plain PyTorch
           version on the card, at Llama-3-8B's attention shape (and the
           decode kernel at head_dim 64, Llama-3.2-1B's), with timings
  serve    the port's OpenAI server (kserve_tpu_torch.runtimes.
           generative_server) with Llama-3-8B at full width and depth and
           seeded random weights: concurrent completions and one streamed
           chat over HTTP, launch counts of both kernels, and step-0 logits
           through the kernels against the plain versions
The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
nothing falls back to the CPU or to the plain versions.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

KERNEL_META = {
    "ragged_paged_attention": {
        "route": "cuda",
        "source": "kserve_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "kserve_tpu/ops/pallas_paged_attention.py:430",
    },
    "paged_decode_attention": {
        "route": "cuda",
        "source": "kserve_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "kserve_tpu/ops/pallas_paged_attention.py:147",
    },
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _require_package():
    if not os.path.isdir(os.path.join(REPO, "kserve_tpu_torch")):
        raise SystemExit(
            "chip_smoke.py must run from a checkout that holds kserve_tpu_torch/")
    if REPO not in sys.path:
        sys.path.insert(0, REPO)


# ---------------------------------------------------------------- device


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    print(smi, flush=True)
    emit(info)
    return info


def phase_build() -> None:
    from kserve_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    info = dict(_build.last_build)
    # nvcc's output (-Xptxas=-v: registers, shared memory, spills per kernel)
    log_path = _build.BUILD_DIR / "nvcc.log"
    log_path.write_text(info.pop("log", ""))
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_log": str(log_path), **info})


# ---------------------------------------------------------------- kernels


def _time_ms(torch, fn, iters: int = 25, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bf16_tol(ref) -> float:
    """Two bf16 ulps at the reference's largest magnitude: both sides do
    f32 math from the same bf16 inputs (the kernel in another summation
    order) and round the output to bf16 once."""
    mag = max(float(ref.abs().max()), 2.0 ** -20)
    return 2.0 * 2.0 ** (math.floor(math.log2(mag)) - 7)


def _make_cache(torch, gen, lanes_kv, nkv, d, ps, dtype):
    """Random pages holding `lanes_kv` tokens per lane, each lane on its own
    shuffled pages (page 0 stays the null page)."""
    need = [max(1, -(-n // ps)) for n in lanes_kv]
    W = max(need)
    P = 1 + sum(need)
    pages = torch.randn((P, 2, nkv, ps, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).tolist()
    table = torch.zeros((len(lanes_kv), W), dtype=torch.int32)
    used = 0
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
        used += n
    return pages, table.cuda()


RAGGED_CASES = {
    # lanes as (kv_start, q_len); the first mirrors a serve step that
    # carries the long prompt's first 1024-token chunk plus decode lanes
    "prefill_chunk": dict(lanes=[(0, 1024), (300, 1), (57, 1), (1200, 1)]),
    "mixed": dict(lanes=[(310, 1), (128, 40), (0, 200), (0, 0), (1500, 1)]),
    "pure_prefill": dict(lanes=[(0, 512), (0, 300), (0, 7)]),
    "pure_decode": dict(lanes=[(5, 1), (130, 1), (2000, 1), (777, 1),
                               (16, 1), (1023, 1), (64, 1), (0, 0)]),
    "chunked": dict(lanes=[(1024, 176), (512, 100), (0, 1)]),
    "window": dict(lanes=[(310, 1), (128, 40), (0, 200), (900, 64)],
                   window=96),
    "softcap_scale": dict(lanes=[(1024, 176), (512, 100), (0, 1)],
                          softcap=50.0, scale=0.0625),
    "f32": dict(lanes=[(40, 9), (0, 30), (100, 1)], dtype="float32"),
}

DECODE_CASES = {
    # 8 lanes at mixed lengths up to ~2k tokens, one inactive
    "d128": dict(d=128, lens=[2048, 1, 17, 300, 1500, 0, 911, 64]),
    "d64_llama3_1b": dict(d=64, lens=[2048, 1, 17, 300, 1500, 0, 911, 64]),
    "d128_softcap_window": dict(d=128, lens=[2000, 5, 600, 0, 33, 128, 1024, 7],
                                softcap=30.0, window=256, scale=0.07),
    "f32": dict(d=128, lens=[100, 0, 37, 512], dtype="float32"),
}


def _ragged_inputs(torch, gen, case, nq=32, nkv=8, d=128, ps=16):
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    lanes = case["lanes"]
    q_start, off = [], 0
    for _, qn in lanes:
        q_start.append(off)
        off += -(-qn // RAGGED_BQ) * RAGGED_BQ
    T = max(off, RAGGED_BQ)
    pages, table = _make_cache(torch, gen, [h + qn for h, qn in lanes],
                               nkv, d, ps, dtype)
    q = torch.randn((T, nq, d), generator=gen, device="cuda").to(dtype)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    return dict(
        q=q, kv_pages=pages, page_table=table, q_start=ints(q_start),
        q_len=ints([qn for _, qn in lanes]),
        kv_start=ints([h for h, _ in lanes]),
        logit_softcap=case.get("softcap", 0.0), scale=case.get("scale"),
        window=case.get("window", 0))


def _decode_inputs(torch, gen, case, nq=32, nkv=8, ps=16):
    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    d = case["d"]
    lens = case["lens"]
    pages, table = _make_cache(torch, gen, lens, nkv, d, ps, dtype)
    q = torch.randn((len(lens), nq, d), generator=gen, device="cuda").to(dtype)
    return dict(
        q=q, kv_pages=pages, page_table=table,
        seq_lens=torch.tensor(lens, dtype=torch.int32, device="cuda"),
        logit_softcap=case.get("softcap", 0.0), scale=case.get("scale"),
        window=case.get("window", 0))


def _ragged_work(case, nq=32, nkv=8, d=128, itemsize=2):
    """Bytes the function must move and flops it must do on this case."""
    lanes, window = case["lanes"], case.get("window", 0)
    kv_bytes = sum(h + qn for h, qn in lanes if qn) * nkv * d * 2 * itemsize
    q_bytes = sum(qn for _, qn in lanes) * nq * d * itemsize
    flops = 0
    for h, qn in lanes:
        for j in range(qn):
            keys = h + j + 1
            if window > 0:
                keys = min(keys, window)
            flops += 4 * keys * d * nq
    return kv_bytes + 2 * q_bytes, flops


def _decode_work(case, nq=32, nkv=8, itemsize=2):
    d, lens, window = case["d"], case["lens"], case.get("window", 0)
    live = [min(n, window) if window > 0 else n for n in lens]
    kv_bytes = sum(live) * nkv * d * 2 * itemsize
    q_bytes = sum(1 for n in lens if n) * nq * d * itemsize
    return kv_bytes + 2 * q_bytes, sum(4 * n * d * nq for n in live)


def _bound(nbytes: int, flops: int, flops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_ragged(torch, inp, case):
    """One F.scaled_dot_product_attention call over the gathered KV of
    every lane (padded batch, boolean causal/window mask): the library
    yardstick, timed only."""
    import torch.nn.functional as F

    from kserve_tpu_torch.ops.attention import _gather_history

    lanes, window = case["lanes"], case.get("window", 0)
    q = inp["q"]
    B = len(lanes)
    nq, d = q.shape[1], q.shape[2]
    k, v = _gather_history(inp["kv_pages"], inp["page_table"])
    L = k.shape[1]
    Lq = max(max(qn for _, qn in lanes), 1)
    qb = torch.zeros((B, nq, Lq, d), dtype=q.dtype, device="cuda")
    mask = torch.zeros((B, 1, Lq, L), dtype=torch.bool, device="cuda")
    kpos = torch.arange(L, device="cuda")
    starts = inp["q_start"].tolist()
    for i, (h, qn) in enumerate(lanes):
        if qn == 0:
            continue
        qb[i, :, :qn] = q[starts[i]:starts[i] + qn].transpose(0, 1)
        qpos = h + torch.arange(Lq, device="cuda")
        m = kpos[None, :] <= qpos[:, None]
        if window > 0:
            m = m & (qpos[:, None] - kpos[None, :] < window)
        mask[i, 0] = m
    kb = k.transpose(1, 2).contiguous()
    vb = v.transpose(1, 2).contiguous()
    scale = case.get("scale") or 1.0 / d ** 0.5
    return lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=scale, enable_gqa=True)


def _sdpa_decode(torch, inp, case):
    import torch.nn.functional as F

    from kserve_tpu_torch.ops.attention import _gather_history

    k, v = _gather_history(inp["kv_pages"], inp["page_table"])
    L = k.shape[1]
    lens = inp["seq_lens"]
    kpos = torch.arange(L, device="cuda")
    mask = (kpos[None, :] < lens[:, None])[:, None, None, :]
    qb = inp["q"][:, :, None, :]
    kb = k.transpose(1, 2).contiguous()
    vb = v.transpose(1, 2).contiguous()
    scale = case.get("scale") or 1.0 / inp["q"].shape[-1] ** 0.5
    return lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=scale, enable_gqa=True)


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version; returns the per-kernel
    summary rows (launches are filled in by the serve phase)."""
    from kserve_tpu_torch.ops import attention as A
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    rows = {}
    specs = [
        ("ragged_paged_attention", RAGGED_CASES, _ragged_inputs,
         K.ragged_paged_attention_cuda, A.ragged_paged_attention_plain,
         ("prefill_chunk",)),
        # the first timed case fills the summary row; d=64 is the port of
        # _packed_decode_kernel, timed for its own PERF.md row
        ("paged_decode_attention", DECODE_CASES, _decode_inputs,
         K.paged_decode_attention_cuda, A.paged_attention_plain,
         ("d128", "d64_llama3_1b")),
    ]
    for name, cases, make, kernel, plain, timed in specs:
        worst = 0.0
        for case_name, case in cases.items():
            inp = make(torch, gen, case)
            got = kernel(**inp)
            ref = plain(**inp)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = (1e-4 if case.get("dtype") == "float32"
                   else _bf16_tol(ref.float()))
            ok = err <= tol and bool(torch.isfinite(got).all())
            emit({"phase": "kernels", "kernel": name, "case": case_name,
                  "dtype": str(inp["q"].dtype).replace("torch.", ""),
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"{name}/{case_name}: kernel disagrees with the plain "
                    f"version (max_abs_err {err} > tol {tol})")
            worst = max(worst, err)
            if case_name not in timed:
                continue
            ms = _time_ms(torch, lambda: kernel(**inp))
            plain_ms = _time_ms(torch, lambda: plain(**inp), iters=20,
                                warmup=1)
            lib = (_sdpa_ragged if name.startswith("ragged")
                   else _sdpa_decode)(torch, inp, case)
            library_ms = _time_ms(torch, lib)
            nbytes, flops = (_ragged_work(case) if name.startswith("ragged")
                             else _decode_work(case))
            bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
            if case_name == timed[0]:
                rows[name] = {
                    "name": name, **KERNEL_META[name], "launches": 0,
                    "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                }
            emit({"phase": "kernels", "kernel": name, "timed_case": case_name,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "bytes": nbytes, "flops": flops})
            del inp, got, ref
            torch.cuda.empty_cache()
        rows[name]["max_abs_err"] = worst
    return rows


# ---------------------------------------------------------------- main


def main() -> int:
    _require_package()
    import torch

    info = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    serve_counts = phase_serve(torch)
    for name, n in serve_counts.items():
        rows[name]["launches"] = n
    missing = [n for n in rows if serve_counts.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"main path never launched kernel(s) {missing}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}),
        flush=True)
    return 0


# ---------------------------------------------------------------- serve

# every other completion is greedy; this one runs the device sampler
# (temperature, top-k, top-p, min-p and a per-request seed)
SAMPLED = {"sampled": {"temperature": 0.8, "top_k": 50, "top_p": 0.9,
                       "min_p": 0.01, "seed": 7}}
SERVE_ARGS = ["--model_name=llama3-8b", "--model_config=llama3-8b",
              "--random_weights", "--http_port=0", "--device=cuda"]
# f32 logits through 32 layers, kernel vs plain attention: the two sum in
# another order only (~1e-7 relative per layer)
F32_LOGITS_REL_TOL = 1e-3
# bf16 logits: bf16 rounding of activations in every layer dominates; the
# kernel path may stray from the plain bf16 path by at most this multiple
# of the plain bf16 path's own distance from f32
BF16_NOISE_FACTOR = 2.0


def _http(port: int, method: str, path: str, body=None, timeout=600):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream_chat(port: int, body: dict, t_send: list):
    """POST a streamed chat; returns (status, events, ttft_s)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        t_send.append(t0)
        conn.request("POST", "/openai/v1/chat/completions",
                     body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        events, ttft = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            events.append(line[len("data: "):])
            if ttft is None and len(events) == 2:  # first token's chunk
                ttft = time.perf_counter() - t0
        return resp.status, events, ttft
    finally:
        conn.close()


def _logits_check(torch, engine) -> dict:
    """Step-0 logits of one packed plan (then one decode step) through the
    CUDA kernels and through the plain versions, on the served weights:

    - float32 (an f32 copy of the weights): kernels and plain versions sum
      in another order only; they must agree within F32_LOGITS_REL_TOL of
      the largest |logit|.
    - bfloat16 (the served path): the plain bf16 path's distance from the
      plain f32 path is bf16's own noise on this model; the kernel path
      may differ from the plain bf16 path by at most BF16_NOISE_FACTOR
      times that noise.
    """
    import dataclasses

    from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import attention as A
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    mc16 = engine.model_config
    mc32 = dataclasses.replace(mc16, dtype="float32")
    ps = engine.config.page_size
    lens = [40, 100, 7]
    W = -(-(max(lens) + 1) // ps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    tokens, seq, pos, q_start, last = [], [], [], [], []
    for i, n in enumerate(lens):
        q_start.append(len(tokens))
        pad = -(-n // RAGGED_BQ) * RAGGED_BQ - n
        tokens += torch.randint(0, mc16.vocab_size, (n,), generator=gen,
                                device="cuda").tolist() + [0] * pad
        seq += [i] * n + [-1] * pad
        pos += list(range(n)) + [0] * pad
        last.append(q_start[-1] + n - 1)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    table = ints([[1 + i * W + j for j in range(W)] for i in range(len(lens))])
    active = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    params32 = {
        k: ([{n: (t.float() if torch.is_tensor(t) else t) for n, t in layer.items()}
             for layer in v] if k == "layers" else v.float())
        for k, v in engine.params.items()}

    def run(params, mc, plain: bool, next_tokens=None):
        pages = init_kv_pages(KVCacheConfig(
            n_layers=mc.n_layers, n_kv_heads=mc.n_kv_heads,
            head_dim=mc.head_dim, page_size=ps,
            num_pages=1 + len(lens) * W, dtype=mc.dtype), "cuda")
        step0, _ = llama.forward_ragged(
            params, mc, ints(tokens), ints(seq), ints(pos), ints(q_start),
            ints(lens), ints([0] * len(lens)), pages, table, ps, ints(last),
            attention_fn=A.ragged_paged_attention_plain if plain else None)
        if next_tokens is None:
            next_tokens = torch.argmax(step0, dim=-1).to(torch.int32)
        step1, _ = llama.decode_step(
            params, mc, next_tokens, ints(lens), pages, table, active, ps,
            attention_fn=A.paged_attention_plain if plain else None)
        return step0, step1, next_tokens

    with torch.inference_mode():
        p32 = run(params32, mc32, plain=True)
        k32 = run(params32, mc32, plain=False, next_tokens=p32[2])
        del params32
        p16 = run(engine.params, mc16, plain=True, next_tokens=p32[2])
        k16 = run(engine.params, mc16, plain=False, next_tokens=p32[2])
    torch.cuda.empty_cache()
    out = {}
    for i, name in enumerate(("forward_ragged", "decode_step")):
        scale = float(p32[i].abs().max())
        err32 = float((k32[i] - p32[i]).abs().max())
        noise16 = float((p16[i] - p32[i]).abs().max())
        err16 = float((k16[i] - p16[i]).abs().max())
        row = {
            "f32_max_abs_err": err32, "f32_tol": F32_LOGITS_REL_TOL * scale,
            "bf16_max_abs_err": err16, "bf16_noise": noise16,
            "bf16_tol": BF16_NOISE_FACTOR * noise16, "max_abs_logit": scale,
            "bf16_argmax_agree": float(
                (k16[i].argmax(-1) == p16[i].argmax(-1)).float().mean()),
        }
        out[name] = row
        finite = all(bool(torch.isfinite(t[i]).all()) for t in (k32, k16))
        if not (finite and err32 <= row["f32_tol"] and err16 <= row["bf16_tol"]):
            raise AssertionError(
                f"{name} logits through the kernels disagree with the plain "
                f"versions: {row}")
    return out


def phase_serve(torch) -> dict:
    """The port's server at Llama-3-8B full width and depth: returns the
    kernel launch counts of the served requests."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.ops import paged_attention_cuda as K
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    args = build_arg_parser().parse_args(SERVE_ARGS)
    model = build_model(args)
    server = ModelServer(http_port=0, host="127.0.0.1")
    t0 = time.perf_counter()
    errors = []

    def run():
        try:
            server.start([model])
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            errors.append(e)
            server.listening.set()

    thread = threading.Thread(target=run, name="model-server", daemon=True)
    thread.start()
    server.listening.wait(900)
    if errors:
        raise errors[0]
    if not server.listening.is_set():
        raise TimeoutError("server did not start listening")
    startup_s = time.perf_counter() - t0
    port = server.port
    status, _ = _http(port, "GET", "/v2/health/ready")
    assert status == 200, f"ready probe answered {status}"
    emit({"phase": "serve", "event": "ready", "startup_s": startup_s,
          "engine_build_s": model.engine.startup_seconds,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})

    base = "The port of a serving stack from one accelerator to another "
    prompts = [
        ("short", "Tell me about the sea.", 32),
        ("medium", base * 6, 48),
        ("long", (base * 40)[:1200], 64),  # > the 1024-token prefill bucket
        ("repeat_a", "Write a haiku about paged attention.", 40),
        ("repeat_b", "Write a haiku about paged attention.", 40),
        ("sampled", "Pick a random word.", 32),
    ]
    chat = {"model": "llama3-8b", "stream": True, "max_tokens": 48,
            "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "user", "content": "Say something long."}]}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_send: list = []
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts) + 1) as pool:
        futs = {
            name: pool.submit(_http, port, "POST", "/openai/v1/completions", {
                "model": "llama3-8b", "prompt": text, "max_tokens": n,
                "ignore_eos": True, **SAMPLED.get(name, {"temperature": 0})})
            for name, text, n in prompts
        }
        chat_fut = pool.submit(_stream_chat, port, chat, t_send)
        results = {name: f.result() for name, f in futs.items()}
        chat_status, events, ttft = chat_fut.result()
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    generated = 0
    texts = {}
    for name, text, n in prompts:
        status, body = results[name]
        if status != 200:
            raise AssertionError(f"completion {name} answered {status}: {body[:300]!r}")
        resp = json.loads(body)
        got = resp["usage"]["completion_tokens"]
        if got != n or resp["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"completion {name}: {got} tokens, wanted {n}")
        generated += got
        texts[name] = resp["choices"][0]["text"]
    if texts["repeat_a"] != texts["repeat_b"]:
        raise AssertionError("a repeated greedy prompt gave another text")
    if chat_status != 200 or events[-1] != "[DONE]":
        raise AssertionError(f"streamed chat answered {chat_status}, last event "
                             f"{events[-1] if events else None!r}")
    token_events = [json.loads(e) for e in events[1:-1]]
    if len(token_events) != chat["max_tokens"]:
        raise AssertionError(f"streamed chat gave {len(token_events)} token events")
    generated += len(token_events)

    logits = _logits_check(torch, model.engine)
    summary = {
        "phase": "serve", "model": "llama3-8b (random weights, seed 1)",
        "requests": len(prompts) + 1, "tokens_generated": generated,
        "wall_s": wall, "tok_per_s": generated / wall, "chat_ttft_s": ttft,
        "engine_steps": model.engine.steps,
        "max_memory_allocated_gb": peak_gb,
        "launches": counts, "logits_check": logits,
        "prompt_tokens": {name: len(model.tokenizer.encode(text))
                          for name, text, _ in prompts},
    }
    emit(summary)
    server.request_stop()
    thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    return counts


if __name__ == "__main__":
    sys.exit(main())
