"""Profile one embeddings request of the port's encoder runtime in process
on the card: its wall, kernel launches, device time by class and the
device's idle share, beside the least time the card could take.

    python3 scripts/torch_profile_encoder.py [--iters 20]

The model is chip_smoke.py's encoder phase's: BERT-base (768 wide, 12
layers, 12 heads, vocabulary 30,522) from seeded random weights, f32, TF32
off.  Each request is `TorchEncoderModel.create_embedding` on a batch of
1, 8 or 32 texts of ~16, ~128 or ~500 bytes (the byte tokenizer: buckets
16, 128 and 512), without HTTP: tokenization, the upload, the encoder,
the mean pool and norm, the copy back and the response objects.  The wall
is the median of `--iters` warm requests, and the encoder call alone is
timed with CUDA events; then one request runs under
torch.profiler and its CUDA kernels are classed by the operator that
launched them: attention (the two einsums and the softmax), GEMM (the
linears' mm / addmm), copy (host <-> device) and elementwise (the rest:
gathers, the mask bias, scaling, GELU, layer norms, residual adds, the
pool).  The bound is max(bytes / 3.35 TB/s, flops / 67 TFLOP/s, the H100
SXM's f32 rate outside the tensor cores): each weight the request uses
read once, the ids in and the vectors out once, and 2 flops per
multiply-add of the linears and the attention products.  One JSON line
per cell, then one with the card's name and power limit as nvidia-smi
reports them.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _classify(ev) -> str:
    """The class of the kernels an operator event launched."""
    names = []
    node = ev
    while node is not None:
        names.append(node.name)
        node = node.cpu_parent
    if any(n == "aten::einsum" or "softmax" in n for n in names):
        return "attention"
    if ev.name in ("aten::mm", "aten::addmm", "aten::bmm"):
        return "gemm"
    if ev.name in ("aten::copy_", "aten::_to_copy", "aten::to"):
        return "copy"
    return "elementwise"


def _bound(cfg, B: int, T: int) -> dict:
    """The least time for one embeddings request of B x T (bucket T)."""
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    linear = L * (4 * h * h + 2 * h * f)  # multiply-adds per token
    flops = 2 * B * T * linear + L * 2 * 2 * B * T * T * h
    weights = L * (4 * h * h + 2 * h * f + 4 * h + f + h + 4 * h) + 2 * h
    # the rows gathered: a word row per position (padding too), T position
    # rows, the token-type rows; ids and mask in (int64), vectors out
    rows = B * T + T + cfg.type_vocab_size
    nbytes = 4 * (weights + rows * h) + 8 * 2 * B * T + 4 * B * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": nbytes}


async def _profile(torch, model, request, iters: int) -> dict:
    async def call():
        t0 = time.perf_counter()
        await model.create_embedding(request)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        await call()
    walls = [await call() for _ in range(iters)]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall = await call()
    by_class = {"gemm": 0.0, "attention": 0.0, "elementwise": 0.0, "copy": 0.0}
    launches = {k: 0 for k in by_class}
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None)
        if not kernels:
            continue
        cls = _classify(ev)
        for k in kernels:
            if k.name.startswith(("Memcpy", "Memset")):
                by_class["copy"] += k.duration / 1e3
                launches["copy"] += 1
            else:
                by_class[cls] += k.duration / 1e3
                launches[cls] += 1
    busy = sum(by_class.values())
    return {"wall_ms_p50": statistics.median(walls), "wall_ms_min": min(walls),
            "profiled_wall_ms": prof_wall, "device_ms": by_class,
            "device_busy_ms": busy, "launches": launches,
            "kernel_launches": sum(v for k, v in launches.items() if k != "copy"),
            "device_idle_share": max(0.0, 1 - busy / prof_wall)}


def _encode_events_ms(torch, model, ids, mask, iters: int) -> float:
    """The median of `iters` `bert.embed` calls on tensors already on the
    card, timed with CUDA events (as enqueued onto an idle device): the
    device time without the profiler."""
    from kserve_tpu_torch.models import bert

    i, m = torch.tensor(ids).cuda(), torch.tensor(mask).cuda()
    out = []
    with torch.inference_mode():
        for _ in range(iters + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            bert.embed(model.params, model.config, i, m)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
    return statistics.median(out[2:])


async def _run(torch, iters: int) -> None:
    import chip_smoke as cs
    from kserve_tpu_torch.models import bert
    from kserve_tpu_torch.protocol.openai.types import EmbeddingRequest
    from kserve_tpu_torch.runtimes.encoder_server import TorchEncoderModel

    cfg = bert.BertConfig()
    model = TorchEncoderModel("bert", config=cfg, random_weights=True, device="cuda")
    model.load()
    rng = random.Random(0)
    for B in cs.ENCODER_BATCHES:
        for label, lo, hi in cs.ENCODER_LENGTHS:
            texts = [cs._encoder_text(rng, lo, hi) for _ in range(B)]
            ids, mask, _ = model._batch_encode(texts)
            request = EmbeddingRequest(model="bert", input=texts, encoding_format="base64")
            row = await _profile(torch, model, request, iters)
            row["encode_ms_events"] = _encode_events_ms(torch, model, ids, mask, iters)
            bound = _bound(cfg, B, ids.shape[1])
            row["bound_share_of_device_busy"] = (
                bound["bound_ms"] / row["device_busy_ms"] if row["device_busy_ms"] else None)
            row["bound_share_of_wall"] = bound["bound_ms"] / row["wall_ms_p50"]
            print(json.dumps({"batch": B, "length": label, "bucket": ids.shape[1],
                              "tokens": int(mask.sum()), **bound, **row}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    asyncio.run(_run(torch, args.iters))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
