"""Time a fresh process's engine start and first requests on the PyTorch
port (kserve_tpu_torch), with and without the start-up warm-up.

    python3 scripts/torch_first_request.py [--aot_warmup on|off] [--requests 3]
        [--build-dir DIR]

Llama-3.2-1B, bf16, seeded random weights, the watchdog on, greedy
requests of 16 tokens after a 39-token prompt.  The kernel library is
built (or reused) in `--build-dir` (default: a fresh directory under
build/, removed at the end, so the build is cold).  A sampler thread reads
every thread's Python stack every 20 ms during the first request; its
most frequent stacks say where that request's time goes.  One JSON line
on stdout: the start's seconds and startup phases, each request's
seconds, the engine's TTFT and decode-step telemetry, the watchdog's
state, and the top stacks.  Run it once per process: what it measures is
the first dispatch of a process.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import shutil
import sys
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _sample_stacks(samples: collections.Counter, stop: threading.Event) -> None:
    me = threading.get_ident()
    while not stop.is_set():
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            stack = traceback.extract_stack(frame)[::-1][:5]
            if names.get(tid) == "MainThread" and stack and "select" in stack[0].name:
                continue  # the event loop waiting
            samples[names.get(tid, "?") + " | " + " <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                for f in stack)] += 1
        time.sleep(0.02)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--aot_warmup", choices=("on", "off"), default="on")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--build-dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from kserve_tpu_torch.engine.sampling import SamplingParams
    from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import _build

    out = {"aot_warmup": args.aot_warmup, "import_s": time.perf_counter() - t0,
           "device": torch.cuda.get_device_name(0)}
    fresh = args.build_dir is None
    _build.BUILD_DIR = (Path(args.build_dir) if args.build_dir
                        else REPO / "build" / f"first_request_{os.getpid()}")
    samples: collections.Counter = collections.Counter()
    stop = threading.Event()

    async def run():
        mc = llama.LlamaConfig.llama3_1b()
        mc.dtype = "bfloat16"
        engine = LLMEngine(mc, EngineConfig(dtype="bfloat16", watchdog=True,
                                            aot_warmup=args.aot_warmup == "on"),
                           ByteTokenizer(mc.vocab_size), device="cuda")
        t = time.perf_counter()
        await engine.start()
        out["start_s"] = time.perf_counter() - t
        out["startup_phases"] = dict(engine.startup_phases)
        out["build"] = {k: v for k, v in _build.last_build.items() if k != "log"}
        params = SamplingParams(max_tokens=16, ignore_eos=True, temperature=0.0)
        sampler = threading.Thread(target=_sample_stacks, args=(samples, stop),
                                   daemon=True)
        sampler.start()
        try:
            for i in range(args.requests):
                t = time.perf_counter()
                toks = [o async for o in engine.generate(list(range(1 + i, 40 + i)), params)]
                out[f"request_{i}_s"] = time.perf_counter() - t
                if len(toks) != 16:
                    raise AssertionError(f"request {i}: {len(toks)} tokens")
                if i == 0:
                    stop.set()
                    sampler.join()
            snap = engine.telemetry_snapshot()
            out["telemetry"] = {k: snap[k] for k in ("ttft_s", "decode_step_s")}
            out["watchdog"] = engine.scheduler_state()["watchdog"]
        finally:
            stop.set()
            await engine.stop()

    try:
        asyncio.run(run())
    finally:
        if fresh:
            shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    out["first_request_top_stacks"] = samples.most_common(12)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
