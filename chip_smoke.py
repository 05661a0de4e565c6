"""Chip smoke test of the PyTorch/CUDA port (kserve_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--package-root DIR]

Phases, each printing JSON lines:
  device   card name and power limit (nvidia-smi), torch/CUDA versions
  build    compiles csrc/*.cu into build/kserve_tpu_torch/ (nvcc, sm_90a)
  kernels  every CUDA kernel instance against its plain PyTorch version on
           the card, at Llama-3-8B's attention shape (and at head_dim 64,
           Llama-3.2-1B's, and 256, Gemma-2-2B's), over bf16/f32 pages and
           over int8 pages with f32 row scales, timed warm and with a cold
           L2, each as the host enqueues it (ms) and on the device alone
           (device_ms), with the host's own time per call (host_ms),
           beside SDPA and (the softcapped d=256 rows) a compiled
           flex_attention; a head_dim no instance takes must raise
  serve    the port's OpenAI server (kserve_tpu_torch.runtimes.
           generative_server) with Llama-3-8B at full width and depth and
           seeded random weights: concurrent completions and one streamed
           chat over HTTP, launch counts of the ragged and decode kernels,
           step-0 logits through the kernels against the plain versions,
           every attention call paired with its plain version in f32
           and in bf16, and one decode step under CUDA sync debugging;
           then GET /admin/telemetry and /metrics: every request in the
           engine's TTFT window and histogram, the decode-token counter
           moved by the tokens served less each request's first, TTFT /
           ITL / queue-wait percentiles from the engine's clock
  d64      the same server with --model_config=llama3-1b (head_dim 64, full
           depth): the served path of the decode kernel's d=64 instance
  checkpoint  Llama-3.2-1B at full width and depth in bf16 served from a
           checkpoint (--model_dir, no --random_weights): its seeded
           weights written as two safetensors shards by the port's
           writer, an HF config.json, a byte-level BPE tokenizer.json in
           Llama-3's form and a tokenizer_config.json with a chat template;
           every loaded tensor bit-equal to the written one, greedy
           completions equal to a --random_weights server's over the same
           directory, the chat prompt through the default template without
           jinja2 (logged once), the ragged and d=64 decode kernels
           launched; load GB/s, peak host staging and the tokenizer's
           encode rate; then the same checkpoint with --weight_quant int8
           (quantized on the host as it streams in): every int8 leaf and
           scale bit-equal to quantize_params of the written weights, and
           greedy texts equal to a server given those

  spec     the server with --spec_decode_k=3 (speculative decoding):
           concurrent greedy completions and a seeded sampled one, the
           dense kernel's launch count and the draft statistics, one verify
           round's logits through the kernels against the plain versions,
           and greedy streams spec-on against spec-off in float32 at full
           width and 2 layers
  kvq      the int8 KV cache (--kv_quant=int8) at Llama-3-8B full width and
           depth: the serve phase's requests, then --spec_decode_k=3 with
           the spec phase's, every attention through the kernels' int8
           instances, logits through them against the plain int8 versions,
           and a no-sync check of two chained int8 spec dispatches
  gemma2   Gemma-2-2B (head_dim 256, softcap 50, 4,096-token windows) at
           full width and depth with --spec_decode_k=3, over bf16 and then
           int8 pages, one prompt past the window: the served path of
           every d=256 instance, with the serve phase's gates
  pressure Llama-3-8B on 33 KV pages for six completions that need 54:
           the engine must preempt and re-prefill, and every completion
           must reach its max_tokens (cold cached prompt pages go first)
  legacy   the legacy programs at Llama-3-8B full width and depth: (a) the
           serve phase's engine with completions and a streamed chat that
           ask for logprobs and sampling penalties, which run on the legacy
           route per iteration beside plain ones on `mixed`; (b) the whole
           engine on the legacy route, --kv_quant=int8 --max_batch_size=160
           (above what one ragged buffer holds), 160 concurrent
           completions, one prompt chunked; logprob gates, launch counts,
           logits of the prefill and decode programs' model calls, a no-sync
           decode_penalized_lp dispatch, and wall and device time per
           dispatch
  prefix   the prefix cache at Llama-3-8B full width and depth, bf16 and
           then --kv_quant=int8: a 1,040-token shared prefix (65 pages)
           cached by one request, then six completions with 20-200-token
           tails and a streamed chat on it, concurrently (>= 6 x 65 page
           hits, the ragged kernel over the cached pages); TTFT of a
           1,201-token prompt cold and with 1,184 tokens cached; the
           first-token logits of a hit prefill against a cold prefill,
           every attention call of the hit chunk paired with its plain
           version
  tiers    the KV tiers: a bit-exact gather -> host -> disk -> inject
           round trip of 65 pages (bf16, and int8 pages with scales),
           the decode kernel equal over injected and original pages; the
           pressure traffic with --kv_offload=host (spilled lanes are
           injected back); a prefix evicted, demoted and paged back in
  lifecycle  drain, checkpoints and resume, deadlines, load shedding and
           the scheduler state at Llama-3-8B full width and depth, bf16,
           with the watchdog on: server A serves 8 streams of 256 tokens
           (one of 1,201 prompt tokens, one seeded) and 2 queued, drained
           mid-stream by POST /admin/drain (readiness 503, liveness 200,
           new work 503 + Retry-After while it drains): all 10 end on
           their checkpoints; server B resumes each through the
           x-generation-checkpoint header to exactly 256 tokens, answers
           504 to an expired deadline upfront and from the queue, takes
           two bursts of 24 (all at once: its 429s are shown; spaced 25
           ms apart: at least one 429) with 429s counted alike by the
           client, the scheduler state and /metrics, and holds a greedy
           lane's resumed logits to an uninterrupted lane's; a subprocess
           starts Llama-3.2-1B over an empty build directory (the kernels
           build before ready, the first request builds nothing, the
           watchdog suspects nothing)
  lora     multi-adapter LoRA at Llama-3-8B full width and depth, bf16:
           three seeded HF PEFT adapters written by the port's writer
           (rank 8 on all seven projections, rank 16 on q/v, rank 16 on
           the MLP) served with --lora_adapters; /openai/v1/models lists
           4 models; 8 concurrent completions mix the base model and all
           three adapters (one of 1,201 prompt tokens) beside a streamed
           chat on an adapter, the OpenAI `model` field choosing; base
           lanes' logits bit-equal to those of the same dispatch with
           every lane on the base model; each adapter's lanes against a
           merged-weight (W + A B) reference (f32 within 1e-3 x max|logit|,
           bf16 within 2x the merged model's bf16 noise); one dispatch
           profiled with and without adapters; then --spec_decode_k=3 with
           adapter lanes (the dense kernel)
  wq       int8 weights (--weight_quant=int8) at Llama-3-8B full width and
           depth, then with --kv_quant=int8 as well: the serve phase's
           wave and gates over int8 weights, the resident weights and KV
           bytes, logits against the dequantized weights (f32 within 1e-3
           x max|logit|, bf16 within 2x their bf16 noise), and one
           dispatch's device time by kernel class (the int8 GEMMs')
  moe      Mixture-of-Experts: Mixtral-8x7B (LlamaConfig.from_hf_config
           of its published config, written by the smoke: 8 experts of
           width 14,336, top 2, GQA 32/8, untied head) at full width and
           16 of its 32 layers (reduced: depth only), bf16, seeded random
           weights drawn once: the serve phase's wave and gates, one
           logprobs and one penalty request on the legacy route, then a
           second engine over the same tensors with --spec_decode_k=3
           --kv_quant=int8; logits through the kernels against the plain
           versions at full width and 2 layers, with the routings that
           flip between the two paths; resident weights and peak
           allocated bytes; then a Mixtral-form checkpoint at full width
           and 2 layers (two shards, layer 1's experts split across them
           out of order, a Mixtral-form tokenizer.json) served with
           --model_dir: every tensor bit-equal to the written one, greedy
           texts equal to a server holding the written tensors, one
           tensor of host staging, --weight_quant int8 refused
  pd       prefill/decode disaggregation at Llama-3-8B full width and
           depth, bf16: a --role prefill server and a --role decode
           server over it, in this process on one set of weights; the
           serve wave's prompts of <= 1,024 tokens plus one of 1,000 and
           a streamed chat through the pair, each prompt's KV over POST
           /v1/prefill; the pages the decode server holds after an inject
           bit-equal to the bytes the prefill server sent; the ragged and
           decode kernels launched by the decode server's dispatches;
           logprobs and a prompt over the prefill server's max_prefill_len
           answer 400; logits over injected KV against a monolithic
           prefill (f32 at 2 layers, greedy tokens equal; bf16 at full
           depth within 2x the bf16 noise); the KV round trip's ms and
           GB/s, inject ms, chat TTFT through the pair and through the
           prefill server alone
  peer     the cross-replica page fabric at the same width and depth: A
           persists a 65-page prefix (a reused 1,040-token prompt), B
           pages it in from A over GET /v1/internal/kv/pages through a
           PeerPageClient fed from A's scheduler state (65 verified hits,
           pages bit-equal to A's files, B's greedy tokens equal to A's
           hit answer, the pages written through to B's own dir), and C
           fetches through FaultInjectingTransport with the first page
           corrupted (counted, never adopted, C's tokens equal to A's
           cold answer); page-in wall, ms per page, TTFT cold / peer /
           local hit
  predictive  the V1/V2 dataplane and the predictive runtimes: from
           --seed, an XGBoost binary:logistic dump (HIGGS's 28 features,
           500 trees of depth 8), a LightGBM "binary sigmoid:1" dump (500
           trees of 255 leaves grown leaf-wise at random: LightGBM's Higgs
           setting), a 3-class multi:softprob XGBoost dump, and a pickled
           SVC stand-in of the iris SVC's shapes (4 features, 3 classes,
           RBF, 45 support vectors; the card machine has no sklearn), each
           served by `python -m kserve_tpu_torch.runtimes.predictive_server`
           in a process of its own (cuda by default, started together, TF32
           forced on by $TORCH_ALLOW_TF32_CUBLAS_OVERRIDE); 1, 64 and 1,024
           rows through V1 :predict, V2 JSON and V2 binary (equal answers),
           held to a float64 walk of each dump's own thresholds (classes
           equal, probabilities within 1e-5) and to the port on the CPU
           (1e-6); in this process each forest's tensors on cuda and the
           leaves its traversal reaches equal to the walk's, and the SVC,
           a StandardScaler + LogisticRegression Pipeline and a
           RandomForestClassifier stand-in converted on cuda and on the
           CPU against float64 (labels equal; probabilities within 1e-5 of
           float64, the SVC's decisions within 1e-4; both within 1e-6 of
           the CPU); then v2/infer p50 / p99 (binary form, 200
           requests per framework and batch, 50 for the softprob dump)
  artifacts  model storage, the storage initializer and the multi-model
           agent: the predictive phase's xgb-higgs and lgb-higgs dumps (from
           --seed), a second XGBoost forest and the iris-SVC stand-in packed
           as .tar.gz, .zip and a directory, served by a standard-library
           http.server; `python -m kserve_tpu_torch.storage.initializer
           --manifest` pulls all nine (http and file://): trees byte-equal
           to the sources, manifests listing every file and size, MB/s;
           `predictive_server --framework xgboost` over one pull on the card
           against the port on the CPU (1e-6), left running for explain; a
           ModelAgent (poll 0.2 s) over the port's REST server in this
           process loads three models (http .tar.gz, file://, .zip) on cuda,
           each V2 answer equal to the directly loaded model's; models.json
           rewritten: the removed model 404 within two polls, the changed
           storageUri serving the new forest (build/artifacts_smoke,
           removed after)
  explain  the explainer: two `python -m kserve_tpu_torch.runtimes.
           explainer_server --model_name xgb-higgs` processes over that
           XGBoost server, Kernel SHAP with 2,104 coalitions (shap's "auto"
           at 28 features) and permutation with 64 repeats per feature, on 8
           HIGGS rows against 100 background rows: attributions finite,
           Kernel SHAP efficient within 1e-6 of the predictor's f(x) - f(mean
           background), both within 1e-6 of the port on the CPU over the same
           predictor, a request's method overriding the flag; :explain p50
           of 5 calls
  forecast the time-series forecaster: `python -m kserve_tpu_torch.
           runtimes.timeseries_server` on the card; 370 seeded hourly load
           curves of 2,016 steps (UCI ElectricityLoadDiagrams20112014's
           clients, 12 weeks), horizon 168 with quantiles 0.1 / 0.5 / 0.9,
           and one 7-column series of 720 steps, horizon 96 (ETTh1,
           Informer's 720 -> 96): means within 1e-6 of the port on the CPU
           and within float32 rounding of a float64 recomputation, season 24
           picked for every load curve, quantiles ordered, start timestamps
           advanced, /v1/timeseries/models listing the forecaster alone;
           wall p50 of 5 calls each, launches per series under torch.profiler
  encoder  the BERT encoder runtime at BERT-base (768 wide, 12 layers, 12
           heads, vocabulary 30,522, 512 positions; ~110 M parameters,
           f32, TF32 off) from seeded random weights on cuda, served in
           this process: embeddings of 1, 8 and 32 texts of ~16, ~128 and
           ~500 tokens in float and base64 form (p50 / p99 of 30 requests
           each), a rerank of one query over 32 documents, classification
           and fill-mask over V1 and V2, each held to the same weights on
           the CPU (hidden states 1e-4, embeddings 1e-5, scores 1e-4;
           labels, order and argmax equal wherever the CPU's top-2 margin
           exceeds 1e-4, the rows under it counted); then the same weights
           written as a BERT safetensors checkpoint with a WordPiece
           tokenizer.json of the full vocabulary and served with
           --model_dir (parameters bit-equal to the draw, WordPiece ids,
           embeddings against the CPU); TF32 turned on for one batch must
           fail the embedding gate (build/encoder_smoke, removed after)
  graph    an InferenceGraph (BASELINE config 5): `python -m
           kserve_tpu_torch.graph.router` in a process of its own, a
           Switch in front of (a) a tokenizer-transformer Model that turns
           {"instances": [text]} into a completion body of token ids and
           the Llama-3-8B server's /openai/v1/completions ($response),
           held token for token (a tokenizer.json whose ids all decode
           apart) to the same completion sent directly, (b) a BERT-base
           encoder; transformers with a predictor_host forward V1 and V2
           to it and answer as the direct calls do; the ms each hop adds
           (router, forwarding; pairs alternating); a dead step answers
           502 naming it, then the breaker's instant 503 "circuit open";
           x-request-deadline 0 answers 504 before any call, echoing
           x-request-id
  epp      the EPP endpoint picker (`python -m kserve_tpu_torch.scheduler.
           epp --poll-interval 0.2`, a process of its own) in front of two
           Llama-3-8B replicas at full width and depth, bf16, one set of
           seeded weights, 1,024 KV pages each, in this process; the EPP and
           the replicas export spans (OTLP/HTTP JSON) to a standard-library
           collector here.  4 prefixes of ~1,000 tokens with 6 requests each
           (streamed chats and completions, ~50-token tails, 32 tokens), the
           first of each alone, the rest 8 at a time: all 200, each stream's
           first event before its last; >= 90% of each prefix's later
           requests on the replica of its first, both replicas serving a
           prefix; the ragged and decode kernels launched on both, exactly
           as their dispatches make; a greedy completion through the EPP
           equal to the same prompt sent to its replica; one streamed chat's
           linked trace (epp.proxy -> the replica's request span ->
           engine.queue / prefill / decode); POST /admin/profile on replica A
           during waves: 202, then 409, its Chrome trace naming the ragged,
           decode and GEMM kernels, with the device's busy ms and idle
           share, and the longest wait of a liveness probe of A meanwhile;
           the ms the EPP adds (p50 of 10 alternating pairs of a short
           completion, and of 30 of GET /openai/v1/models, and the EPP's
           request span less the replica's); B
           stopped mid-wave: only 502 / 503 while its breaker opens, then
           every request on A; both stopped: 503 "no healthy replica"; no
           span dropped or lost by any exporter
  scale    scale from zero and back (BASELINE config 5's "KPA scale 0->N"):
           the EPP (a subprocess, --poll-interval 0.2, breaker window 1 s)
           over two ports where no replica runs; the port's Activator and
           an AutoscalerLoop (EPPSignalSource, ReactivePolicy: queue_high
           8, idle_to_zero 5 s, down_cooldown 3 s, up_cooldown 0; 0..2
           replicas; held requests fed in as held_requests, on_hold ->
           notify_demand) in this process; the loop's actuator starts
           `python -m kserve_tpu_torch.runtimes.generative_server` processes
           (Llama-3-8B, full width and depth, bf16, seeded weights, cuda) and
           SIGTERMs them.  8 completions into the zero window: one wake, one
           process, replayed in arrival order, texts equal to the same 8
           sent straight to the replica; 24 clients of ~500-token prompts:
           1 -> 2 for queue_depth, B takes picks at the EPP, all 200; idle:
           back to 0 (low_load, idle_zero), both exit 0, the card's free
           memory back within 1 GB; a second zero window: a deadline shorter
           than a start answers 504, a normal one wakes a replica (warm
           start); every replica launched the ragged and decode kernels from
           the cached build.  Cold and warm time to ready, wake latency,
           scale-up reaction, time to zero, phase wall
The line before the last is {"kernels": [...]}, the last is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
nothing falls back to the CPU or to the plain versions.

--kernels-only runs the device, build and kernels phases alone and prints
the kernel phase's lines (no summary, no served phases).  --package-root
DIR imports kserve_tpu_torch from DIR instead of this checkout (e.g. an
unpacked `git archive` of another commit under build/), so two trees'
kernels are timed by the same cases and the same timing code.
--decode-min-chunk N sets the decode kernel's least keys per split (the
chunk sweep of PERF.md; the default is the package's own).  --skip-flex
leaves out the flex_attention yardstick and its compiles (an A/B).
--only PHASE[,PHASE...] runs the device and build phases and those served
phases in order (no kernel phase, no summary).  --seed N seeds the predictive, artifacts,
explain and forecast phases' models and data (default 0).  --cold-build-check is the lifecycle phase's
subprocess.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# written between the calls of a cold-L2 timing: 5x the H100's 50 MB L2,
# as a layer's pages were last touched a whole step earlier when served
FLUSH_BYTES = 256 << 20
# device spin before each device-only timed call (~0.5 ms), longer than
# the host's enqueue of one call, so the timing events bracket its kernels
SPIN_CYCLES = 1_000_000

_RAGGED_SRC = "kserve_tpu_torch/csrc/ragged_paged_attention.cu"
_DECODE_SRC = "kserve_tpu_torch/csrc/paged_decode_attention.cu"
_DENSE_SRC = "kserve_tpu_torch/csrc/dense_ragged_paged_attention.cu"
_PALLAS = "kserve_tpu/ops/pallas_paged_attention.py"
# the LAUNCHES keys of the bf16/f32-page instances (int8: + "_int8")
_ATTENTION_KEYS = ("ragged_paged_attention", "paged_decode_attention",
                   "dense_ragged_paged_attention")
# one summary row per kernel instance that stands for a TPU kernel (the
# int8 decode instance stands for paged_attention_xla's int8 gather: the
# JAX package has no int8 Pallas decode kernel)
KERNEL_META = {
    "ragged_paged_attention": {
        "route": "cuda", "source": _RAGGED_SRC, "replaces": f"{_PALLAS}:430"},
    "paged_decode_attention": {
        "route": "cuda", "source": _DECODE_SRC, "replaces": f"{_PALLAS}:147"},
    "paged_decode_attention_d64": {
        "route": "cuda", "source": _DECODE_SRC, "replaces": f"{_PALLAS}:218"},
    "dense_ragged_paged_attention": {
        "route": "cuda", "source": _DENSE_SRC, "replaces": f"{_PALLAS}:556"},
    "ragged_paged_attention_int8": {
        "route": "cuda", "source": _RAGGED_SRC, "replaces": f"{_PALLAS}:430"},
    "dense_ragged_paged_attention_int8": {
        "route": "cuda", "source": _DENSE_SRC, "replaces": f"{_PALLAS}:556"},
    "paged_decode_attention_int8": {
        "route": "cuda", "source": _DECODE_SRC,
        "replaces": "kserve_tpu/ops/attention.py:171"},
}
# the head_dim 256 instances (Gemma-2): a row each, ports of the same
# TPU kernels, launched by the gemma2 phases
for _kernel in _ATTENTION_KEYS:
    for _sfx in ("", "_int8"):
        KERNEL_META[f"{_kernel}_d256{_sfx}"] = KERNEL_META[_kernel + _sfx]
# row -> (the phase whose served run supplies its launch count, the
# LAUNCHES key counted there)
KERNEL_PATH = {
    "ragged_paged_attention": ("serve", "ragged_paged_attention"),
    "paged_decode_attention": ("serve", "paged_decode_attention"),
    "paged_decode_attention_d64": ("d64", "paged_decode_attention"),
    "dense_ragged_paged_attention": ("spec", "dense_ragged_paged_attention"),
    "ragged_paged_attention_int8": ("kvq", "ragged_paged_attention_int8"),
    "paged_decode_attention_int8": ("kvq", "paged_decode_attention_int8"),
    "dense_ragged_paged_attention_int8": (
        "kvq_spec", "dense_ragged_paged_attention_int8"),
}
for _kernel in _ATTENTION_KEYS:
    KERNEL_PATH[f"{_kernel}_d256"] = ("gemma2", _kernel)
    KERNEL_PATH[f"{_kernel}_d256_int8"] = ("gemma2_int8", f"{_kernel}_int8")


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


def _ptxas_of(log: str, marker: str) -> dict:
    """ptxas's registers and spill bytes of each kernel whose mangled name
    holds `marker`, from nvcc's -Xptxas=-v log."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if marker in m.group(1) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return found


def phase_build() -> None:
    from kserve_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    info = dict(_build.last_build)
    info.pop("log", None)
    # nvcc's output (-Xptxas=-v: registers, shared memory, spills per
    # kernel), which the build writes beside the library; trees from
    # before it did are written here
    log_path = _build.BUILD_DIR / "nvcc.log"
    if not log_path.exists():
        log_path.write_text(_build.last_build.get("log", ""))
    # the d=256 instances, bf16 and int8 pages each: the ragged kernel's
    # (wgmma; registers at launch, setmaxnreg moves them between the
    # warpgroups) and the dense and decode kernels' (s256): no spills
    log = log_path.read_text()
    gated = [("ragged", "ragged_kernel_wgmma", "attention_wgmma.cuh"),
             ("decode", "paged_decode_kernel_s256", "attention_split256.cuh"),
             ("dense", "dense_ragged_kernel_s256", "attention_split256.cuh")]
    d256, want = {}, 0
    for kernel, marker, header in gated:
        if not (_build.CSRC / header).exists():  # not in older trees
            continue
        want += 2
        for k, v in _ptxas_of(log, marker).items():
            d256[f"{kernel}_{'int8' if marker + 'Ia' in k else 'bf16'}"] = v
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_log": str(log_path), "d256_ptxas": d256, **info})
    if len(d256) != want or any(
            v.get("spill_stores", 1) or v.get("spill_loads", 1) for v in d256.values()):
        raise AssertionError(f"d=256 instances spill or are missing: {d256}")


# ---------------------------------------------------------------- kernels


def _time_ms(torch, fn, iters: int = 25, warmup: int = 3,
             cold: bool = False, device_only: bool = False) -> float:
    """Median of per-call CUDA-event times (ms).  The events bracket the
    call as the host enqueues it onto an idle device, so a call whose
    kernels finish before its host work does reads as that host work (the
    `ms` of every kernel row since PR 1).  device_only: each call is
    enqueued behind a device spin longer than its host work, so the events
    bracket its kernels only.  cold: FLUSH_BYTES are written before each
    call (outside the events), so it finds nothing of its inputs in the
    L2."""
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.fill_(1)
            if not device_only:
                torch.cuda.synchronize()
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(torch, fn, iters: int = 25, warmup: int = 3) -> float:
    """Median host time (ms) of one call as the host enqueues it onto an
    idle device: perf_counter around the call, no sync inside it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bf16_tol(ref) -> float:
    """Two bf16 ulps at the reference's largest magnitude: both sides do
    f32 math from the same bf16 inputs (the kernel in another summation
    order) and round the output to bf16 once."""
    mag = max(float(ref.abs().max()), 2.0 ** -20)
    return 2.0 * 2.0 ** (math.floor(math.log2(mag)) - 7)


def _make_cache(torch, gen, lanes_kv, nkv, d, ps, dtype, kv_quant="none"):
    """Random pages holding `lanes_kv` tokens per lane, each lane on its own
    shuffled pages (page 0 stays the null page).  kv_quant "int8" gives
    the quantized cache (int8 pages, f32 row scales), quantized by the
    port's own kvcache.quantize_rows."""
    from kserve_tpu_torch.engine.kvcache import quantize_rows

    need = [max(1, -(-n // ps)) for n in lanes_kv]
    W = max(need)
    P = 1 + sum(need)
    pages = torch.randn((P, 2, nkv, ps, d), generator=gen, device="cuda",
                        dtype=torch.float32)
    pages = quantize_rows(pages) if kv_quant == "int8" else pages.to(dtype)
    perm = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).tolist()
    table = torch.zeros((len(lanes_kv), W), dtype=torch.int32)
    used = 0
    for i, n in enumerate(need):
        table[i, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
        used += n
    return pages, table.cuda()


def _int8(cases: dict) -> dict:
    """The same cases over the int8 cache, named `<case>_int8`."""
    return {f"{name}_int8": dict(case, kv_quant="int8")
            for name, case in cases.items()}


# Gemma-2-2B's attention, the served shape of the head_dim 256 instances:
# 8 q / 4 kv heads, softcap 50, 4,096-token windows (on alternate layers),
# scale query_pre_attn_scalar^-0.5
GEMMA = dict(d=256, nq=8, nkv=4, softcap=50.0, window=4096, scale=256 ** -0.5)

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
RAGGED_CASES.update(_int8({k: RAGGED_CASES[k] for k in (
    "prefill_chunk", "mixed", "pure_decode", "window", "softcap_scale", "f32")}))
RAGGED_CASES["d64_int8"] = dict(RAGGED_CASES["mixed_int8"], d=64)
_RAGGED_D256 = {
    # a served 1,024-token chunk of a prompt that runs past the window
    # (queries at 3,700 .. 4,723) beside decode lanes, two of them past the
    # window; its plain version runs in slices of 512 queries (plain_rows),
    # since its [T, keys, nkv, d] gather of all 1,048 rows would not fit
    # the card
    "prefill_chunk_d256": dict(lanes=[(3700, 1024), (4500, 1), (57, 1), (4300, 1)],
                               plain_rows=512, **GEMMA),
    # the first 1,024-token chunk of every Gemma-2 prompt: causal from
    # position 0, no window (the layers without one)
    "first_chunk_d256": dict(lanes=[(0, 1024)], plain_rows=512,
                             **dict(GEMMA, window=0)),
    # two 512-token chunks, the second one across the window's edge
    "two_chunks_d256": dict(lanes=[(0, 512), (3900, 512)], plain_rows=256, **GEMMA),
    "f32_d256": dict(lanes=[(40, 9), (0, 30), (4200, 1)], dtype="float32", **GEMMA),
}
RAGGED_CASES.update(_RAGGED_D256)
RAGGED_CASES.update(_int8(_RAGGED_D256))
# lanes of 1..65 tokens back to back: lane boundaries at every offset of
# the tensor-core kernel's 16-token query tile, with and without a
# window, bf16 and int8 pages, d 128, 64 and 256
_EDGES = [(0, 1), (5, 7), (30, 8), (100, 9), (0, 15), (17, 16), (250, 17),
          (0, 63), (64, 64), (700, 65)]
for _d in (128, 64, 256):
    for _w in (0, 40):
        _edge = dict(lanes=_EDGES, window=_w, d=_d)
        _name = f"tile_edges_d{_d}" + ("_window" if _w else "")
        RAGGED_CASES[_name] = _edge
        RAGGED_CASES[_name + "_int8"] = dict(_edge, kv_quant="int8")
# the same at d=256 over 32-token pages: two pages per 64-key tile, one
# TMA box per page
for _w in (0, 40):
    _edge = dict(lanes=_EDGES, window=_w, d=256, ps=32)
    _name = "tile_edges_d256_ps32" + ("_window" if _w else "")
    RAGGED_CASES[_name] = _edge
    RAGGED_CASES[_name + "_int8"] = dict(_edge, kv_quant="int8")

DECODE_CASES = {
    # 8 lanes at mixed lengths up to ~2k tokens, one inactive
    "d128": dict(d=128, lens=[2048, 1, 17, 300, 1500, 0, 911, 64]),
    "d64_llama3_1b": dict(d=64, lens=[2048, 1, 17, 300, 1500, 0, 911, 64]),
    "d128_softcap_window": dict(d=128, lens=[2000, 5, 600, 0, 33, 128, 1024, 7],
                                softcap=30.0, window=256, scale=0.07),
    "f32": dict(d=128, lens=[100, 0, 37, 512], dtype="float32"),
}
DECODE_CASES.update(_int8(DECODE_CASES))
_DECODE_D256 = {
    # one lane of 6,000 tokens and one of 4,500, both past the window
    "d256": dict(lens=[6000, 1, 17, 300, 4500, 0, 911, 64], **GEMMA),
    "f32_d256": dict(lens=[100, 0, 37, 4200], dtype="float32", **GEMMA),
    # 32-token pages (two per 64-key stage); window edges (position - 99)
    # inside pages and inside the CTAs' runs
    "window_edge_d256_ps32": dict(lens=[1000, 333, 77, 4500, 0, 130, 2049, 65], ps=32,
                                  **dict(GEMMA, window=100)),
    # a 160-lane step (lanes of 25-64 tokens and one of 1,225): more lanes
    # than CTAs, most runs across several (lane, kv head) pairs
    "b160_d256_ps32": dict(lens=[25 + (7 * i) % 40 for i in range(159)] + [1225], ps=32,
                           **GEMMA),
    # 6-token pages: boxes of 2 rows, and int8 scales too unaligned for
    # the bulk copy (the producer loads them itself)
    "edges_d256_ps6": dict(lens=[1, 63, 64, 65, 300, 0, 1000, 2048], ps=6,
                           **dict(GEMMA, window=100)),
}
DECODE_CASES.update(_DECODE_D256)
DECODE_CASES.update(_int8(_DECODE_D256))
# the split-KV kernels' edges (128-key chunks at these tables at d 64 and
# 128; at d=256 runs of the persistent CTA), over bf16 and int8 pages at d
# 128, 64 and 256: every lane split 8+ ways; one live lane
# among inactive ones; lanes on both sides of a 64-key tile and a 128-key
# chunk and one that fills its table (W * ps = 2048); a window whose lower
# edge falls inside a lane's first split; and a long step of 8 lanes of
# ~4,000 tokens (timed, not a row of its own)
_DECODE_SPLIT = {
    "split8": dict(lens=[3000, 1100, 1500, 2900, 1025, 2000, 1300, 1800]),
    "one_live": dict(lens=[0, 0, 2500, 0, 0, 0, 0, 0]),
    "split_edges": dict(lens=[1, 63, 64, 65, 127, 128, 129, 2048]),
    "window_across_split": dict(lens=[1000, 700, 333, 2048, 5, 129, 450, 0],
                                window=200),
    "long": dict(lens=[4000 - 37 * i for i in range(8)]),
}
# the legacy phase's whole-engine batch: 160 lanes of 25-64 cached tokens
# and one of 1,225 (timed, not a row of its own)
DECODE_CASES["b160_d128"] = dict(
    d=128, lens=[25 + (7 * i) % 40 for i in range(159)] + [1225])
DECODE_CASES["b160_d128_int8"] = dict(DECODE_CASES["b160_d128"], kv_quant="int8")
for _d in (128, 64, 256):
    for _kv in ("none", "int8"):
        for _name, _case in _DECODE_SPLIT.items():
            DECODE_CASES[f"{_name}_d{_d}" + ("_int8" if _kv == "int8" else "")] = dict(
                _case, d=_d, kv_quant=_kv)


# speculative verify packing, 8 lanes: (K+1, stride) per case; lane 3 is
# inactive and lane 5 holds 1,500 tokens but has q_len 0 (starved of page
# capacity mid-dispatch): neither may read a page (nor, over int8 pages,
# a scale)
DENSE_HISTORY = [310, 1024, 57, 0, 1999, 1500, 130, 777]
DENSE_CASES = {
    "k0_sp1": dict(kp=1, sp=1),
    "k1_sp2": dict(kp=2, sp=2),
    "k2_sp4": dict(kp=3, sp=4),
    "k3_sp4": dict(kp=4, sp=4),  # the served K=3
    "k3_sp4_window": dict(kp=4, sp=4, window=96),
    "k3_sp4_f32": dict(kp=4, sp=4, dtype="float32"),
    "k3_sp4_d64": dict(kp=4, sp=4, d=64),
    # Gemma-2-2B's verify round: two lanes past the window
    "k3_sp4_d256": dict(kp=4, sp=4, history=[310, 5000, 57, 0, 1999, 1500, 130, 4500],
                        **GEMMA),
    "k3_sp4_f32_d256": dict(kp=4, sp=4, dtype="float32", **GEMMA),
    # over 32-token pages: a K = 1 round, and window edges (position - 99)
    # inside pages and runs
    "k1_sp2_d256": dict(kp=2, sp=2, history=[310, 5000, 57, 0, 1999, 1500, 130, 4500],
                        ps=32, **GEMMA),
    "k3_sp4_window_edge_d256_ps32": dict(
        kp=4, sp=4, history=[1000, 333, 77, 0, 4500, 2000, 130, 2049], ps=32,
        **dict(GEMMA, window=100)),
    "k3_sp4_d256_ps6": dict(kp=4, sp=4, history=[1, 63, 64, 0, 300, 1000, 130, 2048],
                            ps=6, **GEMMA),
}
DENSE_CASES.update(_int8({k: DENSE_CASES[k] for k in (
    "k1_sp2", "k3_sp4", "k3_sp4_window", "k3_sp4_f32", "k3_sp4_d64",
    "k3_sp4_d256", "k3_sp4_f32_d256", "k1_sp2_d256", "k3_sp4_window_edge_d256_ps32",
    "k3_sp4_d256_ps6")}))
for _case in DENSE_CASES.values():
    _case["lanes"] = [(h, 0 if i in (3, 5) else _case["kp"])
                      for i, h in enumerate(_case.get("history", DENSE_HISTORY))]
# the split-KV kernel's edges: every lane split 8+ ways (128-key chunks),
# and one live lane among inactive ones, bf16 and int8 pages, d 128, 64
# and 256
_SPLIT = [3000, 1100, 1500, 2900, 1025, 2000, 1300, 1800]
for _d in (128, 64, 256):
    for _kv in ("none", "int8"):
        _sfx = f"_d{_d}" + ("_int8" if _kv == "int8" else "")
        DENSE_CASES["split8" + _sfx] = dict(
            kp=4, sp=4, d=_d, kv_quant=_kv, lanes=[(h, 4) for h in _SPLIT])
        DENSE_CASES["one_live" + _sfx] = dict(
            kp=4, sp=4, d=_d, kv_quant=_kv,
            lanes=[(0, 0), (0, 0), (2500, 4)] + [(0, 0)] * 5)
# a long verify round: 8 lanes of ~4,000 cached tokens at (K+1, stride)
# = (4, 4) (timed, not a row of its own)
DENSE_CASES["long_k3_sp4"] = dict(
    kp=4, sp=4, lanes=[(4000 - 37 * i, 4) for i in range(8)])


def _heads(case):
    """(nq, nkv) of a case: Llama-3-8B's 32 / 8 unless it names others."""
    return case.get("nq", 32), case.get("nkv", 8)


def _dense_inputs(torch, gen, case):
    ps = case.get("ps", 16)
    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    d, sp, lanes = case.get("d", 128), case["sp"], case["lanes"]
    nq, nkv = _heads(case)
    pages, table = _make_cache(torch, gen, [h + case["kp"] for h, _ in lanes],
                               nkv, d, ps, dtype, case.get("kv_quant", "none"))
    q = torch.randn((len(lanes) * sp, nq, d), generator=gen,
                    device="cuda").to(dtype)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    return dict(
        q=q, kv_pages=pages, page_table=table,
        q_start=ints([i * sp for i in range(len(lanes))]),
        q_len=ints([qn for _, qn in lanes]), kv_start=ints([h for h, _ in lanes]),
        dense_stride=sp, logit_softcap=case.get("softcap", 0.0),
        scale=case.get("scale"), window=case.get("window", 0))


def _dense_kernel(q, kv_pages, page_table, q_start, q_len, kv_start,
                  dense_stride, **kw):
    from kserve_tpu_torch.ops.paged_attention_cuda import (
        dense_ragged_paged_attention_cuda,
    )

    return dense_ragged_paged_attention_cuda(
        q, kv_pages, page_table, q_len, kv_start, dense_stride, **kw)


def _dense_plain(dense_stride, **kw):
    from kserve_tpu_torch.ops.attention import ragged_paged_attention_plain

    return ragged_paged_attention_plain(**kw)


def _plain_in_slices(plain, rows: int):
    """The plain ragged version run one lane and at most `rows` queries at
    a time: query j of lane i sees only lane i's pages and its position
    kv_start[i] + j, so a sub-lane of queries a .. a+m-1 at kv_start
    kv_start[i] + a gives the same rows.  Rows outside every lane stay 0."""
    def run(q, kv_pages, page_table, q_start, q_len, kv_start, **kw):
        out = q.new_zeros(q.shape)
        ints = lambda xs: q_start.new_tensor(xs)  # noqa: E731
        for i, (s, n, h) in enumerate(zip(q_start.tolist(), q_len.tolist(),
                                          kv_start.tolist())):
            for a in range(0, n, rows):
                m = min(rows, n - a)
                out[s + a:s + a + m] = plain(
                    q[s + a:s + a + m], kv_pages, page_table[i:i + 1],
                    ints([0]), ints([m]), ints([h + a]), **kw)
        return out

    return run


def _ragged_inputs(torch, gen, case):
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    ps = case.get("ps", 16)
    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    d, lanes = case.get("d", 128), case["lanes"]
    nq, nkv = _heads(case)
    q_start, off = [], 0
    for _, qn in lanes:
        q_start.append(off)
        off += -(-qn // RAGGED_BQ) * RAGGED_BQ
    T = max(off, RAGGED_BQ)
    pages, table = _make_cache(torch, gen, [h + qn for h, qn in lanes],
                               nkv, d, ps, dtype, case.get("kv_quant", "none"))
    q = torch.randn((T, nq, d), generator=gen, device="cuda").to(dtype)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    return dict(
        q=q, kv_pages=pages, page_table=table, q_start=ints(q_start),
        q_len=ints([qn for _, qn in lanes]),
        kv_start=ints([h for h, _ in lanes]),
        logit_softcap=case.get("softcap", 0.0), scale=case.get("scale"),
        window=case.get("window", 0))


def _decode_inputs(torch, gen, case):
    ps = case.get("ps", 16)
    dtype = getattr(torch, case.get("dtype", "bfloat16"))
    d = case["d"]
    nq, nkv = _heads(case)
    lens = case["lens"]
    pages, table = _make_cache(torch, gen, lens, nkv, d, ps, dtype,
                               case.get("kv_quant", "none"))
    q = torch.randn((len(lens), nq, d), generator=gen, device="cuda").to(dtype)
    return dict(
        q=q, kv_pages=pages, page_table=table,
        seq_lens=torch.tensor(lens, dtype=torch.int32, device="cuda"),
        logit_softcap=case.get("softcap", 0.0), scale=case.get("scale"),
        window=case.get("window", 0))


def _kv_row_bytes(case, d: int, itemsize: int) -> int:
    """Bytes of one cached K or V row of one kv head: d int8 values plus a
    4-byte f32 scale, or d values of the page dtype."""
    return d + 4 if case.get("kv_quant") == "int8" else d * itemsize


def _ragged_work(case, itemsize=2):
    """Bytes the function must move and flops it must do on this case."""
    lanes, window, d = case["lanes"], case.get("window", 0), case.get("d", 128)
    nq, nkv = _heads(case)
    row = _kv_row_bytes(case, d, itemsize)
    # each live lane's keys from its first query's window to its last query
    kv_bytes = sum(h + qn - (max(0, h - window + 1) if window > 0 else 0)
                   for h, qn in lanes if qn) * nkv * 2 * row
    q_bytes = sum(qn for _, qn in lanes) * nq * d * itemsize
    flops = 0
    for h, qn in lanes:
        for j in range(qn):
            keys = h + j + 1
            if window > 0:
                keys = min(keys, window)
            flops += 4 * keys * d * nq
    return kv_bytes + 2 * q_bytes, flops


def _decode_work(case, itemsize=2):
    d, lens, window = case["d"], case["lens"], case.get("window", 0)
    nq, nkv = _heads(case)
    live = [min(n, window) if window > 0 else n for n in lens]
    kv_bytes = sum(live) * nkv * 2 * _kv_row_bytes(case, d, itemsize)
    q_bytes = sum(1 for n in lens if n) * nq * d * itemsize
    return kv_bytes + 2 * q_bytes, sum(4 * n * d * nq for n in live)


def _bound(nbytes: int, flops: int, flops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_ragged(torch, inp, case):
    """One F.scaled_dot_product_attention call over the gathered KV of
    every lane (padded batch, boolean causal/window mask; an int8 cache
    dequantized to q's dtype first): the library yardstick, timed only."""
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
    kb = k.to(q.dtype).transpose(1, 2).contiguous()
    vb = v.to(q.dtype).transpose(1, 2).contiguous()
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
    mask = kpos[None, :] < lens[:, None]
    if case.get("window", 0) > 0:
        mask = mask & (lens[:, None] - 1 - kpos[None, :] < case["window"])
    mask = mask[:, None, None, :]
    qb = inp["q"][:, :, None, :]
    kb = k.to(qb.dtype).transpose(1, 2).contiguous()
    vb = v.to(qb.dtype).transpose(1, 2).contiguous()
    scale = case.get("scale") or 1.0 / inp["q"].shape[-1] ** 0.5
    return lambda: F.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=scale, enable_gqa=True)


def _flex_call(torch, q, k, v, kv0, qlen, case):
    """One compiled torch.nn.attention.flex_attention call: q [B, nq, Lq,
    d] at positions kv0[b] + i (rows i >= qlen[b] are padding), k / v
    [B, nkv, L, d], the softcap as a score_mod and the causal (+ window)
    mask as a block mask.  It computes the softcapped function the d=256
    kernels do, where SDPA takes no softcap; a yardstick, timed only."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cap, window = case["softcap"], case.get("window", 0)
    B, _, Lq, d = q.shape
    L = k.shape[2]

    def score_mod(score, b, h, qi, ki):
        return torch.tanh(score / cap) * cap

    def mask_mod(b, h, qi, ki):
        qp = kv0[b] + qi
        keep = (ki <= qp) & (qi < qlen[b])
        if window > 0:
            keep = keep & (qp - ki < window)
        return keep

    mask = create_block_mask(mask_mod, B, None, Lq, L, device="cuda")
    fn = torch.compile(flex_attention)
    scale = case.get("scale") or 1.0 / d ** 0.5
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=mask,
                      scale=scale, enable_gqa=True)


def _flex_ragged(torch, inp, case):
    """flex_attention on the gathered KV of every lane (padded batch)."""
    from kserve_tpu_torch.ops.attention import _gather_history

    lanes = case["lanes"]
    q = inp["q"]
    k, v = _gather_history(inp["kv_pages"], inp["page_table"])
    Lq = max(max(qn for _, qn in lanes), 1)
    qb = torch.zeros((len(lanes), q.shape[1], Lq, q.shape[2]), dtype=q.dtype,
                     device="cuda")
    for i, (s, (_, qn)) in enumerate(zip(inp["q_start"].tolist(), lanes)):
        qb[i, :, :qn] = q[s:s + qn].transpose(0, 1)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    return _flex_call(torch, qb, k.to(q.dtype).transpose(1, 2).contiguous(),
                      v.to(q.dtype).transpose(1, 2).contiguous(),
                      ints([h for h, _ in lanes]), ints([qn for _, qn in lanes]), case)


def _flex_decode(torch, inp, case):
    """flex_attention for one decode token per lane."""
    from kserve_tpu_torch.ops.attention import _gather_history

    k, v = _gather_history(inp["kv_pages"], inp["page_table"])
    qb = inp["q"][:, :, None, :]
    lens = inp["seq_lens"]
    return _flex_call(torch, qb, k.to(qb.dtype).transpose(1, 2).contiguous(),
                      v.to(qb.dtype).transpose(1, 2).contiguous(),
                      (lens - 1).clamp(min=0), (lens > 0).to(torch.int32), case)


def _flex_times(torch, flex, inp, case) -> dict:
    """library_ms / library_device_ms of the flex_attention yardstick, or
    its error where it does not compile or run."""
    try:
        fn = flex(torch, inp, case)
        fn()
        torch.cuda.synchronize()
        return {"library": "flex_attention", "library_ms": _time_ms(torch, fn),
                "library_device_ms": _time_ms(torch, fn, device_only=True)}
    except Exception as e:  # the yardstick's own failure is a finding, not a fault
        return {"library": "flex_attention", "library_ms": None,
                "library_device_ms": None,
                "flex_error": f"{type(e).__name__}: {str(e)[:400]}"}


def _row_of(kernel: str, case) -> str:
    """The summary row a case belongs to."""
    int8 = "_int8" if case.get("kv_quant") == "int8" else ""
    if case.get("d") == 256:
        return f"{kernel}_d256{int8}"
    if int8:
        return kernel + int8
    if kernel == "paged_decode_attention" and case["d"] == 64:
        return "paged_decode_attention_d64"
    return kernel


def phase_kernels(torch, flex: bool = True) -> dict:
    """Each kernel instance against its plain version; returns the
    per-row summaries (launches are filled in by the served phases).
    flex: time the flex_attention yardstick of the softcapped rows."""
    from kserve_tpu_torch.ops import attention as A
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    rows = {}
    worst = {}
    specs = [
        # (kernel, cases, inputs, kernel wrapper, plain version, timed
        # cases (True: the case fills its row; False: timed and emitted
        # only), library yardsticks (SDPA, and flex_attention where the
        # function has a softcap), work)
        ("ragged_paged_attention", RAGGED_CASES, _ragged_inputs,
         K.ragged_paged_attention_cuda, A.ragged_paged_attention_plain,
         {"prefill_chunk": True, "prefill_chunk_int8": True,
          "prefill_chunk_d256": True, "prefill_chunk_d256_int8": True,
          "first_chunk_d256": False, "first_chunk_d256_int8": False,
          "pure_decode": False, "mixed": False}, (_sdpa_ragged, _flex_ragged),
         _ragged_work),
        # d=64 is the port of _packed_decode_kernel, timed for its own row
        ("paged_decode_attention", DECODE_CASES, _decode_inputs,
         K.paged_decode_attention_cuda, A.paged_attention_plain,
         {"d128": True, "d64_llama3_1b": True, "d128_int8": True,
          "d256": True, "d256_int8": True,
          "long_d128": False, "long_d128_int8": False, "long_d64": False,
          "long_d64_int8": False, "b160_d128": False, "b160_d128_int8": False,
          "b160_d256_ps32": False, "b160_d256_ps32_int8": False},
         (_sdpa_decode, _flex_decode), _decode_work),
        # the library yardstick of a verify round is the ragged one: SDPA
        # on the gathered KV with each lane's causal-offset mask
        ("dense_ragged_paged_attention", DENSE_CASES, _dense_inputs,
         _dense_kernel, _dense_plain,
         {"k3_sp4": True, "k3_sp4_int8": True, "k3_sp4_d256": True,
          "k3_sp4_d256_int8": True, "long_k3_sp4": False},
         (_sdpa_ragged, _flex_ragged), _ragged_work),
    ]
    for name, cases, make, kernel, plain, timed, (library, flex_lib), work in specs:
        for case_name, case in cases.items():
            row = _row_of(name, case)
            inp = make(torch, gen, case)
            case_plain = (_plain_in_slices(plain, case["plain_rows"])
                          if "plain_rows" in case else plain)
            got = kernel(**inp)
            ref = case_plain(**inp)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = (1e-4 if case.get("dtype") == "float32"
                   else _bf16_tol(ref.float()))
            ok = err <= tol and bool(torch.isfinite(got).all())
            emit({"phase": "kernels", "kernel": name, "row": row,
                  "case": case_name,
                  "dtype": str(inp["q"].dtype).replace("torch.", ""),
                  "kv": case.get("kv_quant", "none"),
                  "max_abs_err": err, "tol": tol, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"{name}/{case_name}: kernel disagrees with the plain "
                    f"version (max_abs_err {err} > tol {tol})")
            worst[row] = max(worst.get(row, 0.0), err)
            if case_name in timed:
                sdpa = library(torch, inp, case)
                call = lambda: kernel(**inp)  # noqa: E731
                times = {
                    "ms": _time_ms(torch, call),
                    "host_ms": _host_ms(torch, call),
                    "ms_cold": _time_ms(torch, call, cold=True),
                    "device_ms": _time_ms(torch, call, device_only=True),
                    "device_ms_cold": _time_ms(torch, call, cold=True,
                                               device_only=True),
                    "plain_ms": _time_ms(torch, lambda: case_plain(**inp),
                                         iters=20, warmup=1),
                }
                sdpa_ms = _time_ms(torch, sdpa)
                sdpa_dev = _time_ms(torch, sdpa, device_only=True)
                if case.get("softcap", 0.0) > 0.0:
                    # SDPA takes no softcap: its time (same shapes and mask,
                    # no tanh) is kept under its own names, and the library
                    # time is flex_attention's, which takes one
                    times.update(sdpa_no_softcap_ms=sdpa_ms,
                                 sdpa_no_softcap_device_ms=sdpa_dev)
                    times.update(_flex_times(torch, flex_lib, inp, case) if flex
                                 else {"library_ms": None, "library_device_ms": None})
                else:
                    times.update(library_ms=sdpa_ms, library_device_ms=sdpa_dev)
                nbytes, flops = work(case)
                bound_ms, bound_by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
                if timed[case_name]:
                    rows[row] = {
                        "name": row, **KERNEL_META[row], "launches": 0,
                        "max_abs_err": 0.0, **times, "bound_ms": bound_ms,
                        "bound_by": bound_by, "timed_case": case_name,
                    }
                emit({"phase": "kernels", "kernel": name, "row": row,
                      "timed_case": case_name, **times, "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                      "x_sdpa": times["ms"] / sdpa_ms,
                      "x_sdpa_device": times["device_ms"] / sdpa_dev,
                      "x_library_device": (
                          times["device_ms"] / times["library_device_ms"]
                          if times.get("library_device_ms") else None)})
            del inp, got, ref
            torch.cuda.empty_cache()
    for row, summary in rows.items():
        summary["max_abs_err"] = worst[row]
    _check_head_dim_refused(torch, gen)
    missing = sorted(set(KERNEL_META) - set(rows))
    if missing:
        raise AssertionError(f"kernel rows without a timed case: {missing}")
    return rows


def _check_head_dim_refused(torch, gen) -> None:
    """A head_dim that no instance takes (96) raises ValueError in every
    wrapper on CUDA tensors, and nothing launches."""
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    before = dict(K.LAUNCHES)
    ragged = _ragged_inputs(torch, gen, dict(lanes=[(5, 3), (0, 9)], d=96))
    decode = _decode_inputs(torch, gen, dict(lens=[7, 30], d=96))
    dense = _dense_inputs(torch, gen, dict(kp=4, sp=4, d=96,
                                           lanes=[(5, 4), (20, 4)]))
    for name, call in (
            ("ragged", lambda: K.ragged_paged_attention_cuda(**ragged)),
            ("decode", lambda: K.paged_decode_attention_cuda(**decode)),
            ("dense", lambda: _dense_kernel(**dense))):
        try:
            call()
        except ValueError as e:
            if "head_dim" not in str(e):
                raise
        else:
            raise AssertionError(f"the {name} kernel took head_dim 96")
    torch.cuda.synchronize()
    if dict(K.LAUNCHES) != before:
        raise AssertionError("a refused head_dim launched a kernel")
    emit({"phase": "kernels", "check": "head_dim_96_refused", "ok": True})


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="device, build and kernel phases only")
    ap.add_argument("--package-root", default=None,
                    help="import kserve_tpu_torch from this directory")
    ap.add_argument("--skip-flex", action="store_true",
                    help="leave out the flex_attention yardstick (its "
                         "compiles), e.g. in a kernels-only A/B")
    ap.add_argument("--only", default=None,
                    help="device, build and these served phases, comma-separated, "
                         f"in order (of {', '.join(sorted(SERVED_PHASES))})")
    ap.add_argument("--cold-build-check", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the predictive, artifacts, explain and forecast "
                         "phases' models and data")
    ap.add_argument("--scale-default-breaker", action="store_true",
                    help="run the scale phase's EPP as shipped (its breakers' "
                         "30 s open window) in place of a 1 s window")
    ap.add_argument("--decode-min-chunk", type=int, default=None,
                    help="keys per split of the decode kernel, at least "
                         "(a multiple of 64; default: the package's "
                         "DECODE_MIN_CHUNK)")
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else []
    unknown = [p for p in only if p not in SERVED_PHASES]
    if unknown:
        ap.error(f"--only: unknown phase(s) {unknown}")
    if args.package_root:
        root = os.path.abspath(args.package_root)
        if not os.path.isdir(os.path.join(root, "kserve_tpu_torch")):
            raise SystemExit(f"{root} holds no kserve_tpu_torch/")
        sys.path.insert(0, root)
    else:
        _require_package()
    # flex_attention's compiles cache inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(REPO, "build", "torchinductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, "build", "triton"))
    import torch

    if args.cold_build_check:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: chip_smoke.py runs only on a GPU")
        print(json.dumps(cold_build_check()), flush=True)
        return 0
    if args.decode_min_chunk is not None:
        from kserve_tpu_torch.ops import paged_attention_cuda as K

        if args.decode_min_chunk <= 0 or args.decode_min_chunk % K.TC_KT:
            raise SystemExit(f"--decode-min-chunk must be a positive multiple "
                             f"of {K.TC_KT}")
        K.DECODE_MIN_CHUNK = args.decode_min_chunk
        K.decode_launch_plan.cache_clear()
    t0 = time.perf_counter()
    info = phase_device(torch)
    phase_build()
    # the artifacts phase leaves its XGBoost server here for the explain phase
    shared: dict = {}
    phases = dict(SERVED_PHASES,
                  predictive=functools.partial(phase_predictive, seed=args.seed),
                  artifacts=functools.partial(phase_artifacts, seed=args.seed,
                                              shared=shared),
                  explain=functools.partial(phase_explain, seed=args.seed, shared=shared),
                  forecast=functools.partial(phase_forecast, seed=args.seed),
                  scale=functools.partial(phase_scale, breaker_open_s=(
                      None if args.scale_default_breaker else SCALE_BREAKER_OPEN_S)))
    if only:
        try:
            for name in only:
                phases[name](torch)
        finally:
            for server in shared.values():
                server.stop()
        emit({"phase": "done", "wall_s": time.perf_counter() - t0})
        return 0
    rows = phase_kernels(torch, flex=not args.skip_flex)
    if args.kernels_only:
        emit({"phase": "done", "wall_s": time.perf_counter() - t0})
        return 0
    counts = {"serve": phase_serve(torch), "d64": phase_d64(torch)}
    phase_checkpoint(torch, info)
    counts["spec"] = phase_spec(torch)
    counts.update(phase_kvq(torch))
    counts.update(phase_gemma2(torch))
    phase_pressure(torch)
    phase_legacy(torch)
    counts.update(phase_prefix(torch))
    phase_tiers(torch)
    counts["lifecycle"] = phase_lifecycle(torch)
    counts["lora"] = phase_lora(torch)
    counts.update(phase_wq(torch))
    counts.update(phase_moe(torch))
    counts.update(phase_pd(torch))
    counts.update(phase_peer(torch))
    phases["predictive"](torch)
    try:
        for name in ("artifacts", "explain", "forecast"):
            phases[name](torch)
    finally:
        for server in shared.values():
            server.stop()
    phase_encoder(torch)
    phase_graph(torch)
    counts["epp"] = phase_epp(torch)
    counts["scale"] = phases["scale"](torch)
    for name, row in rows.items():
        phase, key = KERNEL_PATH[name]
        row["launches"] = counts[phase].get(key, 0)
    missing = [n for n, row in rows.items() if row["launches"] <= 0]
    if missing:
        raise AssertionError(f"main path never launched kernel(s) {missing}")
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
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
# each attention call of the f32 plain run, repeated through the kernel on
# the same inputs and cache: summation order only, relative to max(1,
# max|plain|) (the f32 kernel cases' 1e-4)
ATTN_F32_REL_TOL = 1e-4
# bf16 logits: bf16 rounding of activations in every layer dominates; the
# kernel path may stray from the plain bf16 path by at most this multiple
# of the plain bf16 path's own distance from f32
BF16_NOISE_FACTOR = 2.0
# f32 logits over an int8 cache: a K/V element that the two paths compute
# a few ulps apart can round to neighbouring int8 steps, and 32 layers
# amplify such flips far past F32_LOGITS_REL_TOL, so the kernel path may
# stray from the plain int8 path by at most this multiple of the plain
# int8 path's own distance from the unquantized plain path (the model's
# int8 noise); each kernel call is held to ATTN_F32_REL_TOL all the same
INT8_NOISE_FACTOR = 1.0


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


def _stream_chat(port: int, body: dict, t_send: list,
                 path: str = "/openai/v1/chat/completions"):
    """POST a streamed chat, or a streamed completion to `path`; returns
    (status, events, ttft_s).  The first token's chunk is a chat's second
    event (the first names the role) and a completion's first."""
    import http.client

    first_token_event = 2 if path.endswith("/chat/completions") else 1
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        t_send.append(t0)
        conn.request("POST", path,
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
            if ttft is None and len(events) == first_token_event:
                ttft = time.perf_counter() - t0
        return resp.status, events, ttft
    finally:
        conn.close()


def _scrape(port: int) -> dict:
    """GET /metrics as {(sample name, sorted label pairs): value}."""
    status, body = _http(port, "GET", "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics answered {status}")
    return _parse_metrics(body.decode())


def _parse_metrics(text: str) -> dict:
    """The text format's sample lines as {(sample name, sorted label pairs):
    value} (the card machine has no prometheus_client)."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name, _, labels = series.partition("{")
        pairs = tuple(sorted(
            tuple(kv.split("=", 1)) for kv in labels.rstrip("}").split(",") if kv))
        out[(name, tuple((k, v.strip('"')) for k, v in pairs))] = float(value)
    return out


def _telemetry_check(port: int, name: str, before: dict, requests: int,
                     served: int) -> dict:
    """After a wave of `requests` completions that served `served` tokens
    in all: the engine's GET /admin/telemetry counts every one in its TTFT
    window with a positive ITL median, and GET /metrics moved by the same
    wave (engine_generated_tokens_total counts decode tokens, so each
    request's first token, the prefill's sample, is not in it, as in the
    JAX engine).  Returns TTFT / ITL / queue-wait percentiles from the
    engine's clock."""
    status, body = _http(port, "GET", "/admin/telemetry")
    if status != 200:
        raise AssertionError(f"/admin/telemetry answered {status}")
    snap = json.loads(body)["models"][name]
    after = _scrape(port)
    label = (("model_name", name),)

    def delta(sample):
        return after.get((sample, label), 0.0) - before.get((sample, label), 0.0)

    got = {"ttft_n": snap["ttft_s"]["n"], "finished": snap["counts"]["finished"],
           "ttft_count": delta("request_ttft_seconds_count"),
           "generated_total": delta("engine_generated_tokens_total")}
    want = {"ttft_n": requests, "finished": requests, "ttft_count": requests,
            "generated_total": served - requests}
    if got != want or not snap["itl_s"].get("p50", 0) > 0:
        raise AssertionError(f"telemetry {got} != {want} (itl {snap['itl_s']})")
    return {key: {q: snap[key].get(q) for q in ("n", "p50", "p99")}
            for key in ("ttft_s", "itl_s", "queue_wait_s", "e2e_s", "decode_step_s")}


def _logits_check(torch, engine, verify_k=None, legacy=False) -> dict:
    """Step-0 logits of one packed plan, then one decode step (and with
    `verify_k`, one speculative verify round of K+1 tokens per lane at the
    dense stride; with `legacy`, the legacy programs' model calls: a
    batched llama.prefill of the same prompts into a second cache, whose
    attention is plain PyTorch on both paths, and one decode step over the
    cache it wrote), through the CUDA kernels and through the plain
    versions, on the served weights and over a cache of the engine's kind
    (pages in the activation dtype, or int8 pages with scales):

    - each attention call, float32 (an f32 copy of the weights) and
      bfloat16 (the served weights): the plain run also calls the kernel
      on the same inputs and cache; they must agree within
      ATTN_F32_REL_TOL (f32) or within _bf16_tol of that call's plain
      output (bf16: the kernel cases' gate, at the served shapes).
    - float32 logits: kernels and plain versions sum in another order
      only; they must agree within F32_LOGITS_REL_TOL of the largest
      |logit|, or over an int8 cache within INT8_NOISE_FACTOR times the
      model's int8 noise.
    - bfloat16 (the served path): the plain bf16 path's distance from the
      plain f32 path is bf16's own noise on this model; the kernel path
      may differ from the plain bf16 path by at most BF16_NOISE_FACTOR
      times that noise.
    """
    import dataclasses

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import attention as A
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    mc16 = engine.model_config
    mc32 = dataclasses.replace(mc16, dtype="float32")
    kv_quant = engine.config.kv_quant
    ps = engine.config.page_size
    lens = [40, 100, 7]
    kp = 0 if verify_k is None else verify_k + 1
    W = -(-(max(lens) + 1 + kp) // ps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    tokens, seq, pos, q_start, last = [], [], [], [], []
    prompts = torch.zeros((len(lens), max(lens)), dtype=torch.int32)
    for i, n in enumerate(lens):
        q_start.append(len(tokens))
        pad = -(-n // RAGGED_BQ) * RAGGED_BQ - n
        ids = torch.randint(0, mc16.vocab_size, (n,), generator=gen,
                            device="cuda").tolist()
        prompts[i, :n] = torch.tensor(ids, dtype=torch.int32)
        tokens += ids + [0] * pad
        seq += [i] * n + [-1] * pad
        pos += list(range(n)) + [0] * pad
        last.append(q_start[-1] + n - 1)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    table = ints([[1 + i * W + j for j in range(W)] for i in range(len(lens))])
    active = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    sp = None
    if verify_k is not None:
        # lane i's verify slice: its next token plus K drafts, at
        # positions lens[i]+1 .., packed at the stride the engine uses
        sp = A.dense_stride_for(kp, RAGGED_BQ)
        drafts = torch.randint(0, mc16.vocab_size, (len(lens), verify_k),
                               generator=gen, device="cuda")
        v_seq, v_pos, v_at = [], [], []
        for i, n in enumerate(lens):
            v_seq += [i] * kp + [-1] * (sp - kp)
            v_pos += list(range(n + 1, n + 1 + kp)) + [0] * (sp - kp)
            v_at += [i * sp + j for j in range(kp)]
    params32 = _f32_params(torch, engine.params)
    # (dtype, step name) -> (error, tolerance) of the paired call that came
    # closest to its tolerance: f32 relative to max(1, max|plain|), bf16
    # absolute against _bf16_tol of the call's plain output
    attn_err = {}

    def attention(mode: str, step: str, plain, kernel):
        """The attention_fn of one step: the plain version, the kernel
        (None: the model's own dispatch), or "paired": the plain version,
        with the kernel run on the same inputs and held against it."""
        if mode == "plain":
            return plain
        if mode == "kernel":
            return None

        def paired(q, pages, *args, **kw):
            ref = plain(q, pages, *args, **kw)
            got = kernel(q, pages, *args, **kw)
            diff = float((got.float() - ref.float()).abs().max())
            if ref.dtype == torch.float32:
                err = diff / max(1.0, float(ref.float().abs().max()))
                tol = ATTN_F32_REL_TOL
            else:
                err, tol = diff, _bf16_tol(ref.float())
            key = ("f32" if ref.dtype == torch.float32 else "bf16", step)
            if key not in attn_err or err / tol > attn_err[key][0] / attn_err[key][1]:
                attn_err[key] = (err, tol)
            return ref
        return paired

    def run(params, mc, mode: str, picks=None, cache_kind=kv_quant):
        """([step0, step1(, verify)(, legacy_prefill, legacy_decode)]
        logits, the tokens fed after each step that another follows — the
        f32 plain run's greedy picks, reused by all)."""
        pages = _fresh_cache(mc, ps, 1 + len(lens) * W, cache_kind)
        step0, _ = llama.forward_ragged(
            params, mc, ints(tokens), ints(seq), ints(pos), ints(q_start),
            ints(lens), ints([0] * len(lens)), pages, table, ps, ints(last),
            attention_fn=attention(mode, "forward_ragged",
                                   A.ragged_paged_attention_plain,
                                   A.ragged_paged_attention))
        if picks is None:
            picks = [torch.argmax(step0, dim=-1).to(torch.int32)]
        step1, _ = llama.decode_step(
            params, mc, picks[0], ints(lens), pages, table, active, ps,
            attention_fn=attention(mode, "decode_step", A.paged_attention_plain,
                                   A.paged_attention))
        out = [step0, step1]
        if verify_k is not None:
            if len(picks) == 1:
                picks.append(torch.argmax(step1, dim=-1).to(torch.int32))
            slices = torch.cat([picks[1][:, None], drafts.to(torch.int32)], 1)
            v_tok = torch.zeros((len(lens), sp), dtype=torch.int32, device="cuda")
            v_tok[:, :kp] = slices
            verify, _ = llama.forward_ragged(
                params, mc, v_tok.reshape(-1), ints(v_seq), ints(v_pos),
                ints([i * sp for i in range(len(lens))]), ints([kp] * len(lens)),
                ints([n + 1 for n in lens]), pages, table, ps, ints(last),
                attention_fn=attention(
                    mode, "verify", A.ragged_paged_attention_plain,
                    functools.partial(A.ragged_paged_attention, dense_stride=sp)),
                logits_at=ints(v_at), dense_stride=sp)
            out.append(verify)
        if legacy:
            # the `prefill` program's model call, then a `decode` step over
            # the cache it wrote (int8 rows quantized by the prefill)
            lpages = _fresh_cache(mc, ps, 1 + len(lens) * W, cache_kind)
            pre, _ = llama.prefill(params, mc, prompts.to("cuda"), ints(lens),
                                   lpages, table, ps)
            if len(picks) == len(out) - 1:
                picks.append(torch.argmax(pre, dim=-1).to(torch.int32))
            dec, _ = llama.decode_step(
                params, mc, picks[-1], ints(lens), lpages, table, active, ps,
                attention_fn=attention(mode, "legacy_decode",
                                       A.paged_attention_plain, A.paged_attention))
            out += [pre, dec]
        return out, picks

    with torch.inference_mode():
        p32, picks = run(params32, mc32, "paired")
        k32, _ = run(params32, mc32, "kernel", picks=picks)
        if kv_quant == "int8":
            x32, _ = run(params32, mc32, "plain", picks=picks, cache_kind="none")
        del params32
        p16, _ = run(engine.params, mc16, "paired", picks=picks)
        k16, _ = run(engine.params, mc16, "kernel", picks=picks)
    torch.cuda.empty_cache()
    out = {}
    names = ["forward_ragged", "decode_step"] + (
        ["verify"] if verify_k is not None else []) + (
        ["legacy_prefill", "legacy_decode"] if legacy else [])
    for i, name in enumerate(names):
        scale = float(p32[i].abs().max())
        err32 = float((k32[i] - p32[i]).abs().max())
        noise16 = float((p16[i] - p32[i]).abs().max())
        err16 = float((k16[i] - p16[i]).abs().max())
        # the prefill's attention is plain PyTorch on both paths: no
        # kernel call to pair (None)
        f32_pair, bf16_pair = (attn_err.get(("f32", name)),
                               attn_err.get(("bf16", name)))
        row = {
            "attn_f32_max_rel_err": f32_pair and f32_pair[0],
            "attn_f32_tol": ATTN_F32_REL_TOL,
            "attn_bf16_max_abs_err": bf16_pair and bf16_pair[0],
            "attn_bf16_tol": bf16_pair and bf16_pair[1],
            "f32_max_abs_err": err32, "f32_tol": F32_LOGITS_REL_TOL * scale,
            "bf16_max_abs_err": err16, "bf16_noise": noise16,
            "bf16_tol": BF16_NOISE_FACTOR * noise16, "max_abs_logit": scale,
            "bf16_argmax_agree": float(
                (k16[i].argmax(-1) == p16[i].argmax(-1)).float().mean()),
        }
        if kv_quant == "int8" and name != "legacy_prefill":
            # (the prefill's logits read no cache: no int8 noise there)
            row["int8_noise_f32"] = float((p32[i] - x32[i]).abs().max())
            row["f32_tol"] = INT8_NOISE_FACTOR * row["int8_noise_f32"]
        out[name] = row
        finite = all(bool(torch.isfinite(t[i]).all()) for t in (k32, k16))
        pairs = [p for p in (f32_pair, bf16_pair) if p is not None]
        if len(pairs) != (0 if name == "legacy_prefill" else 2):
            raise AssertionError(f"{name}: paired attention calls {pairs}")
        paired_ok = all(e <= t for e, t in pairs)
        if not (finite and paired_ok
                and err32 <= row["f32_tol"] and err16 <= row["bf16_tol"]):
            raise AssertionError(
                f"{name} logits through the kernels disagree with the plain "
                f"versions: {row}")
    return out


def _f32_params(torch, params):
    """A float32 copy of model parameters for the f32 reference runs:
    floating tensors (LoRA stacks and int8 scales among them) in float32,
    int8 weights and Python values as they are."""
    if isinstance(params, dict):
        return {k: _f32_params(torch, v) for k, v in params.items()}
    if isinstance(params, list):
        return [_f32_params(torch, v) for v in params]
    if torch.is_tensor(params) and params.is_floating_point():
        return params.float()
    return params


def _fresh_cache(mc, page_size: int, num_pages: int, kv_quant: str,
                 device="cuda"):
    """An empty cache on the card for model config `mc`: pages in its
    dtype, or with kv_quant "int8" (int8 pages, f32 scales) per layer."""
    import dataclasses

    from kserve_tpu_torch.engine.kvcache import (
        KVCacheConfig,
        init_kv_pages,
        init_kv_scales,
    )

    cfg = KVCacheConfig(n_layers=mc.n_layers, n_kv_heads=mc.n_kv_heads,
                        head_dim=mc.head_dim, page_size=page_size,
                        num_pages=num_pages, dtype=mc.dtype)
    if kv_quant != "int8":
        return init_kv_pages(cfg, device)
    pages = init_kv_pages(dataclasses.replace(cfg, dtype="int8"), device)
    return list(zip(pages, init_kv_scales(cfg, device)))


def _kv_cache_gb(engine) -> float:
    """Device bytes of the engine's KV cache (pages and any scales)."""
    tensors = [t for layer in engine.kv_pages
               for t in (layer if isinstance(layer, tuple) else (layer,))]
    return sum(t.numel() * t.element_size() for t in tensors) / 1e9


def _start_server(torch, argv, phase: str, load=None):
    """The port's server built from command-line `argv` through
    build_arg_parser/build_model, listening on a free port in a thread and
    ready; returns (model, server, thread).  `load` (a function returning
    parameters) replaces the model's own weight load."""
    import threading

    from kserve_tpu_torch.model_server import ModelServer
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    model = build_model(build_arg_parser().parse_args(argv))
    if load is not None:
        model.load = load
        model.weights_stats = {"seconds": 0.0}
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
    status, _ = _http(server.port, "GET", "/v2/health/ready")
    assert status == 200, f"ready probe answered {status}"
    emit({"phase": phase, "event": "ready",
          "startup_s": time.perf_counter() - t0,
          "engine_build_s": model.engine.startup_seconds,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    return model, server, thread


def _stop_server(torch, model, server, thread) -> None:
    """Stop the server thread and free the model's device memory."""
    import gc

    server.request_stop()
    thread.join(120)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    model.engine = None
    gc.collect()
    torch.cuda.empty_cache()


BASE_TEXT = "The port of a serving stack from one accelerator to another "
SERVE_PROMPTS = [
    ("short", "Tell me about the sea.", 32),
    ("medium", BASE_TEXT * 6, 48),
    ("long", (BASE_TEXT * 40)[:1200], 64),  # > the 1024-token prefill bucket
    ("repeat_a", "Write a haiku about paged attention.", 40),
    ("repeat_b", "Write a haiku about paged attention.", 40),
    ("sampled", "Pick a random word.", 32),
]


def _serve_run(torch, argv, phase: str, prompts, chat_tokens: int = 48,
               probe=None, load=None, logits_check=None) -> dict:
    """The port's server built from `argv` (its weights from `load` where
    given, as _start_server takes it): `prompts` ((name, text,
    max_tokens), all concurrent) plus one streamed chat of `chat_tokens`;
    checks every answer, then the logits through the kernels against the
    plain versions (`logits_check(torch, engine)`, default _logits_check),
    then `probe(torch, engine, server)` where given.  Emits the phase
    summary and returns the kernel launch counts of the served requests
    (zeroed just before them, read just after)."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    model, server, thread = _start_server(torch, argv, phase, load=load)
    port, name = server.port, model.name
    chat = {"model": name, "stream": True, "max_tokens": chat_tokens,
            "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "user", "content": "Say something long."}]}

    metrics_before = _scrape(port)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_send: list = []
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts) + 1) as pool:
        futs = {
            label: pool.submit(_http, port, "POST", "/openai/v1/completions", {
                "model": name, "prompt": text, "max_tokens": n,
                "ignore_eos": True, **SAMPLED.get(label, {"temperature": 0})})
            for label, text, n in prompts
        }
        chat_fut = pool.submit(_stream_chat, port, chat, t_send)
        results = {label: f.result() for label, f in futs.items()}
        chat_status, events, ttft = chat_fut.result()
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    generated = 0
    texts = {}
    for label, text, n in prompts:
        status, body = results[label]
        if status != 200:
            raise AssertionError(f"{phase} completion {label} answered {status}: "
                                 f"{body[:300]!r}")
        resp = json.loads(body)
        got = resp["usage"]["completion_tokens"]
        if got != n or resp["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"{phase} completion {label}: {got} tokens, "
                                 f"wanted {n}")
        generated += got
        texts[label] = resp["choices"][0]["text"]
    if texts.get("repeat_a") != texts.get("repeat_b"):
        raise AssertionError("a repeated greedy prompt gave another text")
    if chat_status != 200 or events[-1] != "[DONE]":
        raise AssertionError(f"streamed chat answered {chat_status}, last event "
                             f"{events[-1] if events else None!r}")
    token_events = [json.loads(e) for e in events[1:-1]]
    if len(token_events) != chat_tokens:
        raise AssertionError(f"streamed chat gave {len(token_events)} token events")
    generated += len(token_events)
    telemetry = _telemetry_check(port, name, metrics_before, len(prompts) + 1,
                                 generated)
    # before the probe, which may dispatch more
    per_dispatch = _launches_per_dispatch(phase, model.engine, counts)

    logits = (logits_check or _logits_check)(torch, model.engine)
    decode_no_sync = _check_decode_has_no_sync(torch, model.engine)
    if probe is not None:
        probe(torch, model.engine, server)
    emit({
        "phase": phase, "model": f"{name} (random weights, seed 1)",
        "kv_quant": model.engine.config.kv_quant,
        "kv_cache_gb": _kv_cache_gb(model.engine),
        "requests": len(prompts) + 1, "tokens_generated": generated,
        "wall_s": wall, "tok_per_s": generated / wall, "chat_ttft_s": ttft,
        "engine_telemetry": telemetry,
        "engine_steps": model.engine.steps,
        "max_memory_allocated_gb": peak_gb,
        "launches": counts,
        "launches_per_dispatch": per_dispatch,
        "logits_check": logits,
        "decode_no_sync": decode_no_sync,
        "prompt_tokens": {label: len(model.tokenizer.encode(text))
                          for label, text, _ in prompts},
        "phase_wall_s": time.perf_counter() - t_phase,
    })
    _stop_server(torch, model, server, thread)
    return counts


def _check_decode_has_no_sync(torch, engine) -> dict:
    """One llama.decode_step on the served weights over a fresh cache of
    the engine's kind (8 lanes, one inactive), warm, then once more with
    CUDA sync debugging set to "error": the step, its decode attention
    calls among them, must not wait on the device (the split kernels plan
    from shapes alone and reuse their scratch).  The checked step must
    launch the decode kernel once per layer and give finite logits.  Then
    the same for one `decode_penalized_lp` dispatch of the engine's legacy
    programs (penalties on device counts, a seeded lane, top-k logprobs):
    steps_per_sync decode launches per layer, finite logprobs, and one
    count per live step added."""
    import numpy as np

    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    mc, ps = engine.model_config, engine.config.page_size
    steps = engine.config.steps_per_sync
    lens = [40, 100, 7, 0, 300, 1, 17, 64]
    B, W = len(lens), -(-(max(lens) + 1 + steps) // ps)
    pages = _fresh_cache(mc, ps, 1 + B * W, engine.config.kv_quant)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    table = ints([[1 + i * W + j for j in range(W)] for i in range(B)])
    pos = ints(lens)
    active = torch.tensor([n > 0 for n in lens], device="cuda")
    tokens = ints([65 + i for i in range(B)])
    key = "paged_decode_attention" + (
        "_int8" if engine.config.kv_quant == "int8" else "")
    with torch.inference_mode():
        llama.decode_step(engine.params, mc, tokens, pos, pages, table, active, ps)
        torch.cuda.synchronize()
        before = K.LAUNCHES[key]
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = llama.decode_step(engine.params, mc, tokens, pos, pages,
                                          table, active, ps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launched = K.LAUNCHES[key] - before
    finite = bool(torch.isfinite(logits).all())
    if launched != mc.n_layers or not finite:
        raise AssertionError(f"sync-checked decode step: {launched} {key} launches "
                             f"for {mc.n_layers} layers, finite logits {finite}")

    program = engine._legacy.get("decode_penalized_lp")
    params = ([SamplingParams(temperature=0.0, repetition_penalty=1.2, logprobs=5),
               SamplingParams(temperature=0.8, seed=3, frequency_penalty=0.5,
                              presence_penalty=0.3, logprobs=2)]
              + [SamplingParams(temperature=0.0)] * (B - 2))
    state = SamplingState.from_params(params, "cuda")
    prompt = torch.zeros((B, mc.vocab_size), dtype=torch.bool, device="cuda")
    prompt[:, 60:80] = True
    live = np.asarray([n > 0 for n in lens])
    host = dict(tokens=np.arange(65, 65 + B, dtype=np.int32),
                pos=np.asarray(lens, np.int32), page_table=table.cpu().numpy(),
                active=live, capacity=np.full(B, W * ps, np.int32),
                counters=np.ones(B, np.int32))
    gen = torch.Generator(device="cuda")

    def dispatch(counts):
        return program(engine.params, host["tokens"], host["pos"], pages,
                       host["page_table"], host["active"], host["capacity"],
                       host["counters"], state, gen, prompt, counts)

    with torch.inference_mode():
        dispatch(torch.zeros((B, mc.vocab_size), dtype=torch.int32, device="cuda"))
        counts = torch.zeros((B, mc.vocab_size), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        before = K.LAUNCHES[key]
        torch.cuda.set_sync_debug_mode("error")
        try:
            (toks, lp, top_vals, _), _, counts = dispatch(counts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    program_launches = K.LAUNCHES[key] - before
    lp_ok = bool(torch.isfinite(lp[:, live]).all() and (lp[:, live] <= 0).all()
                 and torch.isfinite(top_vals[:, live]).all())
    counted = int(counts.sum())
    del pages
    torch.cuda.empty_cache()
    if (program_launches != mc.n_layers * steps or not lp_ok
            or counted != steps * int(live.sum()) or toks.shape != (steps, B)):
        raise AssertionError(
            f"sync-checked decode_penalized_lp: {program_launches} {key} "
            f"launches for {mc.n_layers} layers x {steps} steps, logprobs "
            f"ok {lp_ok}, {counted} counts")
    return {"ok": True, "decode_launches": launched,
            "decode_penalized_lp_launches": program_launches}


def _launches_per_dispatch(phase: str, engine, counts: dict) -> dict:
    """The served launches against the engine's dispatches: a mixed
    dispatch launches the ragged kernel once per layer (step 0) and the
    decode kernel once per layer in each of its steps_per_sync - 1 decode
    steps; a dense (spec) dispatch launches the dense kernel once per
    layer per round; a legacy decode dispatch (`decode`, `decode_lp`,
    `decode_penalized`, `decode_penalized_lp`) the decode kernel once per
    layer in each of its steps_per_sync steps, and the legacy prefill
    programs none (their attention is plain PyTorch).  How many dispatches
    a phase runs follows the requests' arrival; the launches per dispatch
    must not move."""
    layers = engine.model_config.n_layers
    steps = engine.config.steps_per_sync
    mixed, dense = engine.steps, engine.dense_steps
    legacy = sum(n for name, n in engine.legacy_dispatches.items()
                 if name.startswith("decode"))
    sfx = "_int8" if engine.config.kv_quant == "int8" else ""
    per = {"ragged_paged_attention" + sfx: layers,
           "paged_decode_attention" + sfx: layers * (steps - 1),
           "dense_ragged_paged_attention" + sfx: layers * steps}
    per_legacy = {"paged_decode_attention" + sfx: layers * steps}
    want = {k: n * (dense if k.startswith("dense") else mixed)
            + per_legacy.get(k, 0) * legacy for k, n in per.items()}
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{phase}: launches {got} != {want} for {mixed} "
                             f"mixed, {dense} dense and {legacy} legacy decode "
                             f"dispatches")
    return {"mixed_dispatches": mixed, "dense_dispatches": dense,
            "legacy_decode_dispatches": legacy, "per_dispatch": per,
            "per_legacy_decode_dispatch": per_legacy,
            "legacy_dispatches": dict(engine.legacy_dispatches)}


def _require_launches(phase: str, counts: dict, launched, idle=()) -> None:
    """Every LAUNCHES key in `launched` ran in the phase, none in `idle`."""
    bad = ([k for k in launched if counts.get(k, 0) <= 0]
           + [k for k in idle if counts.get(k, 0) > 0])
    if bad:
        raise AssertionError(f"{phase}: unexpected launch counts of {bad}: {counts}")


def phase_serve(torch) -> dict:
    """The port's server at Llama-3-8B full width and depth: returns the
    kernel launch counts of the served requests."""
    counts = _serve_run(torch, SERVE_ARGS, "serve", SERVE_PROMPTS)
    _require_launches("serve", counts,
                      ("ragged_paged_attention", "paged_decode_attention"))
    return counts


D64_ARGS = ["--model_name=llama3-1b", "--model_config=llama3-1b",
            "--random_weights", "--http_port=0", "--device=cuda"]


def phase_d64(torch) -> dict:
    """Llama-3.2-1B (head_dim 64) at full depth in bf16: three completions
    and a streamed chat of 32 tokens, one prompt over a 16-token page.
    This is the served path of the decode kernel's d=64 instance (the port
    of _packed_decode_kernel) and of the ragged kernel at d=64."""
    prompts = [
        ("short", "Tell me about the sea.", 32),
        ("long", BASE_TEXT * 2, 32),  # 120 tokens: eight pages
        ("sampled", "Pick a random word.", 32),
    ]
    counts = _serve_run(torch, D64_ARGS, "d64", prompts, chat_tokens=32)
    _require_launches("d64", counts,
                      ("ragged_paged_attention", "paged_decode_attention"))
    return counts


# ---------------------------------------------------------------- checkpoint

# Llama-3's pre-tokenization regex (its tokenizer.json's Split pattern)
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_SPECIAL = {128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
                  128006: "<|start_header_id|>", 128007: "<|end_header_id|>",
                  128009: "<|eot_id|>"}
LLAMA3_TEMPLATE = (
    "{{ bos_token }}{% for m in messages %}<|start_header_id|>{{ m['role'] }}"
    "<|end_header_id|>\n\n{{ m['content'] | trim }}<|eot_id|>{% endfor %}"
    "{% if add_generation_prompt %}<|start_header_id|>assistant<|end_header_id|>"
    "\n\n{% endif %}")
# the words whose left-to-right merges make the smoke tokenizer's merge list
CKPT_WORDS = sorted(set((BASE_TEXT + " Tell me about the sea. Write a haiku "
                         "about paged attention. Say something long. Pick a "
                         "random word. The checkpoint is streamed").split()))
CKPT_PROMPTS = [("short", "Tell me about the sea.", 24),
                ("long", BASE_TEXT * 2, 24),
                ("numbers", "It's 2026: 12345 pages², Ⅻ layers, café — 你好", 24)]
# HF names of the Llama-3.2-1B layer tensors (Linear weights [out, in])
HF_LAYER_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def _write_smoke_tokenizer(model_dir: str) -> int:
    """A byte-level BPE tokenizer.json in Llama-3's form: the 256 byte
    tokens, then the tokens of merging each of CKPT_WORDS (and its
    space-prefixed form) left to right, Llama-3's Split regex and
    ignore_merges, and its special tokens at their ids; plus a
    tokenizer_config.json with a chat template.  Returns the merges."""
    from kserve_tpu_torch.engine.tokenizer_json import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for word in CKPT_WORDS + [" " + w for w in CKPT_WORDS]:
        chars = [b2u[b] for b in word.encode("utf-8")]
        cur = chars[0]
        for c in chars[1:]:
            if cur + c not in vocab:
                vocab[cur + c] = len(vocab)
                merges.append([cur, c])
            cur += c
    data = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": c, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for i, c in sorted(LLAMA3_SPECIAL.items())],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "chat_template": LLAMA3_TEMPLATE}, f)
    return len(merges)


def _write_checkpoint(torch, params, mc, model_dir: str) -> dict:
    """`params` in HF form: config.json and two safetensors shards written
    by the port's writer (models/safetensors_io.py)."""
    from kserve_tpu_torch.models.safetensors_io import save_file

    cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "vocab_size": mc.vocab_size, "hidden_size": mc.hidden_size,
           "intermediate_size": mc.intermediate_size,
           "num_hidden_layers": mc.n_layers, "num_attention_heads": mc.n_heads,
           "num_key_value_heads": mc.n_kv_heads, "head_dim": mc.head_dim,
           "rope_theta": mc.rope_theta, "rms_norm_eps": mc.rms_norm_eps,
           "max_position_embeddings": mc.max_position_embeddings,
           "tie_word_embeddings": mc.tie_word_embeddings, "hidden_act": "silu",
           "torch_dtype": "bfloat16"}
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    tensors = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"]}
    if "lm_head" in params:
        tensors["lm_head.weight"] = params["lm_head"].t()
    for i, layer in enumerate(params["layers"]):
        for key, value in layer.items():
            hf, transpose = HF_LAYER_NAMES[key]
            tensors[f"model.layers.{i}.{hf}"] = value.t() if transpose else value
    names = sorted(tensors)
    nbytes = {n: tensors[n].numel() * tensors[n].element_size() for n in names}
    half, acc, cut = sum(nbytes.values()) / 2, 0, len(names)
    for k, n in enumerate(names):
        acc += nbytes[n]
        if acc >= half:
            cut = k + 1
            break
    t0 = time.perf_counter()
    for shard, part in enumerate((names[:cut], names[cut:])):
        save_file({n: tensors[n] for n in part}, os.path.join(
            model_dir, f"model-{shard + 1:05d}-of-00002.safetensors"))
    return {"n_tensors": len(names), "bytes": sum(nbytes.values()),
            "write_s": time.perf_counter() - t0}


class _Records:
    """A logging handler that keeps the records of one logger."""

    def __init__(self, logger_name: str):
        import logging

        class Keep(logging.Handler):
            def __init__(self):
                super().__init__(logging.DEBUG)
                self.records = []

            def emit(self, record):
                self.records.append(record)

        self._logger = logging.getLogger(logger_name)
        self.handler = Keep()

    def __enter__(self):
        self._logger.addHandler(self.handler)
        return self.handler.records

    def __exit__(self, *exc):
        self._logger.removeHandler(self.handler)


class _Blocked:
    """`import <module>` raises ImportError inside the block (as on a
    machine without the package)."""

    def __init__(self, module: str):
        self.module = module

    def __enter__(self):
        self.had, self.saved = (self.module in sys.modules,
                                sys.modules.get(self.module))
        sys.modules[self.module] = None

    def __exit__(self, *exc):
        if self.had:
            sys.modules[self.module] = self.saved
        else:
            del sys.modules[self.module]


CKPT_MESSAGES = [{"role": "user", "content": "Say something about the sea."}]


def _chat_prompt_tokens(port: int, name: str) -> int:
    status, body = _http(port, "POST", "/openai/v1/chat/completions", {
        "model": name, "messages": CKPT_MESSAGES, "max_tokens": 8,
        "temperature": 0, "ignore_eos": True})
    if status != 200:
        raise AssertionError(f"checkpoint chat answered {status}: {body[:300]!r}")
    return json.loads(body)["usage"]["prompt_tokens"]


def _sequential_texts(port: int, name: str) -> dict:
    """CKPT_PROMPTS one after another (greedy, no eos stop): their texts."""
    out = {}
    for label, text, n in CKPT_PROMPTS:
        status, body = _http(port, "POST", "/openai/v1/completions", {
            "model": name, "prompt": text, "max_tokens": n, "temperature": 0,
            "ignore_eos": True})
        if status != 200:
            raise AssertionError(f"checkpoint completion {label} answered "
                                 f"{status}: {body[:300]!r}")
        resp = json.loads(body)
        if resp["usage"]["completion_tokens"] != n:
            raise AssertionError(f"checkpoint completion {label}: {resp['usage']}")
        out[label] = resp["choices"][0]["text"]
    return out


def phase_checkpoint(torch, info: Optional[dict] = None) -> None:
    """Llama-3.2-1B at full width and depth in bf16 served from a
    checkpoint: its seeded init_params written as two safetensors shards
    by the port's writer, an HF config.json, and a byte-level BPE
    tokenizer.json with Llama-3's split regex and special tokens, served
    with --model_dir (no --random_weights).  Gates: every loaded tensor
    bit-equal to the one written; the greedy completions equal those of a
    --model_dir --random_weights server (the same seed-1 weights drawn on
    the device, the same tokenizer); its chat prompt rendered by the
    tokenizer_config's template through jinja2 when jinja2 is installed,
    and the checkpoint server's (built with jinja2 blocked, as on a
    machine without it) by the default template, which it logs once, at
    load; the ragged and the d=64 decode kernels launched.  Prints the
    load rate, peak host staging, load wall and the tokenizer's encode
    rate on this host."""
    import dataclasses
    import importlib.util
    import shutil

    from kserve_tpu_torch.engine.tokenizer import BaseTokenizer, HFTokenizer
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    emit({"phase": "checkpoint", "event": "start",
          "model": "llama3-1b (seeded random weights, seed 1, bf16)"})
    model_dir = os.path.join(REPO, "build", "checkpoint_smoke")
    shutil.rmtree(model_dir, ignore_errors=True)
    os.makedirs(model_dir)
    try:
        mc = dataclasses.replace(llama.LlamaConfig.llama3_1b(), dtype="bfloat16")
        written = llama.init_params(mc, seed=1, device="cuda")
        ckpt = _write_checkpoint(torch, written, mc, model_dir)
        ckpt["merges"] = _write_smoke_tokenizer(model_dir)
        args = ["--model_name=llama3-1b-ckpt", f"--model_dir={model_dir}",
                "--http_port=0", "--device=cuda"]
        jinja2 = importlib.util.find_spec("jinja2") is not None

        # the reference: the same seed-1 weights drawn on the device
        model, server, thread = _start_server(
            torch, args + ["--random_weights"], "checkpoint")
        want = _sequential_texts(server.port, model.name)
        ref_tok = model.tokenizer
        rendered = {"mode": ref_tok.chat_template_mode,
                    "prompt_tokens": _chat_prompt_tokens(server.port, model.name)}
        _stop_server(torch, model, server, thread)
        del model
        if jinja2:
            import jinja2 as jinja2_mod

            text = jinja2_mod.Environment().from_string(LLAMA3_TEMPLATE).render(
                messages=CKPT_MESSAGES, add_generation_prompt=True,
                bos_token="", eos_token="")
        else:
            text = BaseTokenizer.apply_chat_template(ref_tok, CKPT_MESSAGES)
        if rendered != {"mode": "jinja2" if jinja2 else "default",
                        "prompt_tokens": len(ref_tok.encode(text))}:
            raise AssertionError(f"chat template with jinja2={jinja2}: {rendered}, "
                                 f"expected {len(ref_tok.encode(text))} tokens")

        with _Records("kserve_tpu_torch.engine.tokenizer") as records, \
                _Blocked("jinja2"):
            model, server, thread = _start_server(torch, args, "checkpoint")
        template_logs = [r.getMessage() for r in records if "jinja2" in r.getMessage()]
        port, name, tok = server.port, model.name, model.tokenizer
        engine = model.engine
        mismatched = [key for key, a, b in _param_pairs(written, engine.params)
                      if a.dtype != b.dtype or not torch.equal(a, b)]
        if mismatched:
            raise AssertionError(f"loaded tensors differ from the written ones: "
                                 f"{mismatched[:8]}")
        del written
        K.reset_launch_counts()
        got = _sequential_texts(port, name)
        chat_prompt = _chat_prompt_tokens(port, name)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        if got != want:
            raise AssertionError(f"checkpoint greedy texts {got} != the random-"
                                 f"weights server's {want}")
        default = tok.encode(BaseTokenizer.apply_chat_template(tok, CKPT_MESSAGES))
        if (tok.chat_template_mode != "default" or chat_prompt != len(default)
                or len(template_logs) != 1):
            raise AssertionError(
                f"without jinja2: mode {tok.chat_template_mode}, prompt "
                f"{chat_prompt} tokens against the default template's "
                f"{len(default)}, logged {template_logs}")
        _require_launches("checkpoint", counts,
                          ("ragged_paged_attention", "paged_decode_attention"))
        stats = model.weights_stats
        _stop_server(torch, model, server, thread)
        int8 = _checkpoint_int8(torch, mc, args)

        text = " ".join(t for _, t, _ in CKPT_PROMPTS) * 400
        encoder = HFTokenizer(model_dir)
        t0 = time.perf_counter()
        n_tokens = len(encoder.encode(text))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        encoder.encode(text)
        warm = time.perf_counter() - t0
        emit({
            "phase": "checkpoint", "card": info and info["nvidia_smi"],
            "checkpoint": ckpt, "tensors_bit_equal": ckpt["n_tensors"],
            "load": {**stats, "gb_per_s": stats["read_bytes"] / stats["seconds"] / 1e9},
            "greedy_equal_random_weights": sorted(got),
            "jinja2_installed": jinja2, "chat_with_jinja2_as_installed": rendered,
            "chat_without_jinja2": {"mode": tok.chat_template_mode,
                                    "prompt_tokens": chat_prompt,
                                    "logged": template_logs},
            "launches": counts,
            "bpe_encode": {"tokens": n_tokens, "chars": len(text),
                           "cold_tok_per_s": n_tokens / cold,
                           "warm_tok_per_s": n_tokens / warm},
            "int8": int8,
            "phase_wall_s": time.perf_counter() - t_phase,
        })
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


def _checkpoint_int8(torch, mc, args) -> dict:
    """The checkpoint served with --weight_quant int8: quantized on the
    host tensor by tensor as it streams in (quantize_array_np), held to a
    server whose engine quantizes the same seed-1 bf16 weights on the card
    (quantize_params): every int8 leaf and scale bit-equal, the greedy
    texts equal, the ragged and the d=64 decode kernels launched.  Returns
    the load's accounting (peak host staging among it) and the resident
    bytes."""
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.models.quant import is_quantized, param_bytes
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    wq = ["--weight_quant=int8"]
    model, server, thread = _start_server(
        torch, args + ["--random_weights"] + wq, "checkpoint_int8",
        load=lambda: llama.init_params(mc, seed=1, device="cuda"))
    want = _sequential_texts(server.port, model.name)
    reference = model.engine.params
    _stop_server(torch, model, server, thread)
    model, server, thread = _start_server(torch, args + wq, "checkpoint_int8")
    loaded = model.engine.params
    mismatched, n_int8 = [], 0
    for key, a, b in _param_pairs(reference, loaded):
        if is_quantized(a):
            n_int8 += 1
            same = (is_quantized(b) and a["q"].dtype == b["q"].dtype == torch.int8
                    and torch.equal(a["q"], b["q"]) and torch.equal(a["s"], b["s"]))
        else:
            same = not is_quantized(b) and a.dtype == b.dtype and torch.equal(a, b)
        if not same:
            mismatched.append(key)
    del reference
    K.reset_launch_counts()
    got = _sequential_texts(server.port, model.name)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    stats = dict(model.weights_stats)
    resident = _tensor_bytes(torch, loaded)
    del loaded
    _stop_server(torch, model, server, thread)
    if mismatched or n_int8 != 7 * mc.n_layers + 1:
        raise AssertionError(f"int8 checkpoint load differs from quantize_params "
                             f"in {mismatched[:8]} ({n_int8} int8 leaves)")
    if got != want:
        raise AssertionError(f"int8 checkpoint greedy texts {got} != those of "
                             f"quantize_params of the same weights {want}")
    _require_launches("checkpoint_int8", counts,
                      ("ragged_paged_attention", "paged_decode_attention"))
    return {"load": {**stats, "gb_per_s": stats["read_bytes"] / stats["seconds"] / 1e9},
            "int8_leaves_bit_equal": n_int8,
            "weights_gb": resident / 1e9,
            "param_bytes_gb": {"bf16": param_bytes(mc) / 1e9,
                               "int8": param_bytes(mc, "int8") / 1e9},
            "greedy_equal_quantize_params": sorted(got), "launches": counts}


def _tensor_bytes(torch, tree) -> int:
    """Device bytes of every tensor in a parameter tree."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(torch, v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tensor_bytes(torch, v) for v in tree)
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    return 0


def _param_pairs(a: dict, b: dict):
    """(key, a's tensor, b's tensor) over two parameter dicts; raises on
    a key one of them lacks."""
    if sorted(a) != sorted(b) or len(a["layers"]) != len(b["layers"]):
        raise AssertionError(f"parameter keys differ: {sorted(a)} / {sorted(b)}")
    for key in sorted(k for k in a if k != "layers"):
        yield key, a[key], b[key]
    for i, (la, lb) in enumerate(zip(a["layers"], b["layers"])):
        if sorted(la) != sorted(lb):
            raise AssertionError(f"layer {i} keys differ: {sorted(la)} / {sorted(lb)}")
        for key in sorted(la):
            yield f"layers.{i}.{key}", la[key], lb[key]


SPEC_K = 3


SPEC_PROMPTS = [
    ("short", "Tell me about the sea.", 48),
    ("medium", BASE_TEXT * 6, 56),
    ("repetitive", "ab " * 40, 64),  # bigrams the drafter can follow
    ("haiku", "Write a haiku about paged attention.", 64),
    ("sampled", "Pick a random word.", 48),
]


def _spec_run(torch, argv, phase: str, check_no_sync: bool = False,
              prompts=SPEC_PROMPTS, decode_no_sync: bool = False, load=None,
              logits_check=None) -> dict:
    """A --spec_decode_k=SPEC_K server built from `argv` (a model at full
    width and depth; its weights from `load` where given): `prompts`
    concurrently, the draft statistics, one verify round's logits through
    the kernels against the plain versions (`logits_check`, default
    _logits_check), with `decode_no_sync` one decode step under CUDA sync
    debugging and, with `check_no_sync`, two chained dispatches on the
    served engine under CUDA sync debugging.  Returns the kernel launch
    counts of the served requests."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    emit({"phase": phase, "event": "start",
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    model, server, thread = _start_server(torch, argv, phase, load=load)
    engine = model.engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
        futs = {
            label: pool.submit(_http, server.port, "POST", "/openai/v1/completions", {
                "model": model.name, "prompt": text, "max_tokens": n,
                "ignore_eos": True, **SAMPLED.get(label, {"temperature": 0})})
            for label, text, n in prompts
        }
        results = {label: f.result() for label, f in futs.items()}
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    generated = 0
    for label, _, n in prompts:
        status, body = results[label]
        if status != 200:
            raise AssertionError(f"{phase} completion {label} answered {status}: "
                                 f"{body[:300]!r}")
        resp = json.loads(body)
        got = resp["usage"]["completion_tokens"]
        if got != n or resp["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"{phase} completion {label}: {got} tokens "
                                 f"({resp['choices'][0]['finish_reason']}), wanted {n}")
        generated += got
    stats = dict(engine.spec_stats)
    dense = "dense_ragged_paged_attention" + (
        "_int8" if engine.config.kv_quant == "int8" else "")
    _require_launches(phase, counts, (dense,))
    if not (stats["drafted"] > 0
            and stats["drafted"] == stats["accepted"] + stats["rejected"]):
        raise AssertionError(f"draft statistics do not add up: {stats}")
    logits = (logits_check or _logits_check)(torch, engine, verify_k=SPEC_K)
    summary = {
        "phase": phase, "model": f"{model.name} (random weights, seed 1)",
        "kv_quant": engine.config.kv_quant, "kv_cache_gb": _kv_cache_gb(engine),
        "spec_decode_k": SPEC_K, "requests": len(prompts),
        "prompt_tokens": {label: len(model.tokenizer.encode(text))
                          for label, text, _ in prompts},
        "tokens_generated": generated, "wall_s": wall,
        "tok_per_s": generated / wall, "spec_stats": stats,
        "acceptance": stats["accepted"] / stats["drafted"],
        "mixed_dispatches": engine.steps, "dense_dispatches": engine.dense_steps,
        "chained_dispatches": engine.chained_dispatches,
        "max_memory_allocated_gb": peak_gb,
        "launches": counts,
        "launches_per_dispatch": _launches_per_dispatch(phase, engine, counts),
        "logits_check": logits,
    }
    if decode_no_sync:
        summary["decode_no_sync"] = _check_decode_has_no_sync(torch, engine)
    if check_no_sync:
        summary["no_sync_dispatch"] = _check_dispatch_has_no_sync(torch, engine)
    summary["phase_wall_s"] = time.perf_counter() - t_phase
    emit(summary)
    del engine
    _stop_server(torch, model, server, thread)
    return counts


def phase_spec(torch) -> dict:
    """The port's server with --spec_decode_k=3 at Llama-3-8B full width
    and depth, then the f32 2-layer spec-on/off identity: returns the
    kernel launch counts of the served requests."""
    counts = _spec_run(torch, SERVE_ARGS + [f"--spec_decode_k={SPEC_K}"], "spec")
    emit(_spec_identity_f32(torch))
    return counts


def phase_kvq(torch) -> dict:
    """The int8 KV cache at Llama-3-8B full width and depth: the serve
    phase's requests with --kv_quant=int8, then the spec phase's with
    --kv_quant=int8 --spec_decode_k=3.  Every attention of both runs must
    go through an int8 kernel instance (the bf16-page instances launch
    never); returns {"kvq": counts, "kvq_spec": counts}."""
    int8 = ["--kv_quant=int8"]
    counts = _serve_run(torch, SERVE_ARGS + int8, "kvq", SERVE_PROMPTS)
    _require_launches("kvq", counts, ("ragged_paged_attention_int8",
                                      "paged_decode_attention_int8"),
                      _ATTENTION_KEYS)
    spec_counts = _spec_run(
        torch, SERVE_ARGS + int8 + [f"--spec_decode_k={SPEC_K}"], "kvq_spec",
        check_no_sync=True)
    _require_launches("kvq_spec", spec_counts,
                      ("dense_ragged_paged_attention_int8",), _ATTENTION_KEYS)
    return {"kvq": counts, "kvq_spec": spec_counts}


GEMMA_ARGS = ["--model_name=gemma2-2b", "--model_config=gemma2-2b",
              "--random_weights", "--http_port=0", "--device=cuda",
              "--max_model_len=8192", f"--spec_decode_k={SPEC_K}"]
GEMMA_PROMPTS = SPEC_PROMPTS[:3] + [
    # 4,300 tokens: five chunks over the 1,024 bucket, the last past the
    # 4,096-token window of the sliding layers, then decode past it
    ("past_window", (BASE_TEXT * 71)[:4300], 32),
    ("sampled", "Pick a random word.", 48),
]


def phase_gemma2(torch) -> dict:
    """Gemma-2-2B (head_dim 256, softcap 50, 4,096-token windows on
    alternate layers, scale 256^-0.5) at full width and depth with
    --spec_decode_k=3, over bf16 pages and then with --kv_quant=int8:
    GEMMA_PROMPTS concurrently (one prompt past the window), each run's
    logits, paired attention calls and no-sync checks.  The first mixed
    dispatches launch the ragged and decode kernels, the later rounds the
    dense one: together the two runs launch every d=256 bf16-q instance,
    and neither launches the other's.  Returns {"gemma2": counts,
    "gemma2_int8": counts}."""
    int8_keys = tuple(k + "_int8" for k in _ATTENTION_KEYS)
    counts = _spec_run(torch, GEMMA_ARGS, "gemma2", prompts=GEMMA_PROMPTS,
                       decode_no_sync=True)
    _require_launches("gemma2", counts, _ATTENTION_KEYS, int8_keys)
    int8 = _spec_run(torch, GEMMA_ARGS + ["--kv_quant=int8"], "gemma2_int8",
                     prompts=GEMMA_PROMPTS, decode_no_sync=True)
    _require_launches("gemma2_int8", int8, int8_keys, _ATTENTION_KEYS)
    return {"gemma2": counts, "gemma2_int8": int8}


# 32 usable pages of 16 tokens (512 positions) for six completions that
# need 8-10 pages each: the cache cannot hold them all
PRESSURE_PAGES = 33
PRESSURE_PROMPTS = [
    (f"p{i}", (BASE_TEXT * 2)[: 24 + 7 * i], 96) for i in range(5)
] + [("sampled", "Pick a random word.", 96)]


def _start_pressure_server(torch, phase: str, extra_args=()):
    return _start_server(
        torch, SERVE_ARGS + [f"--kv_pages={PRESSURE_PAGES}", *extra_args], phase)


def phase_pressure(torch) -> dict:
    """Llama-3-8B at full width and depth on PRESSURE_PAGES KV pages (see
    _pressure_run).  Returns the kernel launch counts of the served
    requests."""
    t_phase = time.perf_counter()
    model, server, thread = _start_pressure_server(torch, "pressure")
    counts = _pressure_run(torch, model, server, "pressure", t_phase)
    _stop_server(torch, model, server, thread)
    return counts


def _pressure_run(torch, model, server, phase: str, t_phase: float) -> dict:
    """Six concurrent completions that the cache cannot hold at once.  The
    engine must preempt (and re-prefill, or on a --kv_offload=host server
    inject the spilled pages back) rather than truncate: every completion
    reaches its max_tokens with finish_reason "length" at exactly that
    count, preemption_count > 0, and every page is free afterwards but
    those the prefix cache alone holds.  Returns the kernel launch counts
    of the served requests."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.ops import paged_attention_cuda as K

    engine = model.engine
    K.reset_launch_counts()
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(PRESSURE_PROMPTS)) as pool:
        futs = {
            label: pool.submit(_http, server.port, "POST", "/openai/v1/completions", {
                "model": model.name, "prompt": text, "max_tokens": n,
                "ignore_eos": True, **SAMPLED.get(label, {"temperature": 0})})
            for label, text, n in PRESSURE_PROMPTS
        }
        results = {label: f.result() for label, f in futs.items()}
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    finished = {}
    for label, _, n in PRESSURE_PROMPTS:
        status, body = results[label]
        if status != 200:
            raise AssertionError(f"{phase} completion {label} answered {status}: "
                                 f"{body[:300]!r}")
        resp = json.loads(body)
        got = resp["usage"]["completion_tokens"]
        reason = resp["choices"][0]["finish_reason"]
        finished[label] = [got, reason]
        if got != n or reason != "length":
            raise AssertionError(f"{phase} completion {label}: {got} tokens "
                                 f"({reason}), wanted {n}: truncated")
    free = engine.allocator.free_pages
    cached = engine._prefix_cache.pages_held_alone()
    if engine.preemption_count <= 0 or free + cached != PRESSURE_PAGES - 1:
        raise AssertionError(f"{phase}: {engine.preemption_count} preemptions, "
                             f"{free} free and {cached} held by the cache alone of "
                             f"{PRESSURE_PAGES - 1} pages after")
    _require_launches(phase, counts, ("ragged_paged_attention",
                                      "paged_decode_attention"))
    generated = sum(n for _, _, n in PRESSURE_PROMPTS)
    emit({"phase": phase, "model": f"{model.name} (random weights, seed 1)",
          "kv_pages": PRESSURE_PAGES, "kv_cache_gb": _kv_cache_gb(engine),
          "requests": len(PRESSURE_PROMPTS),
          "prompt_tokens": {label: len(model.tokenizer.encode(text))
                            for label, text, _ in PRESSURE_PROMPTS},
          "completions": finished, "preemption_count": engine.preemption_count,
          "kv_tier_counts": engine.kv_tier_counts,
          "prefix_cache_hits": engine.prefix_cache_hits,
          "pages_free_after": free, "pages_cached_after": cached,
          "mixed_dispatches": engine.steps, "tokens_generated": generated,
          "wall_s": wall, "tok_per_s": generated / wall, "launches": counts,
          "phase_wall_s": time.perf_counter() - t_phase})
    return counts


def _check_dispatch_has_no_sync(torch, engine) -> dict:
    """Enqueue one mixed_decode dispatch and one chained on it with CUDA
    sync debugging set to "error": any operation that waits on the device
    (a blocking copy, .item(), nonzero, boolean-mask indexing) raises.
    Returns what the two dispatches emitted."""
    import numpy as np

    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState

    B, ps = engine.config.max_batch_size, engine.config.page_size
    pos = np.asarray([5, 40, 100, 17] + [0] * (B - 4), np.int32)
    live = pos > 0
    per_lane = -(-(int(pos.max()) + 2 * engine._max_step_advance) // ps)
    table = np.zeros((B, per_lane), np.int32)
    pages = engine.allocator.allocate(int(live.sum()) * per_lane)
    table[live] = np.asarray(pages, np.int32).reshape(-1, per_lane)
    plan = {
        "tokens": np.arange(B, dtype=np.int32) + 65, "pos": pos, "live": live,
        "capacity": np.where(live, per_lane * ps, 0).astype(np.int32),
        "counters": np.ones(B, np.int32), "page_table": table,
        "adapters": np.full(B, -1, np.int32),
        "state": SamplingState.from_params(
            [SamplingParams(temperature=0.0)] * (B - 1)
            + [SamplingParams(temperature=0.8, top_k=50, seed=3)], "cuda"),
    }
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = engine._dispatch_dense(plan)
        second = engine._dispatch_dense(plan, chain=first)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    emitted = [int(engine._wait_host(c)[1].sum()) for c in (first, second)]
    engine.allocator.free(pages)
    if min(emitted) <= 0:
        raise AssertionError(f"sync-checked dispatches emitted {emitted} tokens")
    return {"ok": True, "tokens_emitted": emitted}


def _teacher_engine_class(LLMEngine, upload, streams: dict):
    """An LLMEngine whose draft-table rows hold the bigrams of each lane's
    prompt plus its spec-off greedy stream (`streams`: prompt tuple ->
    tokens), so a draft is the token greedy decode emits next unless that
    token recurs with another successor.  Random weights accept almost no
    bigram drafts of their own; these are accepted, and must reproduce the
    reference token for token."""
    import numpy as np

    class TeacherDrafts(LLMEngine):
        def _refresh_draft_table(self):
            dirty = self._draft_dirty
            super()._refresh_draft_table()
            for i, slot in enumerate(self._slots):
                if ((dirty is not None and i not in dirty)
                        or slot.request_id is None or slot.prefilling is not None):
                    continue
                seq = np.asarray(slot.prompt_ids + streams[tuple(slot.prompt_ids)])
                row = np.full((self.model_config.vocab_size,), -1, np.int32)
                row[seq[:-1]] = seq[1:]
                self._draft_table[i] = upload(row, self.device)

    return TeacherDrafts


def _spec_identity_f32(torch) -> dict:
    """Greedy streams with speculative decoding on against off, in float32
    at Llama-3-8B width and 2 layers (bf16 noise of a random model flips
    near-tied argmaxes; f32 does not): once with the engine's own bigram
    drafts, once with drafts taken from the reference streams (so that
    rounds accept drafts).  A stream that differs fails unless the
    reference's top-2 logit gap at the first differing token is within the
    f32 logits tolerance (a tie the two paths may break either way)."""
    import asyncio
    import dataclasses
    import gc

    from kserve_tpu_torch.device import upload
    from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from kserve_tpu_torch.engine.kvcache import KVCacheConfig, init_kv_pages
    from kserve_tpu_torch.engine.sampling import SamplingParams
    from kserve_tpu_torch.engine.tokenizer import load_tokenizer
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import attention as A

    mc = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2,
                             dtype="float32")
    params = llama.init_params(mc, seed=1, device="cuda")
    tok = load_tokenizer(None, mc.vocab_size)
    ec = dict(max_batch_size=8, page_size=16, num_pages=512,
              max_pages_per_seq=128, max_prefill_len=1024, dtype="float32")
    prompts = [tok.encode(t) for t in (
        "Tell me about the sea.", "ab " * 40,
        "Write a haiku about paged attention.", "Pick a random word.")]
    n_tokens = 48

    async def streams(engine):
        async def one(ids):
            sp = SamplingParams(temperature=0.0, max_tokens=n_tokens, ignore_eos=True)
            return [o.token_id async for o in engine.generate(ids, sp)]

        await engine.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*[one(p) for p in prompts]), 600)
        finally:
            await engine.stop()

    off = LLMEngine(mc, EngineConfig(**ec), tok, params=params, device="cuda")
    ref = asyncio.run(streams(off))
    del off
    gc.collect()
    on = LLMEngine(mc, EngineConfig(spec_decode_k=SPEC_K, **ec), tok,
                   params=params, device="cuda")
    got = asyncio.run(streams(on))
    teacher_cls = _teacher_engine_class(
        LLMEngine, upload, {tuple(p): a for p, a in zip(prompts, ref)})
    teacher = teacher_cls(mc, EngineConfig(spec_decode_k=SPEC_K, **ec), tok,
                          params=params, device="cuda")
    taught = asyncio.run(streams(teacher))
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731

    def ref_logits(seq):
        """Plain f32 logits after `seq` (one lane, plain attention)."""
        n, W = len(seq), -(-len(seq) // 16)
        pages = init_kv_pages(KVCacheConfig(
            n_layers=mc.n_layers, n_kv_heads=mc.n_kv_heads, head_dim=mc.head_dim,
            page_size=16, num_pages=1 + W, dtype="float32"), "cuda")
        with torch.inference_mode():
            logits, _ = llama.forward_ragged(
                params, mc, ints(seq), ints([0] * n), ints(list(range(n))),
                ints([0]), ints([n]), ints([0]), pages,
                ints([list(range(1, W + 1))]), 16, ints([n - 1]),
                attention_fn=A.ragged_paged_attention_plain)
        return logits[0]

    def compare(engine, streams_on, drafts: str) -> dict:
        differing = []
        for i, (a, b) in enumerate(zip(ref, streams_on)):
            if len(a) != n_tokens or len(b) != n_tokens:
                raise AssertionError(f"f32 stream {i}: {len(a)} / {len(b)} tokens")
            if a == b:
                continue
            j = next(t for t in range(n_tokens) if a[t] != b[t])
            logits = ref_logits(prompts[i] + a[:j])
            top2 = torch.topk(logits, 2).values
            gap = float(top2[0] - top2[1])
            tol = F32_LOGITS_REL_TOL * float(logits.abs().max())
            differing.append({"stream": i, "token": j, "top2_gap": gap, "tol": tol})
            if gap > tol:
                raise AssertionError(
                    f"f32 greedy stream {i} differs spec-on ({drafts} drafts) "
                    f"vs spec-off at token {j} with top-2 gap {gap} > tol {tol}")
        if engine.dense_steps <= 0:
            raise AssertionError("the f32 spec engine never ran a dense dispatch")
        return {"drafts": drafts,
                "identical": sum(a == b for a, b in zip(ref, streams_on)),
                "differing": differing, "spec_stats": dict(engine.spec_stats),
                "dense_dispatches": engine.dense_steps,
                "chained_dispatches": engine.chained_dispatches}

    out = {"phase": "spec", "check": "f32_2layer_greedy_identity",
           "streams": len(ref), "tokens_each": n_tokens,
           "runs": [compare(on, got, "bigram"), compare(teacher, taught, "reference")]}
    if teacher.spec_stats["accepted"] <= 0:
        raise AssertionError(
            f"reference drafts were never accepted: {teacher.spec_stats}")
    out["no_sync_dispatch"] = _check_dispatch_has_no_sync(torch, on)
    del on, teacher, params
    gc.collect()
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------- legacy

# (label, prompt, max_tokens, sampling fields): beside two plain greedy
# completions, three that the mixed program does not serve, so every
# iteration they are seated in runs the legacy programs; the plain ones
# run 16 tokens longer and finish on `mixed`
LEGACY_TOP = 5
LEGACY_PROMPTS = [
    ("logprobs", "Tell me about the sea.", 32,
     {"temperature": 0, "logprobs": LEGACY_TOP}),
    ("penalized", BASE_TEXT * 3, 32,
     {"temperature": 0, "frequency_penalty": 0.5, "presence_penalty": 0.3}),
    ("rep_seeded", "Pick a random word.", 32,
     {"temperature": 0.8, "seed": 11, "repetition_penalty": 1.2}),
    ("plain_a", "Write a haiku about paged attention.", 48, {"temperature": 0}),
    ("plain_b", BASE_TEXT * 6, 48, {"temperature": 0}),
]
LEGACY_CHAT_TOKENS = 32
# the whole-engine route: more slots than one 1,024-token ragged buffer
# holds at the kernel's 8-token alignment (128), an int8 cache
LEGACY_BATCH = 160
LEGACY_B_TOKENS = 24
LEGACY_B_PROMPTS = [
    (f"r{i}", f"Request {i}: tell me about the sea.", LEGACY_B_TOKENS)
    for i in range(LEGACY_BATCH - 2)
] + [("long", (BASE_TEXT * 40)[:1200], LEGACY_B_TOKENS),  # 1,201 tokens
     ("sampled", "Pick a random word.", LEGACY_B_TOKENS)]


def _check_greedy_top(label: str, token: str, logprob: float, top) -> None:
    """A greedy token's logprob entry: at most LEGACY_TOP alternatives as
    (token text, logprob) best first, the token the top-1 entry (unless
    the top two tie, which top-k may order either way) and its logprob
    equal to that entry's."""
    if not (logprob <= 0.0 and 1 <= len(top) <= LEGACY_TOP
            and top[0][1] == logprob
            and (top[0][0] == token or top[1][1] == top[0][1])):
        raise AssertionError(f"legacy {label}: greedy token {token!r} "
                             f"logprob {logprob} against top {top}")


def _check_completion_logprobs(label: str, resp: dict, n: int) -> None:
    """The completions logprobs block: one entry per token, each value <=
    0, each top_logprobs dict ({token text: logprob}, the sampled token
    folded in) of at most LEGACY_TOP entries, and greedy tokens on top."""
    lp = resp["choices"][0]["logprobs"]
    if not (len(lp["tokens"]) == len(lp["token_logprobs"]) == len(lp["text_offset"])
            == len(lp["top_logprobs"]) == n):
        raise AssertionError(f"legacy {label}: logprobs of {n} tokens: {lp}")
    for tok, value, top in zip(lp["tokens"], lp["token_logprobs"], lp["top_logprobs"]):
        ranked = sorted(top.items(), key=lambda kv: -kv[1])
        _check_greedy_top(label, tok, value, ranked)
        if top.get(tok) != value:
            raise AssertionError(f"legacy {label}: {tok!r} {value} not in {top}")


def _legacy_requests(torch, server, name, prompts, chat=None):
    """`prompts` (and the streamed `chat` body) concurrently: (results
    {label: (status, body)}, chat (status, events, ttft), wall s, kernel
    launch counts zeroed just before and read just after)."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.ops import paged_attention_cuda as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts) + 1) as pool:
        futs = {
            label: pool.submit(_http, server.port, "POST", "/openai/v1/completions", {
                "model": name, "prompt": text, "max_tokens": n,
                "ignore_eos": True, **fields})
            for label, text, n, fields in prompts
        }
        chat_fut = (pool.submit(_stream_chat, server.port, chat, [])
                    if chat is not None else None)
        results = {label: f.result() for label, f in futs.items()}
        chat_out = chat_fut.result() if chat_fut is not None else None
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    return results, chat_out, wall, dict(K.LAUNCHES)


def _completed(phase: str, results: dict, prompts) -> dict:
    """Every completion answered 200 with exactly its max_tokens; returns
    the parsed bodies."""
    out = {}
    for label, _, n, _ in prompts:
        status, body = results[label]
        if status != 200:
            raise AssertionError(f"{phase} completion {label} answered {status}: "
                                 f"{body[:300]!r}")
        resp = json.loads(body)
        got = resp["usage"]["completion_tokens"]
        if got != n or resp["choices"][0]["finish_reason"] != "length":
            raise AssertionError(f"{phase} completion {label}: {got} tokens, "
                                 f"wanted {n}")
        out[label] = resp
    return out


def _profile_call(torch, fn) -> dict:
    """Wall ms of one call to a synchronize (best of 3, warm), and the
    device busy ms (kernels' summed device time) and kernel launches of
    one more call under torch.profiler."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, launches = 0.0, 0
    for ev in prof.key_averages():
        # kernels only: CPU-side ops also report their kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if ev.self_device_time_total > 0:
            busy += ev.self_device_time_total / 1e3
            launches += ev.count
    return {"wall_ms": min(walls) * 1e3, "device_busy_ms": busy,
            "kernel_launches": launches, "profiled_wall_ms": prof_wall * 1e3,
            "device_idle_share": max(0.0, 1 - busy / (prof_wall * 1e3))}


def _legacy_dispatch_times(torch, engine, lanes: int) -> dict:
    """Wall and device time of one `prefill` (prefill_batch prompts of 48
    tokens), `decode` and `decode_penalized_lp` dispatch (`lanes` greedy
    lanes of 40-100 cached tokens; penalties and top-5 logprobs on every
    lane of the latter) of the engine's legacy programs on its weights
    over a fresh cache of its kind."""
    import numpy as np

    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState

    mc, ec = engine.model_config, engine.config
    ps, steps, Bp = ec.page_size, ec.steps_per_sync, ec.prefill_batch
    lens = np.asarray([40 + (7 * i) % 61 for i in range(lanes)], np.int32)
    W = -(-(int(lens.max()) + 1 + steps) // ps)
    pages = _fresh_cache(mc, ps, 1 + lanes * W, ec.kv_quant)
    table = (1 + np.arange(lanes * W, dtype=np.int32)).reshape(lanes, W)
    rng = np.random.RandomState(5)
    prompts = rng.randint(0, mc.vocab_size, (Bp, 64)).astype(np.int32)
    valid = np.full(Bp, 48, np.int32)
    gen = torch.Generator(device="cuda")
    greedy = [SamplingParams(temperature=0.0)]
    penal = [SamplingParams(temperature=0.0, repetition_penalty=1.2,
                            frequency_penalty=0.5, logprobs=5)]
    state = {k: SamplingState.from_params(v * n, "cuda") for k, v, n in (
        ("prefill", greedy, Bp), ("decode", greedy, lanes),
        ("penalized", penal, lanes))}
    counts = torch.zeros((lanes, mc.vocab_size), dtype=torch.int32, device="cuda")
    prompt = torch.zeros((lanes, mc.vocab_size), dtype=torch.bool, device="cuda")
    prompt[:, 100:140] = True
    decode_args = (engine.params, np.full(lanes, 65, np.int32), lens, pages,
                   table, np.ones(lanes, bool), np.full(lanes, W * ps, np.int32),
                   np.ones(lanes, np.int32))
    legacy = engine._legacy
    calls = {
        "prefill": lambda: legacy.get("prefill")(
            engine.params, prompts, valid, pages, table[:Bp], state["prefill"],
            gen),
        "decode": lambda: legacy.get("decode")(*decode_args, state["decode"], gen),
        "decode_penalized_lp": lambda: legacy.get("decode_penalized_lp")(
            *decode_args, state["penalized"], gen, prompt, counts),
    }
    with torch.inference_mode():
        out = {name: _profile_call(torch, fn) for name, fn in calls.items()}
    del pages, counts, prompt
    torch.cuda.empty_cache()
    out["lanes"] = lanes
    return out


def phase_legacy(torch) -> None:
    """The legacy programs on the card, Llama-3-8B at full width and depth
    (seeded random weights):

    (a) the serve phase's engine (8 slots, bf16): LEGACY_PROMPTS and a
        streamed chat with logprobs and top_logprobs concurrently.  Every
        completion reaches max_tokens; each logprobs block has one entry
        per token, values <= 0, at most LEGACY_TOP alternatives, greedy
        tokens on top; the engine ran both mixed and legacy decode
        dispatches, with the per-dispatch launches of each.
    (b) --kv_quant=int8 --max_batch_size=160 (the batch that raised before
        the legacy route), LEGACY_B_PROMPTS concurrently, one of 1,201
        tokens: the engine resolved to the legacy route and never launched
        the ragged kernel, every legacy decode dispatch launched the int8
        decode kernel n_layers x steps_per_sync times, and every
        completion reached max_tokens.

    Each part holds the prefill and decode programs' logits through the
    kernels to the plain versions (_logits_check with `legacy`), checks a
    decode_penalized_lp dispatch for host syncs and times one prefill,
    decode and decode_penalized_lp dispatch."""
    t_phase = time.perf_counter()
    emit({"phase": "legacy", "event": "start",
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    model, server, thread = _start_server(torch, SERVE_ARGS, "legacy")
    engine = model.engine
    chat = {"model": model.name, "stream": True,
            "max_tokens": LEGACY_CHAT_TOKENS, "temperature": 0,
            "ignore_eos": True, "logprobs": True, "top_logprobs": LEGACY_TOP,
            "messages": [{"role": "user", "content": "Say something long."}]}
    results, (chat_status, events, ttft), wall, counts = _legacy_requests(
        torch, server, model.name, LEGACY_PROMPTS, chat)
    resps = _completed("legacy", results, LEGACY_PROMPTS)
    _check_completion_logprobs("logprobs", resps["logprobs"], 32)
    if chat_status != 200 or events[-1] != "[DONE]":
        raise AssertionError(f"legacy chat answered {chat_status}")
    token_events = [json.loads(e) for e in events[1:-1]]
    if len(token_events) != LEGACY_CHAT_TOKENS:
        raise AssertionError(f"legacy chat gave {len(token_events)} token events")
    for ev in token_events:
        (entry,) = ev["choices"][0]["logprobs"]["content"]
        _check_greedy_top("chat", entry["token"], entry["logprob"],
                          [(t["token"], t["logprob"]) for t in entry["top_logprobs"]])
    legacy_decodes = sum(n for k, n in engine.legacy_dispatches.items()
                         if k.startswith("decode"))
    if engine.steps <= 0 or legacy_decodes <= 0:
        raise AssertionError(f"legacy: {engine.steps} mixed and {legacy_decodes} "
                             f"legacy decode dispatches; wanted both")
    _require_launches("legacy", counts, ("paged_decode_attention",
                                         "ragged_paged_attention"))
    generated = sum(n for _, _, n, _ in LEGACY_PROMPTS) + LEGACY_CHAT_TOKENS
    summary = {
        "phase": "legacy", "part": "per_iteration",
        "model": f"{model.name} (random weights, seed 1)",
        "kv_quant": engine.config.kv_quant,
        "requests": len(LEGACY_PROMPTS) + 1, "tokens_generated": generated,
        "wall_s": wall, "tok_per_s": generated / wall, "chat_ttft_s": ttft,
        "launches": counts,
        "launches_per_dispatch": _launches_per_dispatch("legacy", engine, counts),
        "programs_built": engine._legacy.built,
        "logits_check": _logits_check(torch, engine, legacy=True),
        "decode_no_sync": _check_decode_has_no_sync(torch, engine),
        "dispatch_times": _legacy_dispatch_times(
            torch, engine, engine.config.max_batch_size),
    }
    del engine
    _stop_server(torch, model, server, thread)
    t_part = time.perf_counter()
    emit(dict(summary, part_wall_s=t_part - t_phase))

    model, server, thread = _start_server(
        torch, SERVE_ARGS + ["--kv_quant=int8", f"--max_batch_size={LEGACY_BATCH}"],
        "legacy_b160")
    engine = model.engine
    if engine._use_mixed:
        raise AssertionError("max_batch_size 160 resolved to the mixed program")
    prompts = [(label, text, n, SAMPLED.get(label, {"temperature": 0}))
               for label, text, n in LEGACY_B_PROMPTS]
    results, _, wall, counts = _legacy_requests(torch, server, model.name, prompts)
    _completed("legacy_b160", results, prompts)
    int8_decode = "paged_decode_attention_int8"
    every_key = _ATTENTION_KEYS + tuple(k + "_int8" for k in _ATTENTION_KEYS)
    _require_launches("legacy_b160", counts, (int8_decode,),
                      [k for k in every_key if k != int8_decode])
    used = engine.legacy_dispatches
    if used["prefill"] <= 0 or used["prefill_chunk"] < 2:
        raise AssertionError(f"legacy_b160: legacy dispatches {used}; wanted "
                             f"batched prefills and a chunked prompt")
    generated = LEGACY_BATCH * LEGACY_B_TOKENS
    summary = {
        "phase": "legacy", "part": "whole_engine",
        "model": f"{model.name} (random weights, seed 1)",
        "kv_quant": engine.config.kv_quant, "kv_cache_gb": _kv_cache_gb(engine),
        "max_batch_size": LEGACY_BATCH, "requests": len(prompts),
        "prompt_tokens_long": len(model.tokenizer.encode(LEGACY_B_PROMPTS[-2][1])),
        "tokens_generated": generated, "wall_s": wall,
        "tok_per_s": generated / wall, "launches": counts,
        "launches_per_dispatch": _launches_per_dispatch("legacy_b160", engine, counts),
        "programs_built": engine._legacy.built,
        "logits_check": _logits_check(torch, engine, legacy=True),
        "decode_no_sync": _check_decode_has_no_sync(torch, engine),
        "dispatch_times": _legacy_dispatch_times(torch, engine, LEGACY_BATCH),
    }
    del engine
    _stop_server(torch, model, server, thread)
    done = time.perf_counter()
    emit(dict(summary, part_wall_s=done - t_part, phase_wall_s=done - t_phase))



# ---------------------------------------------------------------- prefix

# BOS + "<|system|>\n" + PREFIX_SYSTEM + "\n" is 1,040 byte-tokenizer
# tokens (65 pages of 16): the system prompt the chat template renders
# first, and the head of every completion of the phase
PREFIX_SYSTEM = (BASE_TEXT * 20)[:1027]
SHARED_TEXT = "<|system|>\n" + PREFIX_SYSTEM + "\n"
SHARED_PAGES = 65
# tokens of each completion's own tail after the shared prefix; each tail
# starts with its own letter, so no two share a page past the prefix
PREFIX_TAILS = [20, 56, 92, 128, 164, 200]
PREFIX_MAX_TOKENS = 24
PREFIX_CHAT_TOKENS = 32
# TTFT of a 1,201-token prompt cold, then of one with the same first
# 1,184 tokens (74 pages) that the cold one left in the cache
TTFT_DOC_BYTES = 1183
TTFT_CACHED_PAGES = 74
TTFT_REPS = 3


def _prefix_tail(i: int, n: int) -> str:
    return (f"{'ABCDEF'[i]} question {i}: " + BASE_TEXT * 4)[:n]


def _ttft_pairs(model, port: int) -> dict:
    """TTFT_REPS pairs of streamed 1,201-token completions on an idle
    server: a cold prompt (no page cached), then one that shares its first
    TTFT_CACHED_PAGES pages (1,184 tokens) and prefills 17."""
    engine, ps = model.engine, model.engine.config.page_size
    cold, hit = [], []
    for k in range(TTFT_REPS):
        doc = (f"Document {k}. " + BASE_TEXT * 30)[:TTFT_DOC_BYTES]
        for tail, times, want in (("Cold tail follows", cold, 0),
                                  ("Warm tail follows", hit, TTFT_CACHED_PAGES)):
            if len(model.tokenizer.encode(doc + tail)) != 1201:
                raise AssertionError("TTFT prompt is not 1,201 tokens")
            h0 = engine.prefix_cache_hits
            status, events, ttft = _stream_chat(port, {
                "model": model.name, "prompt": doc + tail, "max_tokens": 4,
                "temperature": 0, "ignore_eos": True, "stream": True}, [],
                path="/openai/v1/completions")
            n = sum(1 for e in events if e != "[DONE]")
            got = engine.prefix_cache_hits - h0
            if status != 200 or n != 4 or got != want:
                raise AssertionError(f"TTFT request: status {status}, {n} tokens, "
                                     f"{got} pages hit, wanted {want}")
            times.append(ttft)
    return {"prompt_tokens": 1201, "cached_tokens": TTFT_CACHED_PAGES * ps,
            "cold_ttft_s": cold, "hit_ttft_s": hit,
            "cold_ttft_median_s": statistics.median(cold),
            "hit_ttft_median_s": statistics.median(hit)}


def _prefix_logits_check(torch, engine, tail: int = 64) -> dict:
    """First-token logits of a prompt of SHARED_PAGES cached pages plus
    `tail` tokens, prefilled through a prefix hit (another request wrote
    the prefix's pages; the tail's chunk enters the ragged kernel at
    kv_start = the cached tokens), against a cold prefill of the whole
    prompt in the engine's chunks, both through the kernels, on the served
    weights and an f32 copy, over a cache of the engine's kind:

    - float32: within F32_LOGITS_REL_TOL of the largest |logit|, over
      either cache (both sides read int8 pages alike, so the model's int8
      noise, the cold f32 prompt over int8 pages against over f32 pages,
      is printed only);
    - bfloat16: within BF16_NOISE_FACTOR times the model's bf16 noise
      (the cold bf16 prompt against the cold f32 one);
    - each attention call of the hit chunk, paired with its plain version
      on the same inputs and cache: within ATTN_F32_REL_TOL (f32) or
      _bf16_tol (bf16), as in _logits_check."""
    import dataclasses

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import attention as A

    mc16 = engine.model_config
    mc32 = dataclasses.replace(mc16, dtype="float32")
    kv_quant, ps = engine.config.kv_quant, engine.config.page_size
    chunk = engine.config.prefill_buckets[-1]
    cached = SHARED_PAGES * ps
    N = cached + tail
    W = -(-N // ps)
    dev = engine.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    ids = torch.randint(0, mc16.vocab_size, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    table = torch.arange(1, W + 1, dtype=torch.int32, device=dev)[None]
    worst = {}  # dtype -> (err, tol) of the paired call closest to its tol

    def paired(q, pages, *args, **kw):
        ref = A.ragged_paged_attention_plain(q, pages, *args, **kw)
        got = A.ragged_paged_attention(q, pages, *args, **kw)
        diff = float((got.float() - ref.float()).abs().max())
        if ref.dtype == torch.float32:
            err, tol = diff / max(1.0, float(ref.float().abs().max())), ATTN_F32_REL_TOL
        else:
            err, tol = diff, _bf16_tol(ref.float())
        key = str(ref.dtype)
        if key not in worst or err / tol > worst[key][0] / worst[key][1]:
            worst[key] = (err, tol)
        return ref

    def forward(params, mc, pages, start, n, attention_fn=None):
        """One lane's chunk of n tokens at kv_start `start`: its last
        token's logits."""
        logits, _ = llama.forward_ragged(
            params, mc, ids[start:start + n], ints([0] * n),
            torch.arange(start, start + n, dtype=torch.int32, device=dev),
            ints([0]), ints([n]), ints([start]), pages, table, ps, ints([n - 1]),
            attention_fn=attention_fn)
        return logits

    def prefill(params, mc, pages, end):
        for start in range(0, end, chunk):
            out = forward(params, mc, pages, start, min(chunk, end - start))
        return out

    def run(params, mc, cache_kind):
        """(cold logits, hit logits) through the kernels; the hit chunk
        then runs once more with every attention call paired."""
        cold = prefill(params, mc, _fresh_cache(mc, ps, 1 + W, cache_kind, dev), N)
        pages = _fresh_cache(mc, ps, 1 + W, cache_kind, dev)
        prefill(params, mc, pages, cached)
        hit = forward(params, mc, pages, cached, tail)
        forward(params, mc, pages, cached, tail, attention_fn=paired)
        return cold, hit

    with torch.inference_mode():
        params32 = _f32_params(torch, engine.params)
        cold32, hit32 = run(params32, mc32, kv_quant)
        if kv_quant == "int8":
            plain_cache32 = prefill(params32, mc32,
                                    _fresh_cache(mc32, ps, 1 + W, "none", dev), N)
        del params32
        cold16, hit16 = run(engine.params, mc16, kv_quant)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    scale = float(cold32.abs().max())
    row = {
        "prompt_tokens": N, "cached_tokens": cached,
        "f32_max_abs_err": float((hit32 - cold32).abs().max()),
        "f32_tol": F32_LOGITS_REL_TOL * scale, "max_abs_logit": scale,
        "bf16_max_abs_err": float((hit16 - cold16).abs().max()),
        "bf16_noise": float((cold16 - cold32).abs().max()),
        "attn_f32_max_rel_err": worst["torch.float32"][0],
        "attn_f32_tol": ATTN_F32_REL_TOL,
        "attn_bf16_max_abs_err": worst["torch.bfloat16"][0],
        "attn_bf16_tol": worst["torch.bfloat16"][1],
        "bf16_argmax_agree": bool((hit16.argmax(-1) == cold16.argmax(-1)).all()),
    }
    row["bf16_tol"] = BF16_NOISE_FACTOR * row["bf16_noise"]
    if kv_quant == "int8":
        row["int8_noise_f32"] = float((cold32 - plain_cache32).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (hit32, hit16))
    if not (finite and row["f32_max_abs_err"] <= row["f32_tol"]
            and row["bf16_max_abs_err"] <= row["bf16_tol"]
            and all(e <= t for e, t in worst.values())):
        raise AssertionError(f"prefix-hit logits disagree with a cold prefill: {row}")
    return row


def _prefix_run(torch, argv, phase: str) -> dict:
    """The server built from `argv`: one completion with the shared prefix
    (its 65 pages enter the cache), then PREFIX_TAILS completions and a
    streamed chat with the same prefix, concurrently; the TTFT pairs and
    the hit-vs-cold logits check.  Returns the kernel launch counts of the
    served requests (zeroed before the first, read after the concurrent
    ones)."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    model, server, thread = _start_server(torch, argv, phase)
    engine, port, name = model.engine, server.port, model.name
    sfx = "_int8" if engine.config.kv_quant == "int8" else ""
    if len(model.tokenizer.encode(SHARED_TEXT)) != SHARED_PAGES * engine.config.page_size:
        raise AssertionError("the shared prefix is not 65 pages")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    status, body = _http(port, "POST", "/openai/v1/completions", {
        "model": name, "prompt": SHARED_TEXT + "Z: warm the cache.",
        "max_tokens": 8, "temperature": 0, "ignore_eos": True})
    if status != 200:
        raise AssertionError(f"{phase} warm-up answered {status}: {body[:300]!r}")
    hits0 = engine.prefix_cache_hits
    prompts = [(f"tail{n}", SHARED_TEXT + _prefix_tail(i, n), PREFIX_MAX_TOKENS)
               for i, n in enumerate(PREFIX_TAILS)]
    chat = {"model": name, "stream": True, "max_tokens": PREFIX_CHAT_TOKENS,
            "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "system", "content": PREFIX_SYSTEM},
                         {"role": "user", "content": "Answer in one long line."}]}
    t_run = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts) + 1) as pool:
        futs = {label: pool.submit(_http, port, "POST", "/openai/v1/completions", {
            "model": name, "prompt": text, "max_tokens": n, "temperature": 0,
            "ignore_eos": True}) for label, text, n in prompts}
        chat_fut = pool.submit(_stream_chat, port, chat, [])
        results = {label: f.result() for label, f in futs.items()}
        chat_status, events, chat_ttft = chat_fut.result()
    wall = time.perf_counter() - t_run
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    hits = engine.prefix_cache_hits - hits0
    _completed(phase, results, [(label, text, n, None) for label, text, n in prompts])
    if chat_status != 200 or events[-1] != "[DONE]" or len(events) != PREFIX_CHAT_TOKENS + 2:
        raise AssertionError(f"{phase} chat answered {chat_status} with "
                             f"{len(events)} events")
    if hits < len(PREFIX_TAILS) * SHARED_PAGES:
        raise AssertionError(f"{phase}: {hits} prefix-cache page hits, wanted at "
                             f"least {len(PREFIX_TAILS)} x {SHARED_PAGES}")
    _require_launches(phase, counts, ("ragged_paged_attention" + sfx,
                                      "paged_decode_attention" + sfx))
    summary = {
        "phase": phase, "model": f"{name} (random weights, seed 1)",
        "kv_quant": engine.config.kv_quant,
        "shared_prefix_tokens": SHARED_PAGES * engine.config.page_size,
        "tail_tokens": PREFIX_TAILS, "requests": len(prompts) + 2,
        "prefix_cache_hits": hits, "wall_s": wall, "chat_ttft_s": chat_ttft,
        "launches": counts,
        "launches_per_dispatch": _launches_per_dispatch(phase, engine, counts),
        "ttft": _ttft_pairs(model, port),
        "hit_logits_check": _prefix_logits_check(torch, engine),
    }
    del engine
    _stop_server(torch, model, server, thread)
    emit(dict(summary, phase_wall_s=time.perf_counter() - t_phase))
    return counts


def phase_prefix(torch) -> dict:
    """Shared-prefix traffic at Llama-3-8B full width and depth, over bf16
    pages and then --kv_quant=int8: the prefix cache's hits, the ragged
    kernel over cached pages, TTFT cold against hit, and hit-vs-cold
    logits.  Returns the launch counts of both runs."""
    return {"prefix": _prefix_run(torch, SERVE_ARGS, "prefix"),
            "prefix_int8": _prefix_run(torch, SERVE_ARGS + ["--kv_quant=int8"],
                                       "prefix_int8")}


# ---------------------------------------------------------------- tiers

TIERS_DIR = os.path.join(REPO, "build", "chip_smoke_kv")
# the tiers phase's demote / page-in drill on PRESSURE_PAGES pages: a
# 300-token prompt (18 full pages), a 400-token one that evicts them, and
# the first again
PAGEIN_TEXT = ("Page-in prefix. " + BASE_TEXT * 8)[:299]
EVICT_TEXT = ("Eviction filler. " + BASE_TEXT * 12)[:399]


def _inject_round_trip(torch, kv_quant: str) -> dict:
    """SHARED_PAGES pages of a Llama-3-8B-shaped cache (32 layers, 8 KV
    heads, head_dim 128, 16-token pages) filled at random, gathered
    (compiled.gather_pages), read to the host, written to the disk tier
    (.npz, bf16 as int16 bits), read back and injected into other page
    ids (inject / inject_q: pages and scales).  Every injected page must
    equal its source bit for bit, and the decode kernel over the injected
    pages must give exactly its output over the originals.  Times each
    leg on the host clock with the device synchronised."""
    from kserve_tpu_torch.engine.compiled import gather_pages, inject, inject_q
    from kserve_tpu_torch.kvstore import KVTierStore, TierConfig
    from kserve_tpu_torch.ops import attention as A

    L, nkv, d, ps, n = 32, 8, 128, 16, SHARED_PAGES
    P = 2 * n + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    shape = (P, 2, nkv, ps, d)
    if kv_quant == "int8":
        cache = [(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                dtype=torch.int8),
                  torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02)
                 for _ in range(L)]
    else:
        cache = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(L)]
    src = list(range(1, n + 1))
    dst = list(range(2 * n, n, -1))  # other ids, in reverse order
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    host = timed("gather_fetch_ms", lambda: {
        k: v.cpu() for k, v in gather_pages(cache, src).items()})
    nbytes = sum(t.numel() * t.element_size() for t in host.values())
    store = KVTierStore(TierConfig(host_bytes=1, disk_bytes=2 * nbytes,
                                   disk_dir=TIERS_DIR))
    try:
        if not timed("disk_put_ms", lambda: store.put("spill", host)):
            raise AssertionError("the disk tier refused the payload")
        if store.tier_of("spill") != "disk":
            raise AssertionError("the payload did not land on disk")
        back = timed("disk_get_ms", lambda: store.get("spill"))
    finally:
        store.close()
    if kv_quant == "int8":
        timed("inject_ms", lambda: inject_q(cache, back["kv_q"], back["kv_s"], dst))
    else:
        timed("inject_ms", lambda: inject(cache, back["kv"], dst))
    s, t = (torch.tensor(ix, device="cuda") for ix in (src, dst))
    bits = (lambda x: x) if kv_quant == "int8" else (lambda x: x.view(torch.int16))
    for layer in cache:
        for part in (layer if kv_quant == "int8" else (layer,)):
            if not torch.equal(bits(part[t]), bits(part[s])):
                raise AssertionError(f"{kv_quant} inject round trip is not bit-exact")
    q = torch.randn((4, 32, d), generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.tensor([n * ps, 700, 33, 1], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        for layer in (cache[0], cache[-1]):
            outs = [A.paged_attention(q, layer,
                                      tab.to(torch.int32)[None].expand(4, -1).contiguous(),
                                      lens) for tab in (s, t)]
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{kv_quant} decode over injected pages differs")
    del cache
    torch.cuda.empty_cache()
    return {"kv_quant": kv_quant, "pages": n, "layers": L, "bytes": nbytes,
            **times, "inject_gb_per_s": nbytes / times["inject_ms"] / 1e6,
            "bit_exact": True, "decode_equal": True}


def _demote_page_in(model, port: int) -> dict:
    """On the tiers server: PAGEIN_TEXT (its 18 full pages cached), then
    EVICT_TEXT, whose admission evicts them (they demote to the host
    tier), then PAGEIN_TEXT again, which pages them back in and is served
    from them.  Demotions, page-ins and adopted hits must all grow."""
    engine = model.engine
    before = engine.prefix_store_stats()
    for text in (PAGEIN_TEXT, EVICT_TEXT, PAGEIN_TEXT):
        status, body = _http(port, "POST", "/openai/v1/completions", {
            "model": model.name, "prompt": text, "max_tokens": 8,
            "temperature": 0, "ignore_eos": True})
        if status != 200 or json.loads(body)["usage"]["completion_tokens"] != 8:
            raise AssertionError(f"page-in drill answered {status}: {body[:300]!r}")
    after = engine.prefix_store_stats()
    delta = {k: after[k] - before[k] for k in
             ("demotions", "pageins", "pagein_tokens", "hits", "misses",
              "adopted_hit_tokens")}
    if min(delta["demotions"], delta["pageins"], delta["adopted_hit_tokens"]) <= 0:
        raise AssertionError(f"page-in drill: {delta}")
    return {"delta": delta, "pagein_seconds": list(engine.pagein_seconds),
            "store_events": {f"{t}/{e}": n for (t, e), n in
                             sorted(engine._kv_store.events.items())}}


def phase_tiers(torch) -> None:
    """The KV tiers on the card: (a) the inject round trip, bf16 and int8
    pages; (b) the pressure phase's traffic with --kv_offload=host
    --kv_offload_gib=1: preempted lanes spill and are injected back
    (spills and resumes by inject > 0, every completion at max_tokens, no
    spill left in the tiers); (c) on the same server, a prefix evicted,
    demoted and paged back in."""
    t_phase = time.perf_counter()
    emit({"phase": "tiers", "part": "inject_round_trip", "cases": [
        _inject_round_trip(torch, kind) for kind in ("none", "int8")]})
    model, server, thread = _start_pressure_server(
        torch, "tiers_pressure", ["--kv_offload=host", "--kv_offload_gib=1",
                                  f"--kv_offload_dir={TIERS_DIR}"])
    _pressure_run(torch, model, server, "tiers_pressure", time.perf_counter())
    engine = model.engine
    counts = dict(engine.kv_tier_counts)
    spill_left = engine._kv_store.spill_bytes
    if counts["spills"] <= 0 or counts["resume_injects"] <= 0 or spill_left:
        raise AssertionError(f"tiers_pressure: {counts}, {spill_left} spill bytes "
                             f"left in the tiers")
    drill = _demote_page_in(model, server.port)
    summary = {"phase": "tiers", "part": "offload",
               "kv_tier_counts": counts, "spill_bytes_left": spill_left,
               "offload_bytes_after": engine._offload_bytes,
               "preemption_count": engine.preemption_count,
               "demote_page_in": drill}
    del engine
    _stop_server(torch, model, server, thread)
    emit(dict(summary, phase_wall_s=time.perf_counter() - t_phase))


# ---------------------------------------------------------------- lifecycle

LIFECYCLE_MAX_TOKENS = 256
# the drain budget of server A: every seated stream is past 16 tokens when
# the drain starts and, at ~8 tokens a dispatch, far from 256 when it ends
LIFECYCLE_GRACE_S = 1.0
LIFECYCLE_MIN_SHOWN = 16
LIFECYCLE_LONG = (BASE_TEXT * 40)[:1200]  # 1,201 tokens: crosses the 1,024 chunk
# 8 seated streams (7 greedy, one seeded sampled, one of them the long
# prompt), then 2 that must queue behind them
LIFECYCLE_PROMPTS = (
    [("long", LIFECYCLE_LONG)]
    + [(f"g{i}", f"Lane {i}: " + BASE_TEXT * (1 + i)) for i in range(1, 7)]
    + [("sampled", "Pick a random word and keep going.")]
    + [("queued_a", "Queued first: " + BASE_TEXT), ("queued_b", "Queued second.")])
# the deadline lanes outlast their seating (in threes, under the shed
# watermark) and the queued request's 0.5 s budget several times over
LIFECYCLE_DEADLINE_TOKENS = 128
LIFECYCLE_SHED_BURST = 24
LIFECYCLE_SHED_TOKENS = 32
LIFECYCLE_SHED_WATERMARK = 4
LIFECYCLE_SHED_SPACING_S = 0.025
COLD_BUILD_DIR = os.path.join(REPO, "build", "lifecycle_cold_build")


def _http_h(port: int, method: str, path: str, body=None, headers=None,
            timeout=600):
    """(status, lower-cased response headers, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                resp.read())
    finally:
        conn.close()


class _Stream:
    """One streamed completion read on its own thread: its SSE events as
    they come, their arrival times and the first one's latency.  With
    `stop_after`, the client goes away after that many events."""

    def __init__(self, port: int, body: dict, headers=None, stop_after=None):
        import threading

        self.port, self.body, self.headers = port, body, headers or {}
        self.stop_after = stop_after
        self.status = None
        self.events: list = []
        self.ttft = None
        self.t_end = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "_Stream":
        self.thread.start()
        return self

    def _run(self):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            t0 = time.perf_counter()
            conn.request("POST", "/openai/v1/completions",
                         body=json.dumps(self.body),
                         headers={"Content-Type": "application/json", **self.headers})
            resp = conn.getresponse()
            self.status = resp.status
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                if self.ttft is None:
                    self.ttft = time.perf_counter() - t0
                self.events.append(line[len("data: "):])
                if self.stop_after is not None and len(self.events) >= self.stop_after:
                    break
        except Exception as e:  # noqa: BLE001 — reported by the caller's checks
            self.error = e
        finally:
            self.t_end = time.perf_counter()
            conn.close()

    def join(self, timeout=600) -> "_Stream":
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise AssertionError(f"stream {self.body.get('prompt', '')[:20]!r} hung")
        if self.error is not None:
            raise AssertionError(f"stream failed: {self.error!r}")
        return self

    @property
    def token_events(self) -> list:
        return [json.loads(e) for e in self.events
                if e != "[DONE]" and "choices" in json.loads(e)]


def _wait_for(cond, what: str, timeout: float = 300.0) -> None:
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"lifecycle: timed out waiting for {what}")


def _seated(engine, what: str) -> None:
    """Wait until the engine's queue is empty again: on server B requests
    go in one at a time, so the queue never reaches the shed watermark
    before the burst that is meant to."""
    _wait_for(lambda: engine.queue_depth == 0, what)


def _lc_body(name: str, prompt: str, label: str, max_tokens=LIFECYCLE_MAX_TOKENS,
             stream=True) -> dict:
    body = {"model": name, "prompt": prompt, "max_tokens": max_tokens,
            "ignore_eos": True, **SAMPLED.get(label, {"temperature": 0})}
    if stream:
        body.update(stream=True, stream_options={"include_usage": True})
    return body


def _metric(scrape: dict, name: str, **labels) -> float:
    return scrape.get((name, tuple(sorted(labels.items()))), 0.0)


def _watchdog_ok(phase: str, engine) -> dict:
    snap = engine.scheduler_state().get("watchdog")
    if snap is None or snap["state"] != "ok" or snap["suspected_total"] != 0:
        raise AssertionError(f"{phase}: watchdog {snap}, wanted state ok and no "
                             f"suspicion")
    return snap


def _drain_wave(model, port: int) -> dict:
    """Server A: 8 seated streams and 2 queued, a drain once every seated
    stream has LIFECYCLE_MIN_SHOWN tokens, the gates while it drains, and
    every stream ending on its checkpoint."""
    engine, name = model.engine, model.name
    before = _scrape(port)
    seated = [_Stream(port, _lc_body(name, text, label)).start()
              for label, text in LIFECYCLE_PROMPTS[:8]]
    _wait_for(lambda: engine.scheduler_state()["inflight"] == 8, "8 seated lanes")
    queued = [_Stream(port, _lc_body(name, text, label)).start()
              for label, text in LIFECYCLE_PROMPTS[8:]]
    _wait_for(lambda: engine.queue_depth == 2, "2 queued requests")
    _wait_for(lambda: all(len(s.events) >= LIFECYCLE_MIN_SHOWN for s in seated),
              f"{LIFECYCLE_MIN_SHOWN} tokens on every seated stream")
    t_drain = time.perf_counter()
    status, _, body = _http_h(port, "POST", "/admin/drain")
    if status != 200:
        raise AssertionError(f"POST /admin/drain answered {status}")
    seen_state = json.loads(body)["lifecycle"]
    ready = _http_h(port, "GET", "/v2/health/ready")
    live = _http_h(port, "GET", "/v2/health/live")
    refused = _http_h(port, "POST", "/openai/v1/completions",
                      _lc_body(name, "late", "late", 8, stream=False))
    gates = {"lifecycle_at_drain": seen_state, "ready": ready[0],
             "ready_body": json.loads(ready[2]), "live": live[0],
             "new_post": refused[0], "retry_after": refused[1].get("retry-after")}
    if (ready[0] != 503 or live[0] != 200 or refused[0] != 503
            or refused[1].get("retry-after") != "1"):
        raise AssertionError(f"lifecycle gates while draining: {gates}")
    checkpoints = {}
    for (label, _), stream in zip(LIFECYCLE_PROMPTS, seated + queued):
        stream.join()
        last = json.loads(stream.events[-1]) if stream.events else {}
        if (stream.status != 200 or "[DONE]" in stream.events
                or last.get("error", {}).get("type") != "generation_preempted"):
            raise AssertionError(f"lifecycle: stream {label} did not end on a "
                                 f"checkpoint: {stream.events[-2:]}")
        from kserve_tpu_torch.lifecycle import GenerationCheckpoint

        ckpt = GenerationCheckpoint.from_header(last["checkpoint"])
        shown = len(stream.events) - 1
        if ckpt is None or len(ckpt.generated) != shown or ckpt.reason != "drain":
            raise AssertionError(f"lifecycle: {label}'s checkpoint holds "
                                 f"{None if ckpt is None else len(ckpt.generated)} "
                                 f"tokens, the stream showed {shown}")
        if label.startswith("queued") and shown != 0:
            raise AssertionError(f"lifecycle: queued {label} streamed {shown} tokens")
        checkpoints[label] = (last["checkpoint"], ckpt, stream.t_end)
    drain_wall = max(t for _, _, t in checkpoints.values()) - t_drain
    after = _scrape(port)
    n_ckpt = (_metric(after, "generation_checkpoints_total", model_name=name,
                      reason="drain")
              - _metric(before, "generation_checkpoints_total", model_name=name,
                        reason="drain"))
    if n_ckpt != 10 or engine.checkpointed_count != 10:
        raise AssertionError(f"lifecycle: {n_ckpt} drain checkpoints counted, "
                             f"engine {engine.checkpointed_count}, wanted 10")
    _wait_for(lambda: model.engine is not None and not engine._has_live_work(),
              "the drained engine to go idle")
    return {"checkpoints": checkpoints, "drain_wall_s": drain_wall, "gates": gates,
            "salvaged": {label: len(c.generated)
                         for label, (_, c, _) in checkpoints.items()},
            "watchdog": _watchdog_ok("lifecycle_a", engine)}


def _resume_wave(model, port: int, checkpoints: dict) -> dict:
    """Server B: every checkpoint resumed through the header, streamed,
    one at a time until 8 are seated (the last 2 queue behind them, so the
    queue never reaches the shed watermark): each continuation plus what A
    sent makes exactly LIFECYCLE_MAX_TOKENS, finished by length."""
    engine, name = model.engine, model.name
    before = _scrape(port)
    resumes0 = engine.resume_count
    streams = {}
    for i, (label, text) in enumerate(LIFECYCLE_PROMPTS):
        header = checkpoints[label][0]
        streams[label] = _Stream(port, _lc_body(name, text, label),
                                 {"x-generation-checkpoint": header}).start()
        _wait_for(lambda: engine.resume_count > resumes0 + i, f"resume {label}")
        if i < 8:
            _seated(engine, f"resume {label} seated")
    out = {}
    for label, stream in streams.items():
        stream.join()
        salvaged = len(checkpoints[label][1].generated)
        tokens = stream.token_events
        usage = tokens[-1].get("usage") or {} if tokens else {}
        finish = tokens[-1]["choices"][0]["finish_reason"] if tokens else None
        if (stream.status != 200 or stream.events[-1] != "[DONE]"
                or salvaged + len(tokens) != LIFECYCLE_MAX_TOKENS
                or usage.get("completion_tokens") != LIFECYCLE_MAX_TOKENS
                or finish != "length"):
            raise AssertionError(
                f"lifecycle: resumed {label}: status {stream.status}, {salvaged} "
                f"salvaged + {len(tokens)} continued, usage {usage}, finish {finish}")
        out[label] = {"salvaged": salvaged, "continued": len(tokens)}
    after = _scrape(port)
    resumes = (_metric(after, "generation_resumes_total", model_name=name)
               - _metric(before, "generation_resumes_total", model_name=name))
    salvaged_metric = (
        _metric(after, "generation_tokens_salvaged_total", model_name=name)
        - _metric(before, "generation_tokens_salvaged_total", model_name=name))
    salvaged = sum(v["salvaged"] for v in out.values())
    if resumes != 10 or salvaged_metric != salvaged:
        raise AssertionError(f"lifecycle: {resumes} resumes counted (wanted 10), "
                             f"{salvaged_metric} tokens salvaged counted (wanted "
                             f"{salvaged})")
    return {"streams": out, "tokens_salvaged": salvaged}


def _deadline_and_state(model, port: int) -> dict:
    """Server B: x-request-deadline 0 answers 504 before handling; with 8
    lanes decoding, the scheduler state reads 8 in flight, the allocator's
    free pages, READY and a quiet watchdog, and a 9th request with a 0.5 s
    budget answers 504 from the queue while the 8 complete."""
    from concurrent.futures import ThreadPoolExecutor

    engine, name = model.engine, model.name
    before = _scrape(port)
    upfront = _http_h(port, "POST", "/openai/v1/completions",
                      _lc_body(name, "late", "late", 8, stream=False),
                      {"x-request-deadline": "0"})
    if upfront[0] != 504:
        raise AssertionError(f"x-request-deadline: 0 answered {upfront[0]}")
    prompts = [(f"d{i}", f"Deadline lane {i}. " + BASE_TEXT * i) for i in range(8)]
    with ThreadPoolExecutor(max_workers=9) as pool:
        futs = []
        for group in (prompts[:3], prompts[3:6], prompts[6:]):
            futs += [pool.submit(_http, port, "POST", "/openai/v1/completions",
                                 _lc_body(name, text, label,
                                          LIFECYCLE_DEADLINE_TOKENS, stream=False))
                     for label, text in group]
            _wait_for(lambda: engine.scheduler_state()["inflight"] == len(futs),
                      f"{len(futs)} deadline lanes seated")
        for _ in range(20):  # a read between two dispatches' page growth
            free0 = engine.allocator.free_pages
            state = json.loads(_http(port, "GET", "/v1/internal/scheduler/state")[1])
            if engine.allocator.free_pages == free0:
                break
        t0 = time.perf_counter()
        late = pool.submit(_http_h, port, "POST", "/openai/v1/completions",
                           _lc_body(name, "Too late. " + BASE_TEXT, "late",
                                    LIFECYCLE_DEADLINE_TOKENS, stream=False),
                           {"x-request-deadline": "0.5"})
        late_status = late.result()[0]
        late_s = time.perf_counter() - t0
        results = {label: f.result() for (label, _), f in zip(prompts, futs)}
    _completed("lifecycle_deadline", results,
               [(label, None, LIFECYCLE_DEADLINE_TOKENS, None) for label, _ in prompts])
    after = _scrape(port)
    rejected = {c: _metric(after, "resilience_deadline_rejected_total", component=c)
                - _metric(before, "resilience_deadline_rejected_total", component=c)
                for c in ("rest", "engine")}
    wd = state["models"][name].get("watchdog", {})
    checks = {"inflight": state["inflight"], "free_pages": state["free_pages"],
              "allocator_free_pages": free0, "lifecycle": state["lifecycle"],
              "watchdog": wd}
    if (late_status != 504 or rejected != {"rest": 1.0, "engine": 1.0}
            or state["inflight"] != 8 or state["free_pages"] != free0
            or state["lifecycle"] != "READY" or wd.get("state") != "ok"
            or wd.get("suspected_total") != 0):
        raise AssertionError(f"lifecycle deadlines/state: late {late_status}, "
                             f"rejected {rejected}, state {checks}")
    return {"upfront_status": upfront[0], "queued_status": late_status,
            "queued_504_after_s": late_s, "deadline_rejected": rejected,
            "scheduler_state": checks}


def _shed_burst(model, port: int) -> dict:
    """Server B (KSERVE_TPU_SHED_WATERMARK=4): two bursts of
    LIFECYCLE_SHED_BURST concurrent completions.  The first is sent all at
    once: every request can pass the shed gate before any is queued (a
    stream joins the engine's queue when it first asks for a token; the
    JAX server's gate has the same hole, ROADMAP C13), so its 429 count is
    shown, not required.  The second is sent LIFECYCLE_SHED_SPACING_S
    apart: at least one answers 429.  In both, each 429 carries
    Retry-After, every other request reaches its max_tokens, and the
    client's 429 count equals the scheduler state's shed count and
    shed_requests_total{rest}."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    name = model.name

    def burst(tag: str, spacing_s: float) -> dict:
        state0 = json.loads(_http(port, "GET", "/v1/internal/scheduler/state")[1])
        before = _scrape(port)
        barrier = threading.Barrier(LIFECYCLE_SHED_BURST) if not spacing_s else None

        def send(i: int):
            if barrier is not None:
                barrier.wait(60)
            return _http_h(port, "POST", "/openai/v1/completions",
                           _lc_body(name, f"Burst {tag}{i}. " + BASE_TEXT,
                                    f"{tag}{i}", LIFECYCLE_SHED_TOKENS,
                                    stream=False))

        with ThreadPoolExecutor(max_workers=LIFECYCLE_SHED_BURST) as pool:
            futs = []
            for i in range(LIFECYCLE_SHED_BURST):
                futs.append(pool.submit(send, i))
                if spacing_s:
                    # the later arrivals land while a dispatch runs and the
                    # queue behind the 8 lanes has grown
                    time.sleep(spacing_s)
            answers = [f.result() for f in futs]
        shed = [a for a in answers if a[0] == 429]
        served = {f"{tag}{i}": (a[0], a[2]) for i, a in enumerate(answers)
                  if a[0] != 429}
        _completed(f"lifecycle_shed_{tag}", served,
                   [(label, None, LIFECYCLE_SHED_TOKENS, None) for label in served])
        state = json.loads(_http(port, "GET", "/v1/internal/scheduler/state")[1])
        after = _scrape(port)
        counted = (_metric(after, "resilience_shed_requests_total", component="rest")
                   - _metric(before, "resilience_shed_requests_total",
                             component="rest"))
        by_state = state["shed"]["count"] - state0["shed"]["count"]
        if (any(a[1].get("retry-after") != "1" for a in shed)
                or by_state != len(shed) or counted != len(shed)):
            raise AssertionError(f"lifecycle shedding ({tag}): {len(shed)} answered "
                                 f"429, state {state['shed']} (was "
                                 f"{state0['shed']}), counted {counted}")
        return {"shed_429": len(shed), "served": len(served),
                "state_shed": state["shed"]}

    at_once = burst("a", 0.0)
    _wait_for(lambda: not model.engine._has_live_work(), "B to go idle")
    spaced = burst("s", LIFECYCLE_SHED_SPACING_S)
    if not spaced["shed_429"]:
        raise AssertionError(f"lifecycle shedding: the spaced burst shed nothing: "
                             f"{spaced}")
    return {"burst": LIFECYCLE_SHED_BURST, "spacing_s": LIFECYCLE_SHED_SPACING_S,
            "shed_429": spaced["shed_429"], "served": spaced["served"],
            "state_shed": spaced["state_shed"], "at_once": at_once}


def _resume_logits_check(torch, engine, prompt_ids, generated) -> dict:
    """The first logits of a resumed lane against an uninterrupted lane's at
    the same position, through the kernels, on the served weights and an
    f32 copy: the resume prefills prompt + generated[:-1] as ragged chunks
    and decodes generated[-1]; the uninterrupted lane prefills the prompt
    and decodes every generated token.  f32 within F32_LOGITS_REL_TOL of
    the largest |logit|, bf16 within BF16_NOISE_FACTOR x the model's bf16
    noise (the uninterrupted bf16 lane against the f32 one)."""
    import dataclasses

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    mc16 = engine.model_config
    mc32 = dataclasses.replace(mc16, dtype="float32")
    ps, chunk = engine.config.page_size, engine.config.prefill_buckets[-1]
    seq = list(prompt_ids) + list(generated)
    N, P = len(seq), len(prompt_ids)
    W = -(-N // ps)
    dev = engine.device
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    table = torch.arange(1, W + 1, dtype=torch.int32, device=dev)[None]

    def prefill(params, mc, pages, end):
        for start in range(0, end, chunk):
            n = min(chunk, end - start)
            pad = (-n) % RAGGED_BQ
            llama.forward_ragged(
                params, mc, ints(seq[start:start + n] + [0] * pad),
                ints([0] * n + [-1] * pad),
                ints(list(range(start, start + n)) + [0] * pad),
                ints([0]), ints([n]), ints([start]), pages, table, ps,
                ints([n - 1]))

    def decode(params, mc, pages, pos):
        logits, _ = llama.decode_step(
            params, mc, ints([seq[pos]]), ints([pos]), pages, table,
            torch.ones(1, dtype=torch.bool, device=dev), ps)
        return logits

    def run(params, mc):
        pages = _fresh_cache(mc, ps, 1 + W, "none", dev)
        prefill(params, mc, pages, P)
        for pos in range(P, N):
            straight = decode(params, mc, pages, pos)
        pages = _fresh_cache(mc, ps, 1 + W, "none", dev)
        prefill(params, mc, pages, N - 1)
        return straight, decode(params, mc, pages, N - 1)

    with torch.inference_mode():
        params32 = _f32_params(torch, engine.params)
        straight32, resumed32 = run(params32, mc32)
        del params32
        straight16, resumed16 = run(engine.params, mc16)
    torch.cuda.empty_cache()
    scale = float(straight32.abs().max())
    row = {"prompt_tokens": P, "generated_tokens": len(generated),
           "f32_max_abs_err": float((resumed32 - straight32).abs().max()),
           "f32_tol": F32_LOGITS_REL_TOL * scale, "max_abs_logit": scale,
           "bf16_max_abs_err": float((resumed16.float() - straight16.float()).abs().max()),
           "bf16_noise": float((straight16.float() - straight32).abs().max()),
           "bf16_argmax_agree": bool((resumed16.argmax(-1)
                                      == straight16.argmax(-1)).all())}
    row["bf16_tol"] = BF16_NOISE_FACTOR * row["bf16_noise"]
    finite = all(bool(torch.isfinite(t).all()) for t in (resumed32, resumed16))
    if not (finite and row["f32_max_abs_err"] <= row["f32_tol"]
            and row["bf16_max_abs_err"] <= row["bf16_tol"]):
        raise AssertionError(f"resumed logits disagree with an uninterrupted lane: {row}")
    return row


def cold_build_check() -> dict:
    """Run in a subprocess, with the kernel library's build directory
    pointed at the empty COLD_BUILD_DIR: Llama-3.2-1B with the watchdog
    on starts (the kernel library is built in start(), before ready: the
    `compile` startup phase), then serves one request; the served
    dispatches build nothing and the watchdog suspects nothing."""
    import asyncio
    from pathlib import Path

    import torch

    from kserve_tpu_torch.engine.engine import EngineConfig, LLMEngine
    from kserve_tpu_torch.engine.sampling import SamplingParams
    from kserve_tpu_torch.engine.tokenizer import ByteTokenizer
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import _build

    _build.BUILD_DIR = Path(COLD_BUILD_DIR)
    mc = llama.LlamaConfig.llama3_1b()
    mc.dtype = "bfloat16"

    async def main():
        engine = LLMEngine(mc, EngineConfig(dtype="bfloat16", watchdog=True),
                           ByteTokenizer(mc.vocab_size), device="cuda")
        t0 = time.perf_counter()
        await engine.start()
        start_s = time.perf_counter() - t0
        built = dict(_build.last_build)
        built.pop("log", None)
        t1 = time.perf_counter()
        out = [o async for o in engine.generate(
            list(range(1, 40)), SamplingParams(max_tokens=16, ignore_eos=True,
                                               temperature=0.0))]
        serve_s = time.perf_counter() - t1
        after = dict(_build.last_build)
        after.pop("log", None)
        wd = engine.scheduler_state()["watchdog"]
        phases = dict(engine.startup_phases)
        await engine.stop()
        return {"build_dir": str(_build.BUILD_DIR), "start_s": start_s,
                "startup_phases": phases, "build": built,
                "rebuilt_while_serving": after != built, "tokens": len(out),
                "first_request_s": serve_s, "watchdog": wd}

    res = asyncio.run(main())
    torch.cuda.synchronize()
    return res


def _cold_build_subprocess() -> dict:
    import shutil

    shutil.rmtree(COLD_BUILD_DIR, ignore_errors=True)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--cold-build-check"], capture_output=True,
                          text=True, timeout=600)
    try:
        if proc.returncode != 0:
            raise AssertionError(f"cold build check exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if (res["build"].get("cached") is not False or res["rebuilt_while_serving"]
                or res["tokens"] != 16 or res["watchdog"]["suspected_total"] != 0
                or res["startup_phases"].get("compile", 0) <= 0
                or res["build_dir"] != COLD_BUILD_DIR):
            raise AssertionError(f"cold build check: {res}")
        return res
    finally:
        shutil.rmtree(COLD_BUILD_DIR, ignore_errors=True)


def phase_lifecycle(torch) -> dict:
    """Drain, checkpoints and resume, deadlines, shedding and the
    scheduler state at Llama-3-8B full width and depth, bf16, every server
    with KSERVE_TPU_WATCHDOG=1.  A (drain budget LIFECYCLE_GRACE_S): a cold
    TTFT of the 1,201-token prompt, then 8 streams of 256 tokens (7 greedy,
    one seeded) and 2 queued, drained mid-stream: all 10 end on their
    checkpoints, the gates hold while it drains.  B (same weights, shed
    watermark 4): the long lane's checkpoint resumed alone (resume TTFT),
    then all 10 resumed through the header, each spliced to exactly 256
    tokens; deadlines upfront and from the queue; a shed burst; a greedy
    lane's resumed logits against an uninterrupted lane's.  Then a cold
    kernel build in a subprocess.  Returns the launch counts of the served
    traffic of A and B."""
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    env0 = {k: os.environ.get(k) for k in (
        "KSERVE_TPU_WATCHDOG", "KSERVE_TPU_DRAIN_GRACE", "KSERVE_TPU_SHED_WATERMARK")}
    os.environ["KSERVE_TPU_WATCHDOG"] = "1"
    try:
        os.environ["KSERVE_TPU_DRAIN_GRACE"] = str(LIFECYCLE_GRACE_S)
        model, server, thread = _start_server(torch, SERVE_ARGS, "lifecycle_a")
        os.environ.pop("KSERVE_TPU_DRAIN_GRACE")
        name = model.name
        if len(model.tokenizer.encode(LIFECYCLE_LONG)) != 1201:
            raise AssertionError("the long lifecycle prompt is not 1,201 tokens")
        # a short request first, so the cold TTFT below is the prompt's and
        # not a new engine's first dispatch
        warm = _Stream(server.port, _lc_body(name, "Warm up.", "warm", 4)).start().join()
        if warm.status != 200:
            raise AssertionError(f"warm-up request: {warm.status}")
        cold = _Stream(server.port, _lc_body(name, LIFECYCLE_LONG, "long", 4)).start()
        cold.join()
        if cold.status != 200 or cold.events[-1] != "[DONE]":
            raise AssertionError(f"cold TTFT request: {cold.status}")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        drain = _drain_wave(model, server.port)
        emit({"phase": "lifecycle", "part": "drain",
              "drain_wall_s": drain["drain_wall_s"], "gates": drain["gates"],
              "salvaged": drain["salvaged"], "cold_ttft_s": cold.ttft})
        _stop_server(torch, model, server, thread)

        os.environ["KSERVE_TPU_SHED_WATERMARK"] = str(LIFECYCLE_SHED_WATERMARK)
        model, server, thread = _start_server(torch, SERVE_ARGS, "lifecycle_b")
        os.environ.pop("KSERVE_TPU_SHED_WATERMARK")
        port = server.port
        ckpts = drain["checkpoints"]
        warm = _Stream(port, _lc_body(name, "Warm up.", "warm", 4)).start().join()
        if warm.status != 200:
            raise AssertionError(f"warm-up request: {warm.status}")
        first = _Stream(port, _lc_body(name, LIFECYCLE_LONG, "long"),
                        {"x-generation-checkpoint": ckpts["long"][0]},
                        stop_after=1).start().join()
        if first.status != 200 or first.ttft is None:
            raise AssertionError(f"resume TTFT request: {first.status}")
        _wait_for(lambda: not model.engine._has_live_work(), "B to go idle")
        resumed = _resume_wave(model, port, ckpts)
        emit({"phase": "lifecycle", "part": "resume", "resume_ttft_s": first.ttft,
              **resumed})
        deadlines = _deadline_and_state(model, port)
        emit({"phase": "lifecycle", "part": "deadlines", **deadlines})
        shedding = _shed_burst(model, port)
        emit({"phase": "lifecycle", "part": "shedding", **shedding})
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        _require_launches("lifecycle", counts,
                          ("ragged_paged_attention", "paged_decode_attention"))
        lane = max((lbl for lbl, _ in LIFECYCLE_PROMPTS[1:7]),
                   key=lambda lbl: len(ckpts[lbl][1].generated))
        logits = _resume_logits_check(torch, model.engine, ckpts[lane][1].prompt_ids,
                                      ckpts[lane][1].generated)
        emit({"phase": "lifecycle", "part": "resume_logits", "lane": lane, **logits})
        watchdog_b = _watchdog_ok("lifecycle_b", model.engine)
        _stop_server(torch, model, server, thread)
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cold_build = _cold_build_subprocess()
    emit({
        "phase": "lifecycle", "model": f"{name} (random weights, seed 1)",
        "drain_grace_s": LIFECYCLE_GRACE_S,
        "drain_wall_s": drain["drain_wall_s"],
        "gates_while_draining": drain["gates"],
        "tokens_salvaged": resumed["tokens_salvaged"],
        "salvaged_by_stream": drain["salvaged"],
        "resumed": resumed["streams"],
        "cold_ttft_s": cold.ttft, "resume_ttft_s": first.ttft,
        "resume_ttft_prompt_tokens": 1201,
        "resume_ttft_salvaged": len(ckpts["long"][1].generated),
        "deadlines": deadlines, "shedding": shedding,
        "watchdog": {"a": drain["watchdog"], "b": watchdog_b},
        "launches": counts,
        "resume_logits_check": dict(logits, lane=lane),
        "cold_build": cold_build,
        "phase_wall_s": time.perf_counter() - t_phase,
    })
    return counts


# ---------------------------------------------------------------- lora

LORA_DIR = os.path.join(REPO, "build", "lora_smoke")
_PEFT_ALL = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
             "down_proj")
# (name, rank, PEFT target modules): three seeded adapters, alpha = 2 x rank
LORA_ADAPTERS = [("all-r8", 8, _PEFT_ALL), ("qv-r16", 16, ("q_proj", "v_proj")),
                 ("mlp-r16", 16, ("gate_proj", "up_proj", "down_proj"))]
# (label, prompt, max_tokens, model field: None = the base model)
LORA_PROMPTS = [
    ("base_short", "Tell me about the sea.", 32, None),
    ("base_medium", BASE_TEXT * 6, 40, None),
    ("all_long", (BASE_TEXT * 40)[:1200], 48, "all-r8"),  # 1,201 tokens
    ("all_short", "Say something long.", 32, "all-r8"),
    ("qv_repeat_a", "Write a haiku about paged attention.", 40, "qv-r16"),
    ("qv_repeat_b", "Write a haiku about paged attention.", 40, "qv-r16"),
    ("mlp_short", "Tell me about the sea.", 32, "mlp-r16"),
    ("sampled", "Pick a random word.", 32, "mlp-r16"),
]
LORA_SPEC_TOKENS = 48


def _write_peft(torch, mc, path: str, seed: int, rank: int, targets) -> int:
    """A seeded HF PEFT adapter directory for `mc` (adapter_config.json and
    adapter_model.safetensors, float32, written by the port's writer):
    A ~ N(0, 0.02) [r, in], B ~ N(0, 0.02) [out, r], alpha = 2 x rank.
    Returns its bytes."""
    from kserve_tpu_torch.models.safetensors_io import save_file

    h, f = mc.hidden_size, mc.intermediate_size
    q, kv = mc.n_heads * mc.head_dim, mc.n_kv_heads * mc.head_dim
    dims = {"q_proj": ("self_attn", h, q), "k_proj": ("self_attn", h, kv),
            "v_proj": ("self_attn", h, kv), "o_proj": ("self_attn", q, h),
            "gate_proj": ("mlp", h, f), "up_proj": ("mlp", h, f),
            "down_proj": ("mlp", f, h)}
    gen = torch.Generator()
    gen.manual_seed(seed)
    tensors = {}
    for i in range(mc.n_layers):
        for proj in targets:
            module, d_in, d_out = dims[proj]
            pre = f"base_model.model.model.layers.{i}.{module}.{proj}"
            tensors[f"{pre}.lora_A.weight"] = torch.randn(rank, d_in, generator=gen) * 0.02
            tensors[f"{pre}.lora_B.weight"] = torch.randn(d_out, rank, generator=gen) * 0.02
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as fh:
        json.dump({"r": rank, "lora_alpha": 2 * rank, "peft_type": "LORA",
                   "target_modules": list(targets)}, fh)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    return sum(t.numel() * 4 for t in tensors.values())


def _packed_plan(torch, mc, lens, seed: int, ps: int):
    """Lanes of `lens` prompt tokens (seeded ids) packed at multiples of
    the ragged kernel's block, lane i on pages 1 + i W ..: the inputs of
    llama.forward_ragged, plus W."""
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    W = -(-(max(lens) + 2) // ps)
    tokens, seq, pos, q_start, last = [], [], [], [], []
    for i, n in enumerate(lens):
        q_start.append(len(tokens))
        pad = -(-n // RAGGED_BQ) * RAGGED_BQ - n
        tokens += torch.randint(0, mc.vocab_size, (n,), generator=gen,
                                device="cuda").tolist() + [0] * pad
        seq += [i] * n + [-1] * pad
        pos += list(range(n)) + [0] * pad
        last.append(q_start[-1] + n - 1)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    table = ints([[1 + i * W + j for j in range(W)] for i in range(len(lens))])
    return ([ints(tokens), ints(seq), ints(pos), ints(q_start), ints(lens),
             ints([0] * len(lens))], table, ints(last), W)


def _lora_logits_check(torch, engine) -> dict:
    """On the served Llama-3-8B (bf16, full depth, the adapters' stacks on
    its layers), through the kernels:

    - base lanes bit-equal: the step-0 logits of a base lane packed beside
      lanes on all three adapters, and its next decode step's, equal bit
      for bit those of the same dispatch with every lane on the base model
      (the adapter lanes' must differ);
    - each adapter against a merged-weight reference: its lanes' step-0
      logits through the LoRA path (W x + B(A x)) against the weights with
      W + A B merged in: in float32 within F32_LOGITS_REL_TOL of the
      largest |logit|, and in bf16 within BF16_NOISE_FACTOR times the
      merged model's own bf16 noise (merged bf16 against merged f32)."""
    import dataclasses

    from kserve_tpu_torch.models import llama

    mc, ps = engine.model_config, engine.config.page_size
    lens = [40, 100, 7, 64]
    packed, table, last, W = _packed_plan(torch, mc, lens, seed=11, ps=ps)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    active = torch.ones(len(lens), dtype=torch.bool, device="cuda")

    def run(params, mcfg, ids, decode=False):
        pages = _fresh_cache(mcfg, ps, 1 + len(lens) * W, engine.config.kv_quant)
        ad = None if ids is None else ints(ids)
        step0, _ = llama.forward_ragged(params, mcfg, *packed, pages, table, ps,
                                        last, adapter_ids=ad)
        if not decode:
            return step0
        picks = torch.argmax(step0, dim=-1).to(torch.int32)
        step1, _ = llama.decode_step(params, mcfg, picks, ints(lens), pages, table,
                                     active, ps, adapter_ids=ad)
        return step0, step1

    out = {}
    with torch.inference_mode():
        mixed = run(engine.params, mc, [0, -1, 2, 1], decode=True)
        base = run(engine.params, mc, [-1, -1, -1, -1], decode=True)
        bit_equal = all(torch.equal(m[1], b[1]) for m, b in zip(mixed, base))
        adapted_differ = all(not torch.equal(m[i], b[i]) for m, b in zip(mixed, base)
                             for i in (0, 2, 3))
        out["base_lane"] = {"bit_equal": bit_equal, "adapter_lanes_differ": adapted_differ}
        del mixed, base
        mc32 = dataclasses.replace(mc, dtype="float32")
        for name, k in sorted(engine.adapter_ids.items(), key=lambda kv: kv[1]):
            ids = [k] * len(lens)
            lora16 = run(engine.params, mc, ids)
            params32 = _f32_params(torch, engine.params)
            lora32 = run(params32, mc32, ids)
            # merge W + A B into the f32 copy (in place) and into new bf16
            # tensors of the adapted projections only
            merged16 = dict(engine.params, layers=[])
            for layer32, layer16 in zip(params32["layers"], engine.params["layers"]):
                stack = layer32.pop("lora", {})
                out16 = {key: v for key, v in layer16.items() if key != "lora"}
                for proj, ab in stack.items():
                    layer32[proj] += ab["A"][k] @ ab["B"][k]
                    out16[proj] = layer32[proj].to(mc.torch_dtype)
                merged16["layers"].append(out16)
            m32 = run(params32, mc32, None)
            del params32
            m16 = run(merged16, mc, None)
            del merged16
            scale = float(m32.abs().max())
            row = {"f32_max_abs_err": float((lora32 - m32).abs().max()),
                   "f32_tol": F32_LOGITS_REL_TOL * scale,
                   "bf16_max_abs_err": float((lora16.float() - m16).abs().max()),
                   "bf16_noise": float((m16 - m32).abs().max()),
                   "max_abs_logit": scale,
                   "lora_vs_base_max_abs": float((lora16 - run(engine.params, mc, None)).abs().max())}
            row["bf16_tol"] = BF16_NOISE_FACTOR * row["bf16_noise"]
            out[name] = row
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    bad = [n for n, r in out.items() if n != "base_lane" and not (
        r["f32_max_abs_err"] <= r["f32_tol"] and r["bf16_max_abs_err"] <= r["bf16_tol"]
        and r["lora_vs_base_max_abs"] > 0)]
    if bad or not (bit_equal and adapted_differ):
        raise AssertionError(f"LoRA logits: {bad or 'base lanes'} failed: {out}")
    return out


def _dispatch_profile(torch, engine, params, adapters=None) -> dict:
    """One `mixed` dispatch of the served engine's program at its batch
    (every lane decoding at 512 cached tokens, steps_per_sync steps) on
    `params`, warm, then under torch.profiler: wall, launches, the device
    busy ms by kernel class (GEMM among them) and the idle share
    (scripts/torch_profile_mixed.py's profile_step)."""
    import importlib.util

    import numpy as np

    from kserve_tpu_torch.engine.sampling import SamplingParams, SamplingState
    from kserve_tpu_torch.ops.paged_attention_cuda import RAGGED_BQ

    spec = importlib.util.spec_from_file_location(
        "torch_profile_mixed", os.path.join(REPO, "scripts", "torch_profile_mixed.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    mc, ec = engine.model_config, engine.config
    B, ps, steps, context = ec.max_batch_size, ec.page_size, ec.steps_per_sync, 512
    W = -(-(context + steps + 1) // ps)
    pages = _fresh_cache(mc, ps, 1 + B * W, ec.kv_quant)
    plan = prof._plan({i: (context, 1) for i in range(B)}, B, W, ps, RAGGED_BQ)
    state = SamplingState.from_params([SamplingParams(temperature=0.0)] * B, "cuda")
    gen = torch.Generator(device="cuda")
    ids = None if adapters is None else np.asarray(adapters, np.int32)

    def run():
        return engine._mixed(params, *plan[:7], pages, *plan[7:], state, gen,
                             ids)[:1]

    out = prof.profile_step(run, steps)
    out.pop("top_kernels")
    out.pop("launches_by_kernel")
    out["gemm_ms"] = out["device_ms_by_class"].get("gemm", 0.0)
    del pages
    torch.cuda.empty_cache()
    return out


def _completions(port: int, name: str, prompts, chat=None) -> tuple:
    """`prompts` ((label, text, max_tokens, model or None)) concurrently,
    plus `chat` (a streamed chat body) beside them: ({label: (status,
    body)}, chat result or None, wall s)."""
    from concurrent.futures import ThreadPoolExecutor

    t_send: list = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts) + 1) as pool:
        futs = {label: pool.submit(_http, port, "POST", "/openai/v1/completions", {
            "model": model or name, "prompt": text, "max_tokens": n,
            "ignore_eos": True, **SAMPLED.get(label, {"temperature": 0})})
            for label, text, n, model in prompts}
        chat_fut = chat and pool.submit(_stream_chat, port, chat, t_send)
        results = {label: f.result() for label, f in futs.items()}
        chat_out = chat_fut.result() if chat else None
    return results, chat_out, time.perf_counter() - t0


def _check_completions(phase: str, prompts, results) -> tuple:
    """Every completion answered 200 with its max_tokens: (tokens, texts)."""
    generated, texts = 0, {}
    for label, _, n, _ in prompts:
        status, body = results[label]
        if status != 200:
            raise AssertionError(f"{phase} completion {label} answered {status}: "
                                 f"{body[:300]!r}")
        resp = json.loads(body)
        if (resp["usage"]["completion_tokens"] != n
                or resp["choices"][0]["finish_reason"] != "length"):
            raise AssertionError(f"{phase} completion {label}: {resp['usage']}")
        generated += n
        texts[label] = resp["choices"][0]["text"]
    return generated, texts


def phase_lora(torch) -> dict:
    """Multi-adapter LoRA at Llama-3-8B full width and depth, bf16: three
    seeded PEFT adapters written by the port's writer (rank 8 on all seven
    projections, rank 16 on q/v, rank 16 on the MLP), served with
    --lora_adapters.  /openai/v1/models lists 4 models; 8 concurrent
    completions mix the base model and all three adapters (one of 1,201
    prompt tokens, chunked) beside a streamed chat on one adapter; the
    ragged and decode kernels launched, the launches per dispatch as
    without adapters; a repeated greedy prompt on one adapter gives one
    text; the logits gates of _lora_logits_check; one dispatch profiled
    with the adapters (lanes on all three and the base) and without; then
    a short --spec_decode_k 3 run whose lanes carry adapters (the dense
    kernel launched).  Returns the first wave's launch counts."""
    import shutil

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    shutil.rmtree(LORA_DIR, ignore_errors=True)
    mc = llama.LlamaConfig.llama3_8b()
    written, flags = {}, []
    for seed, (name, rank, targets) in enumerate(LORA_ADAPTERS, start=21):
        path = os.path.join(LORA_DIR, name)
        written[name] = _write_peft(torch, mc, path, seed, rank, targets)
        flags.append(f"{name}={path}")
    lora_arg = ["--lora_adapters=" + ",".join(flags)]
    emit({"phase": "lora", "event": "adapters_written",
          "bytes": written, "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    try:
        model, server, thread = _start_server(torch, SERVE_ARGS + lora_arg, "lora")
        port, name, engine = server.port, model.name, model.engine
        status, body = _http(port, "GET", "/openai/v1/models")
        listed = [m["id"] for m in json.loads(body)["data"]]
        if status != 200 or listed != [name] + sorted(written):
            raise AssertionError(f"/openai/v1/models: {status} {listed}")
        stacks = sum(t.numel() * t.element_size() for layer in engine.params["layers"]
                     for ab in layer.get("lora", {}).values() for t in ab.values())
        chat = {"model": "qv-r16", "stream": True, "max_tokens": 40,
                "temperature": 0, "ignore_eos": True,
                "messages": [{"role": "user", "content": "Say something long."}]}
        torch.cuda.synchronize()
        K.reset_launch_counts()
        results, (chat_status, events, ttft), wall = _completions(
            port, name, LORA_PROMPTS, chat)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        generated, texts = _check_completions("lora", LORA_PROMPTS, results)
        if texts["qv_repeat_a"] != texts["qv_repeat_b"]:
            raise AssertionError("a repeated greedy prompt on one adapter gave "
                                 "another text")
        if chat_status != 200 or events[-1] != "[DONE]" or len(events) - 2 != 40:
            raise AssertionError(f"adapter chat: {chat_status}, {len(events)} events")
        generated += 40
        _require_launches("lora", counts,
                          ("ragged_paged_attention", "paged_decode_attention"))
        per_dispatch = _launches_per_dispatch("lora", engine, counts)
        logits = _lora_logits_check(torch, engine)
        decode_no_sync = _check_decode_has_no_sync(torch, engine)
        base_params = dict(engine.params, layers=[
            {k: v for k, v in layer.items() if k != "lora"}
            for layer in engine.params["layers"]])
        B = engine.config.max_batch_size
        profile = {"no_adapters": _dispatch_profile(torch, engine, base_params),
                   "adapters": _dispatch_profile(
                       torch, engine, engine.params, [i % 4 - 1 for i in range(B)])}
        summary = {
            "phase": "lora", "model": f"{name} (random weights, seed 1)",
            "adapters": {n: {"rank": r, "targets": list(t)} for n, r, t in LORA_ADAPTERS},
            "adapter_ids": engine.adapter_ids, "lora_stacks_gb": stacks / 1e9,
            "models_listed": listed, "requests": len(LORA_PROMPTS) + 1,
            "tokens_generated": generated, "wall_s": wall,
            "tok_per_s": generated / wall, "chat_ttft_s": ttft,
            "prompt_tokens": {label: len(model.tokenizer.encode(text))
                              for label, text, _, _ in LORA_PROMPTS},
            "launches": counts, "launches_per_dispatch": per_dispatch,
            "logits_check": logits, "decode_no_sync": decode_no_sync,
            "dispatch_profile": profile,
        }
        del engine, base_params
        _stop_server(torch, model, server, thread)

        # speculative decoding with adapter lanes
        model, server, thread = _start_server(
            torch, SERVE_ARGS + lora_arg + [f"--spec_decode_k={SPEC_K}"], "lora_spec")
        spec_prompts = [(f"spec_{m or 'base'}", "ab " * 40, LORA_SPEC_TOKENS, m)
                        for m in [None] + sorted(written)]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        results, _, spec_wall = _completions(server.port, model.name, spec_prompts)
        torch.cuda.synchronize()
        spec_counts = dict(K.LAUNCHES)
        spec_generated, _ = _check_completions("lora_spec", spec_prompts, results)
        stats = dict(model.engine.spec_stats)
        _require_launches("lora_spec", spec_counts, ("dense_ragged_paged_attention",))
        if not stats["drafted"] > 0:
            raise AssertionError(f"lora_spec drafted nothing: {stats}")
        summary["spec"] = {
            "requests": len(spec_prompts), "tokens_generated": spec_generated,
            "wall_s": spec_wall, "tok_per_s": spec_generated / spec_wall,
            "spec_stats": stats, "launches": spec_counts,
            "launches_per_dispatch": _launches_per_dispatch(
                "lora_spec", model.engine, spec_counts)}
        _stop_server(torch, model, server, thread)
    finally:
        shutil.rmtree(LORA_DIR, ignore_errors=True)
    summary["phase_wall_s"] = time.perf_counter() - t_phase
    emit(summary)
    return counts


# ---------------------------------------------------------------- wq

WQ_ARGS = SERVE_ARGS + ["--weight_quant=int8"]


def _dequant_check(torch, engine) -> dict:
    """The served int8 Llama-3-8B against its dequantized weights (q x s):
    step-0 and decode-step logits of the int8 path ((x @ q) x s, through
    the kernels) against the same model with every int8 leaf replaced by
    its dequantized form: in float32 within F32_LOGITS_REL_TOL of the
    largest |logit| (the two differ in summation and rounding order only),
    and in bf16 within BF16_NOISE_FACTOR times the dequantized model's own
    bf16 noise (its bf16 run against its f32 run)."""
    import dataclasses

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.models.quant import is_quantized

    mc, ps = engine.model_config, engine.config.page_size
    lens = [40, 100, 7]
    packed, table, last, W = _packed_plan(torch, mc, lens, seed=13, ps=ps)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    active = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    mc32 = dataclasses.replace(mc, dtype="float32")

    def run(params, mcfg, picks=None):
        pages = _fresh_cache(mcfg, ps, 1 + len(lens) * W, engine.config.kv_quant)
        step0, _ = llama.forward_ragged(params, mcfg, *packed, pages, table, ps, last)
        if picks is None:
            picks = torch.argmax(step0, dim=-1).to(torch.int32)
        step1, _ = llama.decode_step(params, mcfg, picks, ints(lens), pages, table,
                                     active, ps)
        return (step0, step1), picks

    def dequant(tree, dtype):
        if is_quantized(tree):
            return (tree["q"].float() * tree["s"].float()).to(dtype)
        if isinstance(tree, dict):
            return {k: dequant(v, dtype) for k, v in tree.items()}
        if isinstance(tree, list):
            return [dequant(v, dtype) for v in tree]
        if torch.is_tensor(tree) and tree.is_floating_point():
            return tree.to(dtype)
        return tree

    with torch.inference_mode():
        (q32, picks) = run(_f32_params(torch, engine.params), mc32)
        q16, _ = run(engine.params, mc, picks)
        d32, _ = run(dequant(engine.params, torch.float32), mc32, picks)
        torch.cuda.empty_cache()
        d16, _ = run(dequant(engine.params, mc.torch_dtype), mc, picks)
    torch.cuda.empty_cache()
    out = {}
    for i, step in enumerate(("forward_ragged", "decode_step")):
        scale = float(d32[i].abs().max())
        noise = float((d16[i] - d32[i]).abs().max())
        row = {"f32_max_abs_err": float((q32[i] - d32[i]).abs().max()),
               "f32_tol": F32_LOGITS_REL_TOL * scale,
               "bf16_max_abs_err": float((q16[i] - d16[i]).abs().max()),
               "bf16_noise": noise, "bf16_tol": BF16_NOISE_FACTOR * noise,
               "max_abs_logit": scale}
        out[step] = row
        if not (row["f32_max_abs_err"] <= row["f32_tol"]
                and row["bf16_max_abs_err"] <= row["bf16_tol"]
                and all(bool(torch.isfinite(t[i]).all()) for t in (q16, q32))):
            raise AssertionError(f"int8 weights' {step} logits stray from the "
                                 f"dequantized reference: {row}")
    return out


def phase_wq(torch) -> dict:
    """Int8 weights at Llama-3-8B full width and depth: --weight_quant int8
    (drawn int8 on the card), then with --kv_quant int8 as well.  Each
    serves the serve phase's wave (_serve_run: every completion and the
    chat, telemetry, the kernels' launch counts and logits against their
    plain versions over the int8 weights, a decode step under CUDA sync
    debugging); prints the resident weights and KV bytes, tok/s and one
    profiled dispatch's device time by class (the GEMMs'); the first also
    gates on the dequantized reference (_dequant_check)."""
    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.models.quant import param_bytes

    mc = llama.LlamaConfig.llama3_8b()
    counts = {}
    for phase, extra in (("wq", []), ("wq_kvq", ["--kv_quant=int8"])):
        captured = {}

        def probe(torch_, engine, _server, captured=captured, kv_int8=bool(extra)):
            captured["weights_gb"] = _tensor_bytes(torch_, engine.params) / 1e9
            if not kv_int8:
                # over int8 KV, K/V rows rounding to neighbouring int8 steps
                # swamp this comparison; _serve_run's logits check holds
                # that run's kernels to their plain versions instead
                captured["dequant_check"] = _dequant_check(torch_, engine)
            captured["dispatch_profile"] = _dispatch_profile(torch_, engine,
                                                             engine.params)

        counts[phase] = _serve_run(torch, WQ_ARGS + extra, phase, SERVE_PROMPTS,
                                   probe=probe)
        sfx = "_int8" if extra else ""
        _require_launches(phase, counts[phase], ("ragged_paged_attention" + sfx,
                                                 "paged_decode_attention" + sfx))
        emit({"phase": phase, "event": "int8_weights",
              "param_bytes_gb": {"bf16": param_bytes(mc) / 1e9,
                                 "int8": param_bytes(mc, "int8") / 1e9},
              **captured})
    return counts


# ---------------------------------------------------------------- moe

# Mixtral-8x7B's published config.json (mistralai/Mixtral-8x7B-v0.1), the
# smoke's own copy: 8 experts of SwiGLU width 14,336, top 2, 32 layers
MIXTRAL_8X7B = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-05,
    "rope_theta": 1e6, "sliding_window": None, "tie_word_embeddings": False,
    "hidden_act": "silu", "num_local_experts": 8, "num_experts_per_tok": 2,
    "torch_dtype": "bfloat16"}
# reduced, depth only: 16 full-width layers hold 46.97 GB of bf16 weights
# beside the KV cache on one 80 GB card; all 32 (93.4 GB) do not fit
MOE_LAYERS = 16
# the logits checks hold an f32 copy of the weights they run: the served
# weights' first 2 layers, at full width; the checkpoint is 2 layers too
MOE_CHECK_LAYERS = 2
MOE_NAME = "mixtral-8x7b"
MOE_DIR = os.path.join(REPO, "build", "moe_smoke")
MOE_CKPT_DIR = os.path.join(REPO, "build", "moe_checkpoint_smoke")
MOE_ARGS = [f"--model_name={MOE_NAME}", f"--model_dir={MOE_DIR}",
            "--random_weights", "--http_port=0", "--device=cuda"]


def _write_mixtral_config(model_dir: str, n_layers: int) -> None:
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(dict(MIXTRAL_8X7B, num_hidden_layers=n_layers), f)


class _Routings:
    """Inside the block, the experts each moe_mlp call selected ([N, E]
    bool on the card, one per call in call order): models/moe.py's
    combine_weights wrapped for the block."""

    def __enter__(self):
        from kserve_tpu_torch.models import moe

        self._moe, self._plain = moe, moe.combine_weights
        self.calls = []

        def recording(logits, top_k):
            weights = self._plain(logits, top_k)
            self.calls.append(weights > 0)
            return weights

        moe.combine_weights = recording
        return self.calls

    def __exit__(self, *exc):
        self._moe.combine_weights = self._plain


def _moe_logits_check(torch, engine, **kw) -> dict:
    """_logits_check of the served MoE engine's first MOE_CHECK_LAYERS
    layers at full width (an f32 copy of all 16 would not fit beside
    them): f32 within F32_LOGITS_REL_TOL x max|logit|, bf16 within
    BF16_NOISE_FACTOR x this model's bf16 noise.  Adds the routing flips:
    the (token, layer) routings (padding rows included) whose selected
    experts differ between the kernel path and the plain path, f32 and
    bf16; a near-tie of two router logits can flip one."""
    import dataclasses
    from types import SimpleNamespace

    view = SimpleNamespace(
        model_config=dataclasses.replace(engine.model_config,
                                         n_layers=MOE_CHECK_LAYERS),
        config=engine.config,
        params=dict(engine.params, layers=engine.params["layers"][:MOE_CHECK_LAYERS]))
    with _Routings() as calls:
        out = _logits_check(torch, view, **kw)
    # _logits_check's runs in order: plain and kernel f32 (and over an
    # int8 cache the unquantized plain f32), then plain and kernel bf16
    runs = ["plain_f32", "kernel_f32"] + (
        ["unquantized_f32"] if engine.config.kv_quant == "int8" else []) + [
        "plain_bf16", "kernel_bf16"]
    per = len(calls) // len(runs)
    if per == 0 or per * len(runs) != len(calls):
        raise AssertionError(f"{len(calls)} moe_mlp calls over {len(runs)} runs")
    by_run = {name: calls[i * per:(i + 1) * per] for i, name in enumerate(runs)}

    def flips(a: str, b: str) -> int:
        return sum(int((x != y).any(-1).sum()) for x, y in zip(by_run[a], by_run[b]))

    out["routing_flips"] = {
        "f32": flips("plain_f32", "kernel_f32"),
        "bf16": flips("plain_bf16", "kernel_bf16"),
        "routings": sum(int(x.shape[0]) for x in by_run["plain_f32"]),
        "layers": MOE_CHECK_LAYERS}
    return out


def _moe_legacy(torch, engine, server) -> dict:
    """LEGACY_PROMPTS' logprobs and penalty requests on the served MoE
    engine, concurrently: both reach max_tokens, the logprobs block holds
    its gates, the engine runs legacy decode dispatches, and the kernels
    launch as many times as its dispatches say (the legacy prefills'
    attention is plain PyTorch)."""
    prompts = LEGACY_PROMPTS[:2]

    def legacy_decodes():
        return sum(n for k, n in engine.legacy_dispatches.items()
                   if k.startswith("decode"))

    mixed0, legacy0 = engine.steps, legacy_decodes()
    results, _, wall, counts = _legacy_requests(torch, server, MOE_NAME, prompts)
    resps = _completed("moe_legacy", results, prompts)
    _check_completion_logprobs("logprobs", resps["logprobs"], 32)
    mixed, legacy = engine.steps - mixed0, legacy_decodes() - legacy0
    layers, steps = engine.model_config.n_layers, engine.config.steps_per_sync
    want = {"ragged_paged_attention": layers * mixed,
            "paged_decode_attention": layers * ((steps - 1) * mixed + steps * legacy)}
    got = {k: counts.get(k, 0) for k in want}
    if legacy <= 0 or got != want:
        raise AssertionError(f"moe legacy: launches {got} != {want} for {mixed} "
                             f"mixed and {legacy} legacy decode dispatches")
    return {"requests": [label for label, *_ in prompts], "wall_s": wall,
            "mixed_dispatches": mixed, "legacy_decode_dispatches": legacy,
            "legacy_dispatches": dict(engine.legacy_dispatches),
            "launches": counts}


def _write_mixtral_tokenizer(model_dir: str, vocab_size: int) -> None:
    """A tokenizer.json in Mixtral's form (Llama-2's sentencepiece BPE:
    Prepend/Replace normalizer, byte fallback, <s> and </s>) over
    `vocab_size` ids, each decoding to its own text, so equal completion
    texts are equal token ids; plus the tokenizer_config.json naming
    <s> and </s>."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    vocab["▁"] = len(vocab)
    vocab.update({f"▁t{i}": i for i in range(len(vocab), vocab_size)})
    special = [{"id": i, "content": c, "single_word": False, "lstrip": False,
                "rstrip": False, "normalized": False, "special": True}
               for i, c in enumerate(["<unk>", "<s>", "</s>"])]
    data = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": special,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "vocab": vocab,
                  "merges": []}}
    with open(os.path.join(model_dir, "tokenizer.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>"}, f)


def _write_mixtral_shards(torch, params, model_dir: str) -> dict:
    """`params` (an MoE model of two or more layers) in Mixtral's HF form,
    by the port's writer, as two shards: the second holds layer 1's router
    and its experts 0 .. E/2-1, so that layer's stacks take experts E/2 ..
    E-1 from the first shard before 0 .. from the second."""
    from kserve_tpu_torch.models.safetensors_io import save_file

    def hf(t):  # [in, out] -> HF Linear's [out, in]
        return t.t().contiguous()

    tensors = {"model.embed_tokens.weight": params["embed"],
               "model.norm.weight": params["final_norm"],
               "lm_head.weight": hf(params["lm_head"])}
    for i, layer in enumerate(params["layers"]):
        for key in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"):
            name, transpose = HF_LAYER_NAMES[key]
            tensors[f"model.layers.{i}.{name}"] = (hf(layer[key]) if transpose
                                                   else layer[key])
        moe = f"model.layers.{i}.block_sparse_moe."
        tensors[moe + "gate.weight"] = hf(layer["router"])
        for e in range(layer["w_gate"].shape[0]):
            for w, key in (("w1", "w_gate"), ("w3", "w_up"), ("w2", "w_down")):
                tensors[f"{moe}experts.{e}.{w}.weight"] = hf(layer[key][e])
    n_experts = params["layers"][1]["w_gate"].shape[0]
    late = {"model.layers.1.block_sparse_moe.gate.weight"} | {
        n for n in tensors for e in range(n_experts // 2)
        if n.startswith(f"model.layers.1.block_sparse_moe.experts.{e}.")}
    t0 = time.perf_counter()
    for shard, part in enumerate((sorted(set(tensors) - late), sorted(late))):
        save_file({n: tensors[n] for n in part}, os.path.join(
            model_dir, f"model-{shard + 1:05d}-of-00002.safetensors"))
    nbytes = [t.numel() * t.element_size() for t in tensors.values()]
    return {"n_tensors": len(tensors), "bytes": sum(nbytes),
            "largest_tensor_bytes": max(nbytes), "second_shard": len(late),
            "write_s": time.perf_counter() - t0}


def _moe_checkpoint(torch, mc16) -> dict:
    """Mixtral at full width and MOE_CHECK_LAYERS layers served from a
    Mixtral-form checkpoint (--model_dir): seed-1 weights written as two
    shards with layer 1's experts split across them and out of order, a
    Mixtral-form tokenizer.json.  Gates: every loaded tensor bit-equal to
    the one written; greedy completions equal to a --random_weights
    server's holding the written tensors; the streamed load's host staging
    one tensor (the largest); the ragged and decode kernels launched;
    --weight_quant int8 over the experts refused.  Returns the load's
    accounting and rate."""
    import dataclasses
    import shutil

    from kserve_tpu_torch.models import llama
    from kserve_tpu_torch.ops import paged_attention_cuda as K
    from kserve_tpu_torch.runtimes.generative_server import (
        build_arg_parser,
        build_model,
    )

    mc = dataclasses.replace(mc16, n_layers=MOE_CHECK_LAYERS)
    shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)
    os.makedirs(MOE_CKPT_DIR)
    try:
        written = llama.init_params(mc, seed=1, device="cuda")
        _write_mixtral_config(MOE_CKPT_DIR, mc.n_layers)
        _write_mixtral_tokenizer(MOE_CKPT_DIR, mc.vocab_size)
        ckpt = _write_mixtral_shards(torch, written, MOE_CKPT_DIR)
        args = ["--model_name=mixtral-ckpt", f"--model_dir={MOE_CKPT_DIR}",
                "--http_port=0", "--device=cuda"]
        model, server, thread = _start_server(
            torch, args + ["--random_weights"], "moe_checkpoint",
            load=lambda: written)
        want = _sequential_texts(server.port, model.name)
        _stop_server(torch, model, server, thread)
        model, server, thread = _start_server(torch, args, "moe_checkpoint")
        mismatched = [key for key, a, b in _param_pairs(written, model.engine.params)
                      if a.dtype != b.dtype or not torch.equal(a, b)]
        K.reset_launch_counts()
        got = _sequential_texts(server.port, model.name)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        stats = dict(model.weights_stats)
        _stop_server(torch, model, server, thread)
        del written
        if mismatched:
            raise AssertionError(f"loaded Mixtral tensors differ from the written "
                                 f"ones: {mismatched[:8]}")
        if got != want:
            raise AssertionError(f"Mixtral checkpoint greedy texts {got} != the "
                                 f"random-weights server's {want}")
        if (stats["peak_host_bytes"] != ckpt["largest_tensor_bytes"]
                or stats["n_tensors"] != ckpt["n_tensors"]):
            raise AssertionError(f"Mixtral load staging {stats} against {ckpt}")
        _require_launches("moe_checkpoint", counts,
                          ("ragged_paged_attention", "paged_decode_attention"))
        quant = build_model(build_arg_parser().parse_args(args + ["--weight_quant=int8"]))
        try:
            quant.load()
        except NotImplementedError as e:
            refused = str(e)
        else:
            raise AssertionError("--weight_quant int8 over MoE experts loaded")
        return {"checkpoint": ckpt, "tensors_bit_equal": ckpt["n_tensors"],
                "load": {**stats, "gb_per_s": stats["read_bytes"] / stats["seconds"] / 1e9},
                "greedy_equal_random_weights": sorted(got),
                "int8_refused": refused, "launches": counts}
    finally:
        shutil.rmtree(MOE_CKPT_DIR, ignore_errors=True)


def phase_moe(torch) -> dict:
    """Mixtral-8x7B (LlamaConfig.from_hf_config of its published config:
    8 experts of width 14,336, top 2, GQA 32/8 at head_dim 128, untied
    head, bf16) at full width and MOE_LAYERS of its 32 layers, seeded
    random weights drawn once on the card and served twice:

    (a) the serve phase's wave through the OpenAI server (six
        completions, one of 1,201 prompt tokens, and a streamed chat)
        with its gates, then LEGACY_PROMPTS' logprobs and penalty
        requests on the legacy route (_moe_legacy);
    (b) a second engine over the same tensors with --spec_decode_k=3
        --kv_quant=int8: the spec phase's prompts and gates and two
        chained dispatches under CUDA sync debugging.

    Logits through the kernels against the plain versions at full width
    and MOE_CHECK_LAYERS layers, with the routing flips
    (_moe_logits_check).  (a) launches the ragged and decode kernels'
    bf16-page d=128 instances, (b) the int8-page ragged, decode and dense
    ones.  Then the Mixtral-form checkpoint (_moe_checkpoint).  Prints the
    resident weights, the card's peak allocated bytes of each part, and
    returns {"moe": counts, "moe_spec_int8": counts}."""
    import functools
    import gc
    import shutil

    from kserve_tpu_torch.models import llama

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe", "event": "start",
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    shutil.rmtree(MOE_DIR, ignore_errors=True)
    os.makedirs(MOE_DIR)
    int8_keys = tuple(k + "_int8" for k in _ATTENTION_KEYS)
    try:
        _write_mixtral_config(MOE_DIR, MOE_LAYERS)
        mc = llama.LlamaConfig.from_hf_config(os.path.join(MOE_DIR, "config.json"))
        t0 = time.perf_counter()
        params = llama.init_params(mc, seed=1, device="cuda")
        torch.cuda.synchronize()
        total = _tensor_bytes(torch, params)
        per_layer = _tensor_bytes(torch, params["layers"][0])
        weights = {"weights_gb": total / 1e9, "layer_gb": per_layer / 1e9,
                   "full_depth_gb": (total + (32 - MOE_LAYERS) * per_layer) / 1e9,
                   "draw_s": time.perf_counter() - t0}
        emit({"phase": "moe", "event": "weights", **weights})
        peaks, legacy = {}, {}

        def probe(torch_, engine, server):
            legacy.update(_moe_legacy(torch_, engine, server))
            peaks["moe"] = torch_.cuda.max_memory_allocated() / 1e9

        counts = {"moe": _serve_run(
            torch, MOE_ARGS, "moe", SERVE_PROMPTS, probe=probe, load=lambda: params,
            logits_check=functools.partial(_moe_logits_check, legacy=True))}
        _require_launches("moe", counts["moe"], _ATTENTION_KEYS[:2],
                          (_ATTENTION_KEYS[2],) + int8_keys)
        counts["moe_spec_int8"] = _spec_run(
            torch, MOE_ARGS + [f"--spec_decode_k={SPEC_K}", "--kv_quant=int8"],
            "moe_spec_int8", check_no_sync=True, load=lambda: params,
            logits_check=_moe_logits_check)
        peaks["moe_spec_int8"] = torch.cuda.max_memory_allocated() / 1e9
        _require_launches("moe_spec_int8", counts["moe_spec_int8"], int8_keys,
                          _ATTENTION_KEYS)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        checkpoint = _moe_checkpoint(torch, mc)
        peaks["moe_checkpoint"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(MOE_DIR, ignore_errors=True)
    emit({"phase": "moe", "model": f"{MOE_NAME} (random weights, seed 1, bf16)",
          "reduced": f"depth only: {MOE_LAYERS} of 32 layers",
          **weights, "max_memory_allocated_gb": peaks, "legacy": legacy,
          "checkpoint": checkpoint, "phase_wall_s": time.perf_counter() - t_phase})
    return counts


# ---------------------------------------------------------------- pd

# the serve wave's prompts that fit the prefill role's max_prefill_len,
# plus one of 1,000 tokens (BOS + 999 bytes: 63 pages)
PD_LONG = (BASE_TEXT * 20)[:999]
PD_PROMPTS = [p for p in SERVE_PROMPTS if p[0] != "long"] + [("thousand", PD_LONG, 48)]
PD_ROUND_TRIPS = 3
PD_CHECK_LAYERS = 2


def _llama3_8b_params(torch):
    """Llama-3-8B's seeded random weights (seed 1, bf16), drawn once on the
    card: the weights every server of a phase shares through `load`."""
    from kserve_tpu_torch.models import llama

    mc = llama.LlamaConfig.llama3_8b()
    mc.dtype = "bfloat16"
    params = llama.init_params(mc, seed=1, device="cuda")
    torch.cuda.synchronize()
    return mc, params


def _on_loop(server, coro, timeout: float = 600.0):
    """Run `coro` on a server's own event loop (its engine's) and wait."""
    import asyncio

    return asyncio.run_coroutine_threadsafe(coro, server._loop).result(timeout)


def _engine_tokens(server, engine, ids, max_tokens: int):
    """(token ids, seconds to the first token) of one greedy generation,
    driven through engine.generate on the server's loop."""
    from kserve_tpu_torch.engine.sampling import SamplingParams

    async def run():
        params = SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                ignore_eos=True)
        t0, first, toks = time.perf_counter(), None, []
        async for out in engine.generate(list(ids), params):
            if first is None:
                first = time.perf_counter() - t0
            toks.append(out.token_id)
        return toks, first

    return _on_loop(server, run())


def _prefill_round_trip(port: int, name: str, ids) -> tuple:
    """One POST /v1/prefill/{model} from this thread: (seconds, payload
    bytes, the KV and first token as the decode role reads them)."""
    import http.client

    from kserve_tpu_torch.protocol import pd

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", f"/v1/prefill/{name}", body=json.dumps({
            "prompt_ids": list(ids), "params": {"temperature": 0.0, "max_tokens": 1}}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        seconds = time.perf_counter() - t0
        if resp.status != 200:
            raise AssertionError(f"/v1/prefill answered {resp.status}: {data[:300]!r}")
        kv, first = pd.deserialize_kv(resp.getheader(pd.KV_META_HEADER), bytearray(data))
    finally:
        conn.close()
    return seconds, len(data), kv, first


def _pd_logits_check(torch, engine) -> dict:
    """Logits over injected KV against a monolithic prefill, on the served
    weights: a 1,000-token prompt prefilled the prefill role's way (the
    legacy `prefill` model call, plain attention), its pages gathered to
    the host and injected into a second cache (bit for bit), then one
    decode step over them through the decode kernel; against the same
    prompt prefilled through the ragged kernel (the mixed route) and the
    same decode step over that cache.  Both decode steps take the P/D
    path's first token.

    - float32 at PD_CHECK_LAYERS layers: first-token and decode logits
      within F32_LOGITS_REL_TOL x max|logit|, greedy tokens equal;
    - bfloat16 at full depth: within BF16_NOISE_FACTOR x the model's bf16
      noise (the monolithic bf16 path against an f32 copy of it)."""
    import dataclasses

    from kserve_tpu_torch.engine.compiled import gather_pages, inject
    from kserve_tpu_torch.engine.kvcache import pages_needed
    from kserve_tpu_torch.models import llama

    mc16 = engine.model_config
    ps = engine.config.page_size
    N = 1000
    P = pages_needed(N, ps)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    ids = torch.randint(0, mc16.vocab_size, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device="cuda")  # noqa: E731
    table = torch.arange(1, P + 2, dtype=torch.int32, device="cuda")[None]
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    inject_exact = []

    def decode(params, mc, pages, token):
        logits, _ = llama.decode_step(params, mc, token, ints([N]), pages, table,
                                      active, ps)
        return logits

    def pd_path(params, mc):
        pages_p = _fresh_cache(mc, ps, P + 2, "none")
        first, _ = llama.prefill(params, mc, ids[None], ints([N]), pages_p,
                                 table[:, :P], ps)
        payload = gather_pages(pages_p, list(range(1, P + 1)))["kv"].cpu()
        del pages_p
        pages_d = _fresh_cache(mc, ps, P + 2, "none")
        inject(pages_d, payload, list(range(1, P + 1)))
        back = gather_pages(pages_d, list(range(1, P + 1)))["kv"].cpu()
        inject_exact.append(torch.equal(back.view(torch.uint8), payload.view(torch.uint8)))
        token = torch.argmax(first, dim=-1).to(torch.int32)
        return first, decode(params, mc, pages_d, token), token

    def mono_path(params, mc, token):
        pages = _fresh_cache(mc, ps, P + 2, "none")
        first, _ = llama.forward_ragged(
            params, mc, ids, ints([0] * N),
            torch.arange(N, dtype=torch.int32, device="cuda"), ints([0]),
            ints([N]), ints([0]), pages, table, ps, ints([N - 1]))
        return first, decode(params, mc, pages, token)

    with torch.inference_mode():
        mc2 = dataclasses.replace(mc16, n_layers=PD_CHECK_LAYERS, dtype="float32")
        p2 = _f32_params(torch, dict(engine.params,
                                     layers=engine.params["layers"][:PD_CHECK_LAYERS]))
        pd32 = pd_path(p2, mc2)
        mono32 = mono_path(p2, mc2, pd32[2])
        del p2
        pd16 = pd_path(engine.params, mc16)
        mono16 = mono_path(engine.params, mc16, pd16[2])
        params32 = _f32_params(torch, engine.params)
        ref32 = mono_path(params32, dataclasses.replace(mc16, dtype="float32"),
                          pd16[2])
        del params32
    torch.cuda.empty_cache()
    out = {"prompt_tokens": N, "pages": P, "inject_bit_exact": all(inject_exact)}
    ok = all(inject_exact)
    for i, name in enumerate(("first_token", "decode_step")):
        scale = float(mono32[i].abs().max())
        row = {
            "f32_layers": PD_CHECK_LAYERS,
            "f32_max_abs_err": float((pd32[i] - mono32[i]).abs().max()),
            "f32_tol": F32_LOGITS_REL_TOL * scale, "f32_max_abs_logit": scale,
            "f32_argmax_equal": bool((pd32[i].argmax(-1) == mono32[i].argmax(-1)).all()),
            "bf16_max_abs_err": float((pd16[i].float() - mono16[i].float()).abs().max()),
            "bf16_noise": float((mono16[i].float() - ref32[i]).abs().max()),
            "bf16_argmax_equal": bool((pd16[i].argmax(-1) == mono16[i].argmax(-1)).all()),
        }
        row["bf16_tol"] = BF16_NOISE_FACTOR * row["bf16_noise"]
        finite = all(bool(torch.isfinite(t[i]).all()) for t in (pd32, pd16))
        ok = ok and finite and row["f32_argmax_equal"] and (
            row["f32_max_abs_err"] <= row["f32_tol"]
            and row["bf16_max_abs_err"] <= row["bf16_tol"])
        out[name] = row
    if not ok:
        raise AssertionError(f"logits over injected KV disagree with a monolithic "
                             f"prefill: {out}")
    return out


def phase_pd(torch) -> dict:
    """Prefill/decode disaggregation at Llama-3-8B full width and depth,
    bf16: server P (--role prefill) and server D (--role decode
    --prefill_url P) in this process, sharing one set of seeded weights
    (two caches of 2,048 pages).  D serves PD_PROMPTS as completions and a
    streamed chat, each prompt's KV fetched from P; P then serves the same
    wave itself (the monolithic reference: its chat TTFT, texts).  Gates:
    every completion reaches its max_tokens; P's pages all come back; D's
    dispatches launched the ragged and decode kernels, exactly as many as
    its dispatches make; the pages D holds after one inject equal the bytes
    P sent, bit for bit; a logprobs request and the 1,201-token serve
    prompt (over P's max_prefill_len) answer 400 at D; the logits over
    injected KV (_pd_logits_check).  Prints the KV bytes per request, the
    /v1/prefill round trip (ms, GB/s), inject ms, the chat's TTFT through
    P/D and through P alone, the wave's tok/s and memory allocated.
    Returns {"pd": D's launch counts}."""
    from concurrent.futures import ThreadPoolExecutor

    from kserve_tpu_torch.engine.compiled import gather_pages, inject
    from kserve_tpu_torch.engine.kvcache import pages_needed
    from kserve_tpu_torch.engine.sampling import SamplingParams
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    mc, params = _llama3_8b_params(torch)
    p_model, p_srv, p_thread = _start_server(
        torch, SERVE_ARGS + ["--role=prefill"], "pd", load=lambda: params)
    d_model, d_srv, d_thread = _start_server(
        torch, SERVE_ARGS + ["--role=decode",
                             f"--prefill_url=http://127.0.0.1:{p_srv.port}"],
        "pd", load=lambda: params)
    pe, de, name = p_model.engine, d_model.engine, d_model.name
    ps = de.config.page_size
    page_bytes = de._page_bytes()
    chat = {"model": name, "stream": True, "max_tokens": 48, "temperature": 0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "Say something long."}]}

    def wave(port):
        with ThreadPoolExecutor(max_workers=len(PD_PROMPTS) + 1) as pool:
            futs = {label: pool.submit(_http, port, "POST", "/openai/v1/completions", {
                "model": name, "prompt": text, "max_tokens": n, "ignore_eos": True,
                **SAMPLED.get(label, {"temperature": 0})})
                for label, text, n in PD_PROMPTS}
            chat_fut = pool.submit(_stream_chat, port, chat, [])
            results = {label: f.result() for label, f in futs.items()}
            chat_status, events, ttft = chat_fut.result()
        bodies = _completed(
            "pd", results, [(label, text, n, None) for label, text, n in PD_PROMPTS])
        if chat_status != 200 or events[-1] != "[DONE]" or len(events) != 48 + 2:
            raise AssertionError(f"pd chat answered {chat_status} with "
                                 f"{len(events)} events")
        return bodies, ttft

    try:
        p_free0 = pe.allocator.free_pages
        prefill_calls0 = pe.legacy_dispatches["prefill"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t_run = time.perf_counter()
        pd_bodies, pd_ttft = wave(d_srv.port)
        wall = time.perf_counter() - t_run
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _require_launches("pd", counts, _ATTENTION_KEYS[:2],
                          (_ATTENTION_KEYS[2],) + tuple(k + "_int8" for k in _ATTENTION_KEYS))
        per_dispatch = _launches_per_dispatch("pd", de, counts)
        prefill_calls = pe.legacy_dispatches["prefill"] - prefill_calls0
        if not 1 <= prefill_calls <= len(PD_PROMPTS) + 1:
            raise AssertionError(f"pd: {prefill_calls} detached prefill calls")
        if pe.allocator.free_pages != p_free0:
            raise AssertionError(f"pd: P's free pages {pe.allocator.free_pages} "
                                 f"!= {p_free0} before the wave")
        generated = sum(b["usage"]["completion_tokens"] for b in pd_bodies.values()) + 48
        # the monolithic reference: P serves the same wave itself
        mono_bodies, mono_ttft = wave(p_srv.port)
        greedy = [label for label, _, _ in PD_PROMPTS if label not in SAMPLED]
        texts_equal = sum(pd_bodies[k]["choices"][0]["text"]
                          == mono_bodies[k]["choices"][0]["text"] for k in greedy)
        if (pd_bodies["repeat_a"]["choices"][0]["text"]
                != pd_bodies["repeat_b"]["choices"][0]["text"]):
            raise AssertionError("pd: a repeated greedy prompt gave another text")
        # refusals at D
        status, body = _http(d_srv.port, "POST", "/openai/v1/completions", {
            "model": name, "prompt": "Tell me about the sea.", "max_tokens": 4,
            "logprobs": 2})
        status_long, body_long = _http(d_srv.port, "POST", "/openai/v1/completions", {
            "model": name, "prompt": SERVE_PROMPTS[2][1], "max_tokens": 4})
        if status != 400 or status_long != 400 or b"max_prefill_len" not in body_long:
            raise AssertionError(f"pd refusals: logprobs {status} {body[:200]!r}, "
                                 f"1,201 tokens {status_long} {body_long[:200]!r}")
        # one inject, recorded: the pages D holds right after it against
        # the bytes P sent
        ids = d_model.tokenizer.encode(PD_LONG)
        sent, held = [], []
        handle_prefill = p_model.handle_prefill

        async def spy_prefill(*a, **kw):
            meta, payload = await handle_prefill(*a, **kw)
            sent.append(bytes(payload))
            return meta, payload

        inject_payload = de._inject_payload

        def spy_inject(payload, page_ids):
            inject_payload(payload, page_ids)
            held.append(gather_pages(de.kv_pages, page_ids[:payload["kv"].shape[1]])["kv"])

        p_model.handle_prefill, de._inject_payload = spy_prefill, spy_inject
        try:
            status, body = _http(d_srv.port, "POST", "/openai/v1/completions", {
                "model": name, "prompt": PD_LONG, "max_tokens": 4,
                "temperature": 0, "ignore_eos": True})
        finally:
            p_model.handle_prefill, de._inject_payload = handle_prefill, inject_payload
        if status != 200 or len(sent) != 1 or len(held) != 1:
            raise AssertionError(f"pd probe: {status}, {len(sent)} sent, {len(held)} held")
        held_bytes = held[0].cpu().contiguous().view(torch.uint8).numpy().tobytes()
        if held_bytes != sent[0]:
            raise AssertionError("pd: the pages D holds after the inject differ "
                                 "from the bytes P sent")
        # the round trip and the inject, timed from this thread, and P's
        # detached prefill alone (prefill, gather, copy to the host)
        trips = [_prefill_round_trip(p_srv.port, name, ids)
                 for _ in range(PD_ROUND_TRIPS)]
        detached_ms = []
        for _ in range(PD_ROUND_TRIPS):
            t0 = time.perf_counter()
            _on_loop(p_srv, pe.prefill_detached(ids, SamplingParams(
                max_tokens=1, temperature=0.0)))
            detached_ms.append((time.perf_counter() - t0) * 1e3)
        kv = trips[-1][2]
        n_pages = pages_needed(len(ids), ps)
        injects = []
        for _ in range(PD_ROUND_TRIPS):
            cache = _fresh_cache(mc, ps, n_pages + 1, "none")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inject(cache, kv, list(range(1, n_pages + 1)))
            torch.cuda.synchronize()
            injects.append((time.perf_counter() - t0) * 1e3)
            del cache
        nbytes = trips[-1][1]
        round_trip = {
            "prompt_tokens": len(ids), "kv_bytes": nbytes,
            "ms": [t[0] * 1e3 for t in trips],
            "gbps": [nbytes / t[0] / 1e9 for t in trips],
            "detached_prefill_ms": detached_ms, "inject_ms": injects}
        memory_gb = torch.cuda.memory_allocated() / 1e9
        pe = None  # P's cache goes with its server
        _stop_server(torch, p_model, p_srv, p_thread)
        logits = _pd_logits_check(torch, de)
    finally:
        for m, s, t in ((d_model, d_srv, d_thread), (p_model, p_srv, p_thread)):
            if t.is_alive():
                _stop_server(torch, m, s, t)
    emit({
        "phase": "pd", "model": f"{name} (random weights, seed 1, bf16)",
        "kv_bytes_per_request": {
            label: pages_needed(len(d_model.tokenizer.encode(text)), ps) * page_bytes
            for label, text, _ in PD_PROMPTS},
        "prefill_round_trip": round_trip,
        "requests": len(PD_PROMPTS) + 1, "tokens_generated": generated,
        "wall_s": wall, "tok_per_s": generated / wall,
        "chat_ttft_s": {"pd": pd_ttft, "prefill_role_alone": mono_ttft},
        "detached_prefill_calls": prefill_calls,
        "greedy_texts_equal_to_monolithic": f"{texts_equal} of {len(greedy)}",
        "launches": counts, "launches_per_dispatch": per_dispatch,
        "memory_allocated_gb": memory_gb, "max_memory_allocated_gb": peak_gb,
        "logits_check": logits, "phase_wall_s": time.perf_counter() - t_phase,
    })
    del params
    return {"pd": counts}


# ---------------------------------------------------------------- peer

PEER_DIR = os.path.join(REPO, "build", "peer_smoke")
# SHARED_TEXT (1,040 tokens, 65 pages) and a 9-byte tail: 1,049 tokens,
# whose lookup covers exactly the 65 shared pages
PEER_TEXT = SHARED_TEXT + "Q: go on."
PEER_TOKENS = 16


def _peer_client(torch, a_port: int, wire: dict, transport=None):
    """A PeerPageClient over the port's HTTP client whose index holds A's
    advertised digest set."""
    from kserve_tpu_torch.kvstore import PeerPageClient, PeerPageIndex
    from kserve_tpu_torch.protocol.http_client import AsyncHTTPClient

    index = PeerPageIndex()
    if not index.update(f"http://127.0.0.1:{a_port}", wire):
        raise AssertionError(f"A's peer_pages did not parse: {wire}")
    return PeerPageClient(AsyncHTTPClient(transport=transport), index=index)


def phase_peer(torch) -> dict:
    """The cross-replica page fabric at Llama-3-8B full width and depth,
    bf16, one set of seeded weights shared by three servers:

    - A (--kv_persist_dir A) answers PEER_TEXT twice: the second request
      hits its 65 cached pages, which writes them through to A's persist
      layer; A's GET /v1/internal/scheduler/state then advertises them
      (`peer_pages`);
    - B (its own empty persist dir), with a PeerPageClient over the port's
      HTTP client whose index is fed from A's state, answers the same
      prompt: it pages the 65 pages in from tier `peer` over A's page
      route.  Gates: 65 fetch hits and 1,040 peer tokens; the adopted
      pages equal A's persisted payloads bit for bit; B's greedy tokens
      equal A's second answer's (the same tail chunk alone in its batch
      over bit-equal pages); B wrote the pages through to its own dir;
    - C (empty dir) fetches through FaultInjectingTransport with
      `peer_corrupt` on its first page: that page is counted under
      bad_pages and never adopted, nothing of the run lands, and C's
      tokens equal A's first, cold answer's (the same computation).

    Prints the 65-page page-in wall, ms per page fetched, and time to the
    first token cold (A), through the peer page-in (B) and on a local hit
    (A's second, beside its persist write-through, and a third once that
    has landed).  Returns {"peer": B's launch counts}."""
    import shutil

    from kserve_tpu_torch.engine.compiled import gather_pages
    from kserve_tpu_torch.ops import paged_attention_cuda as K
    from kserve_tpu_torch.protocol.http_client import SocketTransport
    from kserve_tpu_torch.resilience import FaultInjectingTransport, FaultPlan, FaultSpec
    from kserve_tpu_torch.scheduler.prefix import token_prefix_digests

    t_phase = time.perf_counter()
    shutil.rmtree(PEER_DIR, ignore_errors=True)
    _, params = _llama3_8b_params(torch)
    servers = []

    def start(label):
        argv = SERVE_ARGS + [f"--kv_persist_dir={os.path.join(PEER_DIR, label)}"]
        servers.append(_start_server(torch, argv, "peer", load=lambda: params))
        return servers[-1]

    try:
        a_model, a_srv, _ = start("a")
        ae, name = a_model.engine, a_model.name
        ps = ae.config.page_size
        ids = a_model.tokenizer.encode(PEER_TEXT)
        keys = token_prefix_digests(ids, ps, True)
        if len(keys) != SHARED_PAGES:
            raise AssertionError(f"peer prompt looks up {len(keys)} pages")
        a_cold, ttft_cold = _engine_tokens(a_srv, ae, ids, PEER_TOKENS)
        a_hit, ttft_hit = _engine_tokens(a_srv, ae, ids, PEER_TOKENS)
        t0 = time.perf_counter()
        while True:
            state = json.loads(_http(a_srv.port, "GET", "/v1/internal/scheduler/state")[1])
            wire = state["models"][name].get("peer_pages") or {}
            if set(k.hex() for k in keys) <= set(wire.get("digests", ())):
                break
            if time.perf_counter() - t0 > 120:
                raise AssertionError(f"A did not persist the prefix: {state}")
            time.sleep(0.05)
        # a local hit again, with no persist write-through beside it
        a_hit2, ttft_hit2 = _engine_tokens(a_srv, ae, ids, PEER_TOKENS)
        if a_hit2 != a_hit:
            raise AssertionError(f"peer: A's hits disagree: {a_hit} {a_hit2}")
        served0 = _scrape(a_srv.port).get(("kv_peer_pages_served_total", ()), 0.0)

        b_model, b_srv, _ = start("b")
        be = b_model.engine
        page_bytes = be._page_bytes()
        b_client = _peer_client(torch, a_srv.port, wire)
        be.set_peer_client(b_client)
        fetch_key = ("kv_peer_fetch_seconds_sum", ())
        fetch0 = _scrape(a_srv.port).get(fetch_key, 0.0)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        b_toks, ttft_peer = _engine_tokens(b_srv, be, ids, PEER_TOKENS)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        # the 65 verified fetches' own seconds (metrics are process-wide)
        fetch_s = _scrape(a_srv.port).get(fetch_key, 0.0) - fetch0
        _require_launches("peer", counts, _ATTENTION_KEYS[:2])
        stats = be.prefix_store_stats()
        b_peer = be.scheduler_state()["peer"]
        if (b_client.stats["hit"] != SHARED_PAGES
                or stats["pagein_tokens_by_tier"].get("peer") != SHARED_PAGES * ps):
            raise AssertionError(f"peer: B fetched {b_client.stats}, paged in {stats}")
        if b_toks != a_hit:
            raise AssertionError(f"peer: B's tokens {b_toks} != A's {a_hit}")
        mismatched = []
        for key in keys:
            page = be._prefix_cache._pages[key]
            got = gather_pages(be.kv_pages, [page])["kv"].cpu()
            want = ae._kv_store.persist.load(key)["kv"]
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                mismatched.append(key.hex())
        if mismatched:
            raise AssertionError(f"peer: {len(mismatched)} adopted pages differ "
                                 "from A's persisted payloads")
        t0 = time.perf_counter()
        while be._pagein_tasks or len(be._kv_store.persist) < SHARED_PAGES:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("peer: B did not write the pages through")
            time.sleep(0.05)
        if not all(k in be._kv_store.persist for k in keys):
            raise AssertionError("peer: B's persist dir lacks a fetched page")
        pagein_s = be.pagein_seconds[-1]
        served = _scrape(a_srv.port).get(("kv_peer_pages_served_total", ()), 0.0) - served0
        if served != SHARED_PAGES:
            raise AssertionError(f"peer: A served {served} pages")

        c_model, c_srv, _ = start("c")
        ce = c_model.engine
        plan = FaultPlan([FaultSpec(target="127.0.0.1", kind="peer_corrupt", count=1)])
        c_client = _peer_client(torch, a_srv.port, wire, transport=FaultInjectingTransport(
            plan, inner=SocketTransport()))
        ce.set_peer_client(c_client)
        c_toks, ttft_corrupt = _engine_tokens(c_srv, ce, ids, PEER_TOKENS)
        c_stats = ce.prefix_store_stats()
        if (c_client.stats["corrupt"] != 1 or c_client.stats["hit"] != 0
                or c_client.bad_pages != {f"http://127.0.0.1:{a_srv.port}": 1}
                or ce._prefix_cache.adopted or "peer" in c_stats["pagein_tokens_by_tier"]):
            raise AssertionError(f"peer: the corrupt page: {c_client.snapshot()} {c_stats}")
        if c_toks != a_cold:
            raise AssertionError(f"peer: C's tokens {c_toks} != A's cold {a_cold}")
    finally:
        ae = be = ce = None
        for model, server, thread in reversed(servers):
            _stop_server(torch, model, server, thread)
        shutil.rmtree(PEER_DIR, ignore_errors=True)
    del params
    emit({
        "phase": "peer", "model": f"{name} (random weights, seed 1, bf16)",
        "pages": SHARED_PAGES, "prompt_tokens": len(ids),
        "page_bytes": page_bytes,
        "pagein_wall_s": pagein_s, "ms_per_page": pagein_s * 1e3 / SHARED_PAGES,
        "fetch_ms_per_page": fetch_s * 1e3 / SHARED_PAGES,
        "ttft_s": {"cold": ttft_cold, "peer_pagein": ttft_peer,
                   "local_hit_persisting": ttft_hit, "local_hit": ttft_hit2,
                   "corrupt_first_page": ttft_corrupt},
        "b_peer": b_peer, "b_prefix_store": stats, "c_peer": c_client.snapshot(),
        "launches": counts, "phase_wall_s": time.perf_counter() - t_phase,
    })
    return {"peer": counts}


# ---------------------------------------------------------------- predictive

# HIGGS's 28 features (UCI HIGGS); LightGBM's Higgs experiment (docs,
# Experiments): num_leaves 255, 500 iterations; XGBoost at max_depth 8
HIGGS_FEATURES = 28
PREDICTIVE_TREES = 500
XGB_DEPTH = 8
LGB_LEAVES = 255
PREDICTIVE_BATCHES = (1, 64, 1024)
# timed v2/infer requests per framework and batch (the multiclass dump,
# an extra XGBoost model for the class_of_tree path: PREDICTIVE_TIMED_EXTRA)
PREDICTIVE_TIMED = 200
PREDICTIVE_TIMED_EXTRA = 50
# served probabilities against the float64 walk (f32 leaf sums of 500
# trees), and against the port on the CPU (the same f32 arithmetic)
PROBA_TOL = 1e-5
CPU_TOL = 1e-6
# the SVC's pair decisions against float64: sums of ~45 RBF values, each
# rounded to f32 before its exp (the JAX package's tolerance for them)
DECISION_TOL = 1e-4


def xgb_dump(rng, n_trees: int, depth: int, n_features: int,
             objective: str = "binary:logistic", num_class: int = 0,
             base_score: float = 0.3) -> dict:
    """An XGBoost JSON model of `n_trees` complete trees of `depth`: random
    split features, float64 thresholds (no float32 holds them) and leaf
    values, in the format kserve_tpu_torch's xgb_parse reads."""
    import numpy as np

    nodes, internal = 2 ** (depth + 1) - 1, 2 ** depth - 1
    idx = np.arange(nodes)
    left = np.where(idx < internal, 2 * idx + 1, -1).tolist()
    right = np.where(idx < internal, 2 * idx + 2, -1).tolist()
    trees = []
    for _ in range(n_trees):
        cond = np.where(idx < internal, rng.normal(size=nodes),
                        rng.normal(scale=0.05, size=nodes))
        trees.append({"left_children": left, "right_children": right,
                      "split_indices": rng.integers(0, n_features, nodes).tolist(),
                      "split_conditions": cond.tolist()})
    return {"learner": {
        "learner_model_param": {"base_score": repr(base_score),
                                "num_class": str(num_class),
                                "num_feature": str(n_features)},
        "objective": {"name": objective},
        "gradient_booster": {"name": "gbtree", "model": {
            "tree_info": [t % max(num_class, 1) for t in range(n_trees)],
            "trees": trees}}}}


def lgb_dump(rng, n_trees: int, num_leaves: int, n_features: int,
             objective: str = "binary sigmoid:1") -> str:
    """A LightGBM text model of `n_trees` trees of `num_leaves` leaves,
    each grown leaf-wise by splitting a leaf drawn at random (so depths
    vary, as LightGBM's do); float64 thresholds and leaf values."""
    import numpy as np

    lines = ["tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
             "label_index=0", f"max_feature_idx={n_features - 1}",
             f"objective={objective}",
             "feature_names=" + " ".join(f"f{i}" for i in range(n_features)),
             "feature_infos=" + " ".join("none" for _ in range(n_features)), ""]
    for t in range(n_trees):
        # split j turns leaf pick[j] (uniform over the j + 1 leaves so far)
        # into internal node j with children: that leaf, and new leaf j + 1
        pick = (rng.random(num_leaves - 1) * np.arange(1, num_leaves)).astype(int).tolist()
        feature = rng.integers(0, n_features, num_leaves - 1).tolist()
        threshold = rng.normal(size=num_leaves - 1).tolist()
        left, right = [], []
        parent = {0: None}  # leaf -> (internal node, 0 left | 1 right)
        for j, leaf in enumerate(pick):
            left.append(-leaf - 1)
            right.append(-(j + 1) - 1)
            if parent[leaf] is not None:
                node, side = parent[leaf]
                (left if side == 0 else right)[node] = j
            parent[leaf], parent[j + 1] = (j, 0), (j, 1)
        values = rng.normal(scale=0.05, size=num_leaves)
        lines += [f"Tree={t}", f"num_leaves={num_leaves}", "num_cat=0",
                  "split_feature=" + " ".join(map(str, feature)),
                  "threshold=" + " ".join(map(repr, threshold)),
                  "decision_type=" + " ".join("2" for _ in feature),
                  "left_child=" + " ".join(map(str, left)),
                  "right_child=" + " ".join(map(str, right)),
                  "leaf_value=" + " ".join(map(repr, values.tolist())),
                  "shrinkage=1", ""]
    return "\n".join(lines + ["end of trees", ""])


def walk_xgb(doc: dict, X):
    """The float64 reference of an XGBoost dump, node by node on its own
    thresholds (x < threshold goes left): (leaf node ids [B, T], margins
    [B, max(num_class, 1)] with the base score's margin)."""
    import numpy as np

    learner = doc["learner"]
    params = learner["learner_model_param"]
    num_class = int(params["num_class"])
    model = learner["gradient_booster"]["model"]
    X = np.asarray(X, dtype=np.float64)
    rows = np.arange(len(X))
    leaves = np.zeros((len(X), len(model["trees"])), dtype=np.int64)
    margin = np.zeros((len(X), max(num_class, 1)))
    for t, (tree, cls) in enumerate(zip(model["trees"], model["tree_info"])):
        left = np.asarray(tree["left_children"])
        right = np.asarray(tree["right_children"])
        feat = np.asarray(tree["split_indices"])
        cond = np.asarray(tree["split_conditions"], dtype=np.float64)
        node = np.zeros(len(X), dtype=np.int64)
        while True:
            inner = left[node] >= 0
            if not inner.any():
                break
            go = X[rows, feat[node]] < cond[node]
            node = np.where(inner, np.where(go, left[node], right[node]), node)
        leaves[:, t] = node
        margin[:, cls if num_class > 1 else 0] += cond[node]
    base = float(params["base_score"])
    if learner["objective"]["name"].startswith("binary:"):
        base = math.log(base / (1.0 - base))
    return leaves, margin + base


def walk_lgb(text: str, X):
    """The float64 reference of a one-class LightGBM text model, node by
    node on its own thresholds (x <= threshold goes left): (leaf ids [B, T]
    numbered as the parser numbers them, internal nodes first, and raw
    margins [B])."""
    import numpy as np

    X = np.asarray(X, dtype=np.float64)
    trees, cur = [], None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            key, _, val = line.partition("=")
            cur[key] = val
    leaves = np.zeros((len(X), len(trees)), dtype=np.int64)
    margin = np.zeros(len(X))
    for t, tree in enumerate(trees):
        feat = np.asarray(tree["split_feature"].split(), dtype=np.int64)
        thr = np.asarray(tree["threshold"].split(), dtype=np.float64)
        lc = np.asarray(tree["left_child"].split(), dtype=np.int64)
        rc = np.asarray(tree["right_child"].split(), dtype=np.int64)
        values = np.asarray(tree["leaf_value"].split(), dtype=np.float64)
        child = np.zeros(len(X), dtype=np.int64)  # >= 0 internal, < 0 leaf
        while (child >= 0).any():
            at = np.nonzero(child >= 0)[0]
            j = child[at]
            go = X[at, feat[j]] <= thr[j]
            child[at] = np.where(go, lc[j], rc[j])
        leaf = -child - 1
        leaves[:, t] = len(feat) + leaf
        margin += values[leaf]
    return leaves, margin


def _sigmoid(np, z):
    return 1.0 / (1.0 + np.exp(-z))


def _softmax(np, z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# stand-ins for the fitted sklearn estimators the converter reads (the card
# machine has no sklearn): the class names and fitted attributes only.
# Written beside the pickled model so that the server's process unpickles
# them from its PYTHONPATH.
STANDINS_MODULE = "smoke_sklearn_standins"
STANDINS_SOURCE = '''"""Stand-ins of fitted sklearn estimators: attributes only."""


class _Fitted:
    def __init__(self, **attrs):
        self.__dict__.update(attrs)


class SVC(_Fitted):
    pass


class StandardScaler(_Fitted):
    pass


class LogisticRegression(_Fitted):
    pass


class Pipeline(_Fitted):
    pass


class RandomForestClassifier(_Fitted):
    pass


class DecisionTreeClassifier(_Fitted):
    def get_depth(self):
        return self.depth


class Tree(_Fitted):
    pass
'''
# iris's class means and spread (Fisher's iris: setosa, versicolor,
# virginica over sepal/petal length and width)
IRIS_MEANS = ((5.0, 3.4, 1.5, 0.2), (5.9, 2.8, 4.3, 1.3), (6.6, 3.0, 5.6, 2.0))
IRIS_STD = (0.4, 0.35, 0.45, 0.2)


def _iris_rows(np, rng, n: int):
    cls = rng.integers(0, 3, n)
    rows = np.asarray(IRIS_MEANS)[cls] + rng.normal(size=(n, 4)) * IRIS_STD
    return rows.astype(np.float32)


def _standins(np, rng, S):
    """Seeded stand-ins: an SVC of the iris SVC's shapes (4 features, 3
    classes, RBF, 15 support vectors per class), a StandardScaler +
    LogisticRegression Pipeline, and a RandomForestClassifier of 20 trees
    of depth 6; each with its float64 reference decision."""
    classes = np.arange(3)
    sv = np.concatenate([np.asarray(m) + rng.normal(size=(15, 4)) * IRIS_STD
                         for m in IRIS_MEANS])
    n_support = np.array([15, 15, 15], dtype=np.int32)
    dual = rng.uniform(-1.0, 1.0, size=(2, 45))
    intercept = rng.normal(scale=0.1, size=3)
    gamma = 1.0 / (4 * 0.8)
    svc = S.SVC(classes_=classes, n_support_=n_support, dual_coef_=dual,
                intercept_=intercept, support_vectors_=sv, kernel="rbf",
                _gamma=gamma, gamma="scale", coef0=0.0, degree=3,
                n_features_in_=4)
    starts = [0, 15, 30, 45]
    pairs = [(0, 1), (0, 2), (1, 2)]

    def svc_ref(X):
        X = np.asarray(X, dtype=np.float64)
        k = np.exp(-gamma * ((X[:, None, :] - sv[None]) ** 2).sum(-1))
        votes = np.zeros((len(X), 3))
        dec = np.zeros((len(X), 3))
        for p, (i, j) in enumerate(pairs):
            si, sj = slice(starts[i], starts[i + 1]), slice(starts[j], starts[j + 1])
            dec[:, p] = (k[:, si] @ dual[j - 1, si] + k[:, sj] @ dual[i, sj]
                         + intercept[p])
            votes[:, i] += dec[:, p] > 0
            votes[:, j] += dec[:, p] <= 0
        return np.argmax(votes, axis=-1), dec

    mean, scale = np.asarray(IRIS_MEANS).mean(0), np.asarray(IRIS_STD) * 2.0
    coef, bias = rng.normal(size=(3, 4)) * 2.0, rng.normal(size=3)
    pipe = S.Pipeline(steps=[
        ("scaler", S.StandardScaler(mean_=mean, scale_=scale, with_mean=True,
                                    with_std=True)),
        ("clf", S.LogisticRegression(coef_=coef, intercept_=bias, classes_=classes,
                                     n_features_in_=4))], n_features_in_=4)

    def pipe_ref(X):
        z = ((np.asarray(X, dtype=np.float64) - mean) / scale) @ coef.T + bias
        p = _softmax(np, z)
        return np.argmax(p, axis=-1), p

    trees = []
    for _ in range(20):
        depth = 6
        nodes, internal = 2 ** (depth + 1) - 1, 2 ** depth - 1
        idx = np.arange(nodes)
        left = np.where(idx < internal, 2 * idx + 1, -1)
        right = np.where(idx < internal, 2 * idx + 2, -1)
        feat = np.where(idx < internal, rng.integers(0, 4, nodes), -2)
        thr = np.where(idx < internal, np.asarray(IRIS_MEANS)[1][np.maximum(feat, 0)]
                       + rng.normal(size=nodes), -2.0)
        value = rng.uniform(0.5, 20.0, size=(nodes, 1, 3))
        trees.append(S.DecisionTreeClassifier(
            tree_=S.Tree(children_left=left, children_right=right, feature=feat,
                         threshold=thr, value=value), depth=depth))
    forest = S.RandomForestClassifier(estimators_=trees, classes_=classes,
                                      n_features_in_=4)

    def forest_ref(X):
        X = np.asarray(X, dtype=np.float64)
        rows = np.arange(len(X))
        proba = np.zeros((len(X), 3))
        for tree in trees:
            t = tree.tree_
            node = np.zeros(len(X), dtype=np.int64)
            for _ in range(tree.depth):
                inner = t.children_left[node] >= 0
                go = X[rows, np.maximum(t.feature[node], 0)] <= t.threshold[node]
                node = np.where(inner, np.where(go, t.children_left[node],
                                                t.children_right[node]), node)
            v = t.value[node, 0]
            proba += v / v.sum(axis=1, keepdims=True)
        proba /= len(trees)
        return np.argmax(proba, axis=-1), proba

    return {"svc": (svc, svc_ref), "pipeline": (pipe, pipe_ref),
            "random_forest": (forest, forest_ref)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _ServerProcess:
    """`python -m <module> <args> --http_port=<free port>` in a process of
    its own (the normal CLI, on cuda by default), its log in a file; ready
    once /v2/health/ready answers 200."""

    def __init__(self, module: str, args, name: str, log_dir: str, env=None,
                 cwd: str = REPO):
        self.name = name
        self.port = _free_port()
        self.log_path = os.path.join(log_dir, f"{name}.log")
        self._log = open(self.log_path, "w")
        self.t_start = time.perf_counter()
        self.ready_after_s = None  # seconds from the start to ready
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args, f"--http_port={self.port}"],
            cwd=cwd, env=env, stdout=self._log, stderr=subprocess.STDOUT)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def wait_ready(self, timeout: float = 240.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(f"server {self.name} exited "
                                     f"{self.proc.returncode}: {self.log()[-3000:]}")
            try:
                if _http(self.port, "GET", "/v2/health/ready", timeout=5)[0] == 200:
                    if self.ready_after_s is None:
                        self.ready_after_s = time.perf_counter() - self.t_start
                    return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"server {self.name} not ready in {timeout} s")

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._log.close()


class _PredictiveServer(_ServerProcess):
    """`python -m kserve_tpu_torch.runtimes.predictive_server` over one
    model directory."""

    def __init__(self, root: str, framework: str, name: str, model_dir: str,
                 env: dict, log_dir: str):
        self.framework = framework
        super().__init__("kserve_tpu_torch.runtimes.predictive_server",
                         [f"--framework={framework}", f"--model_name={name}",
                          f"--model_dir={model_dir}"], name, log_dir, env, cwd=root)


class _Client:
    """One kept-alive connection to a predictive server."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def post(self, path: str, body: bytes, headers: dict):
        return self.request("POST", path, body, headers)

    def request(self, method: str, path: str, body, headers: dict):
        self.conn.request(method, path, body=body, headers=headers)
        resp = self.conn.getresponse()
        return resp.status, dict((k.lower(), v) for k, v in resp.getheaders()), resp.read()

    def close(self) -> None:
        self.conn.close()


def _v2_bodies(np, name: str, X):
    """The V2 request for rows X in JSON and in the binary-tensor form."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    inp = {"name": "input-0", "shape": list(X.shape), "datatype": "FP32"}
    js = json.dumps({"id": "smoke", "inputs": [dict(inp, data=X.ravel().tolist())]})
    head = json.dumps({"id": "smoke", "inputs": [dict(
        inp, parameters={"binary_data_size": X.nbytes})]}).encode()
    return (js.encode(), {"Content-Type": "application/json"}), (
        head + X.tobytes(), {"Content-Type": "application/octet-stream",
                             "Inference-Header-Content-Length": str(len(head))})


def _v2_output(np, status: int, headers: dict, raw: bytes):
    """The first output of a V2 response as numpy (JSON or binary)."""
    if status != 200:
        raise AssertionError(f"v2 infer answered {status}: {raw[:500]!r}")
    n = headers.get("inference-header-content-length")
    if n is None:
        out = json.loads(raw)["outputs"][0]
        return np.asarray(out["data"]).reshape(out["shape"])
    head = json.loads(raw[:int(n)])
    out = head["outputs"][0]
    dtype = {"FP32": np.float32, "FP64": np.float64, "INT64": np.int64,
             "INT32": np.int32}[out["datatype"]]
    return np.frombuffer(raw[int(n):], dtype=dtype).reshape(out["shape"])


def _served(np, server: _PredictiveServer, X) -> dict:
    """The same rows through V1 :predict, V2 JSON and V2 binary; the three
    answers must be equal."""
    client = _Client(server.port)
    try:
        status, _, raw = client.post(
            f"/v1/models/{server.name}:predict",
            json.dumps({"instances": np.asarray(X, dtype=np.float32).tolist()}).encode(),
            {"Content-Type": "application/json"})
        if status != 200:
            raise AssertionError(f"{server.name} :predict answered {status}: {raw[:500]!r}")
        v1 = np.asarray(json.loads(raw)["predictions"])
        (jb, jh), (bb, bh) = _v2_bodies(np, server.name, X)
        v2_json = _v2_output(np, *client.post(f"/v2/models/{server.name}/infer", jb, jh))
        v2_bin = _v2_output(np, *client.post(f"/v2/models/{server.name}/infer", bb, bh))
    finally:
        client.close()
    if not (np.array_equal(v1, v2_json) and np.array_equal(v1, v2_bin)):
        raise AssertionError(f"{server.name}: V1, V2 JSON and V2 binary answers differ")
    return v1


def _latency(np, server: _PredictiveServer, X, n: int) -> dict:
    """p50 / p99 of v2/infer (binary-tensor form, one kept-alive
    connection, one request at a time), request sent to response read."""
    client = _Client(server.port)
    (_, _), (body, headers) = _v2_bodies(np, server.name, X)
    path = f"/v2/models/{server.name}/infer"
    ms = []
    try:
        for _ in range(5):
            client.post(path, body, headers)
        for _ in range(n):
            t0 = time.perf_counter()
            status, _, _ = client.post(path, body, headers)
            ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"{server.name} v2/infer answered {status}")
    finally:
        client.close()
    ms.sort()
    return {"n": n, "p50_ms": statistics.median(ms),
            "p99_ms": ms[max(0, math.ceil(0.99 * n) - 1)], "max_ms": ms[-1]}


def _forest_on_card(np, forest, X, ref_leaves) -> None:
    """The parsed forest on the card: every tensor on cuda, and the leaf of
    each row in each tree, read from the traversal, equal to the walk's."""
    from kserve_tpu_torch.runtimes.tensorize.trees import forest_apply

    fa = forest_apply(forest, "cuda")
    off = [t.device.type for t in fa.tensors() if t.device.type != "cuda"]
    if off:
        raise AssertionError(f"forest tensors off the card: {off}")
    leaves = fa.leaves(X).cpu().numpy()
    bad = int((leaves != ref_leaves).sum())
    if bad:
        raise AssertionError(f"{bad} of {leaves.size} leaves differ from the walk")


def _tf32_evidence(torch, np, svc, X) -> dict:
    """What TF32 would do to the RBF expansion here: the SVC's pair
    decisions through torch.matmul with TF32 on, against the float64
    reference (reported, not gated: the port does not take this path)."""
    sv = torch.as_tensor(svc.support_vectors_, dtype=torch.float32, device="cuda")
    x = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d2 = (x * x).sum(1, keepdim=True) - 2.0 * (x @ sv.T) + (sv * sv).sum(1)[None]
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    k = torch.exp(-svc._gamma * d2).double().cpu().numpy()
    X64 = np.asarray(X, dtype=np.float64)
    k64 = np.exp(-svc._gamma * ((X64[:, None] - svc.support_vectors_[None]) ** 2).sum(-1))
    return {"tf32_rbf_max_abs_err": float(np.abs(k - k64).max())}


def phase_predictive(torch, seed: int = 0) -> dict:
    """The predictive runtimes on the card: XGBoost, LightGBM and sklearn
    served by `python -m kserve_tpu_torch.runtimes.predictive_server`
    subprocesses over V1 and V2, held to float64 walks and to the port on
    the CPU, with v2/infer p50 / p99 per framework and batch."""
    import importlib
    import pickle
    import shutil
    import tempfile

    import numpy as np

    import kserve_tpu_torch
    from kserve_tpu_torch.runtimes.gbdt_server import LightGBMModel, XGBoostModel
    from kserve_tpu_torch.runtimes.tensorize.sklearn_convert import (
        convert_estimator,
        map_classes,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    root = os.path.dirname(os.path.dirname(os.path.abspath(kserve_tpu_torch.__file__)))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="predictive_smoke_", dir=os.path.join(REPO, "build"))
    servers = []
    try:
        # the model files, from the seed
        dumps = {
            "xgboost": ("xgb-higgs", xgb_dump(rng, PREDICTIVE_TREES, XGB_DEPTH,
                                              HIGGS_FEATURES)),
            "lightgbm": ("lgb-higgs", lgb_dump(rng, PREDICTIVE_TREES, LGB_LEAVES,
                                               HIGGS_FEATURES)),
            "xgboost_multi": ("xgb-softprob", xgb_dump(
                rng, 60, 6, HIGGS_FEATURES, objective="multi:softprob",
                num_class=3, base_score=0.5)),
        }
        paths = {}
        for key, (name, dump) in dumps.items():
            d = os.path.join(tmp, name)
            os.makedirs(d)
            if isinstance(dump, dict):
                paths[key] = os.path.join(d, "model.json")
                with open(paths[key], "w") as f:
                    json.dump(dump, f, separators=(",", ":"))
            else:
                paths[key] = os.path.join(d, "model.txt")
                with open(paths[key], "w") as f:
                    f.write(dump)
        with open(os.path.join(tmp, STANDINS_MODULE + ".py"), "w") as f:
            f.write(STANDINS_SOURCE)
        sys.path.insert(0, tmp)
        try:
            S = importlib.import_module(STANDINS_MODULE)
        finally:
            sys.path.remove(tmp)
        standins = _standins(np, rng, S)
        svc_dir = os.path.join(tmp, "iris-svc")
        os.makedirs(svc_dir)
        with open(os.path.join(svc_dir, "model.pkl"), "wb") as f:
            pickle.dump(standins["svc"][0], f)

        # the servers, started together; TF32 forced on in their
        # processes, so their answers show that the port's products do not
        # depend on the process's matmul settings
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, tmp]),
                   TORCH_ALLOW_TF32_CUBLAS_OVERRIDE="1")
        launch = [("xgboost", "xgb-higgs", os.path.dirname(paths["xgboost"])),
                  ("lightgbm", "lgb-higgs", os.path.dirname(paths["lightgbm"])),
                  ("xgboost", "xgb-softprob", os.path.dirname(paths["xgboost_multi"])),
                  ("sklearn", "iris-svc", svc_dir)]
        t_start = time.perf_counter()
        for framework, name, d in launch:
            servers.append(_PredictiveServer(root, framework, name, d, env, tmp))

        # meanwhile, in this process: the port on the CPU (the servers'
        # second reference), the float64 walks, the leaves on the card, and
        # the sklearn stand-ins converted on cuda and on the CPU
        rows = {b: rng.normal(size=(b, HIGGS_FEATURES)).astype(np.float32)
                for b in PREDICTIVE_BATCHES}
        cpu_models = {
            "xgboost": XGBoostModel("xgb-higgs", paths["xgboost"], device="cpu"),
            "lightgbm": LightGBMModel("lgb-higgs", paths["lightgbm"], device="cpu"),
            "xgboost_multi": XGBoostModel("xgb-softprob", paths["xgboost_multi"],
                                          device="cpu")}
        refs = {}
        for key, walk in (("xgboost", walk_xgb), ("lightgbm", walk_lgb),
                          ("xgboost_multi", walk_xgb)):
            cpu_models[key].load()
            refs[key] = {b: walk(dumps[key][1], X) for b, X in rows.items()}
            _forest_on_card(np, cpu_models[key]._forest, rows[1024],
                            refs[key][1024][0])
        iris = {b: _iris_rows(np, rng, b) for b in PREDICTIVE_BATCHES}
        sk = {}
        for name, (est, ref) in standins.items():
            on_card = convert_estimator(est, "cuda")
            on_cpu = convert_estimator(est, "cpu")
            X = iris[1024]
            labels_card = map_classes(on_card.predict(X), on_card.classes)
            labels_cpu = map_classes(on_cpu.predict(X), on_cpu.classes)
            want, score = ref(X)
            if not np.array_equal(labels_card, labels_cpu):
                raise AssertionError(f"sklearn {name}: cuda and cpu labels differ")
            if name == "svc":
                # rows within 1e-4 of a pair's boundary in float64 may
                # round either way in float32; counted, and none expected
                near = np.abs(score).min(axis=1) < 1e-4
            else:
                near = np.zeros(len(X), dtype=bool)
            wrong = int(((labels_card != want) & ~near).sum())
            if wrong:
                raise AssertionError(f"sklearn {name}: {wrong} labels differ from float64")
            entry = {"rows": len(X), "near_boundary_rows": int(near.sum())}
            if on_card.predict_proba is not None:
                p_card = on_card.predict_proba(X).cpu().numpy()
                p_cpu = on_cpu.predict_proba(X).cpu().numpy()
                entry["proba_vs_f64"] = float(np.abs(p_card - score).max())
                entry["proba_vs_cpu"] = float(np.abs(p_card - p_cpu).max())
                if entry["proba_vs_f64"] > PROBA_TOL or entry["proba_vs_cpu"] > CPU_TOL:
                    raise AssertionError(f"sklearn {name} probabilities: {entry}")
            else:
                d_card = on_card.decision_function(X).cpu().numpy()
                d_cpu = on_cpu.decision_function(X).cpu().numpy()
                entry["decision_vs_f64"] = float(np.abs(d_card - score).max())
                entry["decision_vs_cpu"] = float(np.abs(d_card - d_cpu).max())
                if (entry["decision_vs_f64"] > DECISION_TOL
                        or entry["decision_vs_cpu"] > CPU_TOL):
                    raise AssertionError(f"sklearn {name} decisions: {entry}")
            sk[name] = entry
        sk["tf32"] = _tf32_evidence(torch, np, standins["svc"][0], iris[1024])
        ready_s = {s.name: round(s.wait_ready(), 3) for s in servers}
        start_wall = time.perf_counter() - t_start

        # served answers against the walks and the port on the CPU
        cpu_svc = convert_estimator(standins["svc"][0], "cpu")
        checks = {}
        for server in servers:
            if "on cuda" not in server.log():
                raise AssertionError(f"{server.name} did not place its model on cuda: "
                                     f"{server.log()[-2000:]}")
            got = {}
            for b in PREDICTIVE_BATCHES:
                if server.framework == "sklearn":
                    X = iris[b]
                    served = _served(np, server, X)
                    want, score = standins["svc"][1](X)
                    near = np.abs(score).min(axis=1) < 1e-4
                    if not np.array_equal(served, map_classes(cpu_svc.predict(X),
                                                              cpu_svc.classes)):
                        raise AssertionError("iris-svc labels differ from the CPU port")
                    if ((served != want) & ~near).any():
                        raise AssertionError("iris-svc labels differ from float64")
                    got[b] = {"labels": len(X), "near_boundary_rows": int(near.sum())}
                    continue
                X = rows[b]
                served = _served(np, server, X)
                key = {"xgb-higgs": "xgboost", "lgb-higgs": "lightgbm",
                       "xgb-softprob": "xgboost_multi"}[server.name]
                _, margin = refs[key][b]
                if key == "xgboost_multi":
                    proba = _softmax(np, margin)
                    want_cls, got_cls = proba.argmax(-1), served.argmax(-1)
                else:
                    proba = _sigmoid(np, margin[:, 0] if margin.ndim == 2 else margin)
                    want_cls, got_cls = proba > 0.5, served > 0.5
                cpu = np.asarray(cpu_models[key].predict(
                    {"instances": X.tolist()})["predictions"])
                err, cpu_err = float(np.abs(served - proba).max()), float(
                    np.abs(served - cpu).max())
                if not np.array_equal(want_cls, got_cls):
                    raise AssertionError(f"{server.name}: classes differ from the walk")
                if err > PROBA_TOL or cpu_err > CPU_TOL:
                    raise AssertionError(f"{server.name} batch {b}: vs walk {err}, "
                                         f"vs cpu {cpu_err}")
                got[b] = {"proba_vs_f64": err, "proba_vs_cpu": cpu_err}
            checks[server.name] = got

        latency = {}
        for server in servers:
            n = PREDICTIVE_TIMED_EXTRA if server.name == "xgb-softprob" else PREDICTIVE_TIMED
            data = iris if server.framework == "sklearn" else rows
            latency[server.name] = {b: _latency(np, server, data[b], n)
                                    for b in PREDICTIVE_BATCHES}
        forests = {
            s.name: next((line.split(": ", 1)[-1] for line in s.log().splitlines()
                          if "forest on" in line or "converted on" in line), None)
            for s in servers}
    finally:
        for server in servers:
            server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit({"phase": "predictive", "nvidia_smi": smi, "ready_s": ready_s,
          "servers_start_wall_s": start_wall, "models": forests,
          "served_checks": checks, "sklearn": sk, "v2_infer_binary": latency,
          "phase_wall_s": time.perf_counter() - t_phase})
    return latency


# ---------------------------------------------------------------- artifacts

ARTIFACTS_DIR = os.path.join(REPO, "build", "artifacts_smoke")
# the agent's mtime poll, and the rows of each served check
AGENT_POLL_S = 0.2
ARTIFACT_ROWS = 64


def _file_tree(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _higgs_artifacts(np, root: str, seed: int) -> dict:
    """The predictive phase's xgb-higgs and lgb-higgs dumps (drawn from `seed` as
    phase_predictive draws them), a second XGBoost forest of the same size
    (the agent's changed storageUri) and an iris-SVC stand-in pickle (its
    module written to root, which goes on the path), each in a directory of
    its own under root/src: {name: (framework, dir)}."""
    import importlib
    import pickle

    rng = np.random.default_rng(seed)
    docs = {
        "xgb-higgs": ("xgboost", "model.json",
                      xgb_dump(rng, PREDICTIVE_TREES, XGB_DEPTH, HIGGS_FEATURES)),
        "lgb-higgs": ("lightgbm", "model.txt",
                      lgb_dump(rng, PREDICTIVE_TREES, LGB_LEAVES, HIGGS_FEATURES)),
        "xgb-higgs-v2": ("xgboost", "model.json",
                         xgb_dump(np.random.default_rng(seed + 1), PREDICTIVE_TREES,
                                  XGB_DEPTH, HIGGS_FEATURES)),
    }
    out = {}
    for name, (framework, file_name, doc) in docs.items():
        d = os.path.join(root, "src", name)
        os.makedirs(d)
        with open(os.path.join(d, file_name), "w") as f:
            if isinstance(doc, dict):
                json.dump(doc, f, separators=(",", ":"))
            else:
                f.write(doc)
        out[name] = (framework, d)
    with open(os.path.join(root, STANDINS_MODULE + ".py"), "w") as f:
        f.write(STANDINS_SOURCE)
    if root not in sys.path:
        sys.path.insert(0, root)
    S = importlib.import_module(STANDINS_MODULE)
    d = os.path.join(root, "src", "iris-svc")
    os.makedirs(d)
    with open(os.path.join(d, "model.pkl"), "wb") as f:
        pickle.dump(_standins(np, np.random.default_rng(seed + 2), S)["svc"][0], f)
    out["iris-svc"] = ("sklearn", d)
    return out


def _pack(src_dir: str, www: str, name: str) -> None:
    """src_dir's files as www/<name>.tar.gz and www/<name>.zip."""
    import tarfile
    import zipfile

    files = sorted(_file_tree(src_dir))
    with tarfile.open(os.path.join(www, f"{name}.tar.gz"), "w:gz", compresslevel=1) as tar:
        for rel in files:
            tar.add(os.path.join(src_dir, rel), arcname=rel)
    with zipfile.ZipFile(os.path.join(www, f"{name}.zip"), "w",
                         zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        for rel in files:
            z.write(os.path.join(src_dir, rel), arcname=rel)


class _FileServer:
    """A standard-library HTTP server over a directory, on a thread."""

    def __init__(self, root: str):
        import functools as ft
        import http.server
        import threading

        class Quiet(http.server.SimpleHTTPRequestHandler):
            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), ft.partial(Quiet, directory=root))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def _served_v2(np, port: int, name: str, X):
    """The first output of POST /v2/models/{name}/infer (JSON) of rows X;
    the status and body when it is not 200."""
    (body, headers), _ = _v2_bodies(np, name, X)
    client = _Client(port)
    try:
        status, out_headers, raw = client.post(f"/v2/models/{name}/infer", body, headers)
    finally:
        client.close()
    if status != 200:
        return status, raw
    return status, _v2_output(np, status, out_headers, raw)


def phase_artifacts(torch, seed: int = 0, shared: Optional[dict] = None) -> dict:
    """Model storage, the storage initializer and the multi-model agent on
    the card: the predictive phase's HIGGS forests and an iris-SVC stand-in packed as
    .tar.gz, .zip and a directory, pulled over http and file:// by
    `python -m kserve_tpu_torch.storage.initializer --manifest`, one pull
    served by a predictive_server process, then a ModelAgent in this
    process hot-loading three of them over the port's REST server and
    following a rewritten models.json.  With `shared` (a dict), the
    predictive_server is left running there, under "xgb", for the explain
    phase; its caller stops it."""
    import asyncio
    import shutil

    import numpy as np

    import kserve_tpu_torch
    from kserve_tpu_torch.agent.watcher import ModelAgent
    from kserve_tpu_torch.model_repository import ModelRepository
    from kserve_tpu_torch.protocol.rest.server import RESTServer
    from kserve_tpu_torch.runtimes.gbdt_server import XGBoostModel
    from kserve_tpu_torch.runtimes.predictive_server import build_model
    from kserve_tpu_torch.storage.initializer import MANIFEST_NAME

    t_phase = time.perf_counter()
    split = _Split()
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(kserve_tpu_torch.__file__)))
    shutil.rmtree(ARTIFACTS_DIR, ignore_errors=True)
    os.makedirs(ARTIFACTS_DIR)
    root = ARTIFACTS_DIR
    www = os.path.join(root, "www")
    os.makedirs(www)
    fsrv = aloop = predictor = rest = agent = None
    try:
        src = _higgs_artifacts(np, root, seed)
        for name, (_, d) in src.items():
            _pack(d, www, name)
        split.mark("write_and_pack")
        fsrv = _FileServer(www)
        base = f"http://127.0.0.1:{fsrv.port}"

        # the initializer, a process of its own: every model as .tar.gz and
        # .zip over http and as a directory over file://
        pulls = []
        for name in ("xgb-higgs", "lgb-higgs", "iris-svc"):
            for form, uri in (("tgz", f"{base}/{name}.tar.gz"), ("zip", f"{base}/{name}.zip"),
                              ("dir", f"file://{src[name][1]}")):
                pulls.append((name, form, uri, os.path.join(root, "pulled", f"{name}-{form}")))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([pkg_root, root]),
                   TORCH_ALLOW_TF32_CUBLAS_OVERRIDE="1")
        cmd = [sys.executable, "-m", "kserve_tpu_torch.storage.initializer", "--manifest"]
        for _, _, uri, dest in pulls:
            cmd += [uri, dest]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=pkg_root, env=env, capture_output=True, text=True,
                              timeout=300)
        init_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"initializer exited {proc.returncode}: {proc.stderr[-3000:]}")
        wire_bytes = sum(os.path.getsize(os.path.join(www, f"{n}.{ext}"))
                         for n, form, _, _ in pulls if form != "dir"
                         for ext in (("tar.gz",) if form == "tgz" else ("zip",)))
        tree_bytes = 0
        for name, form, uri, dest in pulls:
            got = _file_tree(dest)
            manifest = json.loads(got.pop(MANIFEST_NAME))
            want = _file_tree(src[name][1])
            if got != want:
                raise AssertionError(f"{uri}: the pulled tree differs from the source")
            if manifest != {"files": {k: len(v) for k, v in want.items()}}:
                raise AssertionError(f"{uri}: manifest {manifest} does not list the tree")
            tree_bytes += sum(len(v) for v in want.values())
        initializer = {"pulls": len(pulls), "wall_s": init_wall,
                       "wire_mb": wire_bytes / 1e6, "tree_mb": tree_bytes / 1e6,
                       "tree_mb_per_s": tree_bytes / 1e6 / init_wall}
        split.mark("initializer_and_checks")

        # one pull served by predictive_server on the card (kept running
        # for the explain phase), against the port on the CPU
        d1 = os.path.join(root, "pulled", "xgb-higgs-tgz")
        predictor = _PredictiveServer(pkg_root, "xgboost", "xgb-higgs", d1, env, root)
        rng = np.random.default_rng(seed + 3)
        X = rng.normal(size=(ARTIFACT_ROWS, HIGGS_FEATURES)).astype(np.float32)
        iris_X = _iris_rows(np, rng, ARTIFACT_ROWS)
        cpu = XGBoostModel("xgb-higgs", d1, device="cpu")
        cpu.load()
        cpu_out = np.asarray(asyncio.run(cpu({"instances": X.tolist()}))["predictions"])
        split.mark("cpu_reference")

        # the agent: three models over http (.tar.gz), file:// and a .zip
        cfg = os.path.join(root, "agent", "models.json")
        os.makedirs(os.path.dirname(cfg))
        entries = [
            {"modelName": "xgb-higgs", "modelSpec": {
                "framework": "xgboost", "storageUri": f"{base}/xgb-higgs.tar.gz",
                "memory": "1Gi"}},
            {"modelName": "lgb-higgs", "modelSpec": {
                "framework": "lightgbm", "storageUri": f"file://{src['lgb-higgs'][1]}"}},
            {"modelName": "iris-svc", "modelSpec": {
                "framework": "sklearn", "storageUri": f"{base}/iris-svc.zip"}},
        ]
        with open(cfg, "w") as f:
            json.dump(entries, f)
        direct = {}
        for name in ("xgb-higgs", "lgb-higgs", "iris-svc", "xgb-higgs-v2"):
            framework, d = src[name]
            direct[name] = build_model(framework, name, d, device="cuda")
            direct[name].load()
        rows = {"xgb-higgs": X, "lgb-higgs": X, "iris-svc": iris_X, "xgb-higgs-v2": X}
        want = {name: np.asarray(asyncio.run(m({"instances": rows[name].tolist()}))[
            "predictions"], dtype=np.float64) for name, m in direct.items()}
        split.mark("direct_models")
        aloop = _AsyncThread()
        repo = ModelRepository()
        rest = RESTServer(repo, "127.0.0.1", 0)
        port = aloop.run(rest.start())
        agent = ModelAgent(repo, config_file=cfg, models_dir=os.path.join(root, "agent", "models"),
                           poll_interval=AGENT_POLL_S)
        t0 = time.perf_counter()
        aloop.run(agent.start())
        load_s = time.perf_counter() - t0
        if set(repo.models) != {"xgb-higgs", "lgb-higgs", "iris-svc"}:
            raise AssertionError(f"the agent loaded {sorted(repo.models)}")
        off = {n: str(m.device) for n, m in repo.models.items() if m.device.type != "cuda"}
        if off:
            raise AssertionError(f"the agent's models off the card: {off}")
        for name in ("xgb-higgs", "lgb-higgs", "iris-svc"):
            status, got = _served_v2(np, port, name, rows[name])
            if status != 200 or not np.array_equal(np.asarray(got, dtype=np.float64).ravel(),
                                                   want[name].ravel()):
                raise AssertionError(f"agent-served {name} differs from the direct model "
                                     f"({status})")
        split.mark("agent_boot")

        # models.json rewritten: lgb-higgs gone, xgb-higgs on a new forest
        svc_model = repo.get_model("iris-svc")
        entries = [dict(entries[0], modelSpec=dict(entries[0]["modelSpec"],
                                                   storageUri=f"{base}/xgb-higgs-v2.zip")),
                   entries[2]]
        mtime = os.path.getmtime(cfg)
        with open(cfg, "w") as f:
            json.dump(entries, f)
        os.utime(cfg, (mtime + 10, mtime + 10))  # an mtime the poll cannot miss
        t_write = time.perf_counter()
        gone_s = new_s = None
        while time.perf_counter() - t_write < 60 and (gone_s is None or new_s is None):
            if gone_s is None and _served_v2(np, port, "lgb-higgs", X)[0] == 404:
                gone_s = time.perf_counter() - t_write
            if new_s is None:
                status, got = _served_v2(np, port, "xgb-higgs", X)
                if status == 200 and np.array_equal(np.asarray(got, dtype=np.float64),
                                                    want["xgb-higgs-v2"]):
                    new_s = time.perf_counter() - t_write
            time.sleep(0.01)
        if gone_s is None or gone_s > 2 * AGENT_POLL_S + 0.3:
            raise AssertionError(f"lgb-higgs still served {gone_s} s after the rewrite")
        if new_s is None or new_s > 2 * AGENT_POLL_S + load_s:
            raise AssertionError(f"xgb-higgs not on its new forest {new_s} s after the "
                                 f"rewrite (boot load {load_s} s)")
        if repo.get_model("iris-svc") is not svc_model or set(repo.models) != {
                "xgb-higgs", "iris-svc"}:
            raise AssertionError("the agent reloaded an unchanged model or kept a removed one")
        split.mark("agent_rewrite")

        ready_s = predictor.wait_ready()
        status, served = _served_v2(np, predictor.port, "xgb-higgs", X)
        if status != 200:
            raise AssertionError(f"predictive_server over the pull answered {status}")
        cpu_err = float(np.abs(np.asarray(served, dtype=np.float64) - cpu_out).max())
        if cpu_err > CPU_TOL or "on cuda" not in predictor.log():
            raise AssertionError(f"predictive_server over the pull: vs cpu {cpu_err}")
        start_to_ready = predictor.ready_after_s
        if shared is not None:
            shared["xgb"], predictor = predictor, None
        split.mark("predictor")
    finally:
        if agent is not None:
            aloop.run(agent.stop())
        if rest is not None:
            aloop.run(rest.stop())
        if aloop is not None:
            aloop.close()
        if predictor is not None:
            predictor.stop()
        if fsrv is not None:
            fsrv.stop()
        shutil.rmtree(root, ignore_errors=True)
    split.mark("stop")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    out = {"phase": "artifacts", "nvidia_smi": smi, "initializer": initializer,
           "predictor_start_to_ready_s": start_to_ready, "predictor_ready_wait_s": ready_s,
           "predictor_vs_cpu": cpu_err, "agent_boot_load_s": load_s,
           "agent_models": 3, "rewrite_gone_s": gone_s, "rewrite_new_forest_s": new_s,
           "split_s": split.s, "phase_wall_s": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------- explain

EXPLAIN_DIR = os.path.join(REPO, "build", "explain_smoke")
EXPLAIN_ROWS = 8
# ~100 background rows: shap's advice is to summarize the background
EXPLAIN_BACKGROUND = 100
# shap's "auto" for 28 features: 2 * 28 + 2,048 coalitions
KERNELSHAP_SAMPLES = 2 * HIGGS_FEATURES + 2048
# 64 repeats per feature
PERMUTATION_SAMPLES = 64 * HIGGS_FEATURES
EXPLAIN_TIMED = 5
# sum(phi) against f(x) - f(mean background): the predictor's float32
# outputs bound it, not the float64 solve
EFFICIENCY_TOL = 1e-6
# the card against the port on the CPU over the same predictor: Kernel
# SHAP of max|phi| (both solve by QR in float64), permutation relative
SHAP_CPU_TOL = 1e-6
PERM_CPU_TOL = 1e-6


def phase_explain(torch, seed: int = 0, shared: Optional[dict] = None) -> dict:
    """The explainer on the card: two `python -m kserve_tpu_torch.runtimes.
    explainer_server --model_name xgb-higgs` processes (Kernel SHAP with
    2,104 coalitions, permutation with 64 repeats per feature) over the
    artifacts phase's XGBoost server, 8 HIGGS rows against 100 background
    rows: finite attributions, Kernel SHAP's efficiency against the
    predictor's own outputs, both methods against the port on the CPU over
    the same predictor (computed while the explainers start), a request's
    method overriding the flag, and :explain p50 over 5 calls.  The
    predictor is `shared["xgb"]` where the artifacts phase left one (this
    phase stops it), else one started here over the same forest."""
    import asyncio
    import shutil

    import numpy as np

    import kserve_tpu_torch
    from kserve_tpu_torch.runtimes.explainer_server import ExplainerModel

    t_phase = time.perf_counter()
    split = _Split()
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(kserve_tpu_torch.__file__)))
    shutil.rmtree(EXPLAIN_DIR, ignore_errors=True)
    os.makedirs(EXPLAIN_DIR)
    env = dict(os.environ, PYTHONPATH=pkg_root)
    predictor = (shared or {}).pop("xgb", None)
    from_artifacts = predictor is not None
    procs = []
    try:
        if predictor is None:  # --only explain: the artifacts phase's forest
            src = _higgs_artifacts(np, EXPLAIN_DIR, seed)
            predictor = _PredictiveServer(pkg_root, "xgboost", "xgb-higgs",
                                          src["xgb-higgs"][1], env, EXPLAIN_DIR)
        host = f"127.0.0.1:{predictor.port}"
        methods = {"kernelshap": KERNELSHAP_SAMPLES, "permutation": PERMUTATION_SAMPLES}
        servers = {m: _ServerProcess(
            "kserve_tpu_torch.runtimes.explainer_server",
            ["--model_name=xgb-higgs", f"--predictor_host={host}", f"--method={m}",
             f"--n_samples={n}"], f"explainer-{m}", EXPLAIN_DIR, env, cwd=pkg_root)
            for m, n in methods.items()}
        procs = list(servers.values())
        rng = np.random.default_rng(seed + 4)
        X = rng.normal(size=(EXPLAIN_ROWS, HIGGS_FEATURES)).astype(np.float32)
        bg = rng.normal(size=(EXPLAIN_BACKGROUND, HIGGS_FEATURES)).astype(np.float32)
        body = {"instances": X.tolist(), "background": bg.tolist()}
        predictor.wait_ready()
        split.mark("predictor")

        # while the explainers start: the predictor's own f(x) and f(mean
        # background), and the port on the CPU in this process over the
        # same predictor
        status, raw = _http(predictor.port, "POST", "/v1/models/xgb-higgs:predict",
                            {"instances": X.astype(np.float64).tolist()
                             + [bg.astype(np.float64).mean(axis=0).tolist()]})
        if status != 200:
            raise AssertionError(f"predictor answered {status}")
        f = np.asarray(json.loads(raw)["predictions"], dtype=np.float64)
        cpu = {}
        for m, n in methods.items():
            model = ExplainerModel("xgb-higgs", host, method=m, n_samples=n, device="cpu")
            cpu[m] = np.asarray(asyncio.run(model.explain(dict(body, method=m)))[
                "explanations"])
        split.mark("cpu_reference")
        ready_s = {m: s.wait_ready() for m, s in servers.items()}
        split.mark("explainers_ready_wait")

        path = "/v1/models/xgb-higgs:explain"
        out, p50, walls = {}, {}, {}
        for m, server in servers.items():
            answers, walls[m] = _timed_posts(server.port, path, dict(body, method=m),
                                             EXPLAIN_TIMED)
            if any(a != answers[0] for a in answers):
                raise AssertionError(f"{m}: repeated :explain calls answered differently")
            if answers[0]["method"] != m:
                raise AssertionError(f"{m}: answered {answers[0]['method']}")
            out[m] = np.asarray(answers[0]["explanations"])
            p50[m] = statistics.median(walls[m])
            if out[m].shape != X.shape or not np.isfinite(out[m]).all():
                raise AssertionError(f"{m}: attributions {out[m].shape}, not all finite")
        # a request's method overrides the process's flag
        (override,), _ = _timed_posts(servers["kernelshap"].port, path,
                                      dict(body, instances=body["instances"][:1],
                                           method="permutation"), 1)
        if override["method"] != "permutation":
            raise AssertionError("the request's method did not override the flag")
        split.mark("requests")

        gap = np.abs(out["kernelshap"].sum(axis=1) - (f[:-1] - f[-1]))
        if gap.max() > EFFICIENCY_TOL:
            raise AssertionError(f"Kernel SHAP efficiency gap {gap.max()}")
        cpu_err = {
            "kernelshap": float(np.abs(out["kernelshap"] - cpu["kernelshap"]).max()
                                / np.abs(cpu["kernelshap"]).max()),
            "permutation": float((np.abs(out["permutation"] - cpu["permutation"])
                                  / np.maximum(np.abs(cpu["permutation"]), 1e-30)).max())}
        if cpu_err["kernelshap"] > SHAP_CPU_TOL or cpu_err["permutation"] > PERM_CPU_TOL:
            raise AssertionError(f"card vs cpu {cpu_err}")
        logs = {m: s.log() for m, s in servers.items()}
        if not all("on cuda" in log for log in logs.values()):
            raise AssertionError(f"an explainer is not on cuda: {logs}")
    finally:
        for server in procs:
            server.stop()
        if predictor is not None:
            predictor.stop()
        shutil.rmtree(EXPLAIN_DIR, ignore_errors=True)
    split.mark("stop")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    res = {"phase": "explain", "nvidia_smi": smi, "rows": EXPLAIN_ROWS,
           "background": EXPLAIN_BACKGROUND, "predictor_from_artifacts": from_artifacts,
           "predictor_rows_per_row": {"kernelshap": KERNELSHAP_SAMPLES + 1,
                                      "permutation": PERMUTATION_SAMPLES + 1},
           "explainer_start_to_ready_s": {m: s.ready_after_s for m, s in servers.items()},
           "explainer_ready_wait_s": ready_s, "explain_p50_ms": p50, "explain_ms": walls,
           "efficiency_max_gap": float(gap.max()), "card_vs_cpu": cpu_err,
           "max_abs_phi": {m: float(np.abs(v).max()) for m, v in out.items()},
           "split_s": split.s, "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# ---------------------------------------------------------------- forecast

FORECAST_DIR = os.path.join(REPO, "build", "forecast_smoke")
# UCI ElectricityLoadDiagrams20112014: 370 clients, hourly; 12 weeks of
# history, a week ahead
LOAD_SERIES = 370
LOAD_STEPS = 2016
LOAD_HORIZON = 168
QUANTILES = [0.1, 0.5, 0.9]
# ETTh1: 7 columns, Informer's 720 -> 96 setting
ETT_VARS = 7
ETT_STEPS = 720
ETT_HORIZON = 96
FORECAST_TIMED = 5
FORECAST_START = "2026-01-01T00:00:00"
FORECAST_REL_TOL = 1e-6


def _load_curves(np, rng, n: int, steps: int):
    """[n, steps] hourly loads: a daily season (amplitude 20-200), a weekly
    one a tenth of it, a trend of up to a tenth over the window and noise
    of 0.15 of the amplitude, around a level 3-10 amplitudes up."""
    t = np.arange(steps)
    amp = rng.uniform(20, 200, size=(n, 1))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1))
    return (amp * rng.uniform(3, 10, size=(n, 1))
            + amp * np.sin(2 * np.pi * t / 24 + phase)
            + 0.1 * amp * np.sin(2 * np.pi * t / 168 + 2 * phase)
            + 0.1 * amp * rng.uniform(-1, 1, size=(n, 1)) * t / steps
            + 0.15 * amp * rng.normal(size=(n, steps)))


def _season_f64(np, y) -> int:
    """The season of best lag autocorrelation among 1, 4, 7, 12, 24 (the
    forecaster's candidates), recomputed here."""
    yc = y - y.mean()
    denom = float(yc @ yc) or 1.0
    best, best_r = 1, -np.inf
    for m in (1, 4, 7, 12, 24):
        if m < len(y):
            r = float(yc[m:] @ yc[:-m]) / denom
            if r > best_r:
                best, best_r = m, r
    return best


def _naive_f64(np, y, m: int, horizon: int):
    """(means, their float32 rounding bound) of seasonal-naive with drift in
    float64 over the float32-rounded series the device reads."""
    y32 = np.asarray(y, dtype=np.float32).astype(np.float64)
    T = len(y32)
    t = np.arange(horizon)
    if m < T:
        drift = (y32[T - 1] - y32[T - 1 - m]) / m
        base = y32[T - m + t % m]
    else:
        drift, base = 0.0, np.full(horizon, y32[T - 1])
    step = drift * (t // m + 1)
    mean = base + step
    return mean, 4 * 2.0 ** -24 * (np.abs(mean) + 3 * np.abs(step))


def _forecast_checks(np, name, served, cpu, series, freq_hours, horizon, want_m=None):
    """One input's gates; returns its picked seasons."""
    from datetime import datetime, timedelta

    _close_rel(np, name, served["mean_forecast"], cpu["mean_forecast"])
    for q in served["quantiles"]:
        _close_rel(np, name, served["quantiles"][q], cpu["quantiles"][q])
    mean = np.asarray(served["mean_forecast"], dtype=np.float64)
    cols = series[:, None] if series.ndim == 1 else series
    mean = mean[:, None] if mean.ndim == 1 else mean
    picks = []
    for v in range(cols.shape[1]):
        m = _season_f64(np, cols[:, v])
        picks.append(m)
        ref, bound = _naive_f64(np, cols[:, v], m, horizon)
        if (np.abs(mean[:, v] - ref) > bound).any():
            raise AssertionError(f"{name}[{v}]: means off the float64 recomputation "
                                 f"(season {m}) by {np.abs(mean[:, v] - ref).max()}")
    if want_m is not None and set(picks) != {want_m}:
        raise AssertionError(f"{name}: seasons {picks}, not {want_m}")
    q = [np.asarray(served["quantiles"][str(p)]) for p in QUANTILES]
    if not ((q[0] <= q[1]).all() and (q[1] <= q[2]).all()):
        raise AssertionError(f"{name}: quantiles out of order")
    start = (datetime.fromisoformat(FORECAST_START)
             + timedelta(hours=freq_hours * len(series))).isoformat()
    if served["start_timestamp"] != start:
        raise AssertionError(f"{name}: start {served['start_timestamp']}, not {start}")
    return picks


def _close_rel(np, what, got, want) -> None:
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if got.shape != want.shape or err.max() > FORECAST_REL_TOL:
        raise AssertionError(f"{what}: card vs cpu {err.max()}")


class _Split:
    """Seconds between successive marks of a phase ("where the time goes")."""

    def __init__(self):
        self.t = time.perf_counter()
        self.s: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def _forecast_profile(torch, body: dict) -> dict:
    """Kernels, copies and device busy time per series of one request
    through a forecaster on the card in this process, under
    torch.profiler (after one warm request)."""
    import asyncio

    from kserve_tpu_torch.protocol.timeseries import ForecastRequest
    from kserve_tpu_torch.runtimes.timeseries_server import SeasonalNaiveForecaster

    card = SeasonalNaiveForecaster("forecaster")
    card.load()
    req = ForecastRequest.from_json(body)
    asyncio.run(card.create_forecast(req))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(card.create_forecast(req))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = copies = 0
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "memcpy" in ev.key.lower():
            copies += ev.count
        else:
            kernels += ev.count
        busy_us += ev.self_device_time_total
    if kernels == 0:
        raise AssertionError("the profiled forecast ran no CUDA kernel")
    n = len(req.inputs)
    return {"series": n, "kernels_per_series": kernels / n, "copies_per_series": copies / n,
            "device_busy_ms": busy_us / 1e3, "wall_ms": wall * 1e3,
            "device_idle_share": max(0.0, 1 - busy_us / 1e3 / (wall * 1e3))}


def phase_forecast(torch, seed: int = 0) -> dict:
    """The time-series forecaster on the card: `python -m kserve_tpu_torch.
    runtimes.timeseries_server` in a process of its own; 370 hourly load
    curves of 12 weeks, a week ahead with quantiles 0.1 / 0.5 / 0.9, and
    one 7-column ETTh1-shaped series of 720 steps, 96 ahead: means against
    the port on the CPU and a float64 recomputation, season 24 picked,
    quantiles ordered, start timestamps advanced; wall p50 over 5 calls of
    each, and launches per series from one torch.profiler capture (taken
    in this process while the server starts)."""
    import asyncio
    import shutil

    import numpy as np

    import kserve_tpu_torch
    from kserve_tpu_torch.protocol.timeseries import ForecastRequest
    from kserve_tpu_torch.runtimes.timeseries_server import SeasonalNaiveForecaster

    t_phase = time.perf_counter()
    split = _Split()
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(kserve_tpu_torch.__file__)))
    shutil.rmtree(FORECAST_DIR, ignore_errors=True)
    os.makedirs(FORECAST_DIR)
    server = _ServerProcess("kserve_tpu_torch.runtimes.timeseries_server",
                            ["--model_name=forecaster"], "forecaster", FORECAST_DIR,
                            dict(os.environ, PYTHONPATH=pkg_root), cwd=pkg_root)
    try:
        rng = np.random.default_rng(seed + 5)
        loads = _load_curves(np, rng, LOAD_SERIES, LOAD_STEPS)
        ett = _load_curves(np, rng, ETT_VARS, ETT_STEPS).T  # [720, 7]
        options = {"horizon": LOAD_HORIZON, "quantiles": QUANTILES}
        bodies = {
            "electricity": {"model": "forecaster", "options": options, "inputs": [
                {"type": "univariate_time_series", "name": f"MT_{i + 1:03d}",
                 "series": loads[i].tolist(), "frequency": "H",
                 "start_timestamp": FORECAST_START} for i in range(LOAD_SERIES)]},
            "etth1": {"model": "forecaster",
                      "options": dict(options, horizon=ETT_HORIZON), "inputs": [
                          {"type": "multivariate_time_series", "name": "ETTh1",
                           "series": ett.tolist(), "frequency": "H",
                           "start_timestamp": FORECAST_START}]},
        }
        raw = {k: json.dumps(b).encode() for k, b in bodies.items()}
        split.mark("data")
        cpu_model = SeasonalNaiveForecaster("forecaster", device="cpu")
        cpu_model.load()
        cpu = {k: asyncio.run(cpu_model.create_forecast(ForecastRequest.from_json(b)))
               .to_dict() for k, b in bodies.items()}
        split.mark("cpu_reference")
        profile = _forecast_profile(torch, bodies["electricity"])
        split.mark("profile")
        ready_s = server.wait_ready()
        split.mark("server_ready_wait")
        walls, served = {}, {}
        client = _Client(server.port)
        try:
            for k, body in raw.items():
                walls[k] = []
                for i in range(FORECAST_TIMED):
                    t0 = time.perf_counter()
                    status, _, out = client.post("/v1/timeseries/forecast", body,
                                                 {"Content-Type": "application/json"})
                    walls[k].append((time.perf_counter() - t0) * 1e3)
                    if status != 200:
                        raise AssertionError(f"{k}: forecast answered {status}: {out[:300]!r}")
                    if i == 0:
                        served[k] = json.loads(out)
            status, _, out = client.request("GET", "/v1/timeseries/models", None, {})
        finally:
            client.close()
        split.mark("requests")
        if status != 200 or json.loads(out) != ["forecaster"]:
            raise AssertionError(f"/v1/timeseries/models answered {status} {out!r}")
        picks = {}
        for k in bodies:
            if served[k]["status"] != "completed" or served[k]["model"] != "forecaster":
                raise AssertionError(f"{k}: {served[k]['status']}")
            content = served[k]["outputs"][0]["content"]
            cpu_content = cpu[k]["outputs"][0]["content"]
            if len(content) != len(bodies[k]["inputs"]):
                raise AssertionError(f"{k}: {len(content)} outputs")
            series = loads if k == "electricity" else [ett]
            picks[k] = []
            for i, (got, want) in enumerate(zip(content, cpu_content)):
                picks[k] += _forecast_checks(
                    np, f"{k}/{got['name']}", got, want, np.asarray(series[i]), 1,
                    len(got["mean_forecast"]), want_m=24 if k == "electricity" else None)
        if "on cuda" not in server.log():
            raise AssertionError(f"the forecaster is not on cuda: {server.log()[-2000:]}")
        split.mark("checks")
    finally:
        server.stop()
        shutil.rmtree(FORECAST_DIR, ignore_errors=True)
    split.mark("stop")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    res = {"phase": "forecast", "nvidia_smi": smi,
           "server_start_to_ready_s": server.ready_after_s, "ready_wait_s": ready_s,
           "request_mb": {k: len(v) / 1e6 for k, v in raw.items()},
           "wall_p50_ms": {k: statistics.median(v) for k, v in walls.items()},
           "wall_ms": walls, "seasons": {k: sorted(set(v)) for k, v in picks.items()},
           "profile": profile, "split_s": split.s,
           "phase_wall_s": time.perf_counter() - t_phase}
    emit(res)
    return res


# ---------------------------------------------------------------- encoder

ENCODER_DIR = os.path.join(REPO, "build", "encoder_smoke")
# served answers against the port on the CPU with the same weights (f32
# both; the card's GEMMs sum in another order): hidden states, then the
# unit-norm embeddings, then the classifier and MLM logits
HIDDEN_TOL = 1e-4
EMB_TOL = 1e-5
LOGIT_TOL = 1e-4
# labels, rerank order and fill-mask argmax must be equal wherever the
# CPU's top-2 margin exceeds this; the rows under it are counted
MARGIN = 1e-4
ENCODER_BATCHES = (1, 8, 32)
# (name, text length in bytes): the byte tokenizer gives one token a byte,
# so buckets 16, 128 and 512
ENCODER_LENGTHS = (("~16", 12, 16), ("~128", 100, 128), ("~500", 470, 500))
ENCODER_TIMED = 30
RERANK_DOCS = 32
ENCODER_WORDS = (
    "the port of a serving stack from one accelerator to another keeps its "
    "answers while the kernels change underneath search engines embed every "
    "document once and every query at request time rerankers score each pair "
    "of query and passage classifiers label reviews tickets and messages the "
    "masked model fills a blank in a sentence token by token across languages "
    "café naïve résumé straße").split()


def _encoder_text(rng, lo: int, hi: int) -> str:
    """ASCII words from ENCODER_WORDS, `lo`..`hi` bytes long."""
    n = rng.randint(lo, hi)
    words = []
    while len(" ".join(words).encode()) < n:
        words.append(rng.choice(ENCODER_WORDS))
    return " ".join(words).encode()[:n].decode("utf-8", errors="ignore").rstrip()


def _write_bert_tokenizer(model_dir: str, vocab_size: int) -> dict:
    """A WordPiece tokenizer.json in bert-base-uncased's form over
    `vocab_size` ids: [PAD], [unused*], [UNK] 100, [CLS] 101, [SEP] 102,
    [MASK] 103, single characters, ENCODER_WORDS, `##` pieces, filler
    words; BertNormalizer, BertPreTokenizer, the WordPiece decoder and the
    [CLS] / [SEP] template (which encoding does not apply)."""
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [f"[unused{i}]" for i in range(99, 994)]
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()] + list("éïüßàç")
    tokens += chars
    for w in sorted({w.lower() for w in ENCODER_WORDS}):
        if w not in tokens:
            tokens.append(w)
    tokens += ["##" + c for c in chars] + ["##s", "##ing", "##ed", "##ly", "##er"]
    tokens += [f"filler{i}" for i in range(vocab_size - len(tokens))]
    vocab = {t: i for i, t in enumerate(tokens)}
    special = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    data = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for t in special],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                  "vocab": vocab},
    }
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "cls_token": "[CLS]", "sep_token": "[SEP]",
                   "unk_token": "[UNK]", "mask_token": "[MASK]"}, f)
    return vocab


def _write_bert_checkpoint(torch, params, cfg, model_dir: str) -> dict:
    """config.json, model.safetensors (HF names, `bert.` prefix) and a
    WordPiece tokenizer.json of the full vocabulary; returns what was
    written."""
    from kserve_tpu_torch.models import bert
    from kserve_tpu_torch.models.safetensors_io import save_file

    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architectures": ["BertForMaskedLM"], "model_type": "bert",
                   "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "type_vocab_size": cfg.type_vocab_size,
                   "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu"}, f)
    tensors = bert.hf_tensors(params)
    path = os.path.join(model_dir, "model.safetensors")
    t0 = time.perf_counter()
    save_file(tensors, path)
    vocab = _write_bert_tokenizer(model_dir, cfg.vocab_size)
    return {"tensors": len(tensors), "bytes": os.path.getsize(path),
            "write_s": time.perf_counter() - t0, "vocab": len(vocab)}


def _serve_models(models, phase: str):
    """A ModelServer over already-loaded `models` in a thread, listening on
    a free port and ready; returns (server, thread)."""
    import threading

    from kserve_tpu_torch.model_server import ModelServer

    server = ModelServer(http_port=0, host="127.0.0.1")
    errors = []

    def run():
        try:
            server.start(models)
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            errors.append(e)
            server.listening.set()

    thread = threading.Thread(target=run, name=f"{phase}-server", daemon=True)
    thread.start()
    server.listening.wait(300)
    if errors:
        raise errors[0]
    if not server.listening.is_set():
        raise TimeoutError(f"{phase} server did not start listening")
    status, _ = _http(server.port, "GET", "/v2/health/ready")
    if status != 200:
        raise AssertionError(f"{phase}: ready probe answered {status}")
    return server, thread


def _stop_models(server, thread) -> None:
    server.request_stop()
    thread.join(120)
    if thread.is_alive():
        raise RuntimeError("model server thread did not stop")


def _post_json(client, path: str, body) -> dict:
    status, _, raw = client.post(path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    if status != 200:
        raise AssertionError(f"{path} answered {status}: {raw[:300]!r}")
    return json.loads(raw)


def _pct(values, q: float) -> float:
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def _vectors(np, body: dict):
    """The embeddings of a response, float or base64, as [n, d] f32."""
    import base64

    rows = []
    for item in body["data"]:
        e = item["embedding"]
        rows.append(np.frombuffer(base64.b64decode(e), np.float32) if isinstance(e, str)
                    else np.asarray(e, np.float32))
    return np.stack(rows)


def _margins(np, logits):
    """The top-2 margin along the last axis."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _labels_check(np, name: str, served, cpu_logits) -> dict:
    """Served argmax against the CPU's, wherever the CPU's top-2 margin
    exceeds MARGIN; the rows under it are counted."""
    served = np.asarray(served)
    want = cpu_logits.argmax(-1)
    clear = _margins(np, cpu_logits) > MARGIN
    bad = int(((served != want) & clear).sum())
    if served.shape != want.shape or bad:
        raise AssertionError(f"encoder {name}: {bad} labels differ from the CPU's "
                             f"beyond the margin (shapes {served.shape} {want.shape})")
    return {"rows": int(want.size), "under_margin": int((~clear).sum()),
            "equal": int((served == want).sum())}


def phase_encoder(torch) -> None:
    """The encoder runtime at BERT-base (768 wide, 12 layers, 12 heads,
    vocabulary 30,522, 512 positions; ~110 M parameters, f32) from seeded
    random weights on cuda, held to the same model on the CPU."""
    import asyncio
    import random

    import numpy as np

    from kserve_tpu_torch.models import bert
    from kserve_tpu_torch.runtimes.encoder_server import TorchEncoderModel

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("encoder: TF32 is on; the f32 gates assume it off")
    cfg = bert.BertConfig()
    gpu = TorchEncoderModel("bert", config=cfg, task="classification",
                            random_weights=True, device="cuda")
    gpu.load()
    cpu = TorchEncoderModel("bert", config=cfg, task="classification",
                            random_weights=True, device="cpu")
    cpu.load()
    leaves = list(zip(bert.hf_tensors(gpu.params).items(), bert.hf_tensors(cpu.params).values()))
    n_params = sum(t.numel() for (_, t), _ in leaves)
    if not all(torch.equal(g, c) for (_, g), c in leaves):
        raise AssertionError("encoder: the seeded draw differs between cuda and the CPU")
    mlm = TorchEncoderModel("bert-mlm", config=cfg, task="fill_mask", device="cuda")
    mlm.tokenizer, mlm.params, mlm.ready = gpu.tokenizer, gpu.params, True
    # the checkpoint leg: the same draw written as a BERT checkpoint with a
    # WordPiece tokenizer.json, loaded back bit-equal
    written = _write_bert_checkpoint(torch, cpu.params, cfg, ENCODER_DIR)
    t0 = time.perf_counter()
    ckpt = TorchEncoderModel("bert-ckpt", model_dir=ENCODER_DIR, device="cuda")
    ckpt.load()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if ckpt.config != cfg or not all(
            torch.equal(a.cpu(), b) for a, b in zip(
                bert.hf_tensors(ckpt.params).values(), bert.hf_tensors(cpu.params).values())):
        raise AssertionError("encoder: checkpoint parameters differ from the draw")
    cpu_ckpt = TorchEncoderModel("bert-ckpt", model_dir=ENCODER_DIR, device="cpu")
    cpu_ckpt.load()
    server, thread = _serve_models([gpu, mlm, ckpt], "encoder")
    client = _Client(server.port)
    rng = random.Random(0)
    out = {"phase": "encoder", "parameters": n_params,
           "weights_gb": n_params * 4 / 1e9, "checkpoint": dict(written, load_s=load_s)}
    try:
        # hidden states, cuda against the CPU, one batch of 8 x 128
        ids, mask, types = cpu._batch_encode([_encoder_text(rng, 100, 128) for _ in range(8)])
        with torch.inference_mode():
            h_gpu = bert.encode(gpu.params, cfg, *(torch.tensor(a).cuda() for a in (ids, mask, types))).cpu()
            h_cpu = bert.encode(cpu.params, cfg, *(torch.tensor(a) for a in (ids, mask, types)))
        hidden_err = float((h_gpu - h_cpu).abs().max())
        if not hidden_err <= HIDDEN_TOL:
            raise AssertionError(f"encoder: hidden states {hidden_err:.3g} from the CPU's")
        out["hidden_max_abs_err"] = hidden_err
        # embeddings: every batch x length, float and base64, then timed
        emb, latency, cpu_s = {}, {}, 0.0
        for B in ENCODER_BATCHES:
            for label, lo, hi in ENCODER_LENGTHS:
                texts = [_encoder_text(rng, lo, hi) for _ in range(B)]
                t0 = time.perf_counter()
                want = _vectors(np, asyncio.run(cpu.create_embedding(_emb_req(texts, "float"))).to_dict())
                cpu_s += time.perf_counter() - t0
                errs = []
                for fmt in ("float", "base64"):
                    body = _post_json(client, "/openai/v1/embeddings",
                                      {"model": "bert", "input": texts, "encoding_format": fmt})
                    got = _vectors(np, body)
                    if got.shape != (B, cfg.hidden_size) or not np.isfinite(got).all():
                        raise AssertionError(f"encoder: embeddings {got.shape}")
                    errs.append(float(np.abs(got - want).max()))
                if max(errs) > EMB_TOL:
                    raise AssertionError(f"encoder: embeddings {B} x {label} {errs} "
                                         f"from the CPU's (gate {EMB_TOL})")
                dims = cfg.hidden_size // 12
                cut = _post_json(client, "/openai/v1/embeddings",
                                 {"model": "bert", "input": texts[:1], "dimensions": dims})
                if len(cut["data"][0]["embedding"]) != dims:
                    raise AssertionError("encoder: dimensions not applied")
                body = {"model": "bert", "input": texts, "encoding_format": "base64"}
                walls = []
                for _ in range(ENCODER_TIMED):
                    t0 = time.perf_counter()
                    _post_json(client, "/openai/v1/embeddings", body)
                    walls.append((time.perf_counter() - t0) * 1e3)
                key = f"{B}x{label}"
                emb[key] = {"max_abs_err": max(errs), "tokens": int(cpu._batch_encode(texts)[1].sum())}
                latency[key] = {"p50_ms": _pct(walls, 0.5), "p99_ms": _pct(walls, 0.99),
                                "min_ms": min(walls)}
        out.update(embeddings=emb, embeddings_ms=latency, cpu_reference_s=cpu_s)
        # rerank: one query over 32 documents
        query = _encoder_text(rng, 30, 40)
        docs = [_encoder_text(rng, 40, 120) for _ in range(RERANK_DOCS)]
        served = _post_json(client, "/openai/v1/rerank",
                            {"model": "bert", "query": query, "documents": docs})
        ids, mask, types = cpu._batch_encode([query] * RERANK_DOCS, docs)
        with torch.inference_mode():
            scores = bert.classify(cpu.params, cfg, *(torch.tensor(a) for a in (ids, mask, types)))[:, -1].numpy()
        order = [r["index"] for r in served["results"]]
        score_err = max(abs(r["relevance_score"] - float(scores[r["index"]]))
                        for r in served["results"])
        inversions = sum(scores[order[i]] < scores[order[j]] - MARGIN
                         for i in range(len(order)) for j in range(i + 1, len(order)))
        close = int(sum(abs(scores[order[i]] - scores[order[i + 1]]) <= MARGIN
                        for i in range(len(order) - 1)))
        if sorted(order) != list(range(RERANK_DOCS)) or inversions or score_err > LOGIT_TOL:
            raise AssertionError(f"encoder rerank: {inversions} inversions beyond the "
                                 f"margin, scores {score_err:.3g} from the CPU's")
        top = _post_json(client, "/openai/v1/rerank", {
            "model": "bert", "query": query, "documents": docs, "top_n": 5,
            "return_documents": False})
        if [r["index"] for r in top["results"]] != order[:5] or "document" in top["results"][0]:
            raise AssertionError("encoder rerank: top_n / return_documents")
        out["rerank"] = {"documents": RERANK_DOCS, "score_max_abs_err": score_err,
                         "adjacent_under_margin": close, "equal_order": order == list(
                             np.argsort(-scores))}
        # classification and fill-mask over V1 and V2
        texts = [_encoder_text(rng, 20, 120) for _ in range(8)]
        ids, mask, types = cpu._batch_encode(texts)
        with torch.inference_mode():
            t = [torch.tensor(a) for a in (ids, mask, types)]
            cls_logits = bert.classify(cpu.params, cfg, *t).numpy()
            mlm_logits = bert.fill_mask_logits(cpu.params, cfg, t[0], t[1]).numpy()
        v2 = {"id": "s", "inputs": [{"name": "text", "shape": [len(texts)],
                                     "datatype": "BYTES", "data": texts}]}
        checks = {}
        for model, logits in (("bert", cls_logits), ("bert-mlm", mlm_logits)):
            v1 = _post_json(client, f"/v1/models/{model}:predict", {"instances": texts})
            checks[f"{model}_v1"] = _labels_check(np, model, v1["predictions"], logits)
            got = _post_json(client, f"/v2/models/{model}/infer", v2)["outputs"][0]
            checks[f"{model}_v2"] = _labels_check(
                np, model, np.asarray(got["data"]).reshape(got["shape"]), logits)
        out["predict"] = checks
        out["classify_logit_margin_min"] = float(_margins(np, cls_logits).min())
        # the checkpoint's WordPiece path: ids and embeddings
        texts = [" ".join(rng.choice(ENCODER_WORDS) for _ in range(12)).capitalize() + "!"
                 for _ in range(4)]
        wp_ids = ckpt.tokenizer.encode(texts[0], add_bos=False)
        unk = ckpt.tokenizer._tok.token_to_id("[UNK]")
        if unk in wp_ids or min(wp_ids) < 999:
            raise AssertionError(f"encoder: WordPiece ids {wp_ids}")
        got = _vectors(np, _post_json(client, "/openai/v1/embeddings",
                                      {"model": "bert-ckpt", "input": texts}))
        want = _vectors(np, asyncio.run(
            cpu_ckpt.create_embedding(_emb_req(texts, "float"))).to_dict())
        ckpt_err = float(np.abs(got - want).max())
        if ckpt_err > EMB_TOL:
            raise AssertionError(f"encoder checkpoint: embeddings {ckpt_err:.3g} off")
        out["checkpoint"].update(wordpiece_ids=wp_ids[:8], embeddings_max_abs_err=ckpt_err)
        status, raw = _http(server.port, "POST", "/openai/v1/completions",
                            {"model": "bert", "prompt": "x"})
        if status != 400 or b"does not support this endpoint" not in raw:
            raise AssertionError(f"encoder: completions on an encoder answered {status}")
        # TF32, reported and shown caught: the same embeddings with TF32 on
        ids, mask, _ = cpu._batch_encode(texts)
        want = bert.embed(cpu.params, cfg, torch.tensor(ids), torch.tensor(mask)).numpy()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with torch.inference_mode():
                tf32 = bert.embed(gpu.params, cfg, torch.tensor(ids).cuda(),
                                  torch.tensor(mask).cuda()).cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_err = float(np.abs(tf32 - want).max())
        if tf32_err <= EMB_TOL:
            raise AssertionError(f"encoder: TF32 embeddings {tf32_err:.3g} pass the gate")
        out["tf32_embeddings_max_abs_err"] = tf32_err
    finally:
        client.close()
        _stop_models(server, thread)
        import shutil

        shutil.rmtree(ENCODER_DIR, ignore_errors=True)
    out["memory_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    del gpu, mlm, ckpt
    torch.cuda.empty_cache()


def _emb_req(texts, fmt: str):
    from kserve_tpu_torch.protocol.openai.types import EmbeddingRequest

    return EmbeddingRequest(model="bert", input=list(texts), encoding_format=fmt)


# ---------------------------------------------------------------- graph

GRAPH_DIR = os.path.join(REPO, "build", "graph_smoke")
GRAPH_PROMPTS = [("short", "Tell me about the sea.", 32),
                 ("medium", BASE_TEXT * 6, 32),
                 ("long", (BASE_TEXT * 20)[:999], 16)]
GRAPH_TIMED = 30
GRAPH_DEAD_TRIES = 8


def _timed_posts(port: int, path: str, body, n: int):
    """(answers, ms per request) of `n` POSTs on one kept-alive connection."""
    client = _Client(port)
    answers, walls = [], []
    try:
        for _ in range(n):
            t0 = time.perf_counter()
            status, _, raw = client.post(path, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            walls.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"{path} answered {status}: {raw[:300]!r}")
            answers.append(json.loads(raw))
    finally:
        client.close()
    return answers, walls


def _paired_posts(direct, via, body, n: int):
    """`n` pairs of POSTs of `body`, alternating which of `direct` and `via`
    ((port, path) each, one kept-alive connection each) goes first; returns
    (first direct answer, first via answer, direct ms, via ms, via - direct
    ms per pair)."""
    clients = [_Client(direct[0]), _Client(via[0])]
    raw = json.dumps(body).encode()
    walls, answers = ([], []), ([], [])
    try:
        for i in range(n):
            for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                path = (direct, via)[k][1]
                t0 = time.perf_counter()
                status, _, out = clients[k].post(path, raw, {"Content-Type": "application/json"})
                walls[k].append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"{path} answered {status}: {out[:300]!r}")
                answers[k].append(json.loads(out))
    finally:
        for c in clients:
            c.close()
    if any(a != answers[0][0] for a in answers[0]) or any(a != answers[1][0] for a in answers[1]):
        raise AssertionError(f"{direct[1]}: repeated requests answered differently")
    return (answers[0][0], answers[1][0], walls[0], walls[1],
            [b - a for a, b in zip(*walls)])


class _RouterProcess:
    """`python -m kserve_tpu_torch.graph.router` over `spec`, its log in a
    file under build/."""

    def __init__(self, spec: dict, log_path: str):
        self.port = _free_port()
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kserve_tpu_torch.graph.router",
             "--graph-json", json.dumps(spec), f"--port={self.port}", "--timeout=120"],
            cwd=REPO, stdout=self._log, stderr=subprocess.STDOUT)

    def wait_ready(self, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                with open(self.log_path) as f:
                    raise AssertionError(f"router exited {self.proc.returncode}: "
                                         f"{f.read()[-3000:]}")
            try:
                if _http(self.port, "GET", "/healthz", timeout=5)[0] == 200:
                    return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"router not ready in {timeout} s")

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._log.close()


def phase_graph(torch) -> None:
    """An InferenceGraph (BASELINE config 5): the graph router in front of
    a tokenizer-transformer and the Llama-3-8B server, plus transformers
    forwarding V1 and V2 to a BERT-base encoder server."""
    import numpy as np

    from kserve_tpu_torch.engine.tokenizer import load_tokenizer
    from kserve_tpu_torch.model import Model, PredictorConfig
    from kserve_tpu_torch.models import bert
    from kserve_tpu_torch.runtimes.encoder_server import TorchEncoderModel

    t_phase = time.perf_counter()
    os.makedirs(GRAPH_DIR, exist_ok=True)
    mc, params = _llama3_8b_params(torch)
    # every id decodes to its own text: equal completion texts are equal
    # token ids
    _write_mixtral_tokenizer(GRAPH_DIR, mc.vocab_size)
    tok = load_tokenizer(GRAPH_DIR, mc.vocab_size)

    class TokenizerTransformer(Model):
        """{"instances": [text], "max_tokens": n} -> the generative
        server's completion body of the text's token ids (greedy)."""

        def __init__(self, model_name: str):
            super().__init__("tokenize")
            self.model_name = model_name
            self.calls = 0

        async def predict(self, payload, headers=None):
            self.calls += 1
            return {"model": self.model_name, "prompt": tok.encode(payload["instances"][0]),
                    "max_tokens": payload.get("max_tokens", 16), "temperature": 0,
                    "ignore_eos": True}

    llama, l_srv, l_thread = _start_server(
        torch, SERVE_ARGS + [f"--model_dir={GRAPH_DIR}"], "graph", load=lambda: params)
    enc = TorchEncoderModel("bert", config=bert.BertConfig(), task="classification",
                            random_weights=True, device="cuda")
    enc.load()
    enc2 = TorchEncoderModel("bert2", config=enc.config, task="classification",
                             device="cuda")
    enc2.tokenizer, enc2.params, enc2.ready = enc.tokenizer, enc.params, True
    servers = [_serve_models([enc, enc2], "graph")]
    host = f"127.0.0.1:{servers[0][0].port}"
    transformer = TokenizerTransformer(llama.name)
    forwarders = [Model(name, PredictorConfig(predictor_host=host, predictor_protocol=proto))
                  for name, proto in (("bert", "v1"), ("bert2", "v2"))]
    for m in (transformer, *forwarders):
        m.load()
    servers.append(_serve_models([transformer, *forwarders], "graph"))
    e_port, t_port = servers[0][0].port, servers[1][0].port
    dead_port = _free_port()
    step = {"tokenize": f"http://127.0.0.1:{t_port}/v1/models/tokenize:predict",
            "generate": f"http://127.0.0.1:{l_srv.port}/openai/v1/completions",
            "classify": f"http://127.0.0.1:{e_port}/v1/models/bert:predict",
            "dead-step": f"http://127.0.0.1:{dead_port}/v1/models/x:predict"}
    spec = {"nodes": {
        "root": {"routerType": "Switch", "steps": [
            {"condition": "route==generate", "nodeName": "pipeline"},
            {"condition": "route==classify", "nodeName": "classify"},
            {"condition": "route==tokenize", "nodeName": "tokenize"},
            {"condition": "route==dead", "nodeName": "dead"}]},
        "pipeline": {"routerType": "Sequence", "steps": [
            {"serviceUrl": step["tokenize"], "name": "tokenize"},
            {"serviceUrl": step["generate"], "name": "generate", "data": "$response"}]},
        "classify": {"routerType": "Sequence", "steps": [
            {"serviceUrl": step["classify"], "name": "classify"}]},
        "tokenize": {"routerType": "Sequence", "steps": [
            {"serviceUrl": step["tokenize"], "name": "tokenize"}]},
        "dead": {"routerType": "Sequence", "steps": [
            {"serviceUrl": step["dead-step"], "name": "dead-step"}]}}}
    router = _RouterProcess(spec, os.path.join(GRAPH_DIR, "router.log"))
    out = {"phase": "graph", "model": f"{llama.name} (random weights, seed 1, bf16)"}
    try:
        out["router_ready_s"] = router.wait_ready()
        # the pipeline: text -> tokenizer-transformer -> completions, token
        # for token the direct completion of the same text.  A first direct
        # call caches the prompt's full pages, so that the two compared
        # calls take one numeric path (a prefix hit); a cold and a hit
        # prefill differ in bf16 rounding, which random weights amplify
        pipeline = {}
        for label, text, n in GRAPH_PROMPTS:
            body = {"model": llama.name, "prompt": text, "max_tokens": n,
                    "temperature": 0, "ignore_eos": True}
            _timed_posts(l_srv.port, "/openai/v1/completions", body, 1)
            (via,), via_ms = _timed_posts(router.port, "/", {
                "route": "generate", "instances": [text], "max_tokens": n}, 1)
            (direct,), direct_ms = _timed_posts(l_srv.port, "/openai/v1/completions",
                                                body, 1)
            if (via["choices"][0]["text"] != direct["choices"][0]["text"]
                    or via["usage"] != direct["usage"]
                    or direct["usage"]["completion_tokens"] != n):
                raise AssertionError(f"graph {label}: through the graph "
                                     f"{via['usage']} {via['choices'][0]['text'][:80]!r}, "
                                     f"direct {direct['usage']} "
                                     f"{direct['choices'][0]['text'][:80]!r}")
            pipeline[label] = {"prompt_tokens": direct["usage"]["prompt_tokens"],
                               "completion_tokens": n, "via_graph_ms": via_ms[0],
                               "direct_ms": direct_ms[0]}
        out["pipeline"] = pipeline
        # forwarding: a transformer with predictor_host, V1 and V2, against
        # the encoder called directly; the router's hop to the encoder and
        # to the (cheap) tokenizer-transformer; requests alternate in pairs
        texts = ["a fine review of the port", "the worst kernel", "tokens per second"]
        v2 = {"id": "g", "inputs": [{"name": "text", "shape": [3], "datatype": "BYTES",
                                     "data": texts}]}
        v1_path, v2_path = "/v1/models/bert:predict", "/v2/models/bert2/infer"
        hops = {}
        for name, direct, via, body in (
                ("forward_v1", (e_port, v1_path), (t_port, v1_path), {"instances": texts}),
                ("forward_v2", (e_port, v2_path), (t_port, v2_path), v2),
                ("router_classify", (e_port, v1_path), (router.port, "/"),
                 {"route": "classify", "instances": texts}),
                ("router_tokenize", (t_port, "/v1/models/tokenize:predict"),
                 (router.port, "/"), {"route": "tokenize", "instances": [texts[0]]})):
            want, got, d_ms, v_ms, added = _paired_posts(direct, via, body, GRAPH_TIMED)
            if name == "forward_v2":
                want = [o["data"] for o in want["outputs"]]
                got = [o["data"] for o in got["outputs"]]
            if got != want:
                raise AssertionError(f"graph {name}: {got} != direct {want}")
            hops[name] = {"direct_p50_ms": _pct(d_ms, 0.5), "via_p50_ms": _pct(v_ms, 0.5),
                          "via_p99_ms": _pct(v_ms, 0.99),
                          "added_ms_per_hop_p50": _pct(added, 0.5)}
        out["hops"] = hops
        # faults: a dead step 502 naming it, then the breaker's instant 503
        seen = []
        for _ in range(GRAPH_DEAD_TRIES):
            t0 = time.perf_counter()
            status, raw = _http(router.port, "POST", "/", {"route": "dead"})
            seen.append((status, (time.perf_counter() - t0) * 1e3,
                         json.loads(raw).get("error", "")))
        if seen[0][0] != 502 or "dead-step" not in seen[0][2]:
            raise AssertionError(f"graph: a dead step answered {seen[0]}")
        opened = [s for s in seen if s[0] == 503 and "circuit open" in s[2]]
        if not opened or seen[-1][0] != 503:
            raise AssertionError(f"graph: the breaker never opened: {seen}")
        # an expired deadline: 504 before any step is called
        calls = transformer.calls
        status, headers, raw = _http_h(router.port, "POST", "/", {
            "route": "generate", "instances": ["never sent"]},
            headers={"x-request-id": "graph-rid", "x-request-deadline": "0"})
        if (status != 504 or headers.get("x-request-id") != "graph-rid"
                or transformer.calls != calls):
            raise AssertionError(f"graph: an expired deadline answered {status} "
                                 f"{raw[:200]!r}, {transformer.calls - calls} calls")
        out["faults"] = {"statuses": [s[0] for s in seen],
                         "first_502": seen[0][2][:120],
                         "open_503_ms": [s[1] for s in opened],
                         "deadline_504": json.loads(raw)["error"]}
        out["memory_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    finally:
        router.stop()
        for srv, thread in servers:
            _stop_models(srv, thread)
        _stop_server(torch, llama, l_srv, l_thread)
        import shutil

        shutil.rmtree(GRAPH_DIR, ignore_errors=True)
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    del params, enc, enc2
    torch.cuda.empty_cache()


EPP_DIR = os.path.join(REPO, "build", "epp_smoke")
EPP_KV_PAGES = 1024
EPP_PREFIXES = 4
EPP_PER_PREFIX = 6
EPP_MAX_TOKENS = 32
EPP_CONCURRENCY = 8
# hop pairs: a short completion costs one whole dispatch (~360 ms, whose
# jitter hides the hop: its spans resolve it), GET /openai/v1/models ~1 ms
EPP_TIMED = {"completion": 10, "models": 30}
# of each prefix's requests after its first, the share that must land on
# the replica that served the first
EPP_AFFINITY_MIN = 0.9
EPP_PROFILE_S = 2.0
EPP_WORDS = ("cache", "page", "kernel", "replica", "router", "token", "prefix",
             "decode", "tensor", "latency", "stream", "batch", "queue", "engine")


def _epp_texts(tok) -> tuple:
    """EPP_PREFIXES seeded ~1,000-token prefixes (a system prompt or a
    retrieved context each) and, per prefix, EPP_PER_PREFIX distinct
    ~50-token tails."""
    import random

    rng = random.Random(18)
    prefixes, tails = [], []
    for k in range(EPP_PREFIXES):
        words = [f"Context {k}:"]
        while len(tok.encode(" ".join(words))) < 1000:
            words.append(rng.choice(EPP_WORDS))
        prefixes.append(" ".join(words) + "\n")
        tails.append([f"Q{k}.{j}: " + " ".join(rng.choice(EPP_WORDS) for _ in range(7))
                      for j in range(EPP_PER_PREFIX)])
    return prefixes, tails


def _epp_body(name: str, prefix: str, tail: str, chat: bool,
              max_tokens: int = EPP_MAX_TOKENS) -> dict:
    """A streamed chat (the prefix as its system message) or a completion
    (the prefix then the tail), greedy."""
    if chat:
        return {"model": name, "stream": True, "max_tokens": max_tokens,
                "temperature": 0, "ignore_eos": True,
                "messages": [{"role": "system", "content": prefix},
                             {"role": "user", "content": tail}]}
    return {"model": name, "prompt": prefix + tail, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True}


def _epp_call(port: int, body: dict, trace_id: str) -> dict:
    """One request through `port` with a traceparent of `trace_id`: its
    status, and for a stream its events with their arrival times, else
    its JSON answer."""
    import http.client

    headers = {"Content-Type": "application/json",
               "traceparent": f"00-{trace_id}-{os.urandom(8).hex()}-01"}
    chat = "messages" in body
    path = "/openai/v1/chat/completions" if chat else "/openai/v1/completions"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    out = {"trace_id": trace_id, "chat": chat}
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(body), headers=headers)
        resp = conn.getresponse()
        out["status"] = resp.status
        if not chat or resp.status != 200:
            raw = resp.read()
            out["body"] = json.loads(raw) if raw else None
        else:
            events, times = [], []
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().strip()
                if line.startswith("data: "):
                    events.append(line[len("data: "):])
                    times.append(time.perf_counter() - t0)
            out["events"], out["times"] = events, times
    except (OSError, http.client.HTTPException) as e:
        out["status"], out["error"] = None, repr(e)
    finally:
        conn.close()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _epp_wave(port: int, calls) -> list:
    """`calls` ((body, trace id) pairs) through `port`, EPP_CONCURRENCY at
    a time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=EPP_CONCURRENCY) as pool:
        return list(pool.map(lambda c: _epp_call(port, *c), calls))


def _epp_check_ok(label: str, results) -> None:
    """Every answer 200 with EPP_MAX_TOKENS tokens; each stream's first event
    before its last (the proxy streams, it does not buffer)."""
    for r in results:
        if r["status"] != 200:
            raise AssertionError(f"epp {label}: answered {r['status']} "
                                 f"{r.get('body') or r.get('error')}")
        if r["chat"]:
            events = r["events"]
            if events[-1] != "[DONE]" or len(events) != EPP_MAX_TOKENS + 2:
                raise AssertionError(f"epp {label}: a stream of {len(events)} events")
            if not r["times"][1] < r["times"][-2]:
                raise AssertionError(f"epp {label}: the first token came with the "
                                     f"last ({r['times'][1]} s, {r['times'][-2]} s)")
        elif r["body"]["usage"]["completion_tokens"] != EPP_MAX_TOKENS:
            raise AssertionError(f"epp {label}: {r['body']['usage']}")


def _served_by(engines, trace_ids) -> dict:
    """{trace id: index of the engine whose finished timelines hold it}."""
    out = {}
    for i, engine in enumerate(engines):
        for tl in engine.telemetry.timelines:
            if tl.trace is not None and tl.trace.trace_id in trace_ids:
                if out.setdefault(tl.trace.trace_id, i) != i:
                    raise AssertionError(f"trace {tl.trace.trace_id} on two replicas")
    return out


class _OTLPCollector:
    """The OTLP/HTTP JSON receiver of the smoke: POST /v1/traces on the
    standard library, every span kept."""

    def __init__(self):
        import http.server
        import threading

        spans = self.spans = []
        self.posts = 0
        collector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                raw = self.rfile.read(int(self.headers["Content-Length"]))
                doc = json.loads(raw)
                for rs in doc["resourceSpans"]:
                    service = {a["key"]: a["value"].get("stringValue")
                               for a in rs["resource"]["attributes"]}.get("service.name")
                    for ss in rs["scopeSpans"]:
                        for sp in ss["spans"]:
                            sp["service"] = service
                            spans.append(sp)
                collector.posts += 1
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def trace(self, trace_id: str) -> list:
        return [s for s in self.spans if s["traceId"] == trace_id]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


class _EPPProcess:
    """`python -m kserve_tpu_torch.scheduler.epp` over `urls`, exporting
    spans to `otlp`, its log in a file under build/."""

    def __init__(self, urls, otlp: str, log_path: str):
        self.port = _free_port()
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kserve_tpu_torch.scheduler.epp",
             "--replicas", ",".join(urls), "--poll-interval", "0.2",
             "--port", str(self.port)],
            cwd=REPO, stdout=self._log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OTEL_EXPORTER_OTLP_ENDPOINT=otlp))

    def wait_ready(self, timeout: float = 120.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                with open(self.log_path) as f:
                    raise AssertionError(f"EPP exited {self.proc.returncode}: "
                                         f"{f.read()[-3000:]}")
            try:
                if _http(self.port, "GET", "/healthz", timeout=5)[0] == 200:
                    return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"EPP not ready in {timeout} s")

    def state(self) -> dict:
        status, raw = _http(self.port, "GET", "/state")
        if status != 200:
            raise AssertionError(f"EPP /state answered {status}")
        return json.loads(raw)

    def stop(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        self._log.close()


def _profile_summary(path: str, window_s: float) -> dict:
    """Kernel names and the device's busy ms and idle share of a torch.
    profiler Chrome trace (the union of its kernels' intervals over the
    capture's span)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    if not kernels:
        raise AssertionError(f"the capture {path} holds no CUDA kernel")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in kernels)
    busy_us, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ts = [float(e["ts"]) for e in events if "ts" in e and e.get("ph") == "X"]
    span_us = max(ts) - min(ts) if ts else 0.0
    names = {e["name"] for e in kernels}
    lower = [n.lower() for n in names]
    return {
        "kernels": len(kernels), "kernel_names": len(names),
        "ragged": sorted(n for n in names if "ragged_kernel" in n
                         and "dense_ragged" not in n)[:2],
        "decode": sorted(n for n in names if "paged_decode_kernel" in n)[:2],
        "gemm_kernels": sum(any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass"))
                            for n in lower),
        "busy_ms": busy_us / 1e3, "trace_span_ms": span_us / 1e3,
        "idle_share": 1.0 - busy_us / span_us if span_us > 0 else None,
        "idle_share_of_window": 1.0 - busy_us / (window_s * 1e6),
        "trace_mb": os.path.getsize(path) / 1e6,
    }


def _hop_pairs(direct: int, via: int, method: str, path: str, body, n: int):
    """`n` pairs of one request to port `direct` and through port `via`
    (one kept-alive connection each), alternating which goes first; the
    `via` ones carry fresh traceparents.  Returns ((direct ms, via ms),
    every answer's (text, usage) or model ids, the via trace ids)."""
    clients = [_Client(direct), _Client(via)]
    raw = json.dumps(body).encode() if body is not None else None
    walls, answers, traces = ([], []), [], []
    try:
        for i in range(n):
            for side in ((0, 1) if i % 2 == 0 else (1, 0)):
                headers = {"Content-Type": "application/json"}
                if side == 1:
                    traces.append(os.urandom(16).hex())
                    headers["traceparent"] = f"00-{traces[-1]}-{os.urandom(8).hex()}-01"
                t0 = time.perf_counter()
                status, _, out = clients[side].request(method, path, raw, headers)
                walls[side].append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"epp hop {path}: answered {status}: {out[:200]!r}")
                answer = json.loads(out)
                # what must agree: a completion's text and usage, a model
                # list's ids (its `created` stamps move with the clock)
                answers.append((answer["choices"][0]["text"], answer["usage"])
                               if "choices" in answer
                               else [m["id"] for m in answer["data"]])
    finally:
        for c in clients:
            c.close()
    return walls, answers, traces


def _span_gaps(collector, traces, timeout: float = 20.0) -> list:
    """Per trace: the EPP's request span less the replica's, in ms (the
    time the EPP spends beyond the replica's own answer)."""
    deadline = time.monotonic() + timeout
    while True:
        gaps = []
        for t in traces:
            spans = collector.trace(t)
            epp = [s for s in spans if s["service"] == "kserve-tpu-torch-epp"
                   and s["name"] != "epp.proxy"]
            rep = [s for s in spans if s["service"] != "kserve-tpu-torch-epp"
                   and not s["name"].startswith("engine.")]
            if len(epp) == 1 and len(rep) == 1:
                gaps.append(sum((int(s["endTimeUnixNano"]) - int(s["startTimeUnixNano"]))
                                * sign / 1e6 for s, sign in ((epp[0], 1), (rep[0], -1))))
        if len(gaps) == len(traces):
            return gaps
        if time.monotonic() > deadline:
            raise AssertionError(f"epp hop: spans of {len(traces) - len(gaps)} "
                                 f"traces missing")
        time.sleep(0.1)


def _check_capture(capture: dict) -> dict:
    """The summary of a served /admin/profile capture, which must hold
    CUDA activity naming the ragged, decode and GEMM kernels."""
    if "CUDA" not in capture["activities"]:
        raise AssertionError(f"epp: the capture has no CUDA activity: {capture}")
    summary = _profile_summary(capture["trace"], capture["seconds"])
    if not summary["ragged"] or not summary["decode"] or not summary["gemm_kernels"]:
        raise AssertionError(f"epp: the capture lacks a kernel of the path: {summary}")
    return summary


def phase_epp(torch) -> dict:
    """The EPP endpoint picker in front of two Llama-3-8B replicas (full
    width and depth, bf16, one set of seeded weights, 1,024 KV pages of 16
    tokens each, in this process), the EPP a subprocess of its own
    (`python -m kserve_tpu_torch.scheduler.epp --poll-interval 0.2`), all
    three exporting spans to a standard-library OTLP collector.  Traffic:
    EPP_PREFIXES prefixes of ~1,000 tokens, EPP_PER_PREFIX requests each
    (streamed chats and completions, distinct ~50-token tails), the first
    of each prefix alone, then EPP_CONCURRENCY at a time.  Gates: every
    answer 200 with its tokens, each stream's first event before its last;
    affinity (EPP_AFFINITY_MIN of each prefix's later requests on the
    replica of its first; both replicas serve a prefix); the ragged and
    decode kernels launched, on both replicas, exactly as their dispatches
    make; a greedy completion through the EPP equal to the same prompt
    sent to its replica (its pages cached first); one streamed chat's
    linked trace (epp.proxy -> the replica's request span -> engine.queue /
    prefill / decode, engine.decode's tokens the chat's); POST
    /admin/profile during waves 202, 409 during the capture, the trace naming the
    ragged, decode and GEMM kernels; the ms the EPP adds (p50 of
    alternating pairs, EPP_TIMED); after B stops, B's breaker open, later requests all
    on A, failures only 502 / 503; both down: 503 "no healthy replica";
    no span lost by any exporter.  Returns {"epp": launch counts}."""
    import shutil

    from kserve_tpu_torch import tracing
    from kserve_tpu_torch.engine.tokenizer import load_tokenizer
    from kserve_tpu_torch.ops import paged_attention_cuda as K

    t_phase = time.perf_counter()
    shutil.rmtree(EPP_DIR, ignore_errors=True)
    os.makedirs(EPP_DIR)
    mc, params = _llama3_8b_params(torch)
    # every id decodes to its own text: equal completion texts are equal ids
    _write_mixtral_tokenizer(EPP_DIR, mc.vocab_size)
    tok = load_tokenizer(EPP_DIR, mc.vocab_size)
    prefixes, tails = _epp_texts(tok)
    collector = _OTLPCollector()
    otlp = f"http://127.0.0.1:{collector.port}"
    # the replicas in this process export through its tracer, set up anew
    os.environ[tracing.ENDPOINT_ENV] = otlp
    tracing.shutdown_tracing()
    tracing.setup_tracing("kserve-tpu-torch-replica")
    argv = SERVE_ARGS + [f"--model_dir={EPP_DIR}", f"--kv_pages={EPP_KV_PAGES}"]
    replicas, epp = [], None
    out = {"phase": "epp", "model": "llama3-8b (random weights, seed 1, bf16), 2 replicas"}
    steps, t_step = {}, [t_phase]

    def lap(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - t_step[0]
        t_step[0] = now

    try:
        for _ in range(2):
            replicas.append(_start_server(torch, argv, "epp", load=lambda: params))
        engines = [m.engine for m, _, _ in replicas]
        name = replicas[0][0].name
        urls = [f"http://127.0.0.1:{srv.port}" for _, srv, _ in replicas]
        epp = _EPPProcess(urls, otlp, os.path.join(EPP_DIR, "epp.log"))
        out["epp_ready_s"] = epp.wait_ready()
        out["kv_cache_gb"] = [_kv_cache_gb(e) for e in engines]
        out["prompt_tokens"] = [len(tok.encode(p)) for p in prefixes]
        lap("start")

        # -- affinity: each prefix's first request alone, the rest 8 at a time
        calls = {(k, j): (_epp_body(name, prefixes[k], tails[k][j], chat=j % 2 == 0),
                          os.urandom(16).hex())
                 for k in range(EPP_PREFIXES) for j in range(EPP_PER_PREFIX)}
        steps0 = [e.steps for e in engines]
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t_run = time.perf_counter()
        first = []
        for k in range(EPP_PREFIXES):
            first += _epp_wave(epp.port, [calls[(k, 0)]])
            time.sleep(0.3)  # the next poll sees this replica's load
        rest = _epp_wave(epp.port, [calls[(k, j)] for j in range(1, EPP_PER_PREFIX)
                                    for k in range(EPP_PREFIXES)])
        wall = time.perf_counter() - t_run
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        _epp_check_ok("wave", first + rest)
        where = _served_by(engines, {t for _, t in calls.values()})
        if len(where) != len(calls):
            raise AssertionError(f"epp: {len(calls) - len(where)} requests on no replica")
        affinity = {}
        for k in range(EPP_PREFIXES):
            home = where[calls[(k, 0)][1]]
            later = [where[calls[(k, j)][1]] for j in range(1, EPP_PER_PREFIX)]
            affinity[k] = {"replica": home,
                           "share": sum(r == home for r in later) / len(later)}
        out["affinity"] = affinity
        if min(a["share"] for a in affinity.values()) < EPP_AFFINITY_MIN:
            raise AssertionError(f"epp: affinity {affinity}")
        if {a["replica"] for a in affinity.values()} != {0, 1}:
            raise AssertionError(f"epp: one replica served every prefix: {affinity}")
        # -- the kernels, on both replicas, exactly as their dispatches make
        layers, spd = mc.n_layers, engines[0].config.steps_per_sync
        mixed = [e.steps - s for e, s in zip(engines, steps0)]
        want = {"ragged_paged_attention": layers * sum(mixed),
                "paged_decode_attention": layers * (spd - 1) * sum(mixed)}
        got = {k: counts.get(k, 0) for k in want}
        if min(mixed) <= 0 or got != want:
            raise AssertionError(f"epp: launches {got} != {want} for mixed dispatches "
                                 f"{mixed} of the two replicas")
        _require_launches("epp", counts, tuple(want))
        generated = sum(EPP_MAX_TOKENS for _ in calls)
        out.update({"requests": len(calls), "tokens_generated": generated, "wall_s": wall,
                    "tok_per_s": generated / wall, "mixed_dispatches": mixed,
                    "launches": counts,
                    "stream_first_event_s": statistics.median(
                        r["times"][1] for r in first + rest if r["chat"]),
                    "stream_last_event_s": statistics.median(
                        r["times"][-2] for r in first + rest if r["chat"])})
        lap("wave")

        # -- tokens: through the EPP against the replica that served it
        probe = _epp_body(name, prefixes[2], "Q2.x: say it once more", chat=False)
        warm = _epp_call(epp.port, probe, os.urandom(16).hex())
        home = _served_by(engines, {warm["trace_id"]})[warm["trace_id"]]
        via = _epp_call(epp.port, probe, os.urandom(16).hex())
        direct = _epp_call(replicas[home][1].port, probe, os.urandom(16).hex())
        _epp_check_ok("tokens", [warm, via, direct])
        if _served_by(engines, {via["trace_id"]}) != {via["trace_id"]: home}:
            raise AssertionError("epp: the repeated prompt left its replica")
        if (via["body"]["choices"][0]["text"] != direct["body"]["choices"][0]["text"]
                or via["body"]["usage"] != direct["body"]["usage"]):
            raise AssertionError(f"epp: through the EPP {via['body']['usage']} "
                                 f"{via['body']['choices'][0]['text'][:80]!r}, direct "
                                 f"{direct['body']['usage']} "
                                 f"{direct['body']['choices'][0]['text'][:80]!r}")
        out["tokens_equal"] = {"replica": home, "prompt_tokens":
                               via["body"]["usage"]["prompt_tokens"]}
        lap("tokens")

        # -- one linked trace, from the EPP hop down to the engine
        chat = _epp_call(epp.port, _epp_body(name, prefixes[1], "Q1.t: trace me",
                                             chat=True), os.urandom(16).hex())
        _epp_check_ok("trace", [chat])
        # each process exports on its own clock, and a request span ends
        # once its answer is written, which may be after the client read it
        want = {"epp.proxy", "POST /{tail}", "POST /openai/v1/chat/completions",
                "engine.queue", "engine.prefill", "engine.decode"}
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            tracing.get_tracer().exporter.force_flush()
            spans = {s["name"]: s for s in collector.trace(chat["trace_id"])}
            if want <= set(spans):
                break
            time.sleep(0.1)
        proxy = spans.get("epp.proxy")
        req = spans.get("POST /openai/v1/chat/completions")
        if proxy is None or req is None or req["parentSpanId"] != proxy["spanId"]:
            raise AssertionError(f"epp: no linked proxy -> replica spans: {spans}")
        for span in ("engine.queue", "engine.prefill", "engine.decode"):
            if spans.get(span, {}).get("parentSpanId") != req["spanId"]:
                raise AssertionError(f"epp: {span} is not below the request span: {spans}")
        decode_attrs = {a["key"]: a["value"] for a in spans["engine.decode"]["attributes"]}
        if int(decode_attrs["tokens"]["intValue"]) != len(chat["events"]) - 2:
            raise AssertionError(f"epp: engine.decode tokens {decode_attrs['tokens']} "
                                 f"for {len(chat['events']) - 2} streamed")
        out["trace"] = {"spans": len(spans), "names": sorted(spans),
                        "services": sorted({s["service"] for s in spans.values()}),
                        "ms": {n: (int(s["endTimeUnixNano"]) - int(s["startTimeUnixNano"]))
                               / 1e6 for n, s in spans.items()}}
        lap("trace")

        # -- profile replica A during waves (no timing, no affinity here),
        # while a probe of A's loop shows what the capture holds it
        import threading
        from concurrent.futures import ThreadPoolExecutor

        a_port = replicas[0][1].port
        stop = threading.Event()
        probe_ms = []

        def waves() -> list:
            done = []
            while not stop.is_set():
                done += _epp_wave(epp.port, [
                    (_epp_body(name, prefixes[k % EPP_PREFIXES], f"P{len(done) + k}: "
                               "profile", chat=k % 2 == 0), os.urandom(16).hex())
                    for k in range(EPP_CONCURRENCY)])
            return done

        def probe() -> None:
            while not stop.is_set():
                t0 = time.perf_counter()
                if _http(a_port, "GET", "/v2/health/live")[0] != 200:
                    raise AssertionError("epp: replica A not live while profiled")
                probe_ms.append((time.perf_counter() - t0) * 1e3)
                time.sleep(0.05)

        with ThreadPoolExecutor(max_workers=2) as pool:
            fut_waves = pool.submit(waves)
            time.sleep(0.5)
            fut_probe = pool.submit(probe)
            try:
                t_prof = time.perf_counter()
                s1, raw1 = _http(a_port, "POST", "/admin/profile",
                                 {"seconds": EPP_PROFILE_S,
                                  "dir": os.path.join(EPP_DIR, "prof")})
                start_ms = (time.perf_counter() - t_prof) * 1e3
                s2, raw2 = _http(a_port, "POST", "/admin/profile",
                                 {"seconds": EPP_PROFILE_S})
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    prof = json.loads(_http(a_port, "GET", "/admin/telemetry")[1])[
                        "profiler"]
                    if not prof["active"]:
                        break
                    time.sleep(0.2)
            finally:
                stop.set()
            profiled = fut_waves.result()
            fut_probe.result()
        if s1 != 202 or s2 != 409:
            raise AssertionError(f"epp: /admin/profile answered {s1} {raw1[:200]!r}, "
                                 f"then {s2} {raw2[:200]!r}")
        _epp_check_ok("profile wave", profiled)
        capture = json.loads(raw1)
        if not prof["capture"].get("done"):
            raise AssertionError(f"epp: the capture was not written: {prof}")
        # what the capture costs: its start and stop on a thread of their
        # own, and the longest a liveness probe of A waited meanwhile
        out["profile"] = dict(_check_capture(capture), answer_ms=start_ms,
                              start_s=prof["capture"]["start_s"],
                              stop_s=prof["capture"]["stop_s"],
                              export_s=prof["capture"]["export_s"],
                              requests=len(profiled),
                              loop_probe_ms={"n": len(probe_ms),
                                             "p50": _pct(probe_ms, 0.5),
                                             "max": max(probe_ms)})
        lap("profile")

        # -- the hop: what the EPP adds, from the client (pairs alternating)
        # and from its own spans (its request span less the replica's)
        # two text chunks long: its text affinity holds it to one replica
        short = {"model": name, "prompt": "Tell me about the sea. " * 6, "max_tokens": 4,
                 "temperature": 0, "ignore_eos": True}
        warm = _epp_call(epp.port, short, os.urandom(16).hex())
        home = _served_by(engines, {warm["trace_id"]})[warm["trace_id"]]
        hop = {}
        for label, method, path, body in (
                ("completion", "POST", "/openai/v1/completions", short),
                ("models", "GET", "/openai/v1/models", None)):
            walls, answers, traces = _hop_pairs(replicas[home][1].port, epp.port, method,
                                                path, body, EPP_TIMED[label])
            if len(set(map(json.dumps, answers))) != 1:
                raise AssertionError(f"epp hop {label}: the answers differ")
            hop[label] = {"direct_p50_ms": _pct(walls[0], 0.5),
                          "via_p50_ms": _pct(walls[1], 0.5),
                          "via_p99_ms": _pct(walls[1], 0.99),
                          "added_ms_per_hop_p50": _pct(
                              [b - a for a, b in zip(*walls)], 0.5),
                          "epp_span_less_replica_span_ms_p50": _pct(
                              _span_gaps(collector, traces), 0.5)}
        out["hop"] = hop
        lap("hop")

        # -- failover: B stops mid-wave
        b_prefixes = [k for k, a in affinity.items() if a["replica"] == 1]
        mid = [(_epp_body(name, prefixes[k], f"F{i}: failover", chat=False),
                os.urandom(16).hex()) for i, k in enumerate(b_prefixes * 4 + [0] * 4)]
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(_epp_wave, epp.port, mid)
            time.sleep(0.3)
            _stop_server(torch, *replicas[1])
            during = fut.result()
        bad = [r["status"] for r in during if r["status"] not in (200, 502, 503)]
        if bad:
            raise AssertionError(f"epp failover: statuses {bad}")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rep_b = [r for r in epp.state()["replicas"] if r["url"] == urls[1]][0]
            if rep_b["breaker"] == "open" and not rep_b["healthy"]:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"epp failover: B still available: {rep_b}")
        after = _epp_wave(epp.port, [(_epp_body(name, prefixes[k], f"A{i}: after",
                                                chat=False), os.urandom(16).hex())
                                     for i, k in enumerate(b_prefixes * 2)])
        _epp_check_ok("after failover", after)
        if set(_served_by(engines[:1], {r["trace_id"] for r in after}).values()) != {0}:
            raise AssertionError("epp failover: a request after B stopped was not on A")
        out["failover"] = {"during": [r["status"] for r in during],
                           "after": [r["status"] for r in after],
                           "b_breaker": rep_b["breaker"]}
        lap("failover")
        epp_tracing = epp.state().get("tracing")
        _stop_server(torch, *replicas[0])
        replicas = []
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            status, raw = _http(epp.port, "POST", "/openai/v1/completions", short)
            if status == 503:
                break
            time.sleep(0.2)
        if status != 503 or json.loads(raw) != {"error": "no healthy replica"}:
            raise AssertionError(f"epp: both down answered {status} {raw[:200]!r}")
        out["all_down"] = json.loads(raw)
        lap("all_down")
        # -- no span lost, here or at the EPP
        tracing.get_tracer().exporter.force_flush()
        replica_tracing = tracing.tracer_stats()
        out["exporters"] = {"replicas": replica_tracing, "epp": epp_tracing,
                            "collector_spans": len(collector.spans),
                            "collector_posts": collector.posts}
        for side, stats in (("replicas", replica_tracing), ("epp", epp_tracing)):
            if not stats or stats["failed"] or stats["dropped"] or not stats["exported"]:
                raise AssertionError(f"epp: the {side}' exporter lost spans: {stats}")
    finally:
        if epp is not None:
            epp.stop()
        for rep in replicas:
            _stop_server(torch, *rep)
        tracing.shutdown_tracing()
        os.environ.pop(tracing.ENDPOINT_ENV, None)
        collector.close()
        shutil.rmtree(EPP_DIR, ignore_errors=True)
    out["steps_s"] = steps
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- scale

SCALE_DIR = os.path.join(REPO, "build", "scale_smoke")
SCALE_HELD = 8
SCALE_HELD_TOKENS = 32
SCALE_LOAD_CLIENTS = 24
# ~500 prompt tokens: the phase's tokenizer.json encodes a character a token
SCALE_LOAD_CHARS = 500
SCALE_LOAD_TOKENS = 32
# requests replica B must have finished before the wave stops
SCALE_B_SERVED = 8
SCALE_EPP_POLL_S = 0.2
# the EPP's breakers open on the failed polls of a replica that is down; a
# replica restarted on the same static url then waits out the open window
# (30 s by default) before it takes picks (ROADMAP C21): the phase runs the
# EPP with a 1 s window, or as shipped with --scale-default-breaker
SCALE_BREAKER_OPEN_S = 1.0
# the loop's knobs: 8 queued per ready replica (a second full batch)
# scales up, so a wake for the 8 held requests starts one replica
SCALE_POLICY = dict(queue_high_per_replica=8.0, queue_low_per_replica=1.0,
                    idle_to_zero_s=5.0, up_cooldown_s=0.0, down_cooldown_s=3.0)
SCALE_INTERVAL_S = 0.25
SCALE_MEM_TOL_GB = 1.0
# shorter than a replica's start: held, then 504
SCALE_SHORT_DEADLINE_S = 2.0
# tries at sending the direct requests in the replayed ones' admission groups
SCALE_DIRECT_ATTEMPTS = 3
SCALE_WORDS = ("wake", "zero", "replica", "queue", "hold", "replay", "scale", "card",
               "token", "page", "kernel", "drain", "budget", "signal")
# the EPP with a shorter breaker window (argv: window, then the EPP's flags)
SCALE_EPP = (
    "import sys\n"
    "from kserve_tpu_torch.resilience import BreakerConfig, BreakerRegistry\n"
    "from kserve_tpu_torch.scheduler import epp\n"
    "open_s = float(sys.argv.pop(1))\n"
    "epp.BreakerRegistry = lambda **kw: BreakerRegistry(BreakerConfig(open_for_s=open_s), **kw)\n"
    "epp.main(sys.argv[1:])\n")
# a replica: `python -m kserve_tpu_torch.runtimes.generative_server` whose
# kernel launches from ready to exit, whether its kernel library came from
# the build cache, and its metrics at exit land in the file named first
# (argv: file, then the server's flags)
SCALE_REPLICA = (
    "import atexit, json, runpy, sys\n"
    "out = sys.argv.pop(1)\n"
    "from kserve_tpu_torch.lifecycle import ReplicaLifecycle\n"
    "from kserve_tpu_torch.metrics import generate_latest\n"
    "from kserve_tpu_torch.ops import _build, paged_attention_cuda as K\n"
    "mark_ready = ReplicaLifecycle.mark_ready\n"
    "def ready(self):\n"
    "    K.reset_launch_counts()  # the served path's launches, not the warm-up's\n"
    "    mark_ready(self)\n"
    "ReplicaLifecycle.mark_ready = ready\n"
    "def report():\n"
    "    with open(out, 'w') as f:\n"
    "        json.dump({'launches': dict(K.LAUNCHES),\n"
    "                   'build_cached': _build.last_build.get('cached'),\n"
    "                   'metrics': generate_latest().decode()}, f)\n"
    "atexit.register(report)\n"
    "runpy.run_module('kserve_tpu_torch.runtimes.generative_server',\n"
    "                 run_name='__main__', alter_sys=True)\n")


class _AsyncThread:
    """An event loop on a thread of its own; `run` waits for a coroutine."""

    def __init__(self):
        import asyncio
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="scale-loop",
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 600.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _replica_actuator(ReplicaActuator, ports, on_zero):
    """The loop's actuator over replica processes, one slot per reserved
    port: `scale_to` starts a replica on the lowest free slot (after the
    slot's last process has exited) or SIGTERMs the newest, and returns
    without waiting for it; a thread per process records its direct
    readiness and its exit.  `on_zero` runs when the last one is stopped."""
    import asyncio
    import signal
    import threading

    class Processes(ReplicaActuator):
        def __init__(self):
            self.live = []  # records, oldest first
            self.records = []  # every process started
            self.last_on = {}  # slot -> its latest record

        async def current_replicas(self) -> int:
            return len(self.live)

        async def scale_to(self, n: int) -> None:
            while len(self.live) < n:
                slot = min(set(range(len(ports))) - {r["slot"] for r in self.live})
                prev = self.last_on.get(slot)
                if prev is not None:
                    await asyncio.to_thread(prev["proc"].wait, 180)
                self._start(slot)
            while len(self.live) > n:
                rec = self.live.pop()
                rec["t_stop"] = time.monotonic()
                rec["proc"].send_signal(signal.SIGTERM)
                if not self.live:
                    on_zero()

        def _start(self, slot: int) -> None:
            port = ports[slot]
            k = len(self.records)
            rec = {"slot": slot, "port": port, "label": f"{'AB'[slot]}{k}",
                   "launches_path": os.path.join(SCALE_DIR, f"launches{k}.json"),
                   "log_path": os.path.join(SCALE_DIR, f"replica{k}.log"),
                   "t_start": time.monotonic(), "t_ready": None, "t_stop": None,
                   "t_exit": None, "rc": None}
            rec["log"] = open(rec["log_path"], "w")
            rec["proc"] = subprocess.Popen(
                [sys.executable, "-c", SCALE_REPLICA, rec["launches_path"],
                 *SERVE_ARGS[:3], f"--model_dir={SCALE_DIR}", f"--http_port={port}",
                 "--device=cuda"],
                cwd=REPO, stdout=rec["log"], stderr=subprocess.STDOUT)
            self.records.append(rec)
            self.live.append(rec)
            self.last_on[slot] = rec
            threading.Thread(target=self._watch, args=(rec,), daemon=True).start()

        @staticmethod
        def _watch(rec) -> None:
            proc = rec["proc"]
            while proc.poll() is None and rec["t_ready"] is None:
                try:
                    if _http(rec["port"], "GET", "/v2/health/ready", timeout=2)[0] == 200:
                        rec["t_ready"] = time.monotonic()
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            rec["rc"] = proc.wait()
            rec["t_exit"] = time.monotonic()
            rec["log"].close()

    return Processes()


def _scale_post(port: int, body: dict, rid: str, headers=None) -> dict:
    t0 = time.monotonic()
    status, resp_headers, raw = _http_h(port, "POST", "/openai/v1/completions", body,
                                        dict({"x-request-id": rid}, **(headers or {})))
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = {"raw": raw[:300].decode(errors="replace")}
    return {"rid": rid, "status": status, "body": payload, "t_send": t0,
            "t_done": time.monotonic(), "headers": resp_headers}


def _at_once(port: int, calls) -> list:
    """POST every (body, request id) of `calls` from a thread each, released
    together by a barrier."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    gate = threading.Barrier(len(calls))

    def one(call):
        gate.wait()
        return _scale_post(port, *call)

    with ThreadPoolExecutor(max_workers=len(calls)) as pool:
        return list(pool.map(one, calls))


def _traceparent() -> dict:
    return {"traceparent": f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"}


def _trace_of(headers: dict) -> str:
    return headers["traceparent"].split("-")[1]


def _admission_groups(port: int, name: str, traces: dict) -> list:
    """The requests of `traces` ({label: trace id}) grouped by the dispatch
    that prefilled them (equal `prefill_start` in the replica's
    /admin/telemetry timelines), in dispatch order."""
    by_trace = {t: label for label, t in traces.items()}
    starts = {}
    t_end = time.monotonic() + 30
    while len(starts) < len(traces):
        if time.monotonic() > t_end:
            raise AssertionError(f"scale: timelines of {sorted(set(traces) - set(starts))} "
                                 "never appeared")
        recent = json.loads(_http(port, "GET", "/admin/telemetry")[1])["models"][name][
            "recent"]
        starts.update({by_trace[tl["trace_id"]]: tl["prefill_start"] for tl in recent
                       if tl.get("trace_id") in by_trace})
        time.sleep(0.05)
    groups = {}
    for label, t in starts.items():
        groups.setdefault(t, []).append(label)
    return [sorted(groups[t]) for t in sorted(groups)]


def _direct_in_groups(port: int, groups, calls: dict) -> dict:
    """POST calls[label] = (body, request id, headers) straight to a replica,
    each group at once, a group only after the replica has seated every
    earlier one; {label: answer}."""
    from concurrent.futures import ThreadPoolExecutor

    futures, seated = {}, 0
    with ThreadPoolExecutor(max_workers=len(calls)) as pool:
        for group in groups:
            fut = pool.submit(_at_once, port, [calls[label] for label in group])
            futures.update({label: (fut, k) for k, label in enumerate(group)})
            seated += len(group)
            t_end = time.monotonic() + 60
            while json.loads(_http(port, "GET", "/v1/internal/scheduler/state")[1])[
                    "inflight"] < seated:
                if time.monotonic() > t_end:
                    raise AssertionError(f"scale: {seated} direct requests never seated")
                time.sleep(0.002)
        return {label: fut.result()[k] for label, (fut, k) in futures.items()}


def _completion(name: str, prompt: str, max_tokens: int) -> dict:
    return {"model": name, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0, "ignore_eos": True}


def phase_scale(torch, breaker_open_s=SCALE_BREAKER_OPEN_S) -> dict:
    """Scale from zero and back on the card: the port's EPP (a subprocess,
    `--poll-interval 0.2`, its breakers' open window `breaker_open_s`;
    None runs `python -m kserve_tpu_torch.scheduler.epp` as shipped) over two
    reserved ports where no replica runs; the port's `Activator` and an
    `AutoscalerLoop` in this process (EPPSignalSource, ReactivePolicy
    SCALE_POLICY, bounds 0..2, the activator's held count fed into the
    signals as `held_requests` and its `on_hold` wired to
    `notify_demand`); an actuator over processes of `python -m
    kserve_tpu_torch.runtimes.generative_server` serving Llama-3-8B at full
    width and depth, bf16, the same seeded weights, 2,048 pages each, on
    cuda.  When the actuator stops the last replica it puts the activator
    back in hold mode (the EPP in front of the replicas keeps accepting,
    so the activator alone cannot see the zero window; ROADMAP C21).
    Steps and gates: (1) 8 completions at once into the zero window: one
    wake, one process, all held and replayed in arrival order, all 200
    with 32 tokens, texts equal to the same 8 sent at once straight to the
    replica; (2) 24 clients of ~500-token prompts in a closed loop: the
    loop scales 1 -> 2 for `queue_depth`, B turns healthy at the EPP and
    finishes SCALE_B_SERVED requests, every answer 200; (3) idle: back to
    0 with reasons from REASONS (low_load, idle_zero), both processes exit
    0, the card's free memory within 1 GB of its value before the phase;
    (4) a second zero window: a request whose deadline is shorter than a
    start gets 504 (expired), one with a normal budget wakes a replica and
    is served; (5) every replica that served launched the ragged and
    decode kernels, its kernel library from the build cache.  Returns
    {"scale": launch counts summed over the replicas}."""
    import asyncio
    import dataclasses
    import random
    import shutil
    import signal
    import threading

    from kserve_tpu_torch.activator import Activator
    from kserve_tpu_torch.autoscale import (
        REASONS,
        AutoscalerLoop,
        ReactiveConfig,
        ReactivePolicy,
        ReplicaActuator,
    )
    from kserve_tpu_torch.autoscale.__main__ import EPPSignalSource
    from kserve_tpu_torch.engine.tokenizer import load_tokenizer
    from kserve_tpu_torch.models.llama import LlamaConfig

    class RecordingActivator(Activator):
        """The port's Activator, noting the order requests enter and leave
        the hold (by x-request-id) and the time of each."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.entered, self.left = [], []

        async def _hold(self, headers):
            rid = headers.get("x-request-id", "")
            self.entered.append((rid, time.monotonic()))
            terminal = await super()._hold(headers)
            self.left.append((rid, time.monotonic(), None if terminal is None
                              else terminal[0]))
            return terminal

    t_phase = time.perf_counter()
    shutil.rmtree(SCALE_DIR, ignore_errors=True)
    os.makedirs(SCALE_DIR)
    mc = LlamaConfig.llama3_8b()
    _write_mixtral_tokenizer(SCALE_DIR, mc.vocab_size)
    tok = load_tokenizer(SCALE_DIR, mc.vocab_size)
    name = SERVE_ARGS[0].split("=", 1)[1]
    free0, total = torch.cuda.mem_get_info()
    ports = [_free_port(), _free_port()]
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    out = {"phase": "scale", "model": f"{name} (random weights, seed 1, bf16), "
           "replica processes", "policy": SCALE_POLICY, "ports": ports,
           "free_gb_before": free0 / 1e9,
           "epp_breaker_open_s": breaker_open_s or "default (as shipped)"}
    steps, t_step = {}, [t_phase]

    def lap(label: str) -> None:
        now = time.perf_counter()
        steps[label] = now - t_step[0]
        t_step[0] = now

    epp_port = _free_port()
    epp_log = open(os.path.join(SCALE_DIR, "epp.log"), "w")
    epp_cmd = ([sys.executable, "-m", "kserve_tpu_torch.scheduler.epp"]
               if breaker_open_s is None
               else [sys.executable, "-c", SCALE_EPP, str(breaker_open_s)])
    epp = subprocess.Popen(
        epp_cmd + ["--replicas", ",".join(urls), "--poll-interval", str(SCALE_EPP_POLL_S),
                   "--port", str(epp_port)],
        cwd=REPO, stdout=epp_log, stderr=subprocess.STDOUT)
    aloop = _AsyncThread()
    box = {}
    actuator = _replica_actuator(ReplicaActuator, ports,
                                 on_zero=lambda: box["activator"].scaled_to_zero())
    epp_url = f"http://127.0.0.1:{epp_port}"

    def epp_state() -> dict:
        status, raw = _http(epp_port, "GET", "/state", timeout=10)
        if status != 200:
            raise AssertionError(f"scale: EPP /state answered {status}")
        return json.loads(raw)

    def replica_log(rec) -> str:
        with open(rec["log_path"]) as f:
            return f.read()[-3000:]

    def check_alive(what: str) -> None:
        if box.get("loop_task") is not None and box["loop_task"].done():
            box["loop_task"].result()  # raises the loop's failure
            raise AssertionError(f"scale: the autoscaler loop ended during {what}")
        for rec in actuator.records:
            if rec["t_stop"] is None and rec["proc"].poll() is not None:
                raise AssertionError(f"scale: replica {rec['label']} exited "
                                     f"{rec['proc'].returncode} during {what}: "
                                     f"{replica_log(rec)}")

    def background(fn, *args):
        """fn(*args) on a thread; a future (wait_for(fut.done, ...) meanwhile
        fails fast when a replica or the loop dies)."""
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(fn, *args)
        pool.shutdown(wait=False)
        return fut

    def wait_for(cond, what: str, timeout: float) -> float:
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            if cond():
                return time.monotonic() - t0
            check_alive(what)
            time.sleep(0.05)
        raise AssertionError(f"scale: timed out ({timeout} s) waiting for {what}")

    try:
        def epp_up() -> bool:
            if epp.poll() is not None:
                raise AssertionError(f"scale: the EPP exited {epp.returncode}")
            try:
                st = epp_state()
            except OSError:
                return False
            return (st["fleet"]["ready_replicas"] == 0
                    and not any(r["healthy"] for r in st["replicas"]))

        out["epp_ready_s"] = wait_for(epp_up, "the EPP with both replicas down", 60)

        async def setup():
            source = EPPSignalSource(epp_url, stale_s=10.0)
            act = RecordingActivator(epp_url, port=0, poll_interval=0.1,
                                     wake_timeout=300.0)
            box["activator"] = act

            async def signals():
                # the requests parked at the gateway are demand the EPP
                # cannot see
                return dataclasses.replace(await source(), held_requests=act.holds.held)

            loop = AutoscalerLoop(ReactivePolicy(ReactiveConfig(**SCALE_POLICY)), signals,
                                  actuator, interval_s=SCALE_INTERVAL_S,
                                  min_replicas=0, max_replicas=2)

            async def scale_up():
                box["wakes"] = box.get("wakes", 0) + 1
                if await actuator.current_replicas() < 1:
                    await actuator.scale_to(1)

            act.scale_up = scale_up
            act.holds.on_hold = loop.notify_demand
            port = await act.start()
            box.update(source=source, loop=loop, activator_running=act,
                       loop_task=asyncio.get_running_loop().create_task(loop.run()))
            return port

        act_port = aloop.run(setup())
        act, loop = box["activator"], box["loop"]
        lap("setup")

        # -- (1) the zero window: 8 completions at once, one wake
        held_calls = [(_completion(name, f"Wake {i}: sea", SCALE_HELD_TOKENS), f"zero-{i}",
                       _traceparent()) for i in range(SCALE_HELD)]
        out["held_prompt_tokens"] = [len(tok.encode(b["prompt"])) for b, _, _ in held_calls]
        held = background(_at_once, act_port, held_calls)
        wait_for(held.done, "the zero window's answers", 600)
        held = held.result()
        bad = [(r["rid"], r["status"], r["body"]) for r in held
               if r["status"] != 200
               or r["body"]["usage"]["completion_tokens"] != SCALE_HELD_TOKENS]
        if bad:
            raise AssertionError(f"scale: zero-window answers {bad}")
        if len(actuator.records) != 1 or box.get("wakes") != 1:
            raise AssertionError(f"scale: {len(actuator.records)} replicas started, "
                                 f"{box.get('wakes')} wakes for one zero window")
        stats1 = dict(act.stats)
        if stats1["buffered"] != SCALE_HELD or stats1["replayed"] != SCALE_HELD:
            raise AssertionError(f"scale: activator stats {stats1}")
        arrived = [rid for rid, _ in act.entered]
        replayed = [rid for rid, _, st in act.left if st is None]
        if replayed != arrived or sorted(arrived) != sorted(r for _, r, _ in held_calls):
            raise AssertionError(f"scale: held in order {arrived}, replayed in {replayed}")
        rec_a = actuator.records[0]
        # bf16 greedy tokens depend on the prefill's batch (its packed
        # length picks the GEMM kernels), so the direct requests go to the
        # replica in the admission groups the replayed ones had, each group
        # once the one before is seated (one dispatch later), until the
        # replica's timelines show the same groups
        groups = _admission_groups(rec_a["port"], name, {
            rid: _trace_of(h) for _, rid, h in held_calls})
        bodies = {rid: b for b, rid, _ in held_calls}
        texts = {r["rid"]: r["body"]["choices"][0]["text"] for r in held}
        for attempt in range(SCALE_DIRECT_ATTEMPTS):
            calls = {rid: (bodies[rid], f"direct{attempt}-{rid}", _traceparent())
                     for rid in bodies}
            direct = _direct_in_groups(rec_a["port"], groups, calls)
            direct_groups = _admission_groups(rec_a["port"], name, {
                rid: _trace_of(calls[rid][2]) for rid in calls})
            if direct_groups == groups:
                break
        else:
            raise AssertionError(f"scale: the direct requests were admitted as "
                                 f"{direct_groups}, never as the replayed {groups}")
        differ = [(rid, texts[rid][:60], str(direct[rid]["body"])[:200])
                  for rid in bodies
                  if direct[rid]["status"] != 200
                  or direct[rid]["body"]["choices"][0]["text"] != texts[rid]]
        if differ:
            raise AssertionError(f"scale: replayed texts differ from direct ones "
                                 f"(admission groups {groups}): {differ}")
        decisions1 = [d.to_dict() for d in loop.decisions]
        if not any(d["reason"] == "hold_demand" for d in decisions1):
            raise AssertionError(f"scale: no hold_demand decision: {decisions1}")
        if any(d["reason"] == "idle_zero" for d in decisions1):
            raise AssertionError(f"scale: idle_zero during the replay: {decisions1}")
        t_first_in = min(t for _, t in act.entered)
        out["zero_window"] = {
            "requests": SCALE_HELD, "arrival_order": arrived,
            "cold_start_s": stats1["cold_start_s"],
            "replica_ready_s": rec_a["t_ready"] - rec_a["t_start"],
            "wake_latency_s": min(t for _, t, st in act.left if st is None) - t_first_in,
            "first_answer_s": min(r["t_done"] for r in held) - t_first_in,
            "last_answer_s": max(r["t_done"] for r in held) - t_first_in,
            "texts_equal_direct": True, "admission_groups": groups,
            "direct_attempts": attempt + 1, "activator_stats": stats1}
        lap("zero_window")

        # -- (2) the scale-up wave: 24 clients in a closed loop
        rng = random.Random(19)

        def load_prompt(k: int, n: int) -> str:
            words = [f"Load {k}.{n}:"]
            while len(" ".join(words)) < SCALE_LOAD_CHARS:
                words.append(rng.choice(SCALE_WORDS))
            return " ".join(words)[:SCALE_LOAD_CHARS]

        prompts = [[load_prompt(k, n) for n in range(64)] for k in range(SCALE_LOAD_CLIENTS)]
        out["load_prompt_tokens"] = len(tok.encode(prompts[0][0]))
        stop = threading.Event()
        results, watch = [], []

        def client(k: int) -> None:
            n = 0
            while not stop.is_set() and n < len(prompts[k]):
                results.append(_scale_post(
                    act_port, _completion(name, prompts[k][n], SCALE_LOAD_TOKENS),
                    f"load-{k}-{n}"))
                n += 1

        def b_served() -> float:
            recs = [r for r in actuator.records if r["slot"] == 1]
            if not recs or recs[-1]["t_ready"] is None:
                return 0.0
            try:
                return _metric(_scrape(recs[-1]["port"]), "request_e2e_seconds_count",
                               model_name=name)
            except OSError:  # stopped by the loop; check_alive sees a death
                return 0.0

        def monitor() -> None:
            while not stop.is_set():
                try:
                    st = epp_state()
                    watch.append((time.monotonic(), [
                        {k: r[k] for k in ("healthy", "queue_depth", "inflight", "breaker")}
                        for r in st["replicas"]], st["fleet"]["ready_replicas"]))
                except OSError:
                    pass
                time.sleep(0.2)

        t_wave = time.monotonic()
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(SCALE_LOAD_CLIENTS)]
        mon = threading.Thread(target=monitor, daemon=True)
        for th in threads + [mon]:
            th.start()
        try:
            wait_for(lambda: b_served() >= SCALE_B_SERVED,
                     f"replica B to finish {SCALE_B_SERVED} requests", 240)
        finally:
            stop.set()
            for th in threads + [mon]:
                th.join(600)
        t_wave_end = time.monotonic()
        bad = [(r["rid"], r["status"], str(r["body"])[:200]) for r in results
               if r["status"] != 200
               or r["body"]["usage"]["completion_tokens"] != SCALE_LOAD_TOKENS]
        if bad:
            raise AssertionError(f"scale: wave answers not 200: {bad[:8]} of {len(bad)}")
        ups = [d for d in loop.decisions if d.action == "scale_up" and d.current == 1]
        if not ups or (ups[0].target, ups[0].reason) != (2, "queue_depth"):
            raise AssertionError(f"scale: no 1 -> 2 queue_depth decision: "
                                 f"{[d.to_dict() for d in loop.decisions][-20:]}")
        if len(actuator.records) != 2 or actuator.records[1]["slot"] != 1:
            raise AssertionError("scale: replica B was not started once")
        rec_b = actuator.records[1]
        b_picks = [t for t, reps, _ in watch
                   if reps[1]["healthy"] and reps[1]["inflight"] + reps[1]["queue_depth"] > 0]
        if not b_picks:
            raise AssertionError(f"scale: the EPP never showed B with work: {watch[-5:]}")
        out["scale_up"] = {
            "requests": len(results), "wall_s": t_wave_end - t_wave,
            "decision": ups[0].to_dict(), "reaction_s": ups[0].at_s - t_wave,
            "replica_b_start_to_ready_s": rec_b["t_ready"] - rec_b["t_start"],
            "decision_to_b_ready_s": rec_b["t_ready"] - ups[0].at_s,
            "b_first_work_at_epp_s": b_picks[0] - t_wave,
            "tok_per_s": len(results) * SCALE_LOAD_TOKENS / (t_wave_end - t_wave)}
        lap("scale_up")

        # -- (3) idle: back to zero, every process out, the memory back
        t_idle = time.monotonic()
        wait_for(lambda: len(actuator.live) == 0 and all(
            r["t_exit"] is not None for r in actuator.records), "scale to zero", 180)
        downs = [d.to_dict() for d in loop.decisions if d.action == "scale_down"]
        reasons = [d["reason"] for d in downs]
        if (not downs or downs[-1]["target"] != 0 or any(r not in REASONS for r in reasons)
                or not set(reasons) <= {"low_load", "idle_zero"}):
            raise AssertionError(f"scale: scale-downs {downs}")
        rcs = {r["label"]: r["rc"] for r in actuator.records}
        if any(rc != 0 for rc in rcs.values()):
            raise AssertionError(f"scale: replicas exited {rcs}: "
                                 f"{[replica_log(r) for r in actuator.records if r['rc']]}")
        free1, _ = torch.cuda.mem_get_info()
        if abs(free1 - free0) > SCALE_MEM_TOL_GB * 1e9:
            raise AssertionError(f"scale: free memory {free1 / 1e9:.2f} GB after, "
                                 f"{free0 / 1e9:.2f} before")
        zero_at = max(r["t_exit"] for r in actuator.records)
        last_answer = max(r["t_done"] for r in results)
        out["to_zero"] = {
            "scale_downs": downs, "exit_codes": rcs,
            "last_answer_to_zero_s": zero_at - last_answer,
            "last_answer_to_idle_zero_s": downs[-1]["at_s"] - last_answer,
            "drain_to_exit_s": {r["label"]: r["t_exit"] - r["t_stop"]
                                for r in actuator.records},
            "waited_s": time.monotonic() - t_idle, "free_gb_after": free1 / 1e9}
        lap("to_zero")

        # -- (4) a second zero window: a deadline shorter than a start, then
        # a normal budget
        short, normal = {}, {}

        def send(into: dict, rid: str, headers) -> None:
            into.update(_scale_post(act_port, _completion(name, "Warm: sea", 16), rid,
                                    headers))

        f_short = background(send, short, "second-short",
                             {"x-request-deadline": str(SCALE_SHORT_DEADLINE_S)})
        time.sleep(0.1)
        f_normal = background(send, normal, "second-normal", None)
        wait_for(lambda: f_short.done() and f_normal.done(), "the second wake's answers",
                 600)
        f_short.result()
        f_normal.result()
        stats2 = dict(act.stats)
        if (short.get("status") != 504 or "expired" not in str(short.get("body"))
                or stats2["expired"] != 1):
            raise AssertionError(f"scale: the short deadline answered "
                                 f"{short.get('status')} {short.get('body')} ({stats2})")
        if normal.get("status") != 200 or normal["body"]["usage"]["completion_tokens"] != 16:
            raise AssertionError(f"scale: the second wake answered {normal}")
        if len(actuator.records) != 3 or box.get("wakes") != 2:
            raise AssertionError(f"scale: {len(actuator.records)} replicas started, "
                                 f"{box.get('wakes')} wakes")
        rec_w = actuator.records[2]
        out["second_wake"] = {
            "short_status": short["status"], "short_wait_s": short["t_done"] - short["t_send"],
            "normal_wait_s": normal["t_done"] - normal["t_send"],
            "warm_start_s": stats2["cold_start_s"],
            "replica_ready_s": rec_w["t_ready"] - rec_w["t_start"]}
        lap("second_wake")

        # -- (5) shut down; the launches of every replica
        aloop.run(_stop_scale(box))
        aloop.run(actuator.scale_to(0))
        wait_for(lambda: all(r["t_exit"] is not None for r in actuator.records),
                 "the last replica's exit", 120)
        counts = {}
        for rec in actuator.records:
            if rec["rc"] != 0:
                raise AssertionError(f"scale: replica {rec['label']} exited {rec['rc']}")
            with open(rec["launches_path"]) as f:
                report = json.load(f)
            if report["build_cached"] is not True:
                raise AssertionError(f"scale: replica {rec['label']} built its kernels "
                                     f"(build cache {report['build_cached']})")
            _require_launches(f"scale {rec['label']}", report["launches"],
                              ("ragged_paged_attention", "paged_decode_attention"))
            rec["launches"] = report["launches"]
            rec["served"] = _metric(_parse_metrics(report["metrics"]),
                                    "request_e2e_seconds_count", model_name=name)
            for k, v in report["launches"].items():
                counts[k] = counts.get(k, 0) + v
        # B's count from its exit report: the loop may stop it as soon as
        # the wave ends
        out["scale_up"]["b_served"] = rec_b["served"]
        out["scale_up"]["a_served"] = len(results) - rec_b["served"]
        out["replicas"] = [{k: rec[k] for k in ("label", "port", "rc", "served")}
                           | {"ready_s": rec["t_ready"] - rec["t_start"],
                              "launches": {k: v for k, v in rec["launches"].items() if v}}
                           for rec in actuator.records]
        out["decision_counts"] = loop.decision_counts()
        out["activator_stats"] = dict(act.stats)
        out["launches"] = counts
        lap("launches")
    finally:
        try:
            aloop.run(_stop_scale(box), timeout=30)
        except Exception as exc:  # noqa: BLE001 — the phase's own error wins
            print(f"scale: shutdown: {exc!r}", file=sys.stderr)
        for rec in actuator.records:
            if rec["proc"].poll() is None:
                rec["proc"].send_signal(signal.SIGTERM)
                try:
                    rec["proc"].wait(60)
                except subprocess.TimeoutExpired:
                    rec["proc"].kill()
                    rec["proc"].wait(30)
        if epp.poll() is None:
            epp.send_signal(signal.SIGTERM)
            try:
                epp.wait(30)
            except subprocess.TimeoutExpired:
                epp.kill()
                epp.wait(30)
        epp_log.close()
        aloop.close()
        shutil.rmtree(SCALE_DIR, ignore_errors=True)
    out["steps_s"] = steps
    out["phase_wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return counts


async def _stop_scale(box: dict) -> None:
    """Stop the autoscaler loop (raising its failure, if it failed), the
    activator and the signal source; idempotent."""
    loop, task = box.pop("loop", None), box.pop("loop_task", None)
    if loop is not None:
        loop.stop()
    if task is not None:
        await task
    act = box.pop("activator_running", None)
    if act is not None:
        await act.stop()
    source = box.pop("source", None)
    if source is not None:
        await source.close()


# the served phases --only can run alone
SERVED_PHASES = {"serve": phase_serve, "d64": phase_d64, "spec": phase_spec,
                 "kvq": phase_kvq, "gemma2": phase_gemma2,
                 "pressure": phase_pressure, "legacy": phase_legacy,
                 "prefix": phase_prefix, "tiers": phase_tiers,
                 "lifecycle": phase_lifecycle, "lora": phase_lora,
                 "wq": phase_wq, "checkpoint": phase_checkpoint,
                 "moe": phase_moe, "pd": phase_pd, "peer": phase_peer,
                 "predictive": phase_predictive, "artifacts": phase_artifacts,
                 "explain": phase_explain, "forecast": phase_forecast,
                 "encoder": phase_encoder,
                 "graph": phase_graph, "epp": phase_epp, "scale": phase_scale}

if __name__ == "__main__":
    sys.exit(main())
