"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each ``.cu`` source compiles to an object with its own ``nvcc`` process,
all started together, and the objects link into one shared library with a
plain C interface, loaded with ``ctypes``.  No source includes PyTorch's
headers, so a cold build takes seconds.  The library lands in
``build/kserve_tpu_torch/`` at the root of the checkout, keyed by a hash
of the sources and flags: an unchanged tree reuses it, any edit rebuilds.
The engine loads it in ``start()`` on CUDA, before it reports ready.

Nothing here runs at import: the CPU-only test machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kserve_tpu_torch"
LIB_NAME = "libpaged_attention.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: {"seconds", "path", "log",
# "cached"} — chip_smoke.py reports it
last_build: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, pages, scales, page_table, q_start, q_len, kv_start, out,
    # partials, tickets, B, G, tq, tiles, slabs, chunk, splits, nq, nkv,
    # head_dim, page_size, W, num_pages, scale, softcap, window, dtype,
    # kv_dtype, stream
    "kt_ragged_paged_attention": (
        [_P] * 10 + [_I] * 13 + [_F, _F, _I, _I, _I, _P]),
    # q, pages, scales, page_table, seq_lens, out, partials, tickets, B,
    # nq, nkv, head_dim, page_size, W, num_pages, chunk, splits, slabs,
    # scale, softcap, window, dtype, kv_dtype, stream
    "kt_paged_decode_attention": (
        [_P] * 8 + [_I] * 10 + [_F, _F, _I, _I, _I, _P]),
    # q, pages, scales, page_table, kv_start, q_len, out, partials,
    # tickets, B, sp, nq, nkv, head_dim, page_size, W, num_pages, chunk,
    # splits, slabs, scale, softcap, window, dtype, kv_dtype, stream
    "kt_dense_ragged_paged_attention": (
        [_P] * 9 + [_I] * 11 + [_F, _F, _I, _I, _I, _P]),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed")


def sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (one nvcc each, in parallel) and link the shared
    library; returns its path.  Reuses a library whose stamp matches."""
    digest = sources_digest()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        last_build.update(seconds=0.0, path=str(lib_path), log="",
                          cached=True)
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name}:\n{logs[-1]}")
        out_lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(out_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError(
                "linking the kernel library failed:\n"
                + link.stdout.decode(errors="replace"))
        os.replace(out_lib, lib_path)
        # nvcc's output beside the library it built (-Xptxas=-v: registers
        # and spills per kernel), whichever caller built it
        (BUILD_DIR / "nvcc.log").write_text("\n".join(logs))
        stamp.write_text(digest)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    last_build.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      log="\n".join(logs), cached=False)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and bound with ctypes."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
