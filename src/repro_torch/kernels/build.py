"""Build the port's CUDA kernels on first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with
a plain C interface; ``csrc/*.cuh`` are headers they share.  The library
lands in ``build/kernels/<hash>/`` at the repository root, keyed by a hash
of the sources, headers and flags, so a checkout builds once and a changed
source rebuilds.  Nothing here runs at import
time: the CPU tests import every module without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libflexnpu_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported function (each returns a cudaError_t)
SIGNATURES = {
    # q, k, v, out, lse (or NULL), B, S, T, H, KVH, D, kv_len, causal,
    # window, softcap, scale, stream
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _F, _F, _P],
    # q, k, v, o, lse, dout, dq, dk, dv, delta (workspace), B, S, T, H, KVH,
    # D, kv_len, causal, window, softcap, scale, stream
    "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k_pages, v_pages, page_tables, lengths, out, scratch, tickets, B,
    # H, KVH, D, ps, maxp, n_split, span, scale, softcap, stream
    "paged_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _F, _F, _P],
    # x, dt, A, Bm, Cm, initial_state (or NULL), y, final_state, workspace
    # (bf16 only), B, S, H, G, P, N, chunk, stream
    "ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 _I, _P],
    # x, dt, A, Bm, Cm, initial_state (or NULL), dy, dfinal (or NULL), dx,
    # ddt, dA, dB, dC, dinit (or NULL), workspace, B, S, H, G, P, N, chunk,
    # stream
    "ssd_scan_bwd": [_P] * 15 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/*.cu on the machine with the card")
    return str(path)


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels if this source hash has no library yet.
    Returns the library's path.  ``ptxas.log`` beside it holds each kernel's
    registers, shared memory and spills (``-Xptxas -v``)."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        procs = [subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in
                  zip(sources(), procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [exe, "-shared", *[str(o) for o in objs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "ptxas.log").write_text("".join(logs))
        os.replace(tmp_lib, lib)   # atomic: a concurrent builder sees all
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with typed entry points
    ``<kernel>_bf16`` and ``<kernel>_f32``."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                for suffix in ("bf16", "f32"):
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would have to carry a gradient through a launch
    here: a kernel's output, written through a raw pointer, has no
    ``grad_fn``, so a backward pass would leave the inputs without a
    gradient and say nothing.  Only ``kernels.ops.FlashAttentionFn`` and
    ``kernels.ops.SSDScanFn``, whose forwards run with grad disabled, give
    a kernel a backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{kernel}: called with grad enabled on inputs that require "
            f"grad, but the CUDA kernel's output carries no gradient; "
            f"train through kernels.ops (flash attention and the SSD scan "
            f"have backward kernels), or call it under torch.no_grad()")


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
