"""Public kernel entry points: one dispatch rule for every kernel.

A wrapper takes tensors that lie on the CPU to the kernel's plain version
and tensors on a CUDA device to the hand-written kernel.  There is no
other branch and no fallback: a CUDA tensor launches the kernel or raises.
(This replaces the JAX package's ``_auto_interpret``, which picked the
Pallas interpreter off the TPU.)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd

# kernel name -> its CUDA wrapper (each counts its launches)
CUDA_WRAPPERS = {
    "flash_attention": _fa.flash_attention_cuda,
    "paged_attention": _pa.paged_attention_cuda,
    "ssd_scan": _ssd.ssd_scan_cuda,
}

# kernel name -> the wrapper's counts by kind, kept beside ``.launches``:
# flash by window, paged by slot-cache capacity, the SSD scan by variant
KIND_COUNTS = {
    "flash_attention": "window_launches",
    "paged_attention": "capacity_launches",
    "ssd_scan": "variant_launches",
}


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def flash_attention(q, k, v, **kw):
    """Prefill attention; see ``kernels.flash_attention``."""
    if _on_cuda(q, k, v):
        return _fa.flash_attention_cuda(q, k, v, **kw)
    return _fa.flash_attention_plain(q, k, v, **kw)


def paged_attention(q, k_pages, v_pages, page_tables, lengths, **kw):
    """Decode attention over KV pages; see ``kernels.paged_attention``."""
    args = (q, k_pages, v_pages, page_tables, lengths)
    if _on_cuda(*args):
        return _pa.paged_attention_cuda(*args, **kw)
    return _pa.paged_attention_plain(*args, **kw)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Mamba-2 SSD chunked scan; see ``kernels.ssd_scan``.  Returns
    (y [B,S,H,P] in x's dtype, final state [B,H,P,N] fp32)."""
    args = (x, dt, A, Bm, Cm)
    extra = () if initial_state is None else (initial_state,)
    if _on_cuda(*args, *extra):
        return _ssd.ssd_scan_cuda(*args, chunk=chunk,
                                  initial_state=initial_state)
    return _ssd.ssd_scan_plain(*args, chunk=chunk,
                               initial_state=initial_state)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in CUDA_WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's count, its counts by kind (KIND_COUNTS), and
    flash's count of launches that were not causal."""
    for name, fn in CUDA_WRAPPERS.items():
        fn.launches = 0
        kinds = getattr(fn, KIND_COUNTS[name])
        for kind in kinds:
            kinds[kind] = 0
    _fa.flash_attention_cuda.noncausal_launches = 0
