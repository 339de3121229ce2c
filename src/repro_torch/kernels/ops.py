"""Public kernel entry points: one dispatch rule for every kernel.

A wrapper takes tensors that lie on the CPU to the kernel's plain version
and tensors on a CUDA device to the hand-written kernel.  There is no
other branch and no fallback: a CUDA tensor launches the kernel or raises.
(This replaces the JAX package's ``_auto_interpret``, which picked the
Pallas interpreter off the TPU.)

Flash attention and the SSD scan also carry a gradient: under autograd
(grad enabled and an input requiring grad) they go through
``FlashAttentionFn`` and ``SSDScanFn``, whose forward and backward each
take the kernel or the plain version by the same rule
(``flash_attention_bwd`` and ``ssd_scan_bwd`` on the card).  The CUDA
wrappers themselves refuse to run under autograd (``build.refuse_grad``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_scan as _ssd

# kernel name -> its CUDA wrapper (each counts its launches)
CUDA_WRAPPERS = {
    "flash_attention": _fa.flash_attention_cuda,
    "flash_attention_bwd": _fa.flash_attention_bwd_cuda,
    "paged_attention": _pa.paged_attention_cuda,
    "ssd_scan": _ssd.ssd_scan_cuda,
    "ssd_scan_bwd": _ssd.ssd_scan_bwd_cuda,
}

# kernel name -> the wrapper's counts by kind, kept beside ``.launches``:
# flash by window, each backward by pass (each call launches all its
# passes), paged by slot-cache capacity, the SSD scan by variant
KIND_COUNTS = {
    "flash_attention": "window_launches",
    "flash_attention_bwd": "pass_launches",
    "paged_attention": "capacity_launches",
    "ssd_scan": "variant_launches",
    "ssd_scan_bwd": "pass_launches",
}


def _on_cuda(*tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward keeps its output and
    its rows' log-sum-exp, the backward computes (dq, dk, dv) from them;
    each takes the kernel (CUDA tensors: ``flash_attention_cuda`` with
    ``return_lse``, then ``flash_attention_bwd_cuda``) or the plain
    version (CPU tensors).  On the card the forward first refuses what the
    backward kernel does not take (``check_bwd``), so no step runs a
    forward it cannot differentiate.  Both kernels are deterministic, so
    a recomputed forward (activation checkpointing) gives the same lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window: int,
                softcap: float, kv_len: Optional[int]):
        kw = dict(causal=causal, scale=scale, window=window,
                  softcap=softcap, kv_len=kv_len)
        if _on_cuda(q, k, v):
            _fa.check_bwd(q)
            out, lse = _fa.flash_attention_cuda(q, k, v, return_lse=True,
                                                **kw)
        else:
            out, lse = _fa.flash_attention_plain(q, k, v, return_lse=True,
                                                 **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        args = (q, k, v, out, lse, dout.contiguous())
        if _on_cuda(q, k, v):
            grads = _fa.flash_attention_bwd_cuda(*args, **ctx.kw)
        else:
            grads = _fa.flash_attention_bwd_plain(*args, **ctx.kw)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, scale: float,
                    window: int = 0, softcap: float = 0.0,
                    kv_len: Optional[int] = None):
    """Prefill attention; see ``kernels.flash_attention``.  Under autograd
    it goes through ``FlashAttentionFn``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, window,
                                      softcap, kv_len)
    kw = dict(causal=causal, scale=scale, window=window, softcap=softcap,
              kv_len=kv_len)
    if _on_cuda(q, k, v):
        return _fa.flash_attention_cuda(q, k, v, **kw)
    return _fa.flash_attention_plain(q, k, v, **kw)


def paged_attention(q, k_pages, v_pages, page_tables, lengths, **kw):
    """Decode attention over KV pages; see ``kernels.paged_attention``."""
    args = (q, k_pages, v_pages, page_tables, lengths)
    if _on_cuda(*args):
        return _pa.paged_attention_cuda(*args, **kw)
    return _pa.paged_attention_plain(*args, **kw)


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: the forward runs the scan (CUDA
    tensors: ``ssd_scan_cuda``, after ``check_bwd`` refuses what the
    backward kernel does not take; CPU tensors: ``ssd_scan_plain``) and
    keeps only its inputs; the backward (``ssd_scan_bwd_cuda`` or
    ``ssd_scan_bwd_plain``) recomputes the chunk states it needs, so the
    forward kernel and the serving path stay as they are.  Returns
    (y, final state); a final state no loss uses has a zero gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk: int):
        kw = dict(chunk=chunk, initial_state=initial_state)
        if _on_cuda(x, dt, A, Bm, Cm):
            _ssd.check_bwd(x, Bm)
            y, final = _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, **kw)
        else:
            y, final = _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, **kw)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, initial_state = ctx.saved_tensors
        args = (x, dt, A, Bm, Cm, dy.contiguous(), dfinal.contiguous())
        kw = dict(chunk=ctx.chunk, initial_state=initial_state)
        if _on_cuda(x, dt, A, Bm, Cm):
            grads = _ssd.ssd_scan_bwd_cuda(*args, **kw)
        else:
            grads = _ssd.ssd_scan_bwd_plain(*args, **kw)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Mamba-2 SSD chunked scan; see ``kernels.ssd_scan``.  Returns
    (y [B,S,H,P] in x's dtype, final state [B,H,P,N] fp32).  Under
    autograd it goes through ``SSDScanFn``."""
    args = (x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (*args,
                                                        initial_state)):
        return SSDScanFn.apply(*args, initial_state, chunk)
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
    """Zero every wrapper's count, its counts by kind (KIND_COUNTS),
    flash's and its backward's counts of launches that were not causal
    and the SSD backward's counts by variant."""
    for name, fn in CUDA_WRAPPERS.items():
        fn.launches = 0
        kinds = getattr(fn, KIND_COUNTS[name])
        for kind in kinds:
            kinds[kind] = 0
    _fa.flash_attention_cuda.noncausal_launches = 0
    _fa.flash_attention_bwd_cuda.noncausal_launches = 0
    for kind in _ssd.ssd_scan_bwd_cuda.variant_launches:
        _ssd.ssd_scan_bwd_cuda.variant_launches[kind] = 0
