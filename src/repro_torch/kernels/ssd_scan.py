"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``, the port of the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_kernel`` (see that source for the
design and what bounds it on the card).  ``ssd_scan_plain`` repeats the
kernel's per-chunk algorithm in plain torch — the intra-chunk
``(C Bᵀ ∘ L)(dt·x)``, the ``exp(cum)``-weighted read of the carried fp32
``[P, N]`` state, the state update, and a ragged tail padded with
``dt = 0`` — so the CPU tests exercise it, and ``chip_smoke.py`` holds the
kernel against it on the card.  ``kernels.ops.ssd_scan`` picks between the
two by the tensors' device.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

DIMS = (16, 32, 64, 128)     # head_dim P and state_dim N the kernel takes
MAX_CHUNK = 256              # the chunk's rows are staged in shared memory
DTYPES = (torch.bfloat16, torch.float32)

_count_lock = threading.Lock()


def effective_chunk(chunk: int, S: int) -> int:
    """The chunk the scan runs with: the TPU wrapper's
    ``min(chunk, max(S, 8))``.  The result does not depend on it."""
    return min(chunk, max(S, 8))


def ssd_scan_plain(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """x: [B, S, H, P]; dt: [B, S, H] (>= 0); A: [H] (< 0);
    Bm/Cm: [B, S, G, N] (head h reads group h // (H/G));
    initial_state: [B, H, P, N] or None.
    Returns (y [B, S, H, P] in x's dtype, final state [B, H, P, N] fp32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = effective_chunk(chunk, S)
    pad = (-S) % Q
    # the ragged tail: dt = 0 there gives decay 1 and no contribution
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Bh = F.pad(Bm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, 2)
    Ch = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).repeat_interleave(rep, 2)
    Af = A.float()
    state = (torch.zeros((Bsz, H, P, N), device=x.device)
             if initial_state is None else initial_state.float().clone())
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, S + pad, Q):
        xq = xf[:, t0:t0 + Q] * dtf[:, t0:t0 + Q, :, None]   # dt folded in
        Bc, Cc = Bh[:, t0:t0 + Q], Ch[:, t0:t0 + Q]          # [B, Q, H, N]
        cum = torch.cumsum(dtf[:, t0:t0 + Q] * Af, dim=1)    # [B, Q, H]
        # L[i, j] = exp(cum_i - cum_j) for i >= j; selected before the exp,
        # since above the diagonal the exponent is positive and may overflow
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # [B, i, j, H]
        L = torch.exp(torch.where(causal[None, :, :, None], seg,
                                  -torch.inf))
        scores = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * L
        y = torch.einsum("bijh,bjhp->bihp", scores, xq)
        # the carried state's contribution, decayed to each row
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", Cc, state)
        ys.append(y)
        last = cum[:, -1]                                    # [B, H]
        w = torch.exp(last[:, None] - cum)                   # [B, Q, H]
        state = torch.exp(last)[..., None, None] * state + torch.einsum(
            "bjh,bjhp,bjhn->bhpn", w, xq, Bc)
    y = torch.cat(ys, 1)[:, :S].to(x.dtype)
    return y, state


def _check(x, dt, A, Bm, Cm, chunk, initial_state):
    named = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    if initial_state is not None:
        named["initial_state"] = initial_state
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, expected "
                             f"the CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/Bm/Cm are {x.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype}; the kernel takes them all bf16 or all "
                        f"fp32")
    for name in ("dt", "A", "initial_state"):
        t = named.get(name)
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}, expected fp32")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}: expected "
                         f"[B,S,H,P] and two equal [B,S,G,N]")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.numel() == 0:
        raise ValueError("ssd_scan: empty input")
    if tuple(Bm.shape[:2]) != (Bsz, S) or tuple(dt.shape) != (Bsz, S, H) \
            or tuple(A.shape) != (H,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} / A "
                         f"{tuple(A.shape)} / Bm {tuple(Bm.shape)} disagree "
                         f"with x {tuple(x.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: {H} heads not a multiple of {G} groups")
    if P not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_scan: head_dim {P} / state_dim {N} not in "
                         f"{DIMS}")
    if not 1 <= chunk or effective_chunk(chunk, S) > MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} outside [1, {MAX_CHUNK}]")
    if initial_state is not None and \
            tuple(initial_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"ssd_scan: initial_state "
                         f"{tuple(initial_state.shape)}, expected "
                         f"{(Bsz, H, P, N)}")


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Launch the CUDA kernel on the current stream; raises on anything
    the kernel does not take.  Counts its launches in ``.launches``."""
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = build.load()
    fn = lib.ssd_scan_bf16 if x.dtype == torch.bfloat16 else lib.ssd_scan_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), final.data_ptr(), Bsz, S, H, G, P, N,
                 effective_chunk(chunk, S), stream)
    build.check(err, "ssd_scan")
    with _count_lock:
        ssd_scan_cuda.launches += 1
    return y, final


ssd_scan_cuda.launches = 0
