"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain version.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``, the port of the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan_kernel`` (``csrc/ssd_scan.cu`` says
what bounds it on the card and what its design does about it).  bf16 runs
the SSD decomposition on the tensor cores in three launches (chunk state,
state passing, chunk scan); fp32 runs the first port's CUDA-core kernel.
``ssd_scan_plain`` runs the same three steps in plain torch and fp32 —
each chunk's own state contribution, the states passed from chunk to
chunk, then each chunk's rows from the state before it and the
decay-masked ``(C Bᵀ ∘ L ∘ dt) x`` — so the CPU tests exercise it, and
``chip_smoke.py`` holds the kernel against it on the card.
``kernels.ops.ssd_scan`` picks between the two by the tensors' device.
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
    Returns (y [B, S, H, P] in x's dtype, final state [B, H, P, N] fp32).

    The bf16 kernel's three steps, in fp32: (1) each chunk's own state
    contribution dS_c, (2) the states passed from chunk to chunk,
    S_c = exp(cum_last_c) S_{c-1} + dS_c, (3) each chunk's rows from
    C S_{c-1}ᵀ and the decay-masked (C Bᵀ ∘ L ∘ dt) x.  Each product's
    first operand is the fp32 one (the decayed dt·x weights, S_{c-1}, W;
    C in C Bᵀ); its second is x, B or C, which the kernel takes exactly."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    Q = effective_chunk(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q
    # the ragged tail: dt = 0 there gives decay 1 and no contribution
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(Bsz, nc, Q, G, R, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).view(Bsz, nc, Q, G, R)
    Bc = F.pad(Bm.float(), (0, 0, 0, 0, 0, pad)).view(Bsz, nc, Q, G, N)
    Cc = F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)).view(Bsz, nc, Q, G, N)
    cum = torch.cumsum(dtf * A.float().view(G, R), dim=2)  # [B, c, Q, G, R]
    last = cum[:, :, -1]                                   # [B, c, G, R]

    # 1. chunk state: dS_c = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    w = torch.exp(last[:, :, None] - cum) * dtf
    dS = torch.einsum("bcjgrp,bcjgn->bcgrpn", w[..., None] * xf, Bc)

    # 2. state passing, sequential over the chunks: prev[:, c] = S_{c-1}
    state = (torch.zeros((Bsz, H, P, N), device=x.device)
             if initial_state is None else initial_state.float())
    state = state.reshape(Bsz, G, R, P, N)
    decay = torch.exp(last)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = decay[:, c, ..., None, None] * state + dS[:, c]
    prev = torch.stack(prev, 1)                            # [B, c, G, R, P, N]

    # 3. chunk scan: y_i = exp(cum_i) C_i S_{c-1}^T + sum_{j<=i} W_ij x_j,
    # W = (C_i . B_j) exp(cum_i - cum_j) dt_j; L selected before the exp,
    # since above the diagonal the exponent is positive and may overflow
    y = torch.einsum("bcgrpn,bcign->bcigrp", prev, Cc)
    y = y * torch.exp(cum)[..., None]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None]             # [B, c, i, j, G, R]
    L = torch.exp(torch.where(causal[:, :, None, None], seg, -torch.inf))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)
    W = scores[..., None] * L * dtf[:, :, None]
    y = y + torch.einsum("bcijgr,bcjgrp->bcigrp", W, xf)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype)
    return y, state.reshape(Bsz, H, P, N)


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
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} is not 16-byte aligned "
                             f"(the bf16 kernel copies 16-byte rows)")
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


def workspace_floats(B: int, S: int, H: int, P: int, N: int,
                     chunk: int) -> int:
    """fp32 elements of the bf16 kernel's workspace: each chunk's own state
    [B, nc, H, P, N] fp32, the state before each chunk as bf16 high and low
    tiles (as many bytes), then cum and dt [B, H, nc, Q] fp32
    (csrc/ssd_scan.cu)."""
    Q = effective_chunk(chunk, S)
    nc = -(-S // Q)
    return B * nc * H * (2 * P * N + 2 * Q)


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Launch the CUDA kernel on the current stream; raises on anything
    the kernel does not take.  Counts its launches in ``.launches``, and
    in ``.variant_launches`` by the kernel that ran: "wgmma" (bf16, the
    tensor cores) or "cuda_core" (fp32).  Raises under autograd
    (``build.refuse_grad``): the scan has no backward kernel yet."""
    build.refuse_grad("ssd_scan", x, dt, A, Bm, Cm, initial_state)
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = effective_chunk(chunk, S)
    y = torch.empty_like(x)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = build.load()
    bf16 = x.dtype == torch.bfloat16
    fn = lib.ssd_scan_bf16 if bf16 else lib.ssd_scan_f32
    # the bf16 kernels' three launches pass data through ws: one per call,
    # so two calls issued from two threads onto one stream never share it
    # (the caching allocator reuses its bytes only after this call's work)
    ws = (torch.empty(workspace_floats(Bsz, S, H, P, N, Q),
                      dtype=torch.float32, device=x.device) if bf16 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(),
                 None if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), final.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 Bsz, S, H, G, P, N, Q, stream)
    build.check(err, "ssd_scan")
    with _count_lock:
        ssd_scan_cuda.launches += 1
        ssd_scan_cuda.variant_launches["wgmma" if bf16 else "cuda_core"] += 1
    return y, final


ssd_scan_cuda.launches = 0
ssd_scan_cuda.variant_launches = {"wgmma": 0, "cuda_core": 0}
