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

The backward (training): ``ssd_scan_bwd_cuda`` launches
``csrc/ssd_scan_bwd.cu`` (four passes; bf16 runs its products on the
tensor cores, fp32 on CUDA cores), and ``ssd_scan_bwd_plain`` computes the
same gradient by its explicit formulas; ``kernels.ops.SSDScanFn`` takes
one or the other by device.
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
    (``build.refuse_grad``: ``kernels.ops.SSDScanFn`` is the path that
    carries a gradient)."""
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


# ------------------------------------------------------------ the backward

# the backward's four passes (csrc/ssd_scan_bwd.cu): each chunk's own
# state and its dy C^T term; the states passed forward and their
# gradients passed back; the rows of every chunk (in bf16 two launches,
# the rows as i and as j); the cumsum of dcum, dA and the group sums of dB
# and dC
BWD_PASSES = ("chunk", "state", "rows", "reduce")


def ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk: int,
                       initial_state=None):
    """(dx, ddt, dA, dB, dC, dinit): the gradient of ``ssd_scan_plain``'s
    (y, final state) against (dy, dfinal), from the forward's inputs, by
    the formulas of ``csrc/ssd_scan_bwd.cu`` in plain torch and fp32, all
    chunks at once at ``effective_chunk(chunk, S)`` (the forward's).
    dx, dB and dC come back in their inputs' dtype; ddt, dA and dinit in
    fp32; dinit is None without an initial state.

    Per chunk and head, with cum_i = sum_{k<=i} dt_k A, S_{c-1} the state
    before the chunk and G_c the gradient of the state after it
    (G_{nc-1} = dfinal):
      G_{c-1} = exp(cum_last) G_c + sum_i exp(cum_i) dy_i C_i^T,
      dinit = G_{-1};
      br_j = sum_{i>=j} (C_i . B_j) exp(cum_i - cum_j) dy_i
             + exp(cum_last - cum_j) G_c B_j;   dx_j = dt_j br_j;
      dB_j = sum over the group's heads of
             sum_{i>=j} exp(cum_i - cum_j) dt_j (dy_i . x_j) C_i
             + exp(cum_last - cum_j) dt_j G_c^T x_j;
      dC_i = sum over the group's heads of exp(cum_i) S_{c-1}^T dy_i
             + sum_{j<=i} exp(cum_i - cum_j) dt_j (dy_i . x_j) B_j;
      ddt_j = x_j . br_j + A sum_{i>=j} dcum_i, dA = sum dt_k dcum's
      reverse cumsum over the chunk, where with
      M_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j (dy_i . x_j) (j <= i) and
      k_j = exp(cum_last - cum_j) dt_j <G_c, x_j B_j^T>:
      dcum_i = sum_j M_ij - sum_i' M_i'i + exp(cum_i) dy_i . (S_{c-1} C_i)
               - k_i, and the last row adds
               sum_j k_j + exp(cum_last) <G_c, S_{c-1}>.
    The ragged tail is neutralised by dt = 0, as in the forward."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    Q = effective_chunk(chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.view(Bsz, nc, Q, *tail)
    xf, dyf = chunks(x, G, R, P), chunks(dy, G, R, P)
    dtf = chunks(dt, G, R)
    Bc, Cc = chunks(Bm, G, N), chunks(Cm, G, N)
    Af = A.float().view(G, R)
    cum = torch.cumsum(dtf * Af, dim=2)                    # [B, c, Q, G, R]
    last = cum[:, :, -1]                                   # [B, c, G, R]
    w = torch.exp(last[:, :, None] - cum)                  # exp(last - cum_j)

    # the states passed forward (prev[:, c] = S_{c-1}) and their gradients
    # passed back (Gs[:, c] = G_c)
    dS = torch.einsum("bcjgrp,bcjgn->bcgrpn", (w * dtf)[..., None] * xf, Bc)
    E = torch.einsum("bcigrp,bcign->bcgrpn",
                     torch.exp(cum)[..., None] * dyf, Cc)
    state = (torch.zeros((Bsz, G, R, P, N), device=x.device)
             if initial_state is None
             else initial_state.float().reshape(Bsz, G, R, P, N))
    decay = torch.exp(last)[..., None, None]
    prev = []
    for c in range(nc):
        prev.append(state)
        state = decay[:, c] * state + dS[:, c]
    prev = torch.stack(prev, 1)                            # [B, c, G, R, P, N]
    g = (torch.zeros((Bsz, G, R, P, N), device=x.device) if dfinal is None
         else dfinal.float().reshape(Bsz, G, R, P, N))
    Gs = [None] * nc
    for c in reversed(range(nc)):
        Gs[c] = g
        g = decay[:, c] * g + E[:, c]
    Gs = torch.stack(Gs, 1)
    dinit = None if initial_state is None else g.reshape(Bsz, H, P, N)

    # the chunks' rows: L_ij = exp(cum_i - cum_j) for j <= i, selected
    # before the exp (above the diagonal the exponent is positive)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None] - cum[:, :, None]             # [B, c, i, j, G, R]
    L = torch.exp(torch.where(causal[:, :, None, None], seg, -torch.inf))
    scores = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)[..., None]
    dyx = torch.einsum("bcigrp,bcjgrp->bcijgr", dyf, xf)
    Wt = L * dtf[:, :, None] * dyx                         # exp dt_j (dy_i.x_j)
    GB = torch.einsum("bcgrpn,bcjgn->bcjgrp", Gs, Bc)      # G_c B_j
    br = (torch.einsum("bcijgr,bcigrp->bcjgrp", scores * L, dyf)
          + w[..., None] * GB)
    dx = dtf[..., None] * br
    ddt = (xf * br).sum(-1)
    Gx = torch.einsum("bcgrpn,bcjgrp->bcjgrn", Gs, xf)     # G_c^T x_j
    dB = (torch.einsum("bcijgr,bcign->bcjgn", Wt, Cc)
          + torch.einsum("bcjgr,bcjgrn->bcjgn", w * dtf, Gx))
    Sd = torch.einsum("bcgrpn,bcigrp->bcigrn", prev, dyf)  # S_{c-1}^T dy_i
    ecum = torch.exp(cum)
    dC = (torch.einsum("bcigr,bcigrn->bcign", ecum, Sd)
          + torch.einsum("bcijgr,bcjgn->bcign", Wt, Bc))

    # dcum, then its reverse cumsum within each chunk gives ddt's and dA's
    # part through cum
    M = scores * Wt                                        # [B, c, i, j, G, R]
    k = w * dtf * (xf * GB).sum(-1)                        # [B, c, j, G, R]
    dcum = (M.sum(3) - M.sum(2) + ecum * (Sd * Cc[:, :, :, :, None]).sum(-1)
            - k)
    dcum[:, :, -1] += k.sum(2) + torch.exp(last) * (Gs * prev).sum((-1, -2))
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + Af * ddA
    dA = (dtf * ddA).sum((0, 1, 2)).reshape(H)

    def rows(t, *tail):
        return t.reshape(Bsz, nc * Q, *tail)[:, :S]
    return (rows(dx, H, P).to(x.dtype), rows(ddt, H), dA,
            rows(dB, G, N).to(Bm.dtype), rows(dC, G, N).to(Cm.dtype), dinit)


def check_bwd(x, Bm) -> None:
    """What the backward kernel does not take, refused before the forward
    launches (``kernels.ops.SSDScanFn``): it takes every head_dim and
    state_dim the forward does (DIMS), in both dtypes, so only those
    outside are refused."""
    P, N = x.shape[-1], Bm.shape[-1]
    if P not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_scan_bwd: head_dim {P} / state_dim {N} not "
                         f"in {DIMS}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan_bwd: x is {x.dtype}, the kernel takes "
                        f"{DTYPES}")


def bwd_heads_per_block(H: int, G: int, dtype) -> int:
    """Heads of a group one rows block of the bf16 backward takes, summing
    their dB and dC before it writes them (csrc/ssd_scan_bwd.cu's
    heads_per_block); fp32 takes one."""
    R = H // G
    if dtype != torch.bfloat16:
        return 1
    return next(hb for hb in (8, 4, 2, 1) if R % hb == 0)


def bwd_state_split(P: int, N: int) -> int:
    """Blocks of the backward's state pass a (batch, head), one float4 of
    [P, N] a thread (csrc/ssd_scan_bwd.cu's state_split), each writing its
    part of <G_c, S_c>."""
    return max(1, P * N // 1024)


def bwd_workspace_floats(B: int, S: int, H: int, G: int, P: int, N: int,
                         chunk: int, dtype) -> int:
    """fp32 elements of the backward kernel's workspace
    (csrc/ssd_scan_bwd.cu): in bf16 the states S_{c-1} and their gradients
    G_c as bf16 high and low tiles (as many bytes as [B, H, nc, P, N] fp32
    each); the chunks' own states and dy C^T terms, [B, H, nc, P, N] each;
    the partials of dB and dC, [B, S, H / bwd_heads_per_block, N] each;
    cum and dy . y, [B, H, nc, Q] each; the partials of the last row's
    extra term of dcum, [B, H, nc, bwd_state_split]."""
    Q = effective_chunk(chunk, S)
    nc = -(-S // Q)
    tiles = 2 if dtype == torch.bfloat16 else 0
    parts = H // bwd_heads_per_block(H, G, dtype)
    return (B * H * nc * ((2 + tiles) * P * N + 2 * Q
                          + bwd_state_split(P, N))
            + 2 * B * S * parts * N)


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk: int,
                      initial_state=None):
    """Launch ``csrc/ssd_scan_bwd.cu`` (its four passes, BWD_PASSES) on
    the current stream; returns what ``ssd_scan_bwd_plain`` returns, and
    raises on anything the kernel does not take.  Its workspace comes from
    the caching allocator for this call alone (autograd runs a backward on
    its own thread).  Counts its calls in ``.launches``, each pass in
    ``.pass_launches``, and the calls by the kernels that ran in
    ``.variant_launches``: "wgmma" (bf16, the tensor cores) or
    "cuda_core" (fp32)."""
    build.refuse_grad("ssd_scan_bwd", x, dt, A, Bm, Cm, dy, dfinal,
                      initial_state)
    check_bwd(x, Bm)
    _check(x, dt, A, Bm, Cm, chunk, initial_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t, shape, dtype in (
            ("dy", dy, x.shape, x.dtype),
            ("dfinal", dfinal, (Bsz, H, P, N), torch.float32)):
        if t is None:
            continue
        if (t.device != x.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
                or (dtype == torch.bfloat16 and t.data_ptr() % 16)):
            raise ValueError(
                f"ssd_scan_bwd: {name} must be a contiguous {dtype} tensor "
                f"of shape {tuple(shape)} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    Q = effective_chunk(chunk, S)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=x.device)
    dA = torch.empty((H,), dtype=torch.float32, device=x.device)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dinit = (None if initial_state is None else
             torch.empty((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device))
    ws = torch.empty(bwd_workspace_floats(Bsz, S, H, G, P, N, Q, x.dtype),
                     dtype=torch.float32, device=x.device)
    lib = build.load()
    bf16 = x.dtype == torch.bfloat16
    fn = lib.ssd_scan_bwd_bf16 if bf16 else lib.ssd_scan_bwd_f32

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), ptr(initial_state), dy.data_ptr(),
                 ptr(dfinal), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), ptr(dinit), ws.data_ptr(),
                 Bsz, S, H, G, P, N, Q, stream)
    build.check(err, "ssd_scan_bwd")
    with _count_lock:
        ssd_scan_bwd_cuda.launches += 1
        for name in BWD_PASSES:
            ssd_scan_bwd_cuda.pass_launches[name] += 1
        ssd_scan_bwd_cuda.variant_launches[
            "wgmma" if bf16 else "cuda_core"] += 1
    return dx, ddt, dA, dB, dC, dinit


ssd_scan_bwd_cuda.launches = 0
ssd_scan_bwd_cuda.pass_launches = dict.fromkeys(BWD_PASSES, 0)
ssd_scan_bwd_cuda.variant_launches = {"wgmma": 0, "cuda_core": 0}
