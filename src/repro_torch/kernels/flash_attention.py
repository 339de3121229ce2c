"""Prefill flash attention: the CUDA kernel's wrapper and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the port of
the TPU kernel ``repro/kernels/flash_attention.py:flash_attention_kernel``
(see that source for the design and what bounds it on the card): bf16
inputs go to the tensor-core kernel (``wgmma``), fp32 inputs to the
CUDA-core kernel, which keeps fp32 products.  ``flash_attention_plain``
repeats the kernels' arithmetic in plain torch — the same BQ x BK tiles,
the same band skipping, the same fp32 online softmax — so the CPU tests
exercise it, and ``chip_smoke.py`` holds the kernels against it on the
card.  One difference: the bf16 kernel rounds the probabilities P to bf16
before P V (they are the tensor cores' A operand), where the plain version
keeps them in fp32; the output is rounded to bf16 anyway, and the two stay
within the 2e-2 bf16 tolerance.  ``kernels.ops.flash_attention`` picks
between the plain version and the kernels by the tensors' device.

Training adds the rows' log-sum-exp to the forward (``return_lse``) and a
backward: ``flash_attention_bwd_cuda`` launches ``csrc/
flash_attention_bwd.cu`` (dQ, dK, dV from q, k, v, the output, lse and
dO, at every head dim and kv_len the forward takes; no Pallas kernel has
a backward), and ``flash_attention_bwd_plain`` repeats its formulas tile
by tile in plain torch.
``kernels.ops.FlashAttentionFn`` joins forward and backward for autograd.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import build

BQ, BK = 64, 64          # the CUDA kernels' tile sizes
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 192, 256)
DTYPES = (torch.bfloat16, torch.float32)

_count_lock = threading.Lock()


def _tile_needed(q_start: int, k_start: int, *, kv_len: int, causal: bool,
                 window: int) -> bool:
    """Does the KV tile at k_start touch the visible band of the q tile?"""
    needed = k_start < kv_len
    if causal:
        needed &= k_start <= q_start + BQ - 1
    if window > 0:
        needed &= k_start + BK - 1 > q_start - window
    return needed


def _visible(qpos, kpos, *, kv_len: int, causal: bool, window: int):
    """The band's mask over (query, key) positions, as the kernels take it."""
    valid = kpos < kv_len
    if causal:
        valid = valid & (kpos <= qpos)
    if window > 0:
        valid = valid & (kpos > qpos - window)
    return valid


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float,
                          window: int = 0, softcap: float = 0.0,
                          kv_len: Optional[int] = None,
                          return_lse: bool = False):
    """q: [B, S, H, D]; k/v: [B, T, KVH, D] -> [B, S, H, D] in q's dtype,
    and with ``return_lse`` also each row's log-sum-exp of its scaled (and
    capped) scores, ``m + log l``, fp32 [B, H, S]."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kv_len = T if kv_len is None else min(kv_len, T)
    qf = q.float().reshape(B, S, KVH, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty((B, KVH, G, S), device=q.device)
    for q0 in range(0, S, BQ):
        qt = qf[:, q0:q0 + BQ]                          # [B, bq, KVH, G, D]
        bq = qt.shape[1]
        qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        m = torch.full((B, KVH, G, bq), NEG_INF, device=q.device)
        l = torch.zeros((B, KVH, G, bq), device=q.device)
        acc = torch.zeros((B, KVH, G, bq, D), device=q.device)
        for k0 in range(0, T, BK):
            if not _tile_needed(q0, k0, kv_len=kv_len, causal=causal,
                                window=window):
                continue
            kt, vt = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt) * scale
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None]
            valid = _visible(qpos, kpos, kv_len=kv_len, causal=causal,
                             window=window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vt)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B, KVH, G, bq, D]
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, D).to(q.dtype)
        lse[..., q0:q0 + bq] = m + torch.log(l)
    if return_lse:
        return out, lse.reshape(B, H, S)
    return out


def _check(q, k, v, kv_len):
    tensors = {"q": q, "k": k, "v": v}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected the CUDA device of q ({q.device})")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes q/k/v all bf16 or all fp32")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"4-d tensor, got shape {tuple(t.shape)}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the bf16 kernel copies 16-byte "
                             f"rows)")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention: empty input")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} heads not a multiple of "
                         f"{k.shape[2]} KV heads")
    if kv_len is not None and not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, {k.shape[1]}]")


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale: float,
                         window: int = 0, softcap: float = 0.0,
                         kv_len: Optional[int] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel on the current stream; raises on anything
    the kernel does not take, and under autograd (``build.refuse_grad``:
    ``kernels.ops.FlashAttentionFn`` is the path that carries a gradient).
    ``return_lse`` also returns the rows' log-sum-exp, fp32 [B, H, S], as
    ``flash_attention_plain``.  Counts its launches in ``.launches``, by
    the window it was given in ``.window_launches``, and those not causal
    in ``.noncausal_launches``."""
    build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, kv_len)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.load()
    fn = (lib.flash_attention_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, S, T, H, KVH, D, T if kv_len is None else kv_len,
                 int(causal), int(window), float(softcap), float(scale),
                 stream)
    build.check(err, "flash_attention")
    with _count_lock:
        flash_attention_cuda.launches += 1
        counts = flash_attention_cuda.window_launches
        counts[int(window)] = counts.get(int(window), 0) + 1
        flash_attention_cuda.noncausal_launches += not causal
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.window_launches = {}
flash_attention_cuda.noncausal_launches = 0


# ------------------------------------------------------------ the backward

BWD_PASSES = ("delta", "dkdv", "dq")     # the backward's three launches


def flash_attention_bwd_plain(q, k, v, o, lse, dout, *, causal: bool = True,
                              scale: float, window: int = 0,
                              softcap: float = 0.0,
                              kv_len: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention_plain``'s output against ``dout``,
    from the forward's output ``o`` and row log-sum-exp ``lse`` [B, H, S]:
    the formulas of ``csrc/flash_attention_bwd.cu`` in plain torch, on the
    same BQ x BK tiles with the same band skipping, in fp32.  Per tile
    P = exp(s - lse) (0 where masked), dP = dO V^T, dS = P (dP - Delta)
    (times 1 - tanh^2 of the capped score under a softcap), with
    Delta = rowsum(dO o); dV += P^T dO, dK += scale dS^T Q,
    dQ += scale dS K.  Returned in the inputs' dtypes."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kv_len = T if kv_len is None else min(kv_len, T)
    qf = q.float().reshape(B, S, KVH, G, D)
    df = dout.float().reshape(B, S, KVH, G, D)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * o.float()).sum(-1)           # [B, S, H]
    delta = delta.reshape(B, S, KVH, G).permute(0, 2, 3, 1)
    lse = lse.reshape(B, KVH, G, S)
    dq = torch.zeros((B, S, KVH, G, D), device=q.device)
    dk = torch.zeros((B, T, KVH, D), device=q.device)
    dv = torch.zeros((B, T, KVH, D), device=q.device)
    for q0 in range(0, S, BQ):
        qt, dt = qf[:, q0:q0 + BQ], df[:, q0:q0 + BQ]  # [B, bq, KVH, G, D]
        bq = qt.shape[1]
        qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        for k0 in range(0, T, BK):
            if not _tile_needed(q0, k0, kv_len=kv_len, causal=causal,
                                window=window):
                continue
            kt, vt = kf[:, k0:k0 + BK], vf[:, k0:k0 + BK]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, kt) * scale
            if softcap > 0:
                t = torch.tanh(s / softcap)
                s = t * softcap
            kpos = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None]
            valid = _visible(qpos, kpos, kv_len=kv_len, causal=causal,
                             window=window)
            p = torch.where(valid, torch.exp(s - lse[..., q0:q0 + bq, None]),
                            0.0)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dt, vt)
            ds = p * (dp - delta[..., q0:q0 + bq, None])
            if softcap > 0:
                ds = ds * (1 - t * t)
            dv[:, k0:k0 + BK] += torch.einsum("bhgqk,bqhgd->bkhd", p, dt)
            dk[:, k0:k0 + BK] += scale * torch.einsum("bhgqk,bqhgd->bkhd",
                                                      ds, qt)
            dq[:, q0:q0 + bq] += scale * torch.einsum("bhgqk,bkhd->bqhgd",
                                                      ds, kt)
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def check_bwd(q) -> None:
    """What the backward kernel does not take, refused before the forward
    launches: a head dim outside HEAD_DIMS (the forward's own)."""
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} not in "
                         f"{HEAD_DIMS}")


def flash_attention_bwd_cuda(q, k, v, o, lse, dout, *, causal: bool = True,
                             scale: float, window: int = 0,
                             softcap: float = 0.0,
                             kv_len: Optional[int] = None):
    """Launch ``csrc/flash_attention_bwd.cu`` (three launches: Delta, dK/dV,
    dQ; bf16 on the tensor cores, fp32 on CUDA cores) on the current
    stream; raises on anything it does not take.  Keys at or past
    ``kv_len`` get zero rows of dk and dv.  Its
    Delta workspace comes from the caching allocator for this call alone
    (autograd runs a backward on its own thread, and a workspace shared
    across calls would race).  Counts its calls in ``.launches`` and each
    pass's launches in ``.pass_launches``, and the calls not causal in
    ``.noncausal_launches``."""
    build.refuse_grad("flash_attention_bwd", q, k, v, o, dout)
    check_bwd(q)
    _check(q, k, v, kv_len)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (B, H, S), torch.float32)):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(
                f"flash_attention_bwd: {name} must be a contiguous {dtype} "
                f"tensor of shape {tuple(shape)} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = build.load()
    fn = (lib.flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_bwd_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                 B, S, T, H, KVH, D, T if kv_len is None else kv_len,
                 int(causal), int(window), float(softcap), float(scale),
                 stream)
    build.check(err, "flash_attention_bwd")
    with _count_lock:
        flash_attention_bwd_cuda.launches += 1
        for name in BWD_PASSES:
            flash_attention_bwd_cuda.pass_launches[name] += 1
        flash_attention_bwd_cuda.noncausal_launches += not causal
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.pass_launches = dict.fromkeys(BWD_PASSES, 0)
flash_attention_bwd_cuda.noncausal_launches = 0
