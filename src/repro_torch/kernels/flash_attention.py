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


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float,
                          window: int = 0, softcap: float = 0.0,
                          kv_len: Optional[int] = None):
    """q: [B, S, H, D]; k/v: [B, T, KVH, D] -> [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kv_len = T if kv_len is None else min(kv_len, T)
    qf = q.float().reshape(B, S, KVH, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
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
            valid = kpos < kv_len
            if causal:
                valid = valid & (kpos <= qpos)
            if window > 0:
                valid = valid & (kpos > qpos - window)
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
                         kv_len: Optional[int] = None):
    """Launch the CUDA kernel on the current stream; raises on anything
    the kernel does not take.  Counts its launches in ``.launches``, by
    the window it was given in ``.window_launches``, and those not causal
    in ``.noncausal_launches``."""
    _check(q, k, v, kv_len)
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.load()
    fn = (lib.flash_attention_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, T, H, KVH, D, T if kv_len is None else kv_len,
                 int(causal), int(window), float(softcap), float(scale),
                 stream)
    build.check(err, "flash_attention")
    with _count_lock:
        flash_attention_cuda.launches += 1
        counts = flash_attention_cuda.window_launches
        counts[int(window)] = counts.get(int(window), 0) + 1
        flash_attention_cuda.noncausal_launches += not causal
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.window_launches = {}
flash_attention_cuda.noncausal_launches = 0
