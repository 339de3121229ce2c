"""Plain-torch oracles for the kernels (the allclose references).

Deliberately naive: the attention oracles materialise the full score
matrix in fp32 and the SSD oracle steps the recurrence one token at a
time, so they are obviously correct and independent of the kernels'
tiling.  Same signatures and layouts as the JAX package's
``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# paged attention (decode): one query token per sequence over paged KV
# ---------------------------------------------------------------------------


def ref_paged_attention(q, k_pages, v_pages, page_tables, lengths, *,
                        scale: float, softcap: float = 0.0):
    """q: [B, H, D]; k/v_pages: [P, ps, KVH, D]; page_tables: [B, maxp];
    lengths: [B].  Returns [B, H, D]."""
    B, H, D = q.shape
    _, ps, KVH, _ = k_pages.shape
    maxp = page_tables.shape[1]
    G = H // KVH
    T = maxp * ps

    # densify: [B, T, KVH, D]
    pt = page_tables.long()
    k = k_pages[pt].reshape(B, T, KVH, D)
    v = v_pages[pt].reshape(B, T, KVH, D)

    qr = q.reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bthd->bhgt", qr.float(), k.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(T, device=q.device)[None]
    mask = pos < lengths.to(q.device)[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------


def ref_flash_attention(q, k, v, *, causal: bool = True, scale: float,
                        window: int = 0, softcap: float = 0.0,
                        kv_len: Optional[int] = None):
    """q: [B, S, H, D]; k/v: [B, T, KVH, D].  Returns [B, S, H, D]."""
    B, S, H, D = q.shape
    T = k.shape[1]
    KVH = k.shape[2]
    G = H // KVH
    qr = q.reshape(B, S, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k.float()) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    valid = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        valid &= kpos < kv_len
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= kpos > qpos - window
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan: sequential (timestep-by-timestep) reference
# ---------------------------------------------------------------------------


def ref_ssd(x, dt, A, Bm, Cm,
            initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H] (>=0); A: [H] (<0);
    Bm/Cm: [B, S, G, N].  Sequential recurrence:
        h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t . h_t
    Returns (y [B, S, H, P], final_state [B, H, P, N])."""
    b, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2).float()           # [b,S,H,N]
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((b, H, Pd, N), device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])           # [b,H]
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        h = decay[..., None, None] * h + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h
