"""Plain fp32 PyTorch pieces of a pre-norm decoder, shared by the
benchmark's references: RoPE, causal (optionally windowed) grouped-query
attention, norms, and the head.  No kernel, no cache, no batching: each
sequence is one teacher-forced pass, run layer by layer over all the
sequences so that only one layer's weights are widened to fp32 at a time.

``precision="fp8"`` is the control: every product's operands are rounded
to float8 e4m3 (scaled per row of each operand) before an fp32 product,
and an int8 KV cache becomes int4.  It is never the reference.

TF32 is switched off: a float32 product on the card may otherwise run in
TF32, a lower precision than the reference claims.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

FP8_MAX = 448.0                   # float8 e4m3's largest finite value
Q_BLOCK = 512                     # query rows of one attention block


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t rounded to float8 e4m3, each slice along ``dim`` scaled so that
    its largest magnitude maps to the format's largest, then widened."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str):
    """x [n, i] @ w [i, o] in fp32, or on fp8-rounded operands."""
    if precision == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rope(x, theta: float, fraction: float = 1.0):
    """Rotary embedding of x [L, H, D] at positions 0..L-1, rotating the
    two halves of the first ``fraction`` of each head (GPT-NeoX's
    layout)."""
    L, _, D = x.shape
    rot = int(D * fraction)
    half = rot // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x[..., rot:]], -1)


def quantize_kv(x, levels: int):
    """x [L, KVH, D] through a symmetric integer cache of ``levels`` steps
    each side (127: int8, 7: int4), one scale a (position, head), rounded
    half to even."""
    s = (x.abs().amax(-1, keepdim=True) / levels).clamp_min(1e-8)
    return torch.round(x / s) * s


def attention(q, k, v, *, window: int, scale: float, precision: str,
              rows: Tuple[int, int]):
    """Causal grouped-query attention of one sequence's query rows
    ``rows[0] .. rows[1] - 1``.  q [L, H, D]; k, v [L, KVH, D].  A key j
    is seen from row i when j <= i and, under a window, j > i - window.
    Returns [rows[1] - rows[0], H, D]."""
    H = q.shape[1]
    G = H // k.shape[1]
    pos = torch.arange(q.shape[0], device=q.device)
    out = []
    for q0 in range(rows[0], rows[1], Q_BLOCK):
        q1 = min(rows[1], q0 + Q_BLOCK)
        kk = k[:q1].repeat_interleave(G, dim=1)      # [q1, H, D]
        vv = v[:q1].repeat_interleave(G, dim=1)
        qb = q[q0:q1]
        if precision == "fp8":
            qb, kk, vv = fp8(qb), fp8(kk), fp8(vv, 0)
        s = torch.einsum("qhd,khd->hqk", qb, kk) * scale
        i, j = pos[q0:q1, None], pos[None, :q1]
        seen = j <= i
        if window > 0:
            seen &= j > i - window
        p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
        if precision == "fp8":
            p = fp8(p)
        out.append(torch.einsum("hqk,khd->qhd", p, vv))
    return torch.cat(out) if out else q[:0]


def layer(tree: Dict, r: int) -> Dict:
    """Repeat r of a stacked parameter tree, widened to fp32."""
    return {k: layer(v, r) if isinstance(v, dict) else v[r].float()
            for k, v in tree.items()}


def head_logits(weights: Dict, x, precision: str,
                strip_bytes: int = 2 << 30):
    """x [n, d] fp32 -> logits [n, V] fp32 through the untied head
    [d, V], widened a strip of columns at a time."""
    head = weights["head"]
    d, V = head.shape
    n = max(1, strip_bytes // (4 * d))
    return torch.cat([matmul(x, head[:, i:i + n].float(), precision)
                      for i in range(0, V, n)], dim=-1)


def forward(weights: Dict, model: Dict, seqs: Sequence[Tuple], *,
            block_fn, norm_fn, precision: str = "fp32") -> List:
    """Logits [n_i, V] (fp32) at the wanted positions of each sequence.

    seqs: (tokens [L] int64, wanted positions [n] int64, first_cached),
    where rows from ``first_cached`` on are decode steps (they read an
    integer KV cache where the model has one).  ``block_fn(h, p, ctx)``
    applies one layer's attention and FFN sublayers; ``norm_fn(x, p)``
    the model's norm."""
    no_tf32()
    x = [weights["embed"][t].float() for t, _, _ in seqs]
    stack = weights["blocks"][0]
    R = int(model["num_layers"])
    for r in range(R):
        p = layer(stack, r)
        x = [block_fn(h, p, dict(first_cached=fc, precision=precision))
             for h, (_, _, fc) in zip(x, seqs)]
        del p
    fin = {k: v.float() for k, v in weights["norm_final"].items()}
    return [head_logits(weights, norm_fn(h[want], fin), precision)
            for h, (_, want, _) in zip(x, seqs)]


def attention_sublayer(h, p: Dict, model: Dict, norm_fn, *, first_cached,
                       precision):
    """h + the attention sublayer of one layer (pre-norm)."""
    H, KVH, D = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    d = model["d_model"]
    L = h.shape[0]
    a = norm_fn(h, p["norm_mixer"])
    at = p["attn"]
    q = matmul(a, at["wq"].reshape(d, H * D), precision).view(L, H, D)
    k = matmul(a, at["wk"].reshape(d, KVH * D), precision).view(L, KVH, D)
    v = matmul(a, at["wv"].reshape(d, KVH * D), precision).view(L, KVH, D)
    frac = float(model.get("rotary_fraction", 1.0))
    q = rope(q, model["rope_theta"], frac)
    k = rope(k, model["rope_theta"], frac)
    kw = dict(window=int(model.get("sliding_window", 0)),
              scale=1.0 / math.sqrt(D), precision=precision)
    if model.get("kv_cache_dtype") == "int8":
        # a prompt's rows attend its own K/V; each decode step reads the
        # cache, every position of it quantized
        levels = 7 if precision == "fp8" else 127
        kq, vq = quantize_kv(k, levels), quantize_kv(v, levels)
        o = torch.cat([attention(q, k, v, rows=(0, first_cached), **kw),
                       attention(q, kq, vq, rows=(first_cached, L), **kw)])
    else:
        o = attention(q, k, v, rows=(0, L), **kw)
    return h + matmul(o.reshape(L, H * D), at["wo"].reshape(H * D, d),
                      precision)
