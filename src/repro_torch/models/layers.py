"""Shared layers: norms, RoPE and M-RoPE, attention with bf16/fp32 or
int8 KV caches, the encoder-decoder's cross-attention, MLP.

Plain functions on tensors in the JAX package's layouts (activations
``[B, S, H, D]``, projections ``[d, H, D]``, caches ``[B, T, KVH, D]``), so
each function is held against its twin in ``repro/models/layers.py``.
Parameters are plain dicts of tensors; a ``lead`` shape prepends stacking
axes (the stack's repeats axis) to every parameter an initialiser draws.
With ``box=True`` each initialiser returns its parameters as ``Param``
boxes carrying the logical axes its JAX twin gives them (without the
stacking axes, which the stack prepends as ``"layers"``); on the ``meta``
device it draws nothing and gives tensors of the shapes alone.

Attention goes one step further than the JAX model, which never calls its
Pallas kernels (its docstring names an ``attn_impl`` switch that does not
exist there).  With ``attn_impl="kernel"`` (the default) prefill attention
goes through ``kernels.ops.flash_attention`` and decode attention through
``kernels.ops.paged_attention``: the hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.  ``attn_impl="plain"`` runs
``blocked_attention`` / ``decode_attention``, the twins of the JAX model's
own attention, on either device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Activation, ModelConfig, Norm, PosEmb
from repro_torch.distributed.sharding import (active_flag, attend_per_rank,
                                              boxed, einsum_per_rank,
                                              put_prefix, put_rows,
                                              shard_act)
from repro_torch.kernels import ops

ATTN_IMPLS = ("kernel", "plain")
NEG_INF = -1e30

# --------------------------------------------------------------------------
# Initializers (drawn from an explicit torch.Generator on the target device;
# on the meta device, shapes alone: a torch.Generator has no meta device)
# --------------------------------------------------------------------------


def dense_param(gen: Optional[torch.Generator], shape, axes, *, device,
                lead=(), dtype=torch.bfloat16, fan_in: Optional[int] = None,
                box: bool = False):
    if torch.device(device).type == "meta":
        x = torch.empty((*lead, *shape), dtype=dtype, device=device)
        return boxed(x, axes, box)
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn((*lead, *shape), generator=gen, device=device,
                    dtype=torch.float32)
    return boxed(x.mul_(scale).to(dtype), axes, box)


def embed_param(gen: Optional[torch.Generator], shape, axes, *, device,
                dtype=torch.bfloat16, box: bool = False):
    # std 1/sqrt(d_model): keeps tied-head logits O(1) at init
    return dense_param(gen, shape, axes, device=device, dtype=dtype,
                       fan_in=shape[-1], box=box)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, d: int, *, device, lead=(),
              box: bool = False) -> Dict:
    ax = ("embed",)
    if cfg.norm == Norm.RMSNORM:
        return {"scale": boxed(torch.ones((*lead, d), device=device), ax,
                               box)}
    if cfg.norm == Norm.LAYERNORM:
        return {"scale": boxed(torch.ones((*lead, d), device=device), ax,
                               box),
                "bias": boxed(torch.zeros((*lead, d), device=device), ax,
                              box)}
    return {}  # NONPARAM_LN


def apply_norm(cfg: ModelConfig, p: Dict, x, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == Norm.RMSNORM:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
        if cfg.norm == Norm.LAYERNORM:
            y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions [..., S] int -> cos/sin [..., S, head_dim//2] (fp32)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [B, S, H, D]; cos/sin [B, S, D//2] (half-split convention)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL M-RoPE: temporal/height/width splits of the half-dim.
    Published split for head_dim=128 is [16, 24, 24]; generalized as
    (1/4, 3/8, 3/8) of half-dim."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    w = half - t - h
    return t, h, w


def mrope_cos_sin(positions_thw, head_dim: int, theta: float):
    """positions_thw [3, B, S] -> cos/sin [B, S, head_dim//2].

    Each frequency band takes its angle from the temporal / height / width
    position row according to its section.  The sections are static, so
    the rows are widened by expand: no index tensor, no host round trip.
    """
    inv = rope_freqs(head_dim, theta, positions_thw.device)  # [half]
    pos = positions_thw.float()
    pos_sel = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], n)
                         for i, n in enumerate(mrope_sections(head_dim))],
                        dim=-1)                              # [B, S, half]
    ang = pos_sel * inv
    return torch.cos(ang), torch.sin(ang)


def positional_cos_sin(cfg: ModelConfig, positions):
    """Dispatch on cfg.pos_emb.  positions: [B,S] int or [3,B,S] for MROPE."""
    if cfg.pos_emb == PosEmb.MROPE:
        if positions.dim() == 2:  # text-only fallback: replicate across t/h/w
            positions = positions[None].expand(3, *positions.shape)
        return mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.pos_emb == PosEmb.ROPE:
        return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return None, None


# --------------------------------------------------------------------------
# Attention core
# --------------------------------------------------------------------------


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def attention_params(cfg: ModelConfig, gen: Optional[torch.Generator], *,
                     device, lead=(), box: bool = False) -> Dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(device=device, lead=lead, box=box)
    return {
        "wq": dense_param(gen, (d, h, hd), ("embed", "heads", "head_dim"),
                          **kw),
        "wk": dense_param(gen, (d, kvh, hd),
                          ("embed", "kv_heads", "head_dim"), **kw),
        "wv": dense_param(gen, (d, kvh, hd),
                          ("embed", "kv_heads", "head_dim"), **kw),
        "wo": dense_param(gen, (h, hd, d), ("heads", "head_dim", "embed"),
                          fan_in=h * hd, **kw),
    }


def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_override:
        return cfg.attn_scale_override
    return 1.0 / math.sqrt(cfg.head_dim)


def project(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` under the JAX twin's type promotion:
    the narrower operand is widened first, so fp32 activations against
    bf16 weights (an encoder over fp32 frames) multiply in fp32, as
    ``jnp.einsum`` does; operands of one dtype pass as they are."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return einsum_per_rank(eq, x, w)


def widened(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` with q, k and v in their promoted dtype
    and the output in q's: a bf16 decoder's cross-attention over an fp32
    encoder's K/V is one fp32 call on an exact upcast of q, its output
    rounded to bf16, as the JAX twin's ``blocked_attention`` (whose
    einsums promote, and which returns q's dtype).  The kernels take one
    dtype.  Each rank attends its own rows and heads (``attend_per_rank``)."""
    if q.dtype == k.dtype:
        return attend_per_rank(attend, q, k, v, **kw)
    dt = torch.promote_types(q.dtype, k.dtype)
    return attend_per_rank(attend, q.to(dt), k.to(dt), v.to(dt),
                           **kw).to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, scale: float,
                      q_positions=None, kv_lengths=None, window: int = 0,
                      softcap: float = 0.0, block_q: int = 512,
                      block_kv: int = 1024):
    """Online softmax over KV blocks inside a loop over Q blocks (the twin
    of the JAX model's attention; a loop stands in for its ``lax.scan``).
    Under autograd each q block, and each kv block inside it, is
    checkpointed, as the JAX twin's ``jax.checkpoint``s are: the backward
    recomputes a block's scores rather than keep its [bq, bk] fp32
    probabilities (flash attention's memory).

    q: [B, Sq, H, D]; k, v: [B, Skv, KVH, D] with GQA (H % KVH == 0).
    q_positions: [B, Sq] absolute query positions (default arange).
    kv_lengths: [B] valid KV length per sequence (default Skv).
    window: sliding-window size (0 = unlimited).
    """
    B, Sq, H, D = q.shape
    _, Skv, KVH, _ = k.shape
    G = H // KVH
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)[None].expand(B, Sq)
    if kv_lengths is None:
        kv_lengths = torch.full((B,), Skv, device=dev)
    remat = torch.is_grad_enabled()

    def kv_block(m, lse, o, q_i, pos_i, k_j, v_j, k0: int):
        pos_j = torch.arange(k0, k0 + k_j.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, k_j.float()) * scale
        s = _softcap(s, softcap)
        valid = pos_j[None, None, :] < kv_lengths[:, None, None]
        if causal:
            valid = valid & (pos_j[None, None, :] <= pos_i[:, :, None])
        if window > 0:
            valid = valid & (pos_j[None, None, :]
                             > pos_i[:, :, None] - window)
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lse = lse * corr + p.sum(-1)
        # the JAX twin rounds p to v's dtype before the PV product
        o = o * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v_j.dtype).float(), v_j.float())
        return m_new, lse, o

    def q_block(q_i, pos_i):
        bq = q_i.shape[1]
        m = torch.full((B, KVH, G, bq), NEG_INF, device=dev)
        lse = torch.zeros((B, KVH, G, bq), device=dev)
        o = torch.zeros((B, KVH, G, bq, D), device=dev)
        for k0 in range(0, Skv, block_kv):
            args = (m, lse, o, q_i, pos_i, k[:, k0:k0 + block_kv],
                    v[:, k0:k0 + block_kv], k0)
            m, lse, o = (checkpoint(kv_block, *args, use_reentrant=False)
                         if remat else kv_block(*args))
        blk = (o / torch.clamp_min(lse, 1e-30)[..., None]).to(q.dtype)
        return blk.permute(0, 3, 1, 2, 4).reshape(B, bq, H, D)

    qr = q.reshape(B, Sq, KVH, G, D)
    out = []
    for q0 in range(0, Sq, block_q):
        args = (qr[:, q0:q0 + block_q].float(),          # [B, bq, KVH, G, D]
                q_positions[:, q0:q0 + block_q])         # [B, bq]
        out.append(checkpoint(q_block, *args, use_reentrant=False)
                   if remat else q_block(*args))
    return torch.cat(out, dim=1)


def decode_attention(q, k_cache, v_cache, *, scale: float, lengths,
                     window: int = 0, softcap: float = 0.0):
    """Single-token decode attention over a dense cache.

    q: [B, 1, H, D]; caches: [B, T, KVH, D]; lengths: [B] (length INCLUDING
    the token just written).  Window masks to the last `window` positions.
    """
    B, _, H, D = q.shape
    s = _decode_scores(q, k_cache, scale=scale, lengths=lengths,
                       window=window, softcap=softcap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def _decode_scores(q, k_cache, *, scale: float, lengths, window: int,
                   softcap: float, t0: int = 0):
    """Masked fp32 scores [B, KVH, G, T] of one query token over cache
    slots t0 .. t0 + T - 1."""
    B, _, H, D = q.shape
    _, T, KVH, _ = k_cache.shape
    qr = q.reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bhgd,bthd->bhgt", qr.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(t0, t0 + T, device=q.device)[None]    # [1, T]
    valid = pos < lengths[:, None]
    if window > 0:
        valid = valid & (pos > (lengths[:, None] - 1 - window))
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def decode_attention_part(q, k_cache, v_cache, *, t0: int, scale: float,
                          lengths, window: int = 0, softcap: float = 0.0):
    """``decode_attention`` over the cache's slots t0 .. t0 + T - 1 alone:
    (its output there, fp32 [B, 1, H, D], and the scores' log-sum-exp
    [B, H]), which blocks of a cache split along T combine (flash
    decoding: ``attend_per_rank``)."""
    B, _, H, D = q.shape
    s = _decode_scores(q, k_cache, scale=scale, lengths=lengths,
                       window=window, softcap=softcap, t0=t0)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgt,bthd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, D), lse.reshape(B, H)


def page_size(T: int) -> int:
    """Tokens per page when a cache of T slots is viewed as pages: the
    largest power of two up to 64 that divides T (the paged kernel takes
    any size)."""
    return math.gcd(T, 64)


def paged_decode_attention(q, k_cache, v_cache, *, scale: float, lengths,
                           softcap: float = 0.0):
    """``decode_attention`` (no window) through the paged kernel.  The dense
    ``[B, T, KVH, D]`` slot cache is viewed as ``B*T/ps`` pages of ``ps``
    tokens under an identity page table; ``ps`` divides ``T``."""
    B, T, KVH, D = k_cache.shape
    ps = page_size(T)
    n_pages = B * T // ps
    page_tables = torch.arange(n_pages, dtype=torch.int32,
                               device=q.device).view(B, T // ps)
    out = ops.paged_attention(
        q[:, 0], k_cache.reshape(n_pages, ps, KVH, D),
        v_cache.reshape(n_pages, ps, KVH, D), page_tables,
        lengths.to(torch.int32), scale=scale, softcap=softcap)
    return out[:, None]


# --------------------------------------------------------------------------
# KV cache: one attention layer's dense cache.  The writes update the
# cache's tensors in place and return the same dict.
# --------------------------------------------------------------------------


def kv_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                  window: int = 0, *, device, lead=()) -> Dict:
    """One attention layer's cache.  window > 0 -> a ring buffer of
    ``min(max_len, window)`` slots, as the JAX twin makes.  An int8 cache
    holds int8 ``k``/``v`` and fp32 ``k_scale``/``v_scale`` [..., B, T, KVH]."""
    T = min(max_len, window) if window > 0 else max_len
    kvh, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (*lead, batch, T, kvh, hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dtype = torch.bfloat16 if cfg.kv_cache_dtype == "bfloat16" \
        else torch.float32
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_axes(is_ring: bool = False) -> Tuple[Optional[str], ...]:
    # ring buffers (sliding window) are small; don't sequence-shard them.
    seq = None if is_ring else "cache_seq"
    return ("cache_batch", seq, "cache_kv_heads", "cache_head_dim")


def _quantize_kv(x):
    """[B, T, H, D] -> int8 values + per-(b,t,h) fp32 scales (round half
    to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def kv_read(cache: Dict, dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cache's K/V; an int8 cache dequantized to ``dtype``."""
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def kv_write_prefill(cache: Dict, k, v) -> Dict:
    """Write a full prompt's K/V.  k/v: [B, S, KVH, D] (post-RoPE).  A
    prompt at least as long as the cache keeps its last T positions,
    ring-aligned, as the JAX twin does; an int8 cache takes the quantized
    values and their per-position scales (``put_prefix``)."""
    for name, x in (("k", k), ("v", v)):
        if "k_scale" in cache:
            x, scale = _quantize_kv(x)
            put_prefix(cache[f"{name}_scale"], scale)
        put_prefix(cache[name], x.to(cache[name].dtype))
    return cache


def kv_write_decode(cache: Dict, k, v, lengths) -> Dict:
    """Scatter one token per sequence at slot ``lengths % T``.
    k/v: [B, 1, KVH, D]; lengths: [B] (length BEFORE this token)."""
    T = cache["k"].shape[1]
    slots = (lengths % T).long()
    for name, x in (("k", k[:, 0]), ("v", v[:, 0])):
        if "k_scale" in cache:
            x, scale = _quantize_kv(x)
            put_rows(cache[f"{name}_scale"], slots, scale)
        put_rows(cache[name], slots, x.to(cache[name].dtype))
    return cache


# --------------------------------------------------------------------------
# Full attention layer (projection + rope + cache + attention + out-proj)
# --------------------------------------------------------------------------


def _qkv(p: Dict, x):
    return tuple(project("bsd,dhk->bshk", x, p[w]) for w in ("wq", "wk",
                                                             "wv"))


def _rope_qk(q, k, cos, sin):
    if cos is None:
        return q, k
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def attention_forward(cfg: ModelConfig, p: Dict, x, positions, *,
                      causal: bool = True, window: int = 0,
                      cache: Optional[Dict] = None, cos=None, sin=None,
                      attn_impl: str = "kernel"):
    """Teacher-forced / prefill attention.  x: [B, S, d_model].
    Returns (out, cache) — the cache written in place, or None."""
    if cos is None:
        cos, sin = positional_cos_sin(cfg, positions)
    q, k, v = _qkv(p, x)
    # q may be sequence-sharded ("act_seq"); k/v are laid out
    # seq-replicated here, once a layer, unless the "kv_seq_sharded" flag
    # leaves them seq-sharded (the JAX twin's constraints)
    kv_seq = "act_seq" if active_flag("kv_seq_sharded") else None
    q = shard_act(q, "batch", "act_seq", "act_heads", "act_head_dim")
    k = shard_act(k, "batch", kv_seq, "act_heads", "act_head_dim")
    v = shard_act(v, "batch", kv_seq, "act_heads", "act_head_dim")
    q, k = _rope_qk(q, k, cos, sin)
    kw = dict(causal=causal, scale=_attn_scale(cfg), window=window,
              softcap=cfg.attn_logit_softcap)
    if attn_impl == "plain":
        # sequence-parallel layout: one q block spanning the (seq-sharded)
        # length, as the JAX twin under the same flag
        kw["block_q"] = q.shape[1] if active_flag("single_q_block") else 512
        attend = blocked_attention
    else:
        attend = ops.flash_attention
    out = attend_per_rank(attend, q, k, v, **kw)
    if cache is not None:
        kv_write_prefill(cache, k, v)
    out = project("bshk,hkd->bsd", out, p["wo"])
    return shard_act(out, "batch", None, "act_embed"), cache


def attention_decode(cfg: ModelConfig, p: Dict, x, lengths, *,
                     window: int = 0, cache: Dict, cos=None, sin=None,
                     attn_impl: str = "kernel"):
    """One-token decode.  x: [B, 1, d_model]; lengths: [B] BEFORE this token.
    Returns (out, cache) with the cache updated in place.

    A windowed layer's ring cache (T <= window slots, slot = position % T)
    holds only positions inside the window, so it is attended unwindowed
    over its ``min(lengths + 1, T)`` filled slots, as in the JAX twin; on
    the kernel path that is the paged kernel.  A windowed cache longer
    than its window needs the window's mask, which only the plain
    ``decode_attention`` has: the kernel path refuses it, before it
    touches the cache."""
    T = cache["k"].shape[1]
    ring = window > 0 and T <= window
    if window > 0 and not ring and attn_impl != "plain":
        raise ValueError(
            f"attention_decode: a cache of {T} slots under a window of "
            f"{window} needs a windowed decode, and the paged kernel, like "
            f"the Pallas one, has no window.  The port's own caches are "
            f"rings of at most `window` slots (stack_cache_init), which "
            f"never reach this branch; use attn_impl='plain' for others")
    if cos is None:
        cos, sin = positional_cos_sin(cfg, lengths[:, None])
    q, k, v = _qkv(p, x)
    q, k = _rope_qk(q, k, cos, sin)
    kv_write_decode(cache, k, v, lengths)
    kd, vd = kv_read(cache, x.dtype)
    lens = lengths + 1
    if ring:                        # every filled slot is inside the window
        lens, window = torch.clamp(lens, max=T), 0
    kw = dict(scale=_attn_scale(cfg), lengths=lens,
              softcap=cfg.attn_logit_softcap)
    if attn_impl == "plain":
        out = attend_per_rank(decode_attention, q, kd, vd, window=window,
                              part=decode_attention_part, **kw)
    else:
        out = attend_per_rank(paged_decode_attention, q, kd, vd, **kw)
    return project("bshk,hkd->bsd", out, p["wo"]), cache


def cross_attention_forward(cfg: ModelConfig, p: Dict, x, enc_k, enc_v, *,
                            attn_impl: str = "kernel"):
    """Decoder cross-attention over precomputed encoder K/V (no cache
    update), unmasked.  x: [B, S, d]; enc_k/enc_v: [B, T, KVH, D], fp32
    under a bf16 decoder when the encoder ran on fp32 frames (``widened``:
    the attention in fp32, its output in q's dtype)."""
    q = project("bsd,dhk->bshk", x, p["wq"])
    kw = dict(causal=False, scale=_attn_scale(cfg))
    attend = blocked_attention if attn_impl == "plain" \
        else ops.flash_attention
    out = widened(attend, q, enc_k, enc_v, **kw)
    return project("bshk,hkd->bsd", out, p["wo"])


def cross_kv(cfg: ModelConfig, p: Dict, enc_out):
    k = project("btd,dhk->bthk", enc_out, p["wk"])
    v = project("btd,dhk->bthk", enc_out, p["wv"])
    return k, v


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------


def mlp_params(cfg: ModelConfig, gen: Optional[torch.Generator], *, device,
               lead=(), d: Optional[int] = None, f: Optional[int] = None,
               box: bool = False) -> Dict:
    d = d or cfg.d_model
    f = f or cfg.d_ff
    kw = dict(device=device, lead=lead, box=box)
    p = {"wi": dense_param(gen, (d, f), ("embed", "mlp"), **kw),
         "wo": dense_param(gen, (f, d), ("mlp", "embed"), fan_in=f, **kw)}
    if cfg.activation in (Activation.SWIGLU, Activation.GEGLU):
        p["wg"] = dense_param(gen, (d, f), ("embed", "mlp"), **kw)
    return p


def apply_mlp(cfg: ModelConfig, p: Dict, x):
    h = project("...d,df->...f", x, p["wi"])
    if cfg.activation == Activation.SWIGLU:
        g = project("...d,df->...f", x, p["wg"])
        h = F.silu(g) * h
    elif cfg.activation == Activation.GEGLU:
        g = project("...d,df->...f", x, p["wg"])
        h = F.gelu(g, approximate="tanh") * h
    elif cfg.activation == Activation.SQUARED_RELU:
        h = torch.square(F.relu(h))
    else:  # GELU
        h = F.gelu(h, approximate="tanh")
    if h.dim() == 3:
        h = shard_act(h, "batch", None, "mlp")
    return project("...f,fd->...d", h, p["wo"])
