"""Mamba-2 mixer: SSD (state-space duality) with chunked scan.

The twin of ``repro/models/mamba2.py`` (arXiv:2405.21060 §6): within a
chunk the recurrence is dense matmuls with a decay mask, across chunks a
loop carries the ``[H, P, N]`` state, and decode is the O(1) recurrent
update.  Dtypes follow the JAX side step by step: the conv history and the
SSM state are fp32, ``xs``/``B``/``C`` bf16 (the model's working type),
``dt`` fp32 after softplus, and ``y + D·xs`` promotes to fp32 before the
gated RMSNorm.

The JAX model never calls its Pallas kernel; the port goes one step
further, as it does for attention.  With ``attn_impl="kernel"`` (the
default) prefill's scan goes through ``kernels.ops.ssd_scan``: the
hand-written CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  ``attn_impl="plain"`` runs ``ssd_chunked``, the twin of the JAX
model's own scan, on either device.  Decode and the depthwise conv are
plain torch on both paths (plain JAX there too).

Caches are written in place (the JAX twin returns new ones): prefill and
decode copy the new conv tail and state into the layer's cache views.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (boxed, einsum_per_rank,
                                              is_dtensor, shard_act)
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_param


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, conv_dim


def mamba_params(cfg: ModelConfig, gen: Optional[torch.Generator], *,
                 device, lead=(), box: bool = False) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + nheads
    f32 = dict(device=device, dtype=torch.float32)
    kw = dict(device=device, lead=lead, box=box)
    # A init in [1, 16) (mamba2 default); dt_bias a constant, as the JAX twin
    a_init = torch.log(torch.linspace(1.0, 16.0, nheads, **f32))
    return {
        "in_proj": dense_param(gen, (d, d_in_proj), ("embed", "ssm_inner"),
                               **kw),
        "conv_w": dense_param(gen, (s.conv_width, conv_dim),
                              ("conv", "ssm_inner"), fan_in=s.conv_width,
                              **kw),
        "conv_b": boxed(torch.zeros((*lead, conv_dim), **f32),
                        ("ssm_inner",), box),
        "A_log": boxed(a_init.expand(*lead, nheads).clone(), ("ssm_heads",),
                       box),
        "D": boxed(torch.ones((*lead, nheads), **f32), ("ssm_heads",), box),
        "dt_bias": boxed(torch.zeros((*lead, nheads), **f32),
                         ("ssm_heads",), box),
        "norm_scale": boxed(torch.ones((*lead, d_inner), **f32),
                            ("ssm_inner",), box),
        "out_proj": dense_param(gen, (d_inner, d), ("ssm_inner", "embed"),
                                fan_in=d_inner, **kw),
    }


def mamba_cache_init(cfg: ModelConfig, batch: int, *, device,
                     lead=()) -> Dict:
    s = cfg.ssm
    _, nheads, conv_dim = _dims(cfg)
    f32 = dict(device=device, dtype=torch.float32)
    return {
        "conv": torch.zeros((*lead, batch, s.conv_width - 1, conv_dim),
                            **f32),
        "ssm": torch.zeros((*lead, batch, nheads, s.head_dim, s.state_dim),
                           **f32),
    }


def mamba_cache_axes() -> Dict[str, Tuple[Optional[str], ...]]:
    return {"conv": ("cache_batch", None, "ssm_inner"),
            "ssm": ("cache_batch", "ssm_heads", None, None)}


# ----------------------------------------------------------------- SSD core


def _segsum(x):
    """x: [..., l] -> [..., l, l]; out[i,j] = sum_{k in (j, i]} x_k, -inf
    above the diagonal."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan (the JAX model's own; a loop stands in for its
    ``lax.scan`` over chunks).

    x: [b, S, h, p] (pre-dt);  dt: [b, S, h] (post-softplus);  A: [h] (<0);
    B, C: [b, S, g, n] (broadcast over h // g heads per group).
    Returns (y [b, S, h, p] in x's dtype, final_state [b, h, p, n] fp32).
    """
    b, S, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    c = Sp // chunk

    Bh = B.repeat_interleave(rep, dim=2).float()              # [b, Sp, h, n]
    Ch = C.repeat_interleave(rep, dim=2).float()
    xq = (x.float() * dt[..., None]).reshape(b, c, chunk, h, p)  # dt folded
    dA = (dt * A[None, None, :]).reshape(b, c, chunk, h)
    dA = dA.movedim(3, 1)                                     # [b,h,c,l]
    Bc = Bh.reshape(b, c, chunk, h, n)
    Cc = Ch.reshape(b, c, chunk, h, n)

    dA_cum = torch.cumsum(dA, dim=-1)                         # [b,h,c,l]
    L = torch.exp(_segsum(dA))                                # [b,h,c,l,l]

    # intra-chunk (diagonal blocks)
    scores = torch.einsum("bclhn,bcshn->bhcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores * L, xq)

    # per-chunk terminal states
    decay_states = torch.exp(dA_cum[..., -1:] - dA_cum)       # [b,h,c,l]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xq)

    # inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[..., -1])                  # [b,h,c]
    state = (torch.zeros((b, h, p, n), device=x.device)
             if initial_state is None else initial_state.float())
    prevs = []
    for k in range(c):
        prevs.append(state)
        state = states[:, k] + chunk_decay[:, :, k, None, None] * state
    prev_states = torch.stack(prevs, 1)                       # [b,c,h,p,n]

    # off-diagonal: y_off[t] = C_t . (exp(dA_cum[t]) * prev_state)
    state_decay = torch.exp(dA_cum)                           # [b,h,c,l]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)

    y = (y_diag + y_off).reshape(b, Sp, h, p)[:, :S]
    return y.to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) recurrent update for one token.

    state: [b, h, p, n]; x_t: [b, h, p]; dt_t: [b, h]; A: [h];
    B_t, C_t: [b, g, n].  Returns (y [b, h, p], new_state).
    """
    h = state.shape[1]
    rep = h // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1).float()            # [b,h,n]
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    dA = torch.exp(dt_t * A[None, :])                         # [b,h]
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt_t, Bh, x_t.float())
    new_state = dA[..., None, None] * state + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


# ------------------------------------------------------------- full mixer


def _causal_conv_full(xBC, w, bias):
    """Depthwise causal conv.  xBC: [B, S, C]; w: [W, C] -> [B, S, C]."""
    W = w.shape[0]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xBC.shape[1], :] * w[i][None, None, :]
              for i in range(W))
    return out + bias[None, None, :]


def _gated_out(p: Dict, y, z, dtype):
    """Gated RMSNorm (fp32) then the out-projection."""
    gated = y * F.silu(z)
    gf = gated.float()
    var = gf.square().mean(-1, keepdim=True)
    y = (gf * torch.rsqrt(var + 1e-6) * p["norm_scale"]).to(dtype)
    return einsum_per_rank("...e,ed->...d", y, p["out_proj"])


def _split_xbc(cfg: ModelConfig, xBC, heads: slice, groups: slice):
    """xBC [..., conv_dim] -> (x [..., Hl, P] of the heads ``heads``,
    B and C [..., Gl, N] of the groups ``groups`` they read)."""
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.ngroups * s.state_dim
    xs, Bmat, Cmat = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    lead = xBC.shape[:-1]
    xs = xs.reshape(*lead, -1, s.head_dim)[..., heads, :]
    Bmat = Bmat.reshape(*lead, s.ngroups, s.state_dim)[..., groups, :]
    Cmat = Cmat.reshape(*lead, s.ngroups, s.state_dim)[..., groups, :]
    return xs, Bmat, Cmat


def _conv(cfg: ModelConfig, p: Dict, xBC, conv, step: bool):
    """The mixer's causal conv over the channels it is given, then SiLU:
    xBC [B, S, C] after the cached history ``conv`` [B, W - 1, C] (or
    zeros) -> (the activation [B, S, C] in xBC's dtype, the conv's input
    with its history, fp32); ``step``: one token, xBC [B, C]."""
    s = cfg.ssm
    w = p["conv_w"].float()                                   # [W, C]
    if step:
        conv_in = torch.cat([conv, xBC.float()[:, None, :]], dim=1)
        out = torch.einsum("bwc,wc->bc", conv_in, w) + p["conv_b"][None]
    else:
        conv_in = xBC.float()
        if conv is not None:
            conv_in = torch.cat([conv, conv_in], dim=1)
            out = _causal_conv_full(conv_in, w,
                                    p["conv_b"])[:, s.conv_width - 1:]
        else:
            out = _causal_conv_full(conv_in, w, p["conv_b"])
    return F.silu(out).to(xBC.dtype), conv_in


def _scan(cfg: ModelConfig, p: Dict, act, dt, state, *, step: bool,
          attn_impl: str = "plain", heads: slice = slice(None),
          groups: slice = slice(None)):
    """The SSD scan of the heads ``heads`` (their groups ``groups``) from
    ``state`` (or zeros): act [B, S, conv_dim] (the conv's activation),
    dt [B, S, H] before the softplus; ``step``: one token, act [B,
    conv_dim], dt [B, H], state required.  Returns (y + D x [B, S, Hl, P]
    (a step: [B, Hl, P]) fp32, the final state)."""
    s = cfg.ssm
    xs, Bmat, Cmat = _split_xbc(cfg, act, heads, groups)
    A = -torch.exp(p["A_log"][heads])
    if step:
        dt = F.softplus(dt[..., heads].float() + p["dt_bias"][heads][None])
        y, state = ssd_decode_step(state, xs, dt, A, Bmat, Cmat)
        return y + p["D"][heads][None, :, None] * xs, state
    xs, Bmat, Cmat = xs.contiguous(), Bmat.contiguous(), Cmat.contiguous()
    dt = F.softplus(dt[..., heads].float() + p["dt_bias"][heads][None, None])
    if attn_impl == "plain":
        y, state = ssd_chunked(xs, dt, A, Bmat, Cmat, s.chunk_size,
                               initial_state=state)
    else:
        y, state = ops.ssd_scan(xs, dt, A, Bmat, Cmat, chunk=s.chunk_size,
                                initial_state=state)
    return y + p["D"][heads][None, None, :, None] * xs, state


def _ssm(cfg: ModelConfig, p: Dict, xBC, dt, cache, step: bool,
         attn_impl: str = "plain"):
    """The mixer between its projections, the cache's conv tail and state
    written in place.  On ``DTensor``s (``_ssm_per_rank``) each rank runs
    the conv over its own channels and the scan over its own heads."""
    if is_dtensor(xBC):
        return _ssm_per_rank(cfg, p, xBC, dt, cache, step, attn_impl)
    s = cfg.ssm
    act, conv_in = _conv(cfg, p, xBC, None if cache is None
                         else cache["conv"], step)
    y, state = _scan(cfg, p, act, dt, None if cache is None
                     else cache["ssm"], step=step, attn_impl=attn_impl)
    if cache is not None:
        if s.conv_width > 1:
            cache["conv"].copy_(conv_in[:, 1 - s.conv_width:])
        cache["ssm"].copy_(state)
    return y


def _ssm_per_rank(cfg: ModelConfig, p: Dict, xBC, dt, cache, step: bool,
                  attn_impl: str):
    """``_ssm`` on ``DTensor``s, as GSPMD partitions the mixer laid out
    over batch, channels and heads: each rank runs the depthwise conv over
    its own batch rows and channels (its conv cache's layout, or xBC's;
    the cache's block written in place), the activation is gathered over
    the channels, and
    each rank scans the heads it holds (as ``A_log`` splits them) with
    their groups, its state's block written in place; y comes back
    sharded by those heads."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import (block_index, per_rank,
                                                  shard_dims)
    s = cfg.ssm
    mesh, dim = xBC.device_mesh, xBC.dim() - 1
    H, G = p["A_log"].shape[0], s.ngroups
    split = shard_dims(p["A_log"], 0)
    # rows and channels as the cache holds them, else as xBC comes
    lead = xBC if cache is None else cache["conv"]
    batch, chans = shard_dims(lead, 0), shard_dims(lead, lead.dim() - 1)
    n = H // math.prod(mesh.size(i) for i in split)
    h0 = block_index(mesh, split) * n
    per_group = H // G
    if n % per_group and per_group % n:
        raise ValueError(f"{n} heads a rank across groups of {per_group}")
    g0 = h0 // per_group
    heads = slice(h0, h0 + n)
    groups = slice(g0, g0 + max(1, n // per_group))
    if cache is not None and (shard_dims(cache["ssm"], 0) != batch
                              or shard_dims(cache["ssm"], 1) != split):
        raise ValueError("the SSM state's cache is not laid out as the "
                         "conv's rows and the mixer's heads")

    def lay(dims):
        """Placements sharding each tensor dim of ``dims`` on its mesh
        dims."""
        out = [Replicate()] * mesh.ndim
        for d, mesh_dims in dims.items():
            for i in mesh_dims:
                out[i] = Shard(d)
        return tuple(out)

    def conv(xl, w, b):
        history = None if cache is None else cache["conv"].to_local()
        act, conv_in = _conv(cfg, {"conv_w": w, "conv_b": b}, xl, history,
                             step)
        if cache is not None and s.conv_width > 1:
            history.copy_(conv_in[:, 1 - s.conv_width:])
        return act
    act = per_rank(conv, mesh, (xBC, p["conv_w"], p["conv_b"]),
                   (lay({0: batch, dim: chans}), lay({1: chans}),
                    lay({0: chans})), lay({0: batch, dim: chans}))
    names = ("dt_bias", "A_log", "D")

    def scan(al, dl, *weights):
        state = None if cache is None else cache["ssm"].to_local()
        y, final = _scan(cfg, dict(zip(names, weights)), al, dl, state,
                         step=step, attn_impl=attn_impl, heads=heads,
                         groups=groups)
        if cache is not None:
            state.copy_(final)
        return y.reshape(*y.shape[:-2], -1)
    return per_rank(scan, mesh, (act, dt, *(p[k] for k in names)),
                    (lay({0: batch}), lay({0: batch}))
                    + ((Replicate(),) * mesh.ndim,) * len(names),
                    lay({0: batch, dim: split}))


def mamba_forward(cfg: ModelConfig, p: Dict, x,
                  cache: Optional[Dict] = None, *,
                  attn_impl: str = "kernel"):
    """Full-sequence (train / prefill) mamba mixer.  x: [B, S, d].
    Returns (y, cache): the cache's conv tail and state written in place,
    or None."""
    d_inner, nheads, conv_dim = _dims(cfg)
    B_, S, _ = x.shape

    proj = einsum_per_rank("bsd,de->bse", x, p["in_proj"])
    z, xBC, dt = torch.split(proj, [d_inner, conv_dim, nheads], dim=-1)
    xBC = shard_act(xBC, "batch", None, "ssm_inner")
    y = _ssm(cfg, p, xBC, dt, cache, False, attn_impl)
    out = _gated_out(p, y.reshape(B_, S, d_inner), z, x.dtype)
    return shard_act(out, "batch", None, "act_embed"), cache


def mamba_decode(cfg: ModelConfig, p: Dict, x, cache: Dict):
    """One-token decode.  x: [B, 1, d].  Returns (y [B,1,d], cache) with
    the cache updated in place."""
    d_inner, nheads, conv_dim = _dims(cfg)
    B_ = x.shape[0]

    proj = einsum_per_rank("bsd,de->bse", x, p["in_proj"])[:, 0]  # [B, e]
    z, xBC, dt = torch.split(proj, [d_inner, conv_dim, nheads], dim=-1)
    y = _ssm(cfg, p, xBC, dt, cache, True)
    out = _gated_out(p, y.reshape(B_, d_inner), z, x.dtype)[:, None, :]
    return out, cache
