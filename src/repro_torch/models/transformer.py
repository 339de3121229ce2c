"""Decoder stack for the dense decoder-only, MoE, VLM-backbone,
attention-free SSM and hybrid families (with gemma2's local/global
alternation, ring caches and post-norms).

The stack is described by a repeating **block pattern** (``block_pattern``
is copied from the JAX package, so both sides name the same blocks):
jamba's is seven Mamba-2 blocks and one attention block, MoE FFNs on every
other one.  As there, parameters and caches are one stacked tree per
pattern position with a leading repeats axis (``[R, ...]``; an attention
position's cache ``[R, B, T, KVH, D]``, a Mamba position's conv and SSM
state ``[R, B, ...]``, so one stack may hold both kinds).
A Python loop over the repeats takes the place of ``lax.scan``; each step
indexes views of the stacked caches, so cache writes land in place, and
takes the stacked parameters apart once per pass (``_unbind``).  With
``remat`` (training) each repeat runs under activation checkpointing, the
twin of the JAX stack's ``jax.checkpoint`` of its scan step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.core import profiler as _prof
from repro_torch.core import spans as _spans
from repro_torch.distributed.sharding import prepend_axis, shard_act
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    mixer: str          # "attn" | "attn_local" | "mamba"
    ffn: str            # "dense" | "moe" | "none"
    window: int = 0     # sliding window for "attn_local" / SWA archs

    @property
    def is_attn(self) -> bool:
        return self.mixer.startswith("attn")


def block_pattern(cfg: ModelConfig) -> List[BlockDesc]:
    """The repeating unit of the layer stack."""
    if cfg.family == Family.SSM:
        return [BlockDesc("mamba", "none")]
    if cfg.local_global_alternating:
        # gemma2: even layers local (sliding window), odd layers global
        return [BlockDesc("attn_local", "dense", cfg.sliding_window),
                BlockDesc("attn", "dense")]
    if cfg.attn_every:  # hybrid (jamba): mamba x (k-1), attn at position k-1
        pat = []
        for j in range(cfg.attn_every):
            mixer = "attn" if j == cfg.attn_every - 1 else "mamba"
            ffn = "dense"
            if cfg.moe is not None and (j % cfg.moe.every) == cfg.moe.every - 1:
                ffn = "moe"
            pat.append(BlockDesc(mixer, ffn))
        return pat
    ffn = "moe" if cfg.moe is not None else "dense"
    window = cfg.sliding_window
    mixer = "attn_local" if window else "attn"
    return [BlockDesc(mixer, ffn, window)]


def num_repeats(cfg: ModelConfig) -> int:
    pat = block_pattern(cfg)
    if cfg.num_layers % len(pat):
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"repeat a pattern of {len(pat)}")
    return cfg.num_layers // len(pat)


def _layer(tree: Dict, r: int) -> Dict:
    """Layer r of a stacked tree: views, so writes reach the stack."""
    return {k: _layer(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _unbind(tree: Dict, R: int) -> List[Dict]:
    """The R layers of a stacked tree, each a dict of views, from one
    ``torch.unbind`` a tensor.  Under autograd its backward stacks the R
    layers' gradients into one tensor, where indexing each layer
    (``_layer``) would allocate a zero tensor of the whole stack for every
    layer's gradient."""
    layers: List[Dict] = [{} for _ in range(R)]
    for k, v in tree.items():
        parts = _unbind(v, R) if isinstance(v, dict) else torch.unbind(v)
        for r in range(R):
            layers[r][k] = parts[r]
    return layers


# ------------------------------------------------------------------- params


def _block_init(cfg: ModelConfig, desc: BlockDesc, gen, R: int,
                device, box: bool = False) -> Dict:
    kw = dict(device=device, lead=(R,), box=box)
    p = {"norm_mixer": L.norm_init(cfg, cfg.d_model, **kw)}
    if desc.mixer == "mamba":
        p["mamba"] = M.mamba_params(cfg, gen, **kw)
    else:
        p["attn"] = L.attention_params(cfg, gen, **kw)
    if desc.ffn != "none":
        p["norm_ffn"] = L.norm_init(cfg, cfg.d_model, **kw)
        if desc.ffn == "moe":
            p["moe"] = MOE.moe_params(cfg, gen, **kw)
        else:
            p["mlp"] = L.mlp_params(cfg, gen, **kw)
    if cfg.use_post_norm:
        p["post_norm_mixer"] = L.norm_init(cfg, cfg.d_model, **kw)
        if desc.ffn != "none":
            p["post_norm_ffn"] = L.norm_init(cfg, cfg.d_model, **kw)
    return p


def stack_init(cfg: ModelConfig, gen, *, device,
               box: bool = False) -> List[Dict]:
    """One stacked (leading dim = repeats) param tree per pattern position;
    boxed, each parameter's axes start with ``"layers"``."""
    R = num_repeats(cfg)
    return [prepend_axis("layers", _block_init(cfg, desc, gen, R, device,
                                               box))
            for desc in block_pattern(cfg)]


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
                     device) -> List[Dict]:
    """One stacked cache per pattern position; a windowed position's is a
    ring of ``min(max_len, window)`` slots."""
    kw = dict(device=device, lead=(num_repeats(cfg),))
    return [M.mamba_cache_init(cfg, batch, **kw) if desc.mixer == "mamba"
            else L.kv_cache_init(cfg, batch, max_len, desc.window, **kw)
            for desc in block_pattern(cfg)]


def stack_cache_axes(cfg: ModelConfig, max_len: int) -> List[Dict]:
    """Logical axes for each cache leaf (leading 'layers' dim)."""
    axes = []
    for desc in block_pattern(cfg):
        if desc.mixer == "mamba":
            a = {k: ("layers",) + v for k, v in M.mamba_cache_axes().items()}
        else:
            is_ring = desc.window > 0 and desc.window < max_len
            kv = ("layers",) + L.kv_cache_axes(is_ring)
            a = {"k": kv, "v": kv}
            if cfg.kv_cache_dtype == "int8":
                a["k_scale"] = kv[:-1]
                a["v_scale"] = kv[:-1]
        axes.append(a)
    return axes


# ------------------------------------------------------------------ forward


def _apply_block(cfg: ModelConfig, desc: BlockDesc, p: Dict, x, *,
                 mode: str, positions=None, lengths=None, cache=None,
                 cos=None, sin=None, attn_impl: str = "kernel",
                 dropless: bool = False, layer: int = 0):
    """mode: 'full' (prefill / teacher-forced) or 'decode'.  Returns (x,
    aux): aux is an MoE block's load-balancing loss, else None.  Decode
    routes one token at a time, dropless, as the reference does.  Inside
    a traced serving step the mixer and the FFN are each a span
    (``core/spans.py``), tagged with ``layer``."""
    aux = None
    sp = None if _prof.ACTIVE is None else _spans.model_span(
        "attention" if desc.mixer != "mamba" else "mamba", layer=layer)
    h = L.apply_norm(cfg, p["norm_mixer"], x)
    if desc.mixer == "mamba":
        if mode == "decode":
            mix, _ = M.mamba_decode(cfg, p["mamba"], h, cache)
        else:
            mix, _ = M.mamba_forward(cfg, p["mamba"], h, cache,
                                     attn_impl=attn_impl)
    elif mode == "decode":
        mix, _ = L.attention_decode(cfg, p["attn"], h, lengths,
                                    window=desc.window, cache=cache,
                                    cos=cos, sin=sin, attn_impl=attn_impl)
    else:
        mix, _ = L.attention_forward(cfg, p["attn"], h, positions,
                                     causal=True, window=desc.window,
                                     cache=cache, cos=cos, sin=sin,
                                     attn_impl=attn_impl)
    if cfg.use_post_norm:
        mix = L.apply_norm(cfg, p["post_norm_mixer"], mix)
    x = x + mix
    if sp is not None:
        sp.close()
    if desc.ffn == "none":
        return x, aux
    sp = None if _prof.ACTIVE is None else _spans.model_span(
        "moe" if desc.ffn == "moe" else "mlp", layer=layer)
    h = L.apply_norm(cfg, p["norm_ffn"], x)
    if desc.ffn == "moe":
        kw = (dict(chunk_size=1, dropless=True) if mode == "decode"
              else dict(dropless=dropless))
        y, aux = MOE.apply_moe(cfg, p["moe"], h, attn_impl=attn_impl, **kw)
    else:
        y = L.apply_mlp(cfg, p["mlp"], h)
    if cfg.use_post_norm:
        y = L.apply_norm(cfg, p["post_norm_ffn"], y)
    x = x + y
    if sp is not None:
        sp.close()
    return x, aux


def stack_forward(cfg: ModelConfig, stacked_params: List[Dict], x, *,
                  positions, caches: Optional[List[Dict]] = None,
                  attn_impl: str = "kernel", dropless: bool = False,
                  remat: bool = False):
    """Full-sequence pass.  x: [B, S, d]; positions [B, S], or [3, B, S]
    under M-RoPE.  Returns (x, caches, aux) — the caches written in place,
    or None; aux the MoE blocks' summed load-balancing loss (fp32 scalar).
    dropless=True routes MoE blocks without overflow (inference).
    remat=True, with grad enabled, runs each repeat of the block pattern
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass, and only the residual stream between
    repeats is kept."""
    pat = block_pattern(cfg)
    R = num_repeats(cfg)
    cos = sin = None
    if not cfg.attention_free:
        cos, sin = L.positional_cos_sin(cfg, positions)
    layers = [_unbind(p, R) for p in stacked_params]

    def step(x, aux, r):
        for j, desc in enumerate(pat):
            c = _layer(caches[j], r) if caches is not None else None
            x, a = _apply_block(cfg, desc, layers[j][r], x, mode="full",
                                positions=positions, cache=c, cos=cos,
                                sin=sin, attn_impl=attn_impl,
                                dropless=dropless, layer=r * len(pat) + j)
            if a is not None:
                aux = aux + a
        # "act_seq" engages Megatron-style sequence parallelism for the
        # residual stream kept between repeats (rules-controlled; off by
        # default)
        return shard_act(x, "batch", "act_seq", "act_embed"), aux

    remat = remat and torch.is_grad_enabled()
    aux = x.new_zeros((), dtype=torch.float32)
    for r in range(R):
        x, aux = (checkpoint(step, x, aux, r, use_reentrant=False) if remat
                  else step(x, aux, r))
    return x, caches, aux


def stack_decode(cfg: ModelConfig, stacked_params: List[Dict], x, *,
                 lengths, caches: List[Dict], attn_impl: str = "kernel"):
    """One-token decode.  x: [B, 1, d].  Returns (x, caches, aux) with the
    caches updated in place."""
    pat = block_pattern(cfg)
    cos = sin = None
    if not cfg.attention_free:
        cos, sin = L.positional_cos_sin(cfg, lengths[:, None])
    aux = x.new_zeros((), dtype=torch.float32)
    for r in range(num_repeats(cfg)):
        for j, desc in enumerate(pat):
            x, a = _apply_block(cfg, desc, _layer(stacked_params[j], r), x,
                                mode="decode", lengths=lengths,
                                cache=_layer(caches[j], r), cos=cos, sin=sin,
                                attn_impl=attn_impl, layer=r * len(pat) + j)
            if a is not None:
                aux = aux + a
    return x, caches, aux
