"""Encoder-decoder backbone (SeamlessM4T text/audio).  The conformer speech
frontend is a stub, as in the JAX package: inputs arrive as precomputed
frame embeddings [B, S_enc, d_model].

The twin of ``repro/models/encdec.py``.  Parameters are stacked as there,
one dict per side with a leading layers axis; a Python loop over the layers
takes the place of ``lax.scan``.  One difference: the JAX
``decode_forward`` recomputes each layer's cross K/V from the encoder's
output inside its scan, the same product ``build_cross_cache`` takes; here
``decode_forward`` takes that cache, so a prefill projects the encoder's
output once for its cross-attention and for the cache it keeps.  In
training the cross K/V are so kept outside the decoder's checkpointed
layers (remat): at seamless-m4t-medium's training shape, 4 x 2048 fp32
frames, they hold 12 layers x 2 x 4 x 2048 x 16 x 64 x 4 bytes = 805 MB
until the backward pass, where the reference recomputes them in each
layer from the encoder's 34 MB output.

fp32 frames (``training/data.py``'s batches) run the whole encoder in
fp32 against bf16 weights, as the JAX twin's type promotion does: the
position table is added in the frames' dtype, each product widens its
weight (``layers.project``), and the attention runs in fp32.  The
decoder stays bf16; its cross-attention over the encoder's fp32 K/V is
one fp32 call on an exact upcast of q (``layers.widened``).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import prepend_axis, shard_act
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer, _unbind

# Decoder positions must cover the assigned decode_32k shape even though the
# published model caps at 4096 (the JAX package's deviation note).
POS_TABLE_LEN = 32_768


def _enc_block_init(cfg: ModelConfig, gen, *, device, lead, box) -> Dict:
    kw = dict(device=device, lead=lead, box=box)
    return {
        "norm_attn": L.norm_init(cfg, cfg.d_model, **kw),
        "attn": L.attention_params(cfg, gen, **kw),
        "norm_ffn": L.norm_init(cfg, cfg.d_model, **kw),
        "mlp": L.mlp_params(cfg, gen, **kw),
    }


def _dec_block_init(cfg: ModelConfig, gen, *, device, lead, box) -> Dict:
    kw = dict(device=device, lead=lead, box=box)
    return {
        "norm_self": L.norm_init(cfg, cfg.d_model, **kw),
        "self_attn": L.attention_params(cfg, gen, **kw),
        "norm_cross": L.norm_init(cfg, cfg.d_model, **kw),
        "cross_attn": L.attention_params(cfg, gen, **kw),
        "norm_ffn": L.norm_init(cfg, cfg.d_model, **kw),
        "mlp": L.mlp_params(cfg, gen, **kw),
    }


def encdec_init(cfg: ModelConfig, gen, *, device, box: bool = False) -> Dict:
    table, table_axes = (POS_TABLE_LEN, cfg.d_model), (None, "embed")
    kw = dict(device=device, box=box)
    return {
        "enc_blocks": prepend_axis("layers", _enc_block_init(
            cfg, gen, lead=(cfg.encoder_layers,), **kw)),
        "dec_blocks": prepend_axis("layers", _dec_block_init(
            cfg, gen, lead=(cfg.num_layers,), **kw)),
        "pos_enc": L.embed_param(gen, table, table_axes, **kw),
        "pos_dec": L.embed_param(gen, table, table_axes, **kw),
        "norm_enc_final": L.norm_init(cfg, cfg.d_model, **kw),
        "norm_dec_final": L.norm_init(cfg, cfg.d_model, **kw),
    }


def _layers(step, x, n: int, remat: bool):
    """x through ``step(x, r)`` for r < n, each layer under activation
    checkpointing when ``remat`` and grad are on (the twin of
    ``jax.checkpoint`` of the JAX twin's scan step)."""
    remat = remat and torch.is_grad_enabled()
    for r in range(n):
        x = (checkpoint(step, x, r, use_reentrant=False) if remat
             else step(x, r))
    return x


def encode(cfg: ModelConfig, params: Dict, src_embeds, *,
           attn_impl: str = "kernel", remat: bool = False):
    """Bidirectional encoder over frame embeddings.  [B, S, d] -> [B, S, d]
    in the frames' dtype: bf16 frames run in bf16, fp32 frames promote the
    whole encoder to fp32 against the bf16 weights (the module
    docstring)."""
    S = src_embeds.shape[1]
    x = src_embeds + params["pos_enc"][:S][None].to(src_embeds.dtype)
    blocks = _unbind(params["enc_blocks"], cfg.encoder_layers)

    def step(x, r):
        p = blocks[r]
        h = L.apply_norm(cfg, p["norm_attn"], x)
        mix, _ = L.attention_forward(cfg, p["attn"], h, None, causal=False,
                                     attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
        return shard_act(x, "batch", "act_seq", "act_embed")

    x = _layers(step, x, cfg.encoder_layers, remat)
    return L.apply_norm(cfg, params["norm_enc_final"], x)


def build_cross_cache(cfg: ModelConfig, params: Dict, enc_out) -> Dict:
    """Per-decoder-layer cross-attention K/V from the encoder's output:
    ``cross_k``/``cross_v`` [L, B, T_enc, KVH, D], in the promoted dtype
    of the output and the weights (fp32 over an fp32 encoder)."""
    blocks = _unbind(params["dec_blocks"], cfg.num_layers)
    ks, vs = zip(*(L.cross_kv(cfg, p["cross_attn"], enc_out)
                   for p in blocks))
    return {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def decode_forward(cfg: ModelConfig, params: Dict, x, cross: Dict, *,
                   positions, self_caches=None, attn_impl: str = "kernel",
                   remat: bool = False):
    """Teacher-forced decoder pass.  x: [B, S_dec, d] (already embedded and
    positioned); ``cross``: ``build_cross_cache``'s K/V.  Returns (x,
    self_caches), the caches written in place, or None.  remat
    checkpoints each layer (training, no caches)."""
    blocks = _unbind(params["dec_blocks"], cfg.num_layers)
    cross_k, cross_v = cross["cross_k"].unbind(0), cross["cross_v"].unbind(0)

    def step(x, r):
        p = blocks[r]
        cache = _layer(self_caches, r) if self_caches is not None else None
        h = L.apply_norm(cfg, p["norm_self"], x)
        mix, _ = L.attention_forward(cfg, p["self_attn"], h, positions,
                                     causal=True, cache=cache,
                                     attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_cross"], x)
        x = x + L.cross_attention_forward(cfg, p["cross_attn"], h,
                                          cross_k[r], cross_v[r],
                                          attn_impl=attn_impl)
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
        return shard_act(x, "batch", "act_seq", "act_embed")

    x = _layers(step, x, cfg.num_layers, remat)
    return L.apply_norm(cfg, params["norm_dec_final"], x), self_caches


def decode_step(cfg: ModelConfig, params: Dict, x, *, lengths, self_caches,
                cross_cache, attn_impl: str = "kernel"):
    """One decoder token.  x: [B, 1, d] (embedded and positioned).  Returns
    (x, self_caches), the caches updated in place.  The cross-attention
    attends one token over the whole cross cache, every length its
    capacity: on the kernel path the paged kernel, as the self-attention.
    Its scale is 1/sqrt(head_dim), as in the JAX twin, which does not read
    ``attn_scale_override`` here (the prefill's cross-attention does).  An
    fp32 cross cache (a prefill over fp32 frames) is attended in fp32, the
    output in the decoder's dtype, as the JAX twin's promotion does."""
    B = x.shape[0]
    for r in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], r)
        h = L.apply_norm(cfg, p["norm_self"], x)
        mix, _ = L.attention_decode(cfg, p["self_attn"], h, lengths,
                                    cache=_layer(self_caches, r),
                                    attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_cross"], x)
        q = L.project("bsd,dhk->bshk", h, p["cross_attn"]["wq"])
        ck, cv = cross_cache["cross_k"][r], cross_cache["cross_v"][r]
        kw = dict(scale=1.0 / (cfg.head_dim ** 0.5),
                  lengths=torch.full((B,), ck.shape[1], dtype=torch.int32,
                                     device=x.device))
        attend = L.decode_attention if attn_impl == "plain" \
            else L.paged_decode_attention
        o = L.widened(attend, q, ck, cv, **kw)
        x = x + L.project("bshk,hkd->bsd", o, p["cross_attn"]["wo"])
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
    return L.apply_norm(cfg, params["norm_dec_final"], x), self_caches
