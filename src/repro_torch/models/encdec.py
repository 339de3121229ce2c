"""Encoder-decoder backbone (SeamlessM4T text/audio).  The conformer speech
frontend is a stub, as in the JAX package: inputs arrive as precomputed
frame embeddings [B, S_enc, d_model].

The twin of ``repro/models/encdec.py``.  Parameters are stacked as there,
one dict per side with a leading layers axis; a Python loop over the layers
takes the place of ``lax.scan``.  One difference: the JAX
``decode_forward`` recomputes each layer's cross K/V from the encoder's
output inside its scan, the same product ``build_cross_cache`` takes; here
``decode_forward`` takes that cache, so a prefill projects the encoder's
output once for its cross-attention and for the cache it keeps.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _layer

# Decoder positions must cover the assigned decode_32k shape even though the
# published model caps at 4096 (the JAX package's deviation note).
POS_TABLE_LEN = 32_768


def _enc_block_init(cfg: ModelConfig, gen, *, device, lead) -> Dict:
    kw = dict(device=device, lead=lead)
    return {
        "norm_attn": L.norm_init(cfg, cfg.d_model, **kw),
        "attn": L.attention_params(cfg, gen, **kw),
        "norm_ffn": L.norm_init(cfg, cfg.d_model, **kw),
        "mlp": L.mlp_params(cfg, gen, **kw),
    }


def _dec_block_init(cfg: ModelConfig, gen, *, device, lead) -> Dict:
    kw = dict(device=device, lead=lead)
    return {
        "norm_self": L.norm_init(cfg, cfg.d_model, **kw),
        "self_attn": L.attention_params(cfg, gen, **kw),
        "norm_cross": L.norm_init(cfg, cfg.d_model, **kw),
        "cross_attn": L.attention_params(cfg, gen, **kw),
        "norm_ffn": L.norm_init(cfg, cfg.d_model, **kw),
        "mlp": L.mlp_params(cfg, gen, **kw),
    }


def encdec_init(cfg: ModelConfig, gen, *, device) -> Dict:
    table = (POS_TABLE_LEN, cfg.d_model)
    return {
        "enc_blocks": _enc_block_init(cfg, gen, device=device,
                                      lead=(cfg.encoder_layers,)),
        "dec_blocks": _dec_block_init(cfg, gen, device=device,
                                      lead=(cfg.num_layers,)),
        "pos_enc": L.embed_param(gen, table, device=device),
        "pos_dec": L.embed_param(gen, table, device=device),
        "norm_enc_final": L.norm_init(cfg, cfg.d_model, device=device),
        "norm_dec_final": L.norm_init(cfg, cfg.d_model, device=device),
    }


def encode(cfg: ModelConfig, params: Dict, src_embeds, *,
           attn_impl: str = "kernel"):
    """Bidirectional encoder over frame embeddings.  [B, S, d] -> [B, S, d].

    ``src_embeds`` must have the weights' dtype (bf16 for a model from
    ``Model.init``).  The JAX twin adds the position table in the inputs'
    own dtype, so fp32 frames against bf16 weights promote its whole
    encoder to fp32; ``torch.einsum`` takes no mixed dtypes, and that path
    is not ported."""
    if src_embeds.dtype != params["pos_enc"].dtype:
        raise ValueError(
            f"encode: src_embeds are {src_embeds.dtype} and the encoder's "
            f"weights {params['pos_enc'].dtype}; pass them in the weights' "
            f"dtype (the JAX package's fp32 promotion is not ported: "
            f"ROADMAP.md queue 1, item 10)")
    S = src_embeds.shape[1]
    x = src_embeds + params["pos_enc"][:S][None]
    for r in range(cfg.encoder_layers):
        p = _layer(params["enc_blocks"], r)
        h = L.apply_norm(cfg, p["norm_attn"], x)
        mix, _ = L.attention_forward(cfg, p["attn"], h, None, causal=False,
                                     attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
    return L.apply_norm(cfg, params["norm_enc_final"], x)


def build_cross_cache(cfg: ModelConfig, params: Dict, enc_out) -> Dict:
    """Per-decoder-layer cross-attention K/V from the encoder's output:
    ``cross_k``/``cross_v`` [L, B, T_enc, KVH, D]."""
    ks, vs = zip(*(L.cross_kv(cfg, _layer(params["dec_blocks"], r)
                              ["cross_attn"], enc_out)
                   for r in range(cfg.num_layers)))
    return {"cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def decode_forward(cfg: ModelConfig, params: Dict, x, cross: Dict, *,
                   positions, self_caches=None, attn_impl: str = "kernel"):
    """Teacher-forced decoder pass.  x: [B, S_dec, d] (already embedded and
    positioned); ``cross``: ``build_cross_cache``'s K/V.  Returns (x,
    self_caches), the caches written in place, or None."""
    for r in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], r)
        cache = _layer(self_caches, r) if self_caches is not None else None
        h = L.apply_norm(cfg, p["norm_self"], x)
        mix, _ = L.attention_forward(cfg, p["self_attn"], h, positions,
                                     causal=True, cache=cache,
                                     attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_cross"], x)
        x = x + L.cross_attention_forward(
            cfg, p["cross_attn"], h, cross["cross_k"][r], cross["cross_v"][r],
            attn_impl=attn_impl)
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
    return L.apply_norm(cfg, params["norm_dec_final"], x), self_caches


def decode_step(cfg: ModelConfig, params: Dict, x, *, lengths, self_caches,
                cross_cache, attn_impl: str = "kernel"):
    """One decoder token.  x: [B, 1, d] (embedded and positioned).  Returns
    (x, self_caches), the caches updated in place.  The cross-attention
    attends one token over the whole cross cache, every length its
    capacity: on the kernel path the paged kernel, as the self-attention.
    Its scale is 1/sqrt(head_dim), as in the JAX twin, which does not read
    ``attn_scale_override`` here (the prefill's cross-attention does)."""
    B = x.shape[0]
    for r in range(cfg.num_layers):
        p = _layer(params["dec_blocks"], r)
        h = L.apply_norm(cfg, p["norm_self"], x)
        mix, _ = L.attention_decode(cfg, p["self_attn"], h, lengths,
                                    cache=_layer(self_caches, r),
                                    attn_impl=attn_impl)
        x = x + mix
        h = L.apply_norm(cfg, p["norm_cross"], x)
        q = torch.einsum("bsd,dhk->bshk", h, p["cross_attn"]["wq"])
        ck, cv = cross_cache["cross_k"][r], cross_cache["cross_v"][r]
        kw = dict(scale=1.0 / (cfg.head_dim ** 0.5),
                  lengths=torch.full((B,), ck.shape[1], dtype=torch.int32,
                                     device=x.device))
        if attn_impl == "plain":
            o = L.decode_attention(q, ck, cv, **kw)
        else:
            o = L.paged_decode_attention(q, ck, cv, **kw)
        x = x + torch.einsum("bshk,hkd->bsd", o, p["cross_attn"]["wo"])
        h = L.apply_norm(cfg, p["norm_ffn"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h)
    return L.apply_norm(cfg, params["norm_dec_final"], x), self_caches
