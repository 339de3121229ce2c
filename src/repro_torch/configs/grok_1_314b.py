"""Grok-1 (314B) — MoE transformer, 8 experts top-2.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2.  GELU-gated MLP in the release; attention-logit
softcap 30 in the public implementation; RoPE.
"""
from repro_torch.configs.base import (Activation, Family, ModelConfig, MoEConfig,
                                Norm, PosEmb)

CONFIG = ModelConfig(
    name="grok-1-314b",
    family=Family.MOE,
    num_layers=64,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    activation=Activation.GEGLU,
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.ROPE,
    rope_theta=10_000.0,
    attn_logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    max_position_embeddings=8_192,
    kv_cache_dtype="int8",
    source="hf:xai-org/grok-1 (unverified tier)",
)
