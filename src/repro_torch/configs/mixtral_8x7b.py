"""Mixtral-8x7B — MoE transformer, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x7B-v0.1] 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA window 4096 (v0.1).
SwiGLU experts, RMSNorm, RoPE theta 1e6.
"""
from repro_torch.configs.base import (Activation, Family, ModelConfig, MoEConfig,
                                Norm, PosEmb)

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family=Family.MOE,
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    activation=Activation.SWIGLU,
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.ROPE,
    rope_theta=1_000_000.0,
    sliding_window=4_096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    max_position_embeddings=32_768,
    source="arXiv:2401.04088 (hf tier)",
)
