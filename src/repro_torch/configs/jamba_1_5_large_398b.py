"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 7:1 interleave with MoE.

[arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large] 72L d_model=8192 64H
(GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.  One attention layer per 8
blocks (1:7 attn:mamba), MoE every other layer; Mamba mixer state 128.

Deviation note (DESIGN.md §Arch-applicability): Jamba's published mixer is
Mamba-1; we use our Mamba-2 SSD mixer with matched state/width so the hybrid
cache/compute structure (the part the paper's scheduler sees) is equivalent.
"""
from repro_torch.configs.base import (Activation, Family, ModelConfig, MoEConfig,
                                Norm, PosEmb, SSMConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family=Family.HYBRID,
    num_layers=72,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    activation=Activation.SWIGLU,
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.NONE,          # Jamba uses no positional embeddings
    attn_every=8,                 # 1 attention layer per 8 blocks
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25, every=2),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
    max_position_embeddings=262_144,
    kv_cache_dtype="int8",
    source="arXiv:2403.19887 (hf tier)",
)
