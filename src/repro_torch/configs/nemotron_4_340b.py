"""Nemotron-4-340B — dense GQA transformer with squared-ReLU MLP.

[arXiv:2402.16819; unverified] 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  Nemotron-4 uses squared-ReLU activations (non-gated MLP) and
RoPE; no tied embeddings.
"""
from repro_torch.configs.base import Activation, Family, ModelConfig, Norm, PosEmb

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family=Family.DENSE,
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,                 # 18432 / 96
    d_ff=73_728,
    vocab_size=256_000,
    activation=Activation.SQUARED_RELU,
    norm=Norm.LAYERNORM,          # Nemotron-4 uses LayerNorm
    pos_emb=PosEmb.ROPE,
    rope_theta=10_000.0,
    max_position_embeddings=4_096,
    kv_cache_dtype="int8",        # 96L x 32k x 128batch KV would exceed HBM in bf16
    source="arXiv:2402.16819 (unverified tier)",
)
