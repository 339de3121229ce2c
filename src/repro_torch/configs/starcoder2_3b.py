"""StarCoder2-3B — dense GQA transformer.

[arXiv:2402.19173; hf:bigcode/starcoder2-3b] 30L d_model=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152.  GELU MLP (non-gated), RoPE, LayerNorm, sliding-window
4096 attention in the published model.
"""
from repro_torch.configs.base import Activation, Family, ModelConfig, Norm, PosEmb

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family=Family.DENSE,
    num_layers=30,
    d_model=3_072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    vocab_size=49_152,
    activation=Activation.GELU,
    norm=Norm.LAYERNORM,
    pos_emb=PosEmb.ROPE,
    rope_theta=999_999.4420358813,
    sliding_window=4_096,
    tie_embeddings=True,
    max_position_embeddings=16_384,
    source="arXiv:2402.19173 (hf tier)",
)
