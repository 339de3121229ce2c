"""SeamlessM4T-Medium — encoder-decoder multimodal (audio frontend stubbed).

[arXiv:2308.11596; hf:facebook/seamless-m4t-medium] 12L d_model=1024 16H
(kv=16 => MHA) d_ff=4096 vocab=256206.  Conformer speech encoder is the
modality frontend — STUBBED per the assignment (``input_specs()`` provides
precomputed frame embeddings).  We model the text backbone: 12 encoder layers
over frame embeddings + 12 decoder layers with self- and cross-attention.
"""
from repro_torch.configs.base import Activation, Family, ModelConfig, Norm, PosEmb

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family=Family.AUDIO,
    num_layers=12,                # decoder layers
    encoder_layers=12,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=256_206,
    activation=Activation.GELU,
    norm=Norm.LAYERNORM,
    pos_emb=PosEmb.LEARNED,
    tie_embeddings=True,
    scale_embedding=True,
    frontend_stub=True,
    max_position_embeddings=4_096,
    source="arXiv:2308.11596 (hf tier)",
)
