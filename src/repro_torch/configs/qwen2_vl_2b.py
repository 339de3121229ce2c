"""Qwen2-VL-2B — VLM; transformer BACKBONE only (vision frontend is a stub).

[arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct] 28L d_model=1536 12H
(GQA kv=2) d_ff=8960 vocab=151936.  M-RoPE (multimodal rotary: temporal /
height / width position triplets), SwiGLU, RMSNorm, tied embeddings.

Per the assignment, the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings alongside token ids.
"""
from repro_torch.configs.base import Activation, Family, ModelConfig, Norm, PosEmb

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=Family.VLM,
    num_layers=28,
    d_model=1_536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8_960,
    vocab_size=151_936,
    activation=Activation.SWIGLU,
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.MROPE,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend_stub=True,
    max_position_embeddings=32_768,
    source="arXiv:2409.12191 (hf tier)",
)
