"""Mamba2-780M — attention-free SSM (state-space duality / SSD).

[arXiv:2405.21060; unverified] 48L d_model=1536 (attn-free) vocab=50280,
ssm_state=128.  Mamba-2 defaults: expand=2 (d_inner=3072), head_dim P=64
(=> 48 SSD heads), conv width 4, chunked SSD scan.
"""
from repro_torch.configs.base import (Activation, Family, ModelConfig, Norm,
                                      PosEmb, SSMConfig)

CONFIG = ModelConfig(
    name="mamba2-780m",
    family=Family.SSM,
    num_layers=48,
    d_model=1_536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    activation=Activation.SWIGLU,   # unused (no MLP block)
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.NONE,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
    source="arXiv:2405.21060 (unverified tier)",
)
