"""Gemma-2-2B — dense GQA with alternating local/global attention + softcaps.

[arXiv:2408.00118; hf:google/gemma-2-2b] 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000.  Even layers use sliding-window (4096) local
attention, odd layers use full global attention; attention-logit softcap 50,
final-logit softcap 30; GeGLU MLP; RMSNorm; head_dim=256 (so q_dim=2048 !=
d_model, per the published config); query scale 1/sqrt(256); tied embeddings.
"""
from repro_torch.configs.base import Activation, Family, ModelConfig, Norm, PosEmb

CONFIG = ModelConfig(
    name="gemma2-2b",
    family=Family.DENSE,
    num_layers=26,
    d_model=2_304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9_216,
    vocab_size=256_000,
    activation=Activation.GEGLU,
    norm=Norm.RMSNORM,
    pos_emb=PosEmb.ROPE,
    rope_theta=10_000.0,
    sliding_window=4_096,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
    use_post_norm=True,
    scale_embedding=True,
    max_position_embeddings=8_192,
    source="arXiv:2408.00118 (hf tier)",
)
