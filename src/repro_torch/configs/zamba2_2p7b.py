"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attn blocks [arXiv:2411.15242].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64. One
shared transformer block applied every 6 mamba layers (9 applications, each
with its own KV cache). d_inner=5120, ssm head_dim=64 -> 80 SSD heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    attention="gqa",
    mlp="geglu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    shared_attn_every=6,
    tie_embeddings=True,
)
