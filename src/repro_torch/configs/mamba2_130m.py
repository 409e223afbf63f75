"""mamba2-130m [ssm] — SSD state-space duality [arXiv:2405.21060].

24L d_model=768, attention-free, vocab=50280, ssm_state=128. d_inner=1536,
head_dim=64 -> 24 SSD heads, 1 B/C group. O(1)-per-token decode state makes
every long-context shape runnable.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    norm="rmsnorm",
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)
