"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652; hf:01-ai/Yi-6B].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, SwiGLU, RMSNorm,
rope_theta=5e6 (Yi's long-context base).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    attention="gqa",
    rope_theta=5_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
)
