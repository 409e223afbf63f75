"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000. Tied embeddings,
sqrt(d_model) embedding scaling, GeGLU MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=256000,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    attention="gqa",
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
)
