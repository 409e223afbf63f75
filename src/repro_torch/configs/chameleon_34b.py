"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ-VAE image
tokenizer is a STUB per the assignment: images arrive as token ids inside the
shared 65536-entry vocabulary (early fusion = the backbone is a plain decoder
over the fused token stream). Chameleon applies qk-norm for stability.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    d_ff=22016,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    attention="gqa",
    qk_norm=True,
    mlp="swiglu",
    norm="rmsnorm",
    param_dtype="bfloat16",
    remat_group=8,  # the reference's grouping of the residual carries
)
