"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
GELU expert MLPs, logit softcap 30 (grok caps attention+output logits; we
apply the output cap).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    d_ff=32768,
    vocab_size=131072,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    attention="gqa",
    mlp="gelu",
    norm="rmsnorm",
    num_experts=8,
    num_experts_per_tok=2,
    logits_softcap=30.0,
    param_dtype="bfloat16",
    remat_group=8,  # the reference's grouping of the residual carries
)
