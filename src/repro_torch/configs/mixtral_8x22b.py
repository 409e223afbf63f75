"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2,
sliding window 4096 (per the assignment). The rolling KV cache bounds
decode memory to the window, which is what makes its ``long_500k`` cell
runnable (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    d_ff=16384,
    vocab_size=32768,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    attention="gqa",
    sliding_window=4096,
    mlp="swiglu",
    norm="rmsnorm",
    num_experts=8,
    num_experts_per_tok=2,
    param_dtype="bfloat16",
    remat_group=7,  # the reference's grouping of the residual carries
)
