"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000. The reference
sizes it for a pod of many devices with bf16 params and moments; here it
builds and runs only reduced (one card holds none of it).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    d_ff=73728,
    vocab_size=256000,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    attention="gqa",
    mlp="relu2",
    norm="layernorm",
    param_dtype="bfloat16",
    remat_group=8,  # the reference's grouping of the residual carries
)
