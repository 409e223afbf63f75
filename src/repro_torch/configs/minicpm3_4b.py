"""minicpm3-4b [dense] — MLA latent attention [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448. Multi-head Latent Attention:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head_dim=64.
The decode cache stores only [ckv|k_pe] = 288 floats/token — 13x smaller
than the equivalent GQA cache, which is why its decode shapes are the
memory-lightest of the dense archs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    d_ff=6400,
    vocab_size=73448,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
)
