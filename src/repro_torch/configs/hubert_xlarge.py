"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-prediction
codebook). The conv waveform frontend is a STUB per the assignment:
``input_specs`` feeds precomputed 512-dim frame embeddings; the backbone
projects them to d_model. Bidirectional attention, no decode shapes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    attention="gqa",
    causal=False,
    is_encoder=True,
    mlp="gelu",
    norm="layernorm",
    input_mode="frames",
    frame_dim=512,
)
