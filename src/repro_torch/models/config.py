"""Model configuration covering every assigned architecture family.

The counterpart of ``repro.models.config``: one dataclass describes dense /
MoE / SSM / hybrid / encoder LMs, with every field and default of the
reference's; the per-arch files in ``repro_torch/configs`` instantiate it
with the published numbers. ``reduced()`` produces the family-preserving
smoke-test config. Only ``dtype`` differs: it returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: shapes, attention, MLP, numerics and remat policy."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    # attention
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    attention: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    # mlp
    mlp: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    shared_attn_every: int = 0
    # encoder (hubert)
    is_encoder: bool = False
    mask_prob: float = 0.08  # masked-prediction corruption rate
    # embeddings / head
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma: x *= sqrt(d_model)
    logits_softcap: float = 0.0
    # input frontend: tokens, or precomputed frame/patch embeddings (stub)
    input_mode: str = "tokens"  # tokens | frames
    frame_dim: int = 0
    # attention chunking (flash-style two-level scan; memory-bounds long seqs)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    # the reference's sequence-parallel prefill over a mesh; kept as a field,
    # with no effect on one device (the q blocks run in turn)
    flash_q_parallel: bool = False
    # embeddings pad to this multiple (the padded tail is masked in the head)
    vocab_pad_multiple: int = 128
    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    # remat: "full" = recompute the whole block in bwd (Megatron-style full
    # activation recomputation); "block" saves matmul outputs; "none" saves all.
    remat: str = "full"
    # >1: checkpoint GROUPS of layers so only L/group residual carries are
    # saved (each layer checkpointed again inside its group). Must divide
    # num_layers.
    remat_group: int = 1
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def uses_attention(self) -> bool:
        return self.attention != "none" or self.shared_attn_every > 0

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.uses_ssm else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """Whether a 500k-token decode is deployable (bounded per-token state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder

    def dtype(self, kind: str) -> torch.dtype:
        """The ``torch.dtype`` of ``kind``: ``"param"`` or ``"act"`` (activations)."""
        name = {"param": self.param_dtype, "act": self.activation_dtype}[kind]
        return _DTYPES[name]

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        small: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 4 if self.shared_attn_every == 0 else 2 * self.shared_attn_every),
            d_model=128,
            d_ff=256 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
        )
        if self.uses_attention:
            small.update(num_heads=4, num_kv_heads=max(1, min(self.num_kv_heads, 4) if self.num_heads != self.num_kv_heads else 4), head_dim=32)
            if self.num_kv_heads == self.num_heads:
                small["num_kv_heads"] = 4
            elif self.num_kv_heads == 1:
                small["num_kv_heads"] = 1
            else:
                small["num_kv_heads"] = 2
        if self.attention == "mla":
            small.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=16, v_head_dim=32, head_dim=32)
        if self.num_experts:
            small.update(num_experts=4)
        if self.uses_ssm:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.sliding_window is not None:
            small = {**small, "sliding_window": 64}
        if self.input_mode == "frames":
            small["frame_dim"] = 128
        return dataclasses.replace(self, **small, name=self.name + "-smoke")

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
