"""Dispatch of the per-bucket Gram op.

``impl`` takes the JAX package's ``gram_impl`` spellings so that configs
carry over:

  - ``"auto"``, ``"pallas"``, ``"pallas_fused"``: the hand-written kernel
    (:func:`repro_torch.kernels.bpmf_gram.bpmf_gram`), which launches the
    CUDA kernel on a CUDA tensor and takes the plain version on a CPU one.
    ``"pallas_fused"`` names the fused ring-step kernel in the JAX package;
    outside a ring step it means the per-bucket kernel there too;
  - ``"xla"``: the plain PyTorch version. It runs on CPU tensors only and
    raises on a CUDA tensor instead of quietly replacing the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bpmf_gram as gram_kernel

GRAM_IMPLS = ("auto", "pallas_fused", "pallas", "xla")


def bpmf_gram(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-bucket gather+Gram op; returns ``(G [B, K, K], g [B, K])``.

    Raises:
        ValueError: An unknown ``impl``, or ``impl="xla"`` on a CUDA tensor.
    """
    if impl not in GRAM_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {'|'.join(GRAM_IMPLS)}")
    if impl == "xla":
        if X.device.type != "cpu":
            raise ValueError(
                "impl='xla' is the plain PyTorch version, which runs only on CPU "
                f"tensors; on {X.device} use 'auto' (the CUDA kernel)"
            )
        return gram_kernel.bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    return gram_kernel.bpmf_gram(X, nbr, val, nnz, compute_dtype)
