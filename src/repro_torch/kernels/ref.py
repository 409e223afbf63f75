"""Plain PyTorch oracles for every kernel in this package."""
from __future__ import annotations

import torch


def bpmf_gram_ref(
    X: torch.Tensor,  # [Ns, K] opposite-side latents
    nbr: torch.Tensor,  # [B, P] int32 padded neighbor indices into X
    val: torch.Tensor,  # [B, P] f32 centered ratings (0 in padding)
    nnz: torch.Tensor,  # [B] int32 true neighbor counts
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """G[b] = sum_p x_{nbr[b,p]} x^T (masked), g[b] = sum_p x_{nbr[b,p]} val[b,p].

    Inputs are rounded to ``compute_dtype``; products are summed in float64
    (where they are exact) and rounded to float32 once.
    """
    P = nbr.shape[1]
    mask = torch.arange(P, device=nbr.device)[None, :] < nnz[:, None]
    Xn = X[nbr.long()].to(compute_dtype).double() * mask[..., None]
    v = val.to(compute_dtype).double()
    G = torch.einsum("bpk,bpl->bkl", Xn, Xn)
    g = torch.einsum("bpk,bp->bk", Xn, v)
    return G.float(), g.float()
