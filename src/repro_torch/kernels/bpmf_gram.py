"""The per-bucket gather + Gram kernel: a CUDA kernel and its plain PyTorch version.

For a bucket of B items, each with up to P neighbor ids into the opposite
side's factors ``X [Ns, K]``, compute per item::

    G[b] = sum_{p < nnz[b]} x_{nbr[b,p]} x_{nbr[b,p]}^T        [K, K]
    g[b] = sum_{p < nnz[b]} val[b,p] * x_{nbr[b,p]}            [K]

:func:`bpmf_gram` is the port of ``repro/kernels/bpmf_gram.py:
bpmf_gram_pallas``. On a CUDA tensor it launches the hand-written kernel in
``csrc/bpmf_gram.cu`` (the note there says what bounds it and how the
design answers); on a CPU tensor it runs :func:`bpmf_gram_plain`. There is
no other route: a CUDA tensor never falls back to the plain version.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the plain
version, so a run can show which of the two did its work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

LAUNCHES = 0
PLAIN_CALLS = 0

MAX_K = 128  # the kernel keeps at most 33 sums per thread: K (K + 3) / 2 <= 33 * 256


def _round(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and back to float32 (identity for f32)."""
    if compute_dtype == torch.float32:
        return x.to(torch.float32)
    return x.to(compute_dtype).to(torch.float32)


def bpmf_gram_plain(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather once, then one augmented contraction ``Z = Y^T Y`` with ``Y = [Xn | val]``.

    Mirrors ``repro.kernels.ops._bpmf_gram_xla``: the masked ``[B, P, K]``
    neighbor block is built once, ``G = Z[:K, :K]`` and ``g = Z[:K, K]``.
    Inputs are rounded to ``compute_dtype``; the contraction runs in
    float64, where their products are exact, and rounds to float32 once.
    So this is the correctly rounded sum, a yardstick for any float32
    summation order: two float32 orders (the JAX package's and a BLAS
    one) can sit 2e-5 apart at the test shapes, each within 1e-5 of it.
    """
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    P = nbr.shape[1]
    mask = torch.arange(P, device=nbr.device)[None, :] < nnz[:, None]
    Xn = _round(X[nbr.long()], compute_dtype).double() * mask[..., None]
    Y = torch.cat([Xn, _round(val, compute_dtype).double()[..., None]], dim=-1)
    Z = torch.bmm(Y.transpose(1, 2), Y).float()
    return Z[:, :-1, :-1].contiguous(), Z[:, :-1, -1].contiguous()


def _check(X, nbr, val, nnz, compute_dtype) -> None:
    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(f"X must be a float32 [Ns, K] tensor, got {X.dtype} {tuple(X.shape)}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2:
        raise ValueError(f"nbr must be an int32 [B, P] tensor, got {nbr.dtype} {tuple(nbr.shape)}")
    if val.dtype != torch.float32 or val.shape != nbr.shape:
        raise ValueError(f"val must be float32 {tuple(nbr.shape)}, got {val.dtype} {tuple(val.shape)}")
    if nnz.dtype != torch.int32 or nnz.shape != nbr.shape[:1]:
        raise ValueError(f"nnz must be int32 [{nbr.shape[0]}], got {nnz.dtype} {tuple(nnz.shape)}")
    if not 1 <= X.shape[1] <= MAX_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_K}, got K={X.shape[1]}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    for name, t in (("X", X), ("nbr", nbr), ("val", val), ("nnz", nnz)):
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library():
    loaded = load_library("bpmf_gram")
    fn = loaded.lib.bpmf_gram_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        loaded.lib.bpmf_gram_error_string.argtypes = [ctypes.c_int]
        loaded.lib.bpmf_gram_error_string.restype = ctypes.c_char_p
    return loaded.lib


def bpmf_gram(
    X: torch.Tensor,
    nbr: torch.Tensor,
    val: torch.Tensor,
    nnz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(G [B, K, K], g [B, K])`` in float32: the CUDA kernel, or the plain version on CPU.

    Raises:
        ValueError: Wrong dtypes, shapes, devices, non-contiguous inputs or
            K outside ``[1, 128]`` (CUDA tensors).
        RuntimeError: The kernel failed to build or to launch.
    """
    if X.device.type == "cpu":
        return bpmf_gram_plain(X, nbr, val, nnz, compute_dtype)
    if X.device.type != "cuda":
        raise ValueError(f"bpmf_gram runs on CPU or CUDA tensors, got {X.device}")
    _check(X, nbr, val, nnz, compute_dtype)
    B, P = nbr.shape
    Ns, K = X.shape
    G = torch.empty(B, K, K, dtype=torch.float32, device=X.device)
    g = torch.empty(B, K, dtype=torch.float32, device=X.device)
    if B == 0:
        return G, g
    lib = _library()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.bpmf_gram_launch(
        X.data_ptr(), nbr.data_ptr(), val.data_ptr(), nnz.data_ptr(),
        G.data_ptr(), g.data_ptr(), B, P, Ns, K,
        int(compute_dtype == torch.bfloat16), stream,
    )
    if err:
        msg = lib.bpmf_gram_error_string(err).decode()
        raise RuntimeError(f"bpmf_gram kernel launch failed: {msg} (cuda error {err})")
    global LAUNCHES
    LAUNCHES += 1
    return G, g
