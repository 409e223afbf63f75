"""The port's CUDA kernel on the card: tests that need a GPU and import no JAX.

Every test here is marked ``cuda`` and skips itself without a CUDA device.
On a GPU machine (which has no JAX) run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They hold the hand-written Gram kernel to its plain version at the shapes of
tests/test_kernels.py and at K in {4, 6}, check that a launch moves
``LAUNCHES`` and not ``PLAIN_CALLS``, and that ``impl="xla"`` refuses a CUDA
tensor instead of quietly replacing the kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.kernels import ops

SHAPES = [
    # (Ns, K, B, P): tests/test_kernels.py's shapes, then the small K the sampler tests use
    (16, 8, 1, 8),
    (64, 32, 13, 70),
    (128, 32, 8, 128),
    (100, 16, 5, 300),
    (256, 64, 4, 512),
    (32, 128, 3, 17),
    (300, 32, 2, 1024),
    (40, 4, 7, 33),
    (40, 6, 7, 33),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, Ns, K, B, P, device):
    """A bucket whose first row is empty (nnz = 0) and whose neighbors repeat."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Ns, K)).astype(np.float32)
    nnz = rng.integers(0, P + 1, B).astype(np.int32)
    nnz[0] = 0
    nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
    val = rng.normal(size=(B, P)).astype(np.float32)
    val[np.arange(P)[None] >= nnz[:, None]] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (X, nbr, val, nnz))


@pytest.mark.cuda
def test_xla_impl_raises_on_cuda_tensor(cuda):
    case = _case(5, 30, 8, 4, 16, cuda)
    with pytest.raises(ValueError, match="CPU"):
        ops.bpmf_gram(*case, impl="xla")


@pytest.mark.cuda
@pytest.mark.parametrize("Ns,K,B,P", SHAPES)
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, Ns, K, B, P, compute_dtype):
    case = _case(Ns + P, Ns, K, B, P, cuda)
    launches, plain = gram_kernel.LAUNCHES, gram_kernel.PLAIN_CALLS
    G, g = ops.bpmf_gram(*case, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert gram_kernel.LAUNCHES == launches + 1
    assert gram_kernel.PLAIN_CALLS == plain
    Gw, gw = gram_kernel.bpmf_gram_plain(*case, compute_dtype)
    # the kernel sums float32 products one by one in p order, the plain
    # version is the correctly rounded sum: the gap of entry (i, j) stays
    # under 16 eps sqrt(P) times sum_p |x_i x_j| <= sqrt(G_ii G_jj)
    tol = 16 * torch.finfo(torch.float32).eps * P**0.5
    d = torch.diagonal(Gw, dim1=1, dim2=2)
    v2 = (case[2].double() ** 2).sum(1, keepdim=True).float()
    assert ((G - Gw).abs() <= tol * (d[:, :, None] * d[:, None, :]).sqrt()).all()
    assert ((g - gw).abs() <= tol * (d * v2).sqrt()).all()
    assert not G[0].any() and not g[0].any()


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic(cuda):
    case = _case(3, 500, 32, 64, 2048, cuda)
    a = ops.bpmf_gram(*case)
    b = ops.bpmf_gram(*case)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
