"""The port's Gram op on the CPU against the JAX kernel and both oracles.

On the CPU the port's op takes its plain PyTorch version; it is held to the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py runs
it) and to both packages' oracles, with that file's bands: 1e-5 in f32 on
its SHAPES, 5e-2 in bf16. The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py, which imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.kernels import ops, ref

SHAPES = [
    # (Ns, K, B, P), the shapes of tests/test_kernels.py
    (16, 8, 1, 8),
    (64, 32, 13, 70),
    (128, 32, 8, 128),
    (100, 16, 5, 300),
    (256, 64, 4, 512),
    (32, 128, 3, 17),
    (300, 32, 2, 1024),
]


def _case(seed, Ns, K, B, P, empty_rows=0, duplicates=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(Ns, K)).astype(np.float32)
    nnz = rng.integers(0, P + 1, B).astype(np.int32)
    nnz[:empty_rows] = 0
    nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
    if duplicates:
        nbr[:, 1::2] = nbr[:, ::2][:, : nbr[:, 1::2].shape[1]]
    val = rng.normal(size=(B, P)).astype(np.float32)
    val[np.arange(P)[None] >= nnz[:, None]] = 0.0
    return X, nbr, val, nnz


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("Ns,K,B,P", SHAPES)
def test_plain_gram_matches_jax_kernel_and_refs(Ns, K, B, P):
    case = _case(Ns * 1000 + K * 100 + B * 10 + P, Ns, K, B, P)
    jk = jops.bpmf_gram(*_jax(*case), force_pallas=True)
    jr = jref.bpmf_gram_ref(*_jax(*case))
    plain = gram_kernel.bpmf_gram_plain(*_torch(*case))
    dispatched = ops.bpmf_gram(*_torch(*case))
    oracle = ref.bpmf_gram_ref(*_torch(*case))
    for got in (plain, dispatched, oracle):
        _close(got, jk, 1e-5)
        _close(got, jr, 1e-5)


@pytest.mark.parametrize(
    "compute_dtype,jax_dtype,tol",
    [(torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 5e-2)],
)
def test_plain_gram_dtypes(compute_dtype, jax_dtype, tol):
    case = _case(7, 64, 32, 9, 96)
    jk = jops.bpmf_gram(*_jax(*case), compute_dtype=jax_dtype, force_pallas=True)
    jr = jref.bpmf_gram_ref(*_jax(*case), compute_dtype=jax_dtype)
    got = ops.bpmf_gram(*_torch(*case), compute_dtype=compute_dtype)
    _close(got, jk, tol)
    _close(got, jr, tol)
    _close(ref.bpmf_gram_ref(*_torch(*case), compute_dtype=compute_dtype), jr, tol)


@pytest.mark.parametrize("K", [4, 6, 8])
def test_plain_gram_empty_rows_and_duplicate_neighbors(K):
    """nnz = 0 rows give exact zeros; repeated neighbors count once per slot."""
    case = _case(100 + K, 20, K, 6, 40, empty_rows=2, duplicates=True)
    G, g = ops.bpmf_gram(*_torch(*case))
    assert not G[:2].any() and not g[:2].any()
    _close((G, g), jops.bpmf_gram(*_jax(*case), force_pallas=True), 1e-5)
    _close((G, g), jref.bpmf_gram_ref(*_jax(*case)), 1e-5)


def test_gram_impls_on_cpu_count_plain_calls():
    """Every impl spelling takes the plain version on a CPU tensor; none launches."""
    case = _torch(*_case(5, 30, 8, 4, 16))
    want = gram_kernel.bpmf_gram_plain(*case)
    launches, plain = gram_kernel.LAUNCHES, gram_kernel.PLAIN_CALLS
    for impl in ops.GRAM_IMPLS:
        _close(ops.bpmf_gram(*case, impl=impl), want, 0.0)
    assert gram_kernel.LAUNCHES == launches
    assert gram_kernel.PLAIN_CALLS == plain + len(ops.GRAM_IMPLS)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.bpmf_gram(*case, impl="triton")
