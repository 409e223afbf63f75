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
from repro_torch.core.types import Bucket
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


# The split of long rows into pieces, as the CUDA kernels run it. The plans
# are host arithmetic, so they are tested here; the kernels on the card are
# held to the plain versions at the same boundaries in tests/test_torch_cuda.py.


@pytest.mark.parametrize("B,P,num_sms", [(5, 131_072, 132), (1, 131_072, 132), (20_391, 512, 132),
                                         (2, 1024, 132), (64, 2048, 1), (3, 40, 132)])
def test_piece_width_spreads_heavy_buckets(B, P, num_sms):
    W = gram_kernel.piece_width(B, P, num_sms)
    assert gram_kernel.MIN_PIECE_RATINGS <= W <= gram_kernel.PIECE_RATINGS
    assert W % 64 == 0  # whole shared-memory tiles
    # the widest piece that gives every SM eight pieces, where there is one
    assert W == gram_kernel.MIN_PIECE_RATINGS or B * -(-P // W) >= 8 * num_sms
    assert W == gram_kernel.PIECE_RATINGS or B * -(-P // (2 * W)) < 8 * num_sms


@pytest.mark.parametrize("W", [256, 2048])
def test_bucket_pieces_cover_each_rating_once(W):
    P = 3 * W + 5
    nnz = np.array([0, W - 1, W, W + 1, P, 2 * W], np.int32)
    item, lo, hi, direct = gram_kernel.bucket_pieces(nnz, P, W)
    for b, n in enumerate(nnz):
        mine = item == b
        ranges = list(zip(lo[mine], hi[mine]))
        assert ranges[0][0] == 0 and ranges[-1][1] == n  # starts at 0, ends at nnz
        assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))  # contiguous, ascending
        assert all(h - l <= W for l, h in ranges) and all(h > l for l, h in ranges[1:])
        assert direct[mine].all() == (n <= W) and direct[mine].any() == (n <= W)
    # nnz = 0, W - 1, W: one piece written directly; W + 1: two; P: four
    assert np.bincount(item).tolist() == [1, 1, 1, 2, 4, 2]
    assert lo.max() < -(-P // W) * W  # every piece lies in the grid


def _layout(seed, cap, shapes, K=4, Ns=30):
    """``ops.flatten_step``'s layout of buckets whose item ids are drawn per bucket."""
    rng = np.random.default_rng(seed)
    buckets = []
    for B, P, dead, nnz, *given in shapes:
        n = rng.integers(0, P + 1, B).astype(np.int32) if nnz is None else np.asarray(nnz, np.int32)
        ids = np.asarray(given[0], np.int32) if given else rng.permutation(cap)[:B].astype(np.int32)
        ids[list(dead)] = -1
        arrays = (ids, rng.integers(0, Ns, (B, P)).astype(np.int32),
                  rng.normal(size=(B, P)).astype(np.float32), n)
        buckets.append(Bucket(*(torch.from_numpy(a) for a in arrays)))
    return ops.flatten_step(tuple(buckets), 128, 8)


# tests/test_gram_fused.py's edge layouts, then a row (item 5) whose 48
# chunks lie in three buckets, with other rows' chunks between them: with 16
# chunks a piece it spans three pieces
PLAN_LAYOUTS = {
    "multibucket": (64, [(16, 8, (), None), (9, 32, (), None), (4, 128, (), None)]),
    "B_not_multiple_of_tb": (24, [(13, 64, (), None)]),
    "all_padding": (16, [(8, 16, (), [0] * 8), (8, 16, (), None)]),
    "item_minus_one": (20, [(10, 32, (0, 3, 9), None)]),
    "multichunk": (16, [(8, 300, (), None)]),
    "three_pieces": (6, [(2, 2048, (), [2048, 100], [5, 0]), (2, 2048, (), [7, 2048], [1, 5]),
                         (3, 2048, (), [50, 2048, 1], [2, 5, 3])]),
}


@pytest.mark.parametrize("name", sorted(PLAN_LAYOUTS))
@pytest.mark.parametrize("max_chunks", [1, 2, 16])
def test_fused_piece_plan(name, max_chunks):
    cap, shapes = PLAN_LAYOUTS[name]
    _, _, item, cnt = _layout(len(name), cap, shapes)
    order = gram_kernel.chunk_order(item, cnt, max_chunks)
    plan = order.pieces
    start, length, p_item, slot = (t.numpy() for t in (plan.start, plan.length, plan.item, plan.slot))
    chunks = order.chunks.numpy()
    assert (length >= 1).all() and (length <= max_chunks).all()
    assert list(length) == sorted(length, reverse=True)  # longest pieces first
    # every live chunk in exactly one piece, and a piece's chunks are its row's
    covered = np.concatenate([chunks[s : s + n] for s, n in zip(start, length)]) if len(start) else []
    live = np.nonzero(((item >= 0) & (cnt > 0)).numpy())[0]
    assert sorted(covered) == sorted(live)
    for s, n, it in zip(start, length, p_item):
        assert (item.numpy()[chunks[s : s + n]] == it).all()
    split = dict(zip(plan.row_item.tolist(), zip(plan.row_start.tolist(), plan.row_len.tolist())))
    for r, it in enumerate(order.item.tolist()):
        mine = np.nonzero(p_item == it)[0]
        if len(mine) == 1:
            assert slot[mine[0]] == -1 and it not in split
            continue
        # a split row's slots are consecutive, and in slot order its pieces
        # walk the row's ascending chunk list from its start
        first, count = split[it]
        by_slot = mine[np.argsort(slot[mine])]
        assert slot[by_slot].tolist() == list(range(first, first + count))
        walked = np.concatenate([chunks[start[q] : start[q] + length[q]] for q in by_slot])
        row = chunks[order.start[r] : order.start[r] + order.length[r]]
        assert np.array_equal(walked, row) and (np.diff(walked) > 0).all()
    assert plan.num_slots == int((slot >= 0).sum())
    if name == "three_pieces" and max_chunks == 16:
        assert split[5][1] == 3 and len(split) == 1
