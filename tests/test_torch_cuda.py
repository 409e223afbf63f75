"""The port's CUDA kernels on the card: tests that need a GPU and import no JAX.

Every test here is marked ``cuda`` and skips itself without a CUDA device.
On a GPU machine (which has no JAX) run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

They hold the hand-written Gram kernel to its plain version at the shapes of
tests/test_kernels.py and at K in {4, 6}, check that a launch moves
``LAUNCHES`` and not ``PLAIN_CALLS``, and that ``impl="xla"`` refuses a CUDA
tensor instead of quietly replacing the kernel. The fused ring-step kernel
is held to its plain version at the edge shapes of tests/test_gram_fused.py
(several buckets whose item ids repeat, B not a multiple of tb, all-padding
buckets, item = -1, rows longer than one chunk), in float32 and bfloat16,
with the same allowance, and must give equal bits on two launches.

Both kernels split a long row into pieces on separate blocks and add the
pieces in a second pass. The split cases hold them to the plain versions
where the pieces turn: a bucket item with nnz = W - 1, W, W + 1 and P, one
item with all P = 131,072 ratings, a fused row whose chunks, not adjacent,
span three pieces, at K in {1, 31, 32, 33, 128}, in float32 and bfloat16,
from a starting G that is not symmetric, with alpha = 2.

The checkpoint and serving slice on the card: a run saved at sweep 2 and
restored (in a fresh engine and in the same one) continues bit for bit as
the uninterrupted run, for ``sequential``, a 2-shard ``ring`` and
2-chain ``posterior_merge``; an exported artifact (the sequential one and
the merged one) served from the card answers as the engine's predictor
does, and coalesced requests answer as isolated ones, bit for bit.

The sweep as one device program: for each backend, a block replayed from
its captured CUDA graph equals the eager loop bit for bit (every tensor of
the carry and every metrics row), with the eager loop's Gram launches per
sweep; a replay from a carry that is not the graph's own (a restored one)
refills the static buffers first; ``donate_blocks="off"`` hands back
copies that the next block leaves alone; and an eager block runs under
``torch.cuda.set_sync_debug_mode("error")``, so it has no hidden host read.

The item-sharded top-k on the card (1, 3 and 4 item shards, a tie across
shards) returns the replicated scan's ids and scores bit for bit.

The autotuner on the card: every candidate ``measure_step`` times (the
fused kernel at each chunk width, the per-bucket kernel at each piece
width) is admitted, and each lies within the band of the plain version;
a ring warmed to one decision for every step (per-bucket, or fused at
``pc`` 64 or 256) plans it, each step against the plain version, the
captured block equal to the eager one with the plans' launches, and the
legacy ``Backend.sweep`` leaves the graph's buffers alone.

The fig5 driver at its smoke size on the card: ``ring_async`` at depths
1, 2 and 4 gives the ring's factors bit for bit, the modes agree in RMSE,
and the ring steps launch the fused kernel.

The LM scaffold's attention family on the card: each reduced config's
forward (dense and flash paths) and one train step equal the CPU's within
1e-4 in f32 from the same params (and the init draws agree to float32
rounding); prefill + teacher-forced decode matches forward within 2e-3 and
greedy generation gives the CPU's tokens; the attention's bf16 products
with float32 output (and their gradients) match their plain CPU version.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.bpmf import BPMFConfig, BPMFEngine, load_dataset
from repro_torch.core import prng, sweep_graph
from repro_torch.core.types import Bucket
from repro_torch.kernels import bpmf_gram as gram_kernel
from repro_torch.kernels import ops
from repro_torch.serve import BPMFServer, PosteriorPredictor, parse_request, run_request

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


# name: (Ns, K, cap, [(B, P, dead rows, all empty)]), tests/test_gram_fused.py's edge shapes
FUSED_CASES = {
    "multibucket": (96, 16, 64, [(16, 8, (), False), (9, 32, (), False), (4, 128, (), False)]),
    "B_not_multiple_of_tb": (64, 8, 24, [(13, 64, (), False)]),
    "all_padding": (32, 8, 16, [(8, 16, (), True), (8, 16, (), False)]),
    "item_minus_one": (48, 16, 20, [(10, 32, (0, 3, 9), False)]),
    "multichunk": (64, 16, 16, [(8, 300, (), False)]),
    "K32_long_rows": (500, 32, 40, [(24, 2048, (), False), (40, 8, (), False)]),
    "K128": (50, 128, 6, [(4, 70, (), False)]),
}


def _fused_case(name, device):
    Ns, K, cap, shapes = FUSED_CASES[name]
    rng = np.random.default_rng(sorted(FUSED_CASES).index(name))
    X = torch.from_numpy(rng.normal(size=(Ns, K)).astype(np.float32)).to(device)
    buckets = []
    for B, P, dead, empty in shapes:
        nnz = np.zeros(B, np.int32) if empty else rng.integers(0, P + 1, B).astype(np.int32)
        nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
        val = rng.normal(size=(B, P)).astype(np.float32)
        val[np.arange(P)[None] >= nnz[:, None]] = 0.0
        ids = rng.permutation(cap)[:B].astype(np.int32)
        ids[list(dead)] = -1
        buckets.append(Bucket(*(torch.from_numpy(a).to(device) for a in (ids, nbr, val, nnz))))
    G = torch.from_numpy(rng.normal(size=(cap, K, K)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(cap, K)).astype(np.float32)).to(device)
    return X, tuple(buckets), G, g


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_CASES))
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_matches_plain(cuda, name, compute_dtype):
    X, buckets, G0, g0 = _fused_case(name, cuda)
    step = ops.fused_step(buckets)
    args = (X, step.nbr, step.val, step.item, step.cnt, 2.0, compute_dtype, step.order)
    launches, plain = gram_kernel.FUSED_LAUNCHES, gram_kernel.FUSED_PLAIN_CALLS
    G, g = gram_kernel.bpmf_gram_fused(G0.clone(), g0.clone(), *args)
    G2, g2 = gram_kernel.bpmf_gram_fused(G0.clone(), g0.clone(), *args)
    torch.cuda.synchronize()
    assert gram_kernel.FUSED_LAUNCHES == launches + 2 and gram_kernel.FUSED_PLAIN_CALLS == plain
    assert torch.equal(G, G2) and torch.equal(g, g2)
    # from zero sums the kernel's output is alpha times the row's Gram: the
    # per-bucket allowance 16 eps sqrt(P) sqrt(G_ii G_jj) applies, with P the
    # most ratings a row has in the step
    Z, z = gram_kernel.bpmf_gram_fused(torch.zeros_like(G0), torch.zeros_like(g0), *args)
    Zw, zw = gram_kernel.bpmf_gram_fused_plain(torch.zeros_like(G0), torch.zeros_like(g0), *args)
    per_row = torch.zeros(G0.shape[0], dtype=torch.int64, device=cuda)
    live = step.item >= 0
    per_row.index_add_(0, step.item[live].long(), step.cnt[live].long())
    tol = 16 * torch.finfo(torch.float32).eps * max(int(per_row.max()), 1) ** 0.5
    d = torch.diagonal(Zw, dim1=1, dim2=2).clamp_min(0)
    assert ((Z - Zw).abs() <= tol * (d[:, :, None] * d[:, None, :]).sqrt() + 1e-30).all()
    # with running sums the two differ by float32 rounding of those sums
    Gw, gw = gram_kernel.bpmf_gram_fused_plain(G0.clone(), g0.clone(), *args)
    scale = 1 + (d[:, :, None] * d[:, None, :]).sqrt()
    assert ((G - Gw).abs() <= (tol + 4 * torch.finfo(torch.float32).eps) * (scale + G0.abs())).all()
    untouched = torch.ones(G0.shape[0], dtype=torch.bool, device=cuda)
    untouched[step.order.item.long()] = False
    assert torch.equal(G[untouched], G0[untouched]) and torch.equal(g[untouched], g0[untouched])


@pytest.mark.cuda
def test_fused_step_impls_on_cuda(cuda):
    X, buckets, G0, g0 = _fused_case("multibucket", cuda)
    with pytest.raises(ValueError, match="CPU"):
        ops.bpmf_gram_step(G0.clone(), g0.clone(), X, buckets, alpha=2.0, gram_impl="xla")
    launches = gram_kernel.FUSED_LAUNCHES
    fused = ops.bpmf_gram_step(G0.clone(), g0.clone(), X, buckets, alpha=2.0, gram_impl="auto")
    assert gram_kernel.FUSED_LAUNCHES == launches + 1
    per_bucket = ops.bpmf_gram_step(G0.clone(), g0.clone(), X, buckets, alpha=2.0, gram_impl="pallas")
    torch.cuda.synchronize()
    for a, b in zip(fused, per_bucket):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def _gram_allowance(G, g, Gw, gw, val, P):
    """The per-bucket allowance: 16 eps sqrt(P) sqrt(G_ii G_jj), sqrt(G_ii sum val^2) for g."""
    tol = 16 * torch.finfo(torch.float32).eps * P**0.5
    d = torch.diagonal(Gw, dim1=1, dim2=2)
    v2 = (val.double() ** 2).sum(1, keepdim=True).float()
    assert ((G - Gw).abs() <= tol * (d[:, :, None] * d[:, None, :]).sqrt()).all()
    assert ((g - gw).abs() <= tol * (d * v2).sqrt()).all()


def _split_bucket(seed, Ns, K, nnz, P, device):
    rng = np.random.default_rng(seed)
    nnz = np.asarray(nnz, np.int32)
    X = rng.normal(size=(Ns, K)).astype(np.float32)
    nbr = rng.integers(0, Ns, (len(nnz), P)).astype(np.int32)
    val = rng.normal(size=(len(nnz), P)).astype(np.float32)
    val[np.arange(P)[None] >= nnz[:, None]] = 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (X, nbr, val, nnz))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_at_piece_boundaries(cuda, K, compute_dtype):
    B, P = 6, 4 * gram_kernel.MIN_PIECE_RATINGS
    W = gram_kernel.piece_width(B, P, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert W < P  # the bucket is split
    nnz = [0, W - 1, W, W + 1, P, 3]
    case = _split_bucket(K, 400, K, nnz, P, cuda)
    launches, reduces = gram_kernel.LAUNCHES, gram_kernel.REDUCE_LAUNCHES
    G, g = ops.bpmf_gram(*case, compute_dtype=compute_dtype)
    G2, g2 = ops.bpmf_gram(*case, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert (gram_kernel.LAUNCHES, gram_kernel.REDUCE_LAUNCHES) == (launches + 2, reduces + 2)
    assert torch.equal(G, G2) and torch.equal(g, g2)
    _gram_allowance(G, g, *gram_kernel.bpmf_gram_plain(*case, compute_dtype), case[2], P)
    assert not G[0].any() and not g[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_one_item_with_all_slots(cuda, compute_dtype):
    P = 131_072  # the heaviest MovieLens-20M bucket's pad, every slot real
    case = _split_bucket(0, 27_278, 32, [P], P, cuda)
    G, g = ops.bpmf_gram(*case, compute_dtype=compute_dtype)
    G2, g2 = ops.bpmf_gram(*case, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert torch.equal(G, G2) and torch.equal(g, g2)
    _gram_allowance(G, g, *gram_kernel.bpmf_gram_plain(*case, compute_dtype), case[2], P)


def _three_piece_step(K, device):
    """A ring-step layout where row 5 has 48 chunks in three buckets, others' chunks between."""
    rng = np.random.default_rng(K)
    cap, Ns = 8, 300
    X = torch.from_numpy(rng.normal(size=(Ns, K)).astype(np.float32)).to(device)
    buckets = []
    for ids, nnz in (([5, 0], [2048, 100]), ([1, 5], [7, 2048]), ([2, 5, 3], [50, 2048, 1])):
        B, P = len(ids), 2048
        nbr = rng.integers(0, Ns, (B, P)).astype(np.int32)
        val = rng.normal(size=(B, P)).astype(np.float32)
        val[np.arange(P)[None] >= np.asarray(nnz)[:, None]] = 0.0
        arrays = (np.asarray(ids, np.int32), nbr, val, np.asarray(nnz, np.int32))
        buckets.append(Bucket(*(torch.from_numpy(a).to(device) for a in arrays)))
    G = torch.from_numpy(rng.normal(size=(cap, K, K)).astype(np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(cap, K)).astype(np.float32)).to(device)
    return X, ops.fused_step(tuple(buckets)), G, g


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_fused_kernel_row_over_three_pieces(cuda, K, compute_dtype):
    X, step, G0, g0 = _three_piece_step(K, cuda)
    plan = step.order.pieces
    assert plan.row_item.tolist() == [5] and plan.row_len.tolist() == [3]
    args = (X, step.nbr, step.val, step.item, step.cnt, 2.0, compute_dtype, step.order)
    reduces = gram_kernel.FUSED_REDUCE_LAUNCHES
    G, g = gram_kernel.bpmf_gram_fused(G0.clone(), g0.clone(), *args)
    G2, g2 = gram_kernel.bpmf_gram_fused(G0.clone(), g0.clone(), *args)
    torch.cuda.synchronize()
    assert gram_kernel.FUSED_REDUCE_LAUNCHES == reduces + 2
    assert torch.equal(G, G2) and torch.equal(g, g2)
    Z, z = gram_kernel.bpmf_gram_fused(torch.zeros_like(G0), torch.zeros_like(g0), *args)
    Zw, zw = gram_kernel.bpmf_gram_fused_plain(torch.zeros_like(G0), torch.zeros_like(g0), *args)
    tol = 16 * torch.finfo(torch.float32).eps * (3 * 2048) ** 0.5
    d = torch.diagonal(Zw, dim1=1, dim2=2).clamp_min(0)
    assert ((Z - Zw).abs() <= tol * (d[:, :, None] * d[:, None, :]).sqrt() + 1e-30).all()
    v2 = torch.zeros(G0.shape[0], dtype=torch.float64, device=cuda)
    live = step.item >= 0
    v2.index_add_(0, step.item[live].long(), (step.val[live].double() ** 2).sum(1))
    assert ((z - zw).abs() <= tol * (d * 2.0 * v2[:, None]).sqrt() + 1e-30).all()
    # from the non-symmetric start, G[i][j] and G[j][i] each get the row's partial
    Gw, gw = gram_kernel.bpmf_gram_fused_plain(G0.clone(), g0.clone(), *args)
    scale = 1 + (d[:, :, None] * d[:, None, :]).sqrt()
    assert ((G - Gw).abs() <= (tol + 4 * torch.finfo(torch.float32).eps) * (scale + G0.abs())).all()
    untouched = torch.ones(G0.shape[0], dtype=torch.bool, device=cuda)
    untouched[step.order.item.long()] = False
    assert torch.equal(G[untouched], G0[untouched]) and torch.equal(g[untouched], g0[untouched])


def _checkpointed_run(name: str, directory: str | None):
    """(config, ratings) of a 6-sweep run that saves every 2 sweeps into ``directory``."""
    coo = load_dataset("synthetic", num_users=300, num_movies=200, nnz=8000, noise_std=0.3, seed=5)
    cfg = BPMFConfig().replace(
        name=name, num_shards=2, num_partitions=2, K=16, num_sweeps=6, burn_in=1, sweeps_per_block=2,
        checkpoint_dir=directory, checkpoint_every=2, bucket_pads=(8, 32, 128),
    )
    return cfg, coo


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "ring", "posterior_merge"])
def test_checkpoint_resume_is_bit_identical_on_card(cuda, tmp_path, name):
    cfg, coo = _checkpointed_run(name, str(tmp_path))
    full = BPMFEngine(cfg).fit(coo)  # saves at sweeps 2, 4 and 6
    assert full.device.type == "cuda" and full._manager().all_steps() == [2, 4, 6]
    want = list(full.history)
    U, V = full.factors()
    for engine in (BPMFEngine(cfg), full):  # a fresh engine, and the same one rewound
        assert engine.restore(coo, step=2) == 2
        launches = gram_kernel.LAUNCHES + gram_kernel.FUSED_LAUNCHES
        engine.fit()
        assert gram_kernel.LAUNCHES + gram_kernel.FUSED_LAUNCHES > launches
        assert engine.history == want
        got_U, got_V = engine.factors()
        np.testing.assert_array_equal(got_U, U)
        np.testing.assert_array_equal(got_V, V)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "posterior_merge"])
def test_served_answers_are_the_engines_and_coalesce_bit_for_bit(cuda, tmp_path, name):
    cfg, coo = _checkpointed_run(name, None)
    engine = BPMFEngine(cfg.replace(keep_factor_samples=4, checkpoint_every=0)).fit(coo)
    path = engine.export(str(tmp_path / "art"))
    served = PosteriorPredictor.load(path, device="cuda")
    ours = engine.predictor()
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 300, 64), rng.integers(0, 200, 64)
    for a, b in zip(served.predict(rows, cols, return_std=True), ours.predict(rows, cols, return_std=True)):
        assert a.tobytes() == b.tobytes()
    ids, vals = served.top_k(rows, 10)
    ids2, vals2 = ours.top_k(rows, 10)
    np.testing.assert_array_equal(ids, ids2)
    assert vals.tobytes() == vals2.tobytes()
    for i in range(0, 64, 9):  # one query alone has the bits it has in the batch
        one = served.predict(rows[i:i + 1], cols[i:i + 1], return_std=True)
        assert one[0][0] == ours.predict(rows, cols)[i]
        np.testing.assert_array_equal(served.top_k(int(rows[i]), 10)[0], ids[i])
        assert served.top_k(int(rows[i]), 10)[1].tobytes() == vals[i].tobytes()

    payloads = [{"rows": rng.integers(0, 300, n).tolist(), "cols": rng.integers(0, 200, n).tolist(),
                 "std": True} for n in (1, 3, 8, 2)]
    payloads += [{"user": int(u), "k": 10} for u in rng.integers(0, 300, 4)]
    expected = [run_request(served, parse_request(p)) for p in payloads]
    with BPMFServer(path, deadline_ms=300.0, adaptive=False, watch=False) as srv:
        barrier = threading.Barrier(len(payloads))
        results = [None] * len(payloads)

        def client(i):
            barrier.wait()
            results[i] = srv.handle_request(payloads[i], timeout=60)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert srv.batcher.stats()["coalesced_requests"] > 0
    assert results == [(200, want) for want in expected]


def _fresh_carry(engine):
    b = engine.backend
    return b.init_state(engine._k_init), b.init_pred(), b.init_accum()


def _assert_same_bits(got, want):
    a, b = sweep_graph.tensors(got), sweep_graph.tensors(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "ring", "ring_async", "allgather", "posterior_merge"])
def test_captured_block_equals_eager_bit_for_bit(cuda, name):
    cfg, coo = _checkpointed_run(name, None)
    engine = BPMFEngine(cfg.replace(checkpoint_every=0, pipeline_depth=2))
    engine.prepare(coo)
    b = engine.backend
    assert b.captures() and b.graph is None
    before = sweep_graph.launch_counts()
    eager = b.sweep_block(engine._k_run, *_fresh_carry(engine), 4, _eager=True)
    eager_counts = {k: v - before[k] for k, v in sweep_graph.launch_counts().items()}
    # the eager loop updates the accumulator in place: continue from a copy
    eager2 = b.sweep_block(engine._k_run, *sweep_graph.map_tensors(eager[:3], torch.clone), 2, _eager=True)
    captured = b.sweep_block(engine._k_run, *_fresh_carry(engine), 4)
    assert b.graph is not None and b.graph.replays == 4
    _assert_same_bits(captured, eager)
    assert {k: 4 * v for k, v in b.graph.launches_per_replay.items()} == eager_counts
    assert sum(eager_counts.values()) > 0
    # the next block continues from the graph's own (donated) buffers
    again = b.sweep_block(engine._k_run, *captured[:3], 2)
    assert sweep_graph.tensors(again[0])[0] is sweep_graph.tensors(captured[0])[0]
    _assert_same_bits(again, eager2)
    assert torch.equal(again[3][:, 2].cpu(), torch.tensor([5.0, 6.0]))
    assert not again[3][:, 3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "posterior_merge"])
def test_replay_refills_the_static_buffers_from_a_restored_carry(cuda, name):
    cfg, coo = _checkpointed_run(name, None)
    engine = BPMFEngine(cfg.replace(checkpoint_every=0, donate_blocks="off"))
    engine.prepare(coo)
    b = engine.backend
    first = b.sweep_block(engine._k_run, *_fresh_carry(engine), 2)
    kept = sweep_graph.map_tensors(first[:3], torch.clone)
    second = b.sweep_block(engine._k_run, *first[:3], 2)
    # "off" handed back copies: the second block left the first's carry alone
    _assert_same_bits(first[:3], kept)
    # a carry from the host (as restore() builds it) replays as the original did
    host = sweep_graph.map_tensors(kept, lambda t: t.cpu())
    restored = sweep_graph.map_tensors(host, lambda t: t.to(cuda))
    _assert_same_bits(b.sweep_block(engine._k_run, *restored, 2), second)
    assert b.graph.replays == 6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sequential", "ring", "posterior_merge"])
def test_eager_block_has_no_hidden_sync(cuda, name):
    cfg, coo = _checkpointed_run(name, None)
    engine = BPMFEngine(cfg.replace(checkpoint_every=0))
    engine.prepare(coo)
    b = engine.backend
    carry = _fresh_carry(engine)
    carry = b.sweep_block(engine._k_run, *carry, 1, _eager=True)[:3]  # builds the kernels, the handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = b.sweep_block(engine._k_run, *carry, 2, _eager=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[3]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_top_k_on_card_equals_the_replicated_scan(cuda, shards):
    from repro_torch.serve import ArtifactMeta
    from repro_torch.serve.predictor import serve_devices

    rng = np.random.default_rng(shards)
    users, movies, K = 50, 1037, 32
    U = rng.normal(scale=0.5, size=(users, K)).astype(np.float32)
    V = rng.normal(scale=0.5, size=(movies, K)).astype(np.float32)
    V[700] = V[3]  # a tie across shards: the lower id first
    arrays = {"U_mean": U, "V_mean": V, "U_samples": U[None], "V_samples": V[None]}
    meta = ArtifactMeta(users, movies, K, 3.5, 1.0, 5.0, 1, 1, "synthetic", 1, 0)
    p = PosteriorPredictor(meta, arrays, "cuda", topk_mode="sharded", item_devices=serve_devices(shards, "cuda"))
    for k in (1, 10, 400):
        got, want = p.top_k(np.arange(users), k), p.top_k(np.arange(users), k, sharded=False)
        assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()


# ---------- the autotuner on the card ----------


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,Ns,K", [([(48, 64), (16, 32)], 128, 32), ([(8, 4096), (24, 128)], 512, 32),
                                         ([(128, 8)], 128, 16)])
def test_every_measure_step_candidate_matches_the_plain_version(cuda, tmp_path, shapes, Ns, K):
    from repro_torch.kernels import autotune

    cache = autotune.AutotuneCache(str(tmp_path / "gram_cuda.json"))
    best, timings = autotune.measure_step(shapes, Ns, K, iters=3, cache=cache, device=cuda)
    assert set(timings) == set(autotune.candidates("cuda"))  # none left out, and no "xla" on the card
    entry = next(iter(cache.entries().values()))
    assert "rejected" not in entry and entry["card"] != "cuda" and best.impl in ("pallas_fused", "pallas")
    cap = -(-sum(b for b, _ in shapes) // 8) * 8
    X, buckets = autotune.synthetic_step(shapes, Ns, K, cap, cuda)
    zeros = lambda: (torch.zeros(cap, K, K, device=cuda), torch.zeros(cap, K, device=cuda))  # noqa: E731
    want = gram_kernel.bpmf_gram_fused_plain(*zeros(), X, *ops.flatten_step(buckets, 128, 8), 2.0)
    for label, dec in autotune.candidates("cuda").items():
        got = ops.bpmf_gram_step(*zeros(), X, buckets, alpha=2.0, plan=ops.StepPlan.for_decision(dec, buckets))
        assert autotune.step_band(*got, *want, buckets, 2.0) <= 1.0, label


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [("pallas", None, 256), ("pallas_fused", 64, None), ("pallas_fused", 256, None)])
def test_a_warmed_ring_runs_its_decisions_captured_as_eager(cuda, tmp_path, warm):
    from repro_torch.kernels import autotune

    cache = autotune.AutotuneCache(str(tmp_path / "gram_cuda.json"))
    cfg, coo = _checkpointed_run("ring", None)
    cfg = cfg.replace(checkpoint_every=0)
    cold = BPMFEngine(cfg)
    cold.prepare(coo)
    for key, _ in autotune.workload_step_keys(cold.backend.data, cfg.model.K):
        cache.record(key, autotune.Decision(*warm))
    autotune.set_cache(cache)
    try:
        engine = BPMFEngine(cfg)
        engine.prepare(coo)
    finally:
        autotune.set_cache(None)
    b = engine.backend
    plans = b.data.step_plans()
    assert plans and all(p.decision == autotune.Decision(*warm) for *_, p in plans)
    # every warmed step against its plain version, from zero sums
    state = b.init_state(engine._k_init)
    for side, t, i, plan in plans:
        S = b.num_shards
        X = (state.V if side == "users" else state.U)[(i - t) % S]
        cap, K = getattr(b.data, side).cap, cfg.model.K
        buckets = getattr(b.data, side).steps[t][i]
        got = ops.bpmf_gram_step(torch.zeros(cap, K, K, device=cuda), torch.zeros(cap, K, device=cuda), X,
                                 buckets, alpha=2.0, plan=plan)
        want = gram_kernel.bpmf_gram_fused_plain(torch.zeros(cap, K, K, device=cuda),
                                                 torch.zeros(cap, K, device=cuda), X,
                                                 *ops.flatten_step(buckets, 128, 8), 2.0)
        assert autotune.step_band(*got, *want, buckets, 2.0) <= 1.0, (side, t, i)
    before = sweep_graph.launch_counts()
    eager = b.sweep_block(engine._k_run, *_fresh_carry(engine), 3, _eager=True)
    eager_counts = {k: v - before[k] for k, v in sweep_graph.launch_counts().items()}
    captured = b.sweep_block(engine._k_run, *_fresh_carry(engine), 3)
    _assert_same_bits(captured, eager)
    assert {k: 3 * v for k, v in b.graph.launches_per_replay.items()} == eager_counts
    fused = warm[0] == "pallas_fused"
    assert (eager_counts["FUSED_LAUNCHES"] > 0) == fused and (eager_counts["LAUNCHES"] > 0) != fused
    # the legacy per-sweep dispatch leaves the graph and its buffers alone
    kept = sweep_graph.map_tensors(captured[:3], torch.clone)
    _, _, m = b.sweep(engine._k_run, captured[0], captured[1])
    assert m.sweep == 4.0
    _assert_same_bits(captured[:3], kept)
    assert b.graph.replays == 3


@pytest.mark.cuda
def test_fig5_smoke_on_the_card_keeps_ring_async_bit_for_bit(cuda, tmp_path):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks_torch import fig5_overlap

    before = gram_kernel.FUSED_LAUNCHES
    payload = fig5_overlap.run(smoke=True, out_path=str(tmp_path / "fig5_overlap.json"), device="cuda")
    assert payload["device"] == "gpu" and payload["cards"] == 1
    assert payload["ring_async_bitwise"] and payload["parity_ok"]
    assert gram_kernel.FUSED_LAUNCHES > before  # the ring steps ran the fused kernel


LM_FAMILY = ("gemma-2b", "yi-6b", "chameleon-34b", "nemotron-4-340b", "hubert-xlarge")


def _lm_on(tree, device):
    from repro_torch.training.optimizer import tree_map

    return tree_map(lambda t: t.clone().to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_FAMILY)
def test_reduced_lm_on_the_card_matches_the_cpu(cuda, arch):
    """Each reduced attention-family config, f32 activations: the card's forward (dense and flash paths)
    and one train step's loss and grad norm within 1e-4 of the CPU's, from the same params and batch; the
    init on each device agrees to float32 rounding (one bf16 step for bf16 params)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import step_generator, synthetic_lm_batch
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW, tree_leaves
    from repro_torch.training.train import init_train_state, make_train_step

    cfg = get_config(arch).reduced().replace(activation_dtype="float32")
    batch = synthetic_lm_batch(step_generator(0, 0), cfg, 2, 48, "cpu")
    V = cfg.vocab_size
    for c in (cfg, cfg.replace(attn_q_chunk=16, attn_kv_chunk=32)):
        model = build_model(c)
        params = model.init(prng.key(0), "cpu")
        with torch.no_grad():
            want = model.forward(params, batch["inputs"])[0][..., :V]
            got = model.forward(_lm_on(params, cuda), batch["inputs"].to(cuda))[0][..., :V].cpu()
        assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))
    model = build_model(cfg)
    opt = AdamW(learning_rate=1e-3)
    cpu_state = init_train_state(prng.key(1), model, opt, "cpu")
    card_state = init_train_state(prng.key(1), model, opt, cuda)
    for a, b in zip(tree_leaves(cpu_state.params), tree_leaves(card_state.params)):
        # the same bits, made normal by each device's log1p and sqrt
        step = 2**-7 if a.dtype == torch.bfloat16 else 1e-6
        assert float((b.cpu().float() - a.float()).abs().max()) <= step * float(a.float().abs().max())
    _, m_cpu = make_train_step(model, opt)(cpu_state, batch)
    _, m_card = make_train_step(model, opt)(card_state, {k: v.to(cuda) for k, v in batch.items()})
    for name in ("loss", "grad_norm"):
        assert abs(float(m_card[name]) - float(m_cpu[name])) <= 1e-4 * max(1.0, abs(float(m_cpu[name])))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [a for a in LM_FAMILY if a != "hubert-xlarge"])
def test_reduced_lm_decode_on_the_card_matches_forward(cuda, arch):
    """Prefill + teacher-forced decode on the card against the card's forward (``tests/test_archs.py``'s
    2e-3 band, f32), through the flash path for the cache, and greedy generation equal to the CPU's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.lm_serve import greedy_generate

    cfg = get_config(arch).reduced().replace(activation_dtype="float32", attn_q_chunk=4, attn_kv_chunk=8)
    model = build_model(cfg)
    params = model.init(prng.key(2), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 16), generator=torch.Generator().manual_seed(3)).to(torch.int32)
    tokens = tokens.to(cuda)
    with torch.no_grad():
        full, _ = model.forward(params, tokens)
        logits, cache = model.prefill(params, tokens[:, :8], model.init_cache(1, 16, cuda))
        outs = [logits[:, -1]]
        for t in range(8, 16):
            pos = torch.tensor([t], dtype=torch.int32, device=cuda)
            logits, cache = model.decode(params, tokens[:, t : t + 1], cache, pos)
            outs.append(logits[:, -1])
    stepwise = torch.stack(outs, dim=1)
    np.testing.assert_allclose(stepwise[:, :-1].cpu().numpy(), full[:, 7:-1].cpu().numpy(), atol=2e-3, rtol=2e-3)
    got = greedy_generate(model, params, tokens[:, :6], steps=4, max_len=10)
    want = greedy_generate(model, _lm_on(params, "cpu"), tokens[:, :6].cpu(), steps=4, max_len=10)
    assert got.cpu().tolist() == want.tolist()


@pytest.mark.cuda
def test_narrow_bmm_on_the_card_matches_its_plain_version(cuda):
    """The bf16 products of attention (float32 output on the card, widened inputs on the CPU) and their
    gradients: the card within float32 rounding of the CPU's (summation order only)."""
    from repro_torch.models.attention import _bmm_f32

    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
            for s in ((3, 64, 256), (3, 256, 96)))
    outs = []
    for dev in ("cpu", cuda):
        x, y = (t.to(dev).detach().clone().requires_grad_(True) for t in (a, b))
        out = _bmm_f32(x, y)
        assert out.dtype == torch.float32
        out.square().sum().backward()
        outs.append((out.detach().cpu(), x.grad.float().cpu(), y.grad.float().cpu()))
    (o1, ga1, gb1), (o2, ga2, gb2) = outs
    assert float((o2 - o1).abs().max()) <= 1e-5 * float(o1.abs().max())
    for g1, g2 in ((ga1, ga2), (gb1, gb2)):  # bf16 gradients: one bf16 step apart at most
        assert float((g2 - g1).abs().max()) <= 2**-7 * float(g1.abs().max())
