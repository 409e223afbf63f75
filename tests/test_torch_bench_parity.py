"""The new drivers' deterministic quantities against the reference on the same seeded inputs.

``benchmarks_torch``'s fig3, fig4 and fig_merge_comm record layouts,
modelled bytes and baselines that do not depend on timing. Each is held
here to the JAX package's own functions on the same ratings:

* fig3's movies-side buckets per variant (pads, counts and contents)
  against ``repro.data.sparse.build_bpmf_data``;
* fig4's and fig_merge_comm's ``cap_u``, ``cap_v`` and modelled ring bytes
  against ``repro.core.distributed.build_distributed_data``, and the bytes
  metered through ``Ring.rotate`` in one eager sweep equal to that model
  exactly;
* fig_merge_comm's ``baseline_rmse`` within 1e-12 of
  ``repro.core.subset_merge.column_mean_rmse``, and its ``collective_ops``
  0 for ``sequential`` and ``posterior_merge`` and ``2 (S - 1)`` ring
  rotations for the ring.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks_torch import common, fig3_multicore, fig4_scaling, fig_merge_comm  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro.core import subset_merge as ref_merge  # noqa: E402
from repro.data import sparse as ref_sparse  # noqa: E402
from repro.data.synthetic import SyntheticSpec as RefSpec  # noqa: E402
from repro.data.synthetic import synthetic_ratings as ref_synthetic  # noqa: E402
from repro_torch.bpmf import BPMFEngine  # noqa: E402
from repro_torch.data.sparse import RatingsCOO, build_bpmf_data  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_coo(spec):
    """The reference's ratings for a port spec, and the same arrays as the port's ``RatingsCOO``."""
    ref, _ = ref_synthetic(RefSpec(**{f: getattr(spec, f) for f in spec.__dataclass_fields__}))
    port = RatingsCOO(np.asarray(ref.rows), np.asarray(ref.cols), np.asarray(ref.vals), ref.num_users,
                      ref.num_movies)
    return ref, port


def test_fig3_buckets_per_variant_match_the_reference():
    ref, coo = _ref_coo(fig3_multicore.spec(smoke=True))
    pads = fig3_multicore.variant_pads(coo)
    indptr, _, _ = ref_sparse.csr_from_coo(ref.cols, ref.rows, ref.vals, ref.num_movies)
    ref_max = int((indptr[1:] - indptr[:-1]).max())
    assert pads["maxpad_graphlab_like"] == (1 << int(np.ceil(np.log2(max(ref_max, 8)))),)
    assert pads["bucketed_lpt"] == (8, 32, 128, 512, 2048) and pads["bucketed_coarse"] == (2048,)
    for mode, p in pads.items():
        got = build_bpmf_data(coo, pads=p, test_fraction=0.1, seed=0).movies.buckets
        want = ref_sparse.build_bpmf_data(ref, pads=p, test_fraction=0.1, seed=0).movies.buckets
        assert [[b.B, b.P] for b in got] == [list(np.asarray(b.nbr).shape) for b in want], mode
        for g, w in zip(got, want):
            for field in ("item_ids", "nbr", "val", "nnz"):
                assert np.array_equal(getattr(g, field).numpy(), np.asarray(getattr(w, field))), (mode, field)
    assert len(pads) == 3


def _ref_layout(coo, S: int, **kw) -> tuple[int, int]:
    _, plan = ref_dist.build_distributed_data(coo, num_shards=S, **kw)
    return int(plan.part_users.cap), int(plan.part_movies.cap)


@pytest.mark.parametrize("S", [2, 4])
def test_fig4_ring_bytes_match_the_reference_model_and_the_meter(S):
    ref, coo = _ref_coo(fig4_scaling.process_spec(smoke=True))
    K = 8
    got = fig4_scaling.ring_bytes_per_sweep(coo, K, S, torch.device("cpu"))
    cap_u, cap_v = _ref_layout(ref, S, seed=0)
    assert (got["cap_u"], got["cap_v"]) == (cap_u, cap_v)
    assert got["modelled"] == S * (S - 1) * (cap_u + cap_v) * K * 4
    assert got["measured"] == got["modelled"] and got["model_matches"]
    assert got["rotate_calls"] == 2 * (S - 1)


def test_fig_merge_comm_layout_bytes_and_baseline_match_the_reference():
    w = fig_merge_comm.workload(smoke=False)
    coo = fig_merge_comm.load_task(w)
    cfg = fig_merge_comm.base_config(w)
    from repro.bpmf import load_dataset as ref_load

    ref = ref_load("synthetic", num_users=w["users"], num_movies=w["movies"], nnz=w["nnz"], noise_std=0.3, seed=7)
    assert np.array_equal(coo.rows, np.asarray(ref.rows)) and np.array_equal(coo.vals, np.asarray(ref.vals))
    baseline = fig_merge_comm.subset_merge.column_mean_rmse(coo, cfg.run.test_fraction, cfg.run.seed)
    assert abs(baseline - ref_merge.column_mean_rmse(ref, cfg.run.test_fraction, cfg.run.seed)) <= 1e-12

    engine = BPMFEngine(cfg.replace(name="ring"), device="cpu")
    engine.prepare(coo)
    S = fig_merge_comm.NUM_SHARDS
    cap_u, cap_v = _ref_layout(ref, S, pads=cfg.backend.bucket_pads, test_fraction=cfg.run.test_fraction,
                               seed=cfg.run.seed, strategy=cfg.backend.partition_strategy)
    modelled = S * (S - 1) * (cap_u + cap_v) * w["K"] * 4
    assert fig_merge_comm.bytes_per_sweep(engine) == modelled == 71680  # the reference's committed number
    meter = common.metered_sweep(engine)
    assert meter["rotate_bytes"] == modelled
    assert fig_merge_comm.collective_ops(engine) == meter["rotate_calls"] == 2 * (S - 1)


@pytest.mark.parametrize("name,extra", [("sequential", {}), ("posterior_merge", {"num_partitions": 2}),
                                        ("ring_async", {"pipeline_depth": 2})])
def test_fig_merge_comm_collective_ops_per_backend(name, extra):
    w = fig_merge_comm.workload(smoke=True)
    engine = BPMFEngine(fig_merge_comm.base_config(w).replace(name=name, **extra), device="cpu")
    engine.prepare(fig_merge_comm.load_task(w))
    ops = fig_merge_comm.collective_ops(engine)
    if name == "ring_async":
        assert ops == 2 * (fig_merge_comm.NUM_SHARDS - 1) and fig_merge_comm.bytes_per_sweep(engine) > 0
    else:
        assert ops == 0 and fig_merge_comm.bytes_per_sweep(engine) == 0


def test_the_ring_meter_comes_off():
    from repro_torch.core.distributed import Ring

    rotate, all_gather = Ring.rotate, Ring.all_gather
    with pytest.raises(RuntimeError), common.metered_ring():
        assert Ring.rotate is not rotate
        raise RuntimeError("leave the block by an error")
    assert Ring.rotate is rotate and Ring.all_gather is all_gather
