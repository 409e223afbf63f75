"""Multi-process training of the port (DESIGN.md §14) against its own single process and the JAX package.

In this process, at small shapes:

* ``build_distributed_data_per_host`` on a chunk stream equals the JAX
  package's on the same chunks: the global plan, the counts and every local
  shard's buckets; with every shard local it equals the port's
  ``build_distributed_data`` bit for bit;
* ``RestartPolicy``, ``FailureInjector`` and ``StepTimer`` decide as the
  JAX package's classes do;
* a checkpoint whose factor leaf is written as per-shard files (the
  reference's names) is read by the port's and the JAX package's readers.

In subprocesses (``multidevice``), on the CPU over ``gloo``:

* a gang of 2 processes (96 x 64 x 1,500, K = 8, S = 4) draws bit for bit
  the samples of one process: ``ring``, ``ring_async`` (depth 2) and
  ``allgather`` (metrics, gathered factors, exported artifact bytes), and
  ``posterior_merge`` with 2 chains; every rank holds less than the total
  training nnz; a checkpoint restores 2 -> 1 and 1 -> 2 with the
  uninterrupted run's bits;
* the ``--elastic`` launcher, with the last rank killed at sweep 3,
  restarts at 1 process and ends with the uninterrupted run's artifact.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.core import distributed as jdist
from repro.data.sparse import RatingsCOO as JRatingsCOO
from repro.data.synthetic import SyntheticSpec as JSpec
from repro.data.synthetic import synthetic_ratings as jsynthetic
from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import ShardedHostLeaf, restore_checkpoint, save_checkpoint
from repro_torch.core import distributed as dist
from repro_torch.data.sparse import RatingsCOO
from repro_torch.runtime import elastic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PADS = (8, 32, 128)
GANG_TIMEOUT_S = 300


def _coo(nnz: int = 1500):
    coo, _ = jsynthetic(JSpec(num_users=96, num_movies=64, nnz=nnz, discretize=False))
    return coo


def _port(coo) -> RatingsCOO:
    return RatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies)


@pytest.mark.parametrize("S,local", [(4, (0, 1)), (4, (2, 3)), (4, (3,)), (2, (1,))])
def test_per_host_build_matches_jax(S, local):
    coo = _coo()
    chunk_rows = 400  # several chunks, the last one short
    jdata, jplan = jdist.build_distributed_data_per_host(
        JRatingsCOO(coo.rows, coo.cols, coo.vals, coo.num_users, coo.num_movies).chunked(chunk_rows),
        S, local, pads=PADS)
    data, plan = dist.build_distributed_data_per_host(_port(coo).chunked(chunk_rows), S, local, pads=PADS)
    for got, want in ((plan.part_users, jplan.part_users), (plan.part_movies, jplan.part_movies)):
        np.testing.assert_array_equal(got.perm, want.perm)
        assert got.cap == want.cap
    assert (plan.local_shards, plan.local_nnz, plan.total_nnz) == (
        jplan.local_shards, jplan.local_nnz, jplan.total_nnz)
    assert 0 < plan.local_nnz < plan.total_nnz
    assert float(data.mean_rating) == float(jdata.mean_rating)
    assert (data.min_rating, data.max_rating) == (jdata.min_rating, jdata.max_rating)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(data.test, f).numpy(), np.asarray(getattr(jdata.test, f)))
    for side, jside in ((data.users, jdata.users), (data.movies, jdata.movies)):
        assert (side.shard_offset, side.num_shards, side.cap) == (local[0], len(local), jside.cap)
        for i, d in enumerate(local):
            np.testing.assert_array_equal(
                side.orig_ids[i].numpy(), np.asarray(jside.orig_ids)[d * side.cap:(d + 1) * side.cap])
        for t in range(S):
            assert all(len(side.steps[t][i]) == len(jside.steps[t]) for i in range(len(local)))
            for k, jb in enumerate(jside.steps[t]):
                for f in ("item_ids", "nbr", "val", "nnz"):
                    block = getattr(jb, f)  # a LocalShardedArray of the local shards' rows
                    assert block.global_rows % S == 0 and block.row_offset == local[0] * (block.global_rows // S)
                    got = torch.cat([getattr(side.steps[t][i][k], f) for i in range(len(local))]).numpy()
                    np.testing.assert_array_equal(got, block.block)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_per_host_build_with_every_shard_local_equals_the_full_build(S):
    coo = _port(_coo())
    full, fplan = dist.build_distributed_data(coo, S, pads=PADS)
    per, pplan = dist.build_distributed_data_per_host(coo.chunked(333), S, range(S), pads=PADS)
    assert pplan.local_nnz == pplan.total_nnz and pplan.local_shards == tuple(range(S))
    np.testing.assert_array_equal(pplan.part_users.perm, fplan.part_users.perm)
    np.testing.assert_array_equal(pplan.part_movies.perm, fplan.part_movies.perm)
    assert float(per.mean_rating) == float(full.mean_rating)
    for f in ("rows", "cols", "vals"):
        assert torch.equal(getattr(per.test, f), getattr(full.test, f))
    for a, b in ((per.users, full.users), (per.movies, full.movies)):
        assert all(torch.equal(x, y) for x, y in zip(a.orig_ids, b.orig_ids))
        for sa, sb in zip(a.steps, b.steps):
            for ba, bb in zip(sa, sb):
                for x, y in zip(ba, bb):
                    for f in ("item_ids", "nbr", "val", "nnz"):
                        assert torch.equal(getattr(x, f), getattr(y, f))


def test_local_shard_range_and_the_retention_guard():
    for S, P in ((4, 1), (4, 2), (8, 4), (6, 3)):
        for p in range(P):
            assert dist.local_shard_range(S, p, P) == jdist.local_shard_range(S, p, P)
    with pytest.raises(ValueError, match="divisible"):
        dist.local_shard_range(6, 0, 4)
    # one movie, so every rating touches shard 0: a process owning only
    # shard 0 would keep the whole training set, which the guard refuses
    one_movie = RatingsCOO(np.arange(8, dtype=np.int32), np.zeros(8, np.int32), np.ones(8, np.float32), 8, 1)
    with pytest.raises(RuntimeError, match="locality filter"):
        dist.build_distributed_data_per_host(one_movie.chunked(3), 2, (0,), pads=PADS, test_fraction=0.0)


def test_backend_rule_ring_layout_and_job_arguments_are_checked(monkeypatch):
    from repro_torch.launch import hostdevices

    cpu, card, card0 = torch.device("cpu"), torch.device("cuda"), torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert hostdevices.choose_backend(cpu, 2) == "gloo"
    assert hostdevices.choose_backend(card, 2) == "nccl"  # a card each
    assert hostdevices.choose_backend(card, 3) == "gloo"  # ranks share a card
    assert hostdevices.choose_backend(card0, 2) == "gloo"  # every rank on card 0
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert hostdevices.init_multiprocess(device="cpu") is False and hostdevices.process_count() == 1
    with pytest.raises(ValueError, match="without a --coordinator"):
        hostdevices.init_multiprocess(num_processes=2, process_id=1, device="cpu")
    with pytest.raises(ValueError, match="needs all of"):
        hostdevices.init_multiprocess("127.0.0.1:1", num_processes=2, device="cpu")
    ring = dist.Ring(["cpu"] * 2)
    assert (ring.num_shards, ring.num_processes, ring.local_shards, ring.spans_processes) == (2, 1, range(0, 2), False)
    with pytest.raises(ValueError, match="do not tile"):
        dist.Ring(["cpu"] * 2, num_shards=5)
    with pytest.raises(RuntimeError, match="2-process job"):
        dist.Ring(["cpu"] * 2, num_shards=4, shard_offset=2)  # rank 1 of 2, in a process that is no job


@pytest.mark.parametrize("total,start,budget", [(4, 2, 2), (8, 4, 3), (6, 4, 2), (3, 3, 1), (5, 2, 0)])
def test_restart_policy_matches_jax(total, start, budget):
    ours = elastic.RestartPolicy(total_devices=total, max_restarts=budget)
    theirs = jelastic.RestartPolicy(total_devices=total, max_restarts=budget)
    n = start
    for _ in range(budget + 1):
        got, want = ours.next_layout(n), theirs.next_layout(n)
        assert got == want
        if got is None:
            break
        n = got[0]
    assert ours.restarts_done == theirs.restarts_done


def test_failure_injector_and_step_timer_match_jax():
    ours, theirs = elastic.FailureInjector({3: 1, 5: 2}), jelastic.FailureInjector({3: 1, 5: 2})
    for step in range(1, 8):
        raised = []
        for inj, exc in ((ours, elastic.NodeFailure), (theirs, jelastic.NodeFailure)):
            try:
                inj.check(step)
                raised.append(None)
            except exc as e:
                raised.append(e.lost_devices)
        assert raised[0] == raised[1]
    times = [1.0, 1.1, 0.9, 1.0, 1.05, 3.5, 1.0, 0.95, 2.5, 1.0] + [1.0] * 45 + [9.0]
    ot, jt = elastic.StepTimer(window=50), jelastic.StepTimer(window=50)
    flags = [(ot.record(i, s), jt.record(i, s)) for i, s in enumerate(times)]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert ot.straggler_steps == jt.straggler_steps and ot.straggler_steps


def test_sharded_leaf_files_read_by_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    U = rng.normal(size=(12, 3)).astype(np.float32)
    pieces = tuple((((lo, lo + 4), (0, 3)), U[lo:lo + 4]) for lo in (0, 4, 8))
    leaf = ShardedHostLeaf(global_shape=(12, 3), dtype="float32", shards=pieces)
    save_checkpoint(str(tmp_path), 2, {"state__.U": leaf, "history": np.zeros((2, 3), np.float32)})
    files = sorted(os.listdir(tmp_path / "step_00000002"))
    assert "state__.U.shard-4_8-0_3.npy" in files and "history.npy" in files
    np.testing.assert_array_equal(restore_checkpoint(str(tmp_path), ["state__.U"])["state__.U"], U)
    theirs = jrestore(str(tmp_path), {"state__.U": np.zeros((12, 3), np.float32)})
    np.testing.assert_array_equal(np.asarray(theirs["state__.U"]), U)
    local = dist.LocalShardedArray(torch.from_numpy(U[4:8]), 12, 4)
    assert local.shape == (12, 3) and local.host_leaf().shards[0][0] == ((4, 8), (0, 3))
    np.testing.assert_array_equal(dist.fetch_global(dist.LocalShardedArray(torch.from_numpy(U), 12, 0)), U)


# One gang member (or the single process): runs every backend from the same
# start, or resumes a ring checkpoint, and prints a RESULT line of hashes.
WORKER = """
import hashlib, json, os, sys
import numpy as np
import torch

pid, nproc, port, phase, ckroot, out = sys.argv[1:7]
pid, nproc = int(pid), int(nproc)
torch.set_num_threads(1)
from repro_torch.launch.hostdevices import init_multiprocess, shutdown
if nproc > 1:
    init_multiprocess(f"127.0.0.1:{port}", nproc, pid, device="cpu", timeout_s=120)
from repro_torch.bpmf import BPMFConfig, BPMFEngine
from repro_torch.data.synthetic import SyntheticSpec, synthetic_ratings

coo, _ = synthetic_ratings(SyntheticSpec(num_users=96, num_movies=64, nnz=1500, discretize=False))

def h(a):
    return hashlib.md5(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]

def files(d):
    return {os.path.relpath(os.path.join(r, f), d): h(np.fromfile(os.path.join(r, f), np.uint8))
            for r, _, fs in sorted(os.walk(d)) for f in sorted(fs)}

def finish(eng, name):
    U, V = eng.factors()
    hist = np.asarray([[m.rmse_sample, m.rmse_avg, m.sweep] for m in eng.history], np.float32)
    art = os.path.join(out, f"art-{phase}-{name}-{nproc}")
    eng.export(art)
    res = {"U": h(U), "V": h(V), "hist": h(hist), "rmse": eng.rmse}
    if pid == 0:
        res["art"] = files(art)
    return res

def config(name, **kw):
    return BPMFConfig().replace(name=name, num_shards=4, K=8, num_sweeps=4, burn_in=2,
                                sweeps_per_block=2, keep_factor_samples=2, **kw)

results = {}
if phase == "fresh":
    for name, kw in (("ring", {}), ("ring_async", {"pipeline_depth": 2}), ("allgather", {}),
                     ("posterior_merge", {"num_partitions": 2})):
        eng = BPMFEngine(config(name, checkpoint_dir=os.path.join(ckroot, name), checkpoint_every=2, **kw),
                         device="cpu")
        eng.fit(coo)
        results[name] = finish(eng, name)
        if name == "ring":
            plan = eng.backend.plan
            results["nnz"] = [plan.local_nnz, plan.total_nnz]
for src in sys.argv[7:]:  # resume each given ring checkpoint at sweep 2
    eng = BPMFEngine(config("ring", checkpoint_dir=src), device="cpu")
    eng.prepare(coo)
    assert eng.restore(step=2) == 2
    eng.fit()
    results["resume:" + os.path.basename(os.path.dirname(src))] = finish(eng, "resume")
print("RESULT", json.dumps(results), flush=True)
shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(k, None)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _gang(script, nproc: int, args: list[str]) -> list[dict]:
    """Run ``script`` as an nproc gang; every member's RESULT."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(nproc), port, *args], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        dump = "\n".join(f"--- rank {i} ---\n{o[-3000:]}" for i, o in enumerate(outs))
        raise AssertionError(f"gang failed {[p.returncode for p in procs]}:\n{dump}")
    return [json.loads(next(line for line in o.splitlines() if line.startswith("RESULT "))[7:]) for o in outs]


@pytest.mark.multidevice
def test_gloo_gang_matches_one_process_and_restores_across_process_counts(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(WORKER))
    one, two = tmp_path / "ck1", tmp_path / "ck2"
    (single,) = _gang(script, 1, ["fresh", str(one), str(tmp_path)])
    # fresh runs of every backend, then the single process's ring checkpoint resumed (1 -> 2)
    ranks = _gang(script, 2, ["fresh", str(two), str(tmp_path), str(one / "ring")])
    # the gang's ring checkpoint resumed by one process (2 -> 1)
    (back,) = _gang(script, 1, ["resume", str(tmp_path / "unused"), str(tmp_path), str(two / "ring")])

    step = two / "ring" / "step_00000002"
    files = sorted(os.listdir(step))
    assert [f for f in files if f.startswith("state__.U.")] == [
        "state__.U.shard-0_48-0_8.npy", "state__.U.shard-48_96-0_8.npy"], files
    leaves = restore_checkpoint(str(two / "ring"), ["state__.U", "state__.V"], step=2)
    theirs = jrestore(str(two / "ring"), {k: np.zeros(v.shape, v.dtype) for k, v in leaves.items()}, step=2)
    for k in leaves:
        np.testing.assert_array_equal(np.asarray(theirs[k]), leaves[k])
    for rank in ranks:
        assert 0 < rank["nnz"][0] < rank["nnz"][1]
        for name in ("ring", "ring_async", "allgather", "posterior_merge"):
            for key in ("U", "V", "hist", "rmse"):
                assert rank[name][key] == single[name][key], (name, key)
        assert rank["resume:ck1"]["hist"] == single["ring"]["hist"]
        assert rank["resume:ck1"]["U"] == single["ring"]["U"] and rank["resume:ck1"]["V"] == single["ring"]["V"]
    assert ranks[0]["nnz"][0] + ranks[1]["nnz"][0] >= ranks[0]["nnz"][1]
    for name in ("ring", "ring_async", "allgather", "posterior_merge"):
        assert ranks[0][name]["art"] == single[name]["art"], name
    assert ranks[0]["resume:ck1"]["art"] == single["ring"]["art"]
    for key in ("U", "V", "hist", "art"):
        assert back["resume:ck2"][key] == single["ring"][key], key


@pytest.mark.multidevice
def test_elastic_launcher_restarts_at_one_process_with_the_same_samples(tmp_path):
    common = ["--device", "cpu", "--backend", "ring", "--num-shards", "4", "--users", "96", "--movies", "64",
              "--nnz", "1500", "--K", "8", "--sweeps", "6", "--burn-in", "2", "--sweeps-per-block", "1"]

    def launch(own, fwd):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.multiproc", *own, "--", *common, *fwd],
                           env=_env(), capture_output=True, text=True, timeout=GANG_TIMEOUT_S)
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
        return r.stdout

    ref = launch(["--num-processes", "1"], ["--export-artifact", str(tmp_path / "ref")])
    out = launch(["--num-processes", "2", "--elastic", "--max-restarts", "2", "--timeout", "240"],
                 ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
                  "--inject-failure", "3", "--export-artifact", str(tmp_path / "art")])
    assert "injected failure at sweep 3 on process 1" in out
    assert "elastic restart: 1 processes x 4 shards" in out and "resumed from checkpoint at sweep 2" in out
    assert "restarts=1" in out.splitlines()[-1]
    final = [line for line in out.splitlines() if "final rmse(avg)=" in line]
    assert final and final[-1].split("final ")[1].split(" after")[0] in ref
    for name in sorted(os.listdir(tmp_path / "ref")):
        if os.path.isfile(tmp_path / "ref" / name):
            assert (tmp_path / "art" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), name
    for name in ("U_mean", "V_mean", "U_samples", "V_samples"):
        got = restore_checkpoint(str(tmp_path / "art"), [name])[name]
        np.testing.assert_array_equal(got, restore_checkpoint(str(tmp_path / "ref"), [name])[name])
