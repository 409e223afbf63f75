"""The dry run (``repro_torch.launch.dryrun``, ROADMAP Queue 1 item 11e) against the JAX package's and itself.

Everything runs on the CPU at small sizes, or on the ``meta`` device:

* **plan**: for every arch on both production meshes, ``train_plan``'s
  rules and microbatches, ``default_optimizer``'s moment dtype,
  ``num_params``, ``active_params`` and ``model_flops_global`` of train,
  prefill and decode equal the reference's, computed on a
  ``jax.sharding.AbstractMesh``;
* **shapes**: every leaf of rank 0's train state, batch and caches equals
  the reference's ``NamedSharding(AbstractMesh, spec).shard_shape``; the
  BPMF stand-in's per-shard buckets are the reference's shapes over S;
* **the trace is the program that runs**: for reduced float32 configs on a
  ``(1, 1)`` mesh, the cost model on ``meta`` gives exactly the flops,
  bytes, ops, sites and memory of the same cost model around the real step
  on CPU tensors;
* **flops against the reference's HLO** (``hlo_analysis.analyze`` of the
  compiled one-device step): reduced gemma-2b's train step and prefill
  exactly; reduced mamba2-130m's prefill exactly once the SSD's C·Bᵀ
  product is split out (the reference forms it per head, ``rep = H / G``
  times the port's per-group product), its train step within 6% (the same
  product in the forward and the recompute, and the SSD's backward
  products, which the two sides take in other orders and sizes);
* **wire bytes** equal the reference's ``collective_stats`` and
  ``HloCostModel`` for every op and group size;
* **the BPMF ring**: an abstract rank's permute bytes, times S, equal the
  bytes ``metered_sweep`` counts in one real eager sweep of an S = 8 ring,
  and its Gram flops the kernels' work formula for its buckets;
* **extrapolation**: a deep train cell's counts from depths k and 2k equal
  a full trace; the peak at 2 microbatches is the peak at 4 but for the
  extra microbatches' metric scalars;
* **roofline**: ``roofline.table`` gives the reference's table for an ok
  and a failed cell, the CLI writes the reference's keys, and a failing
  cell exits 1.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when it is
imported; the fixture imports it after jax has its devices and restores
the variable, so no later subprocess inherits 512 devices.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import roofline as ref_roofline  # noqa: E402
from benchmarks_torch import common, fig_merge_comm, roofline  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.hlo_analysis import HloCostModel, analyze  # noqa: E402
from repro.models import module as ref_module  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.training import lm_serve as ref_lm_serve  # noqa: E402
from repro.training import train as ref_train  # noqa: E402
from repro.training.optimizer import AdamW as RefAdamW  # noqa: E402
from repro_torch.bpmf import BPMFEngine  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.registry import ARCHS, ShapeSpec  # noqa: E402
from repro_torch.core.types import BPMFConfig  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch.mesh import bpmf_ring_from, make_production_mesh  # noqa: E402
from repro_torch.models import module  # noqa: E402
from repro_torch.models.collectives import Mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.train import batch_specs  # noqa: E402

MESHES = [False, True]  # multi_pod
REF_MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
F32 = dict(activation_dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``launch/dryrun.py``, imported after jax's init with ``XLA_FLAGS`` restored after."""
    jax.devices()
    with pytest.MonkeyPatch.context() as mp:
        if "XLA_FLAGS" in os.environ:
            mp.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
        else:
            mp.delenv("XLA_FLAGS", raising=False)
        import repro.launch.dryrun as rd
    return rd


def _ref_mesh(multi_pod: bool) -> AbstractMesh:
    return AbstractMesh(*REF_MESHES[multi_pod])


def _ref_rules_name(rules) -> str:
    return next(n for n in ("TRAIN_RULES", "ZERO_RULES", "SERVE_RULES", "DECODE_RULES")
                if getattr(ref_module, n) is rules)


# ---------------------------------------------------------------------------
# plan and shapes against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", MESHES, ids=["pod16x16", "pod2x16x16"])
def test_plan_matches_the_reference(ref_dryrun, multi_pod):
    mesh, rmesh = make_production_mesh(multi_pod), _ref_mesh(multi_pod)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        model, rmodel = build_model(cfg), ref_build_model(rcfg)
        assert (model.num_params(), model.active_params()) == (rmodel.num_params(), rmodel.active_params()), arch
        rules, mb = dryrun.train_plan(cfg, mesh, 256)
        rrules, rmb = ref_dryrun.train_plan(rcfg, rmesh, 256)
        assert (dryrun.rules_name(rules), mb) == (_ref_rules_name(rrules), rmb), arch
        moment = dryrun.default_optimizer(cfg, model.num_params()).moment_dtype
        assert str(moment).replace("torch.", "") == jnp.dtype(
            ref_dryrun.default_optimizer(rcfg, rmodel.num_params()).moment_dtype).name, arch
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            if shape == "decode_32k" and cfg.is_encoder:
                continue
            spec = SHAPES[shape]
            _, _, meta = dryrun.cell_step(arch, shape, mesh)
            factor = {"train": 6.0 * spec.seq_len, "prefill": 2.0 * spec.seq_len, "decode": 2.0}[spec.kind]
            assert meta["model_flops_global"] == factor * rmodel.matmul_params() * spec.global_batch, (arch, shape)
            assert meta["num_params"] == rmodel.num_params(), (arch, shape)


def _shards(ref_shapes, ref_specs, rmesh) -> list[tuple]:
    leaves = jax.tree.leaves(ref_shapes)
    specs = jax.tree.leaves(ref_specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(specs)
    return [tuple(NamedSharding(rmesh, sp).shard_shape(tuple(a.shape))) for a, sp in zip(leaves, specs)]


def _leaf_shapes(tree) -> list[tuple]:
    if isinstance(tree, torch.Tensor):
        return [tuple(tree.shape)]
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree):
        return [s for f in dataclasses.fields(tree) if not isinstance(getattr(tree, f.name), bool)
                for s in _leaf_shapes(getattr(tree, f.name))]
    return [s for k in sorted(tree) for s in _leaf_shapes(tree[k])]


@pytest.mark.parametrize("multi_pod", MESHES, ids=["pod16x16", "pod2x16x16"])
def test_rank0_shapes_match_the_reference(multi_pod):
    mesh, rmesh = make_production_mesh(multi_pod), _ref_mesh(multi_pod)
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        rmodel = ref_build_model(rcfg)
        # train: params and both moments, and the batch's specs
        spec = SHAPES["train_4k"]
        _, (state, _), meta = dryrun.cell_step(arch, "train_4k", mesh)
        rrules = getattr(ref_module, meta["plan"]["rules"])
        rparams = _shards(rmodel.abstract(), rmodel.specs(rrules, rmesh), rmesh)
        assert _leaf_shapes(state.params) == rparams, arch
        assert _leaf_shapes(state.opt.mu) == rparams == _leaf_shapes(state.opt.nu), arch
        want = ref_train.batch_specs(rcfg, rrules, rmesh, spec.global_batch, spec.seq_len)
        got = batch_specs(cfg, getattr(module, meta["plan"]["rules"]), mesh, spec.global_batch, spec.seq_len)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, arch
        # caches under SERVE_RULES (prefill) and DECODE_RULES (decode)
        for shape, rules_name in (("prefill_32k", "SERVE_RULES"), ("decode_32k", "DECODE_RULES")):
            if cfg.is_encoder:
                continue
            spec = SHAPES[shape]
            _, args, _ = dryrun.cell_step(arch, shape, mesh)
            rrules = getattr(ref_module, rules_name)
            rm = ref_build_model(rcfg.replace(flash_q_parallel=True)) if shape == "prefill_32k" else rmodel
            want = _shards(rm.abstract_cache(spec.global_batch, spec.seq_len),
                           rm.cache_specs(rrules, rmesh, spec.global_batch, spec.seq_len), rmesh)
            assert _leaf_shapes(args[2]) == want, (arch, shape)
            assert _leaf_shapes(args[0]) == _shards(rm.abstract(), rm.specs(rrules, rmesh), rmesh), (arch, shape)


def test_abstract_bpmf_data_is_the_reference_shard(ref_dryrun):
    S, K = 16, 8
    ref = ref_dryrun.abstract_bpmf_data(S, 5_000, 300, 40_000, K)
    for rank in (0, 5):
        got = dryrun.abstract_bpmf_data(S, 5_000, 300, 40_000, K, rank=rank)
        for side in ("users", "movies"):
            rs, ps = getattr(ref, side), getattr(got, side)
            assert (ps.cap, ps.num_items, ps.shard_offset) == (rs.cap, rs.num_items, rank)
            assert tuple(ps.orig_ids[0].shape) == (rs.orig_ids.shape[0] // S,)
            for rstep, pstep in zip(rs.steps, ps.steps, strict=True):
                for rb, pb in zip(rstep, pstep[0], strict=True):
                    for f in ("item_ids", "nbr", "val", "nnz"):
                        r_shape = getattr(rb, f).shape
                        assert tuple(getattr(pb, f).shape) == (r_shape[0] // S, *r_shape[1:]), (side, f)
        assert tuple(got.test.rows.shape) == ref.test.rows.shape


# ---------------------------------------------------------------------------
# the trace on meta is the program that runs
# ---------------------------------------------------------------------------

TRACE_CASES = [("gemma-2b", "train"), ("gemma-2b", "prefill"), ("gemma-2b", "decode"),
               ("minicpm3-4b", "prefill"), ("mixtral-8x22b", "train"), ("mamba2-130m", "decode"),
               ("zamba2-2.7b", "decode"), ("hubert-xlarge", "prefill")]
SMALL = {"train": ShapeSpec("t", 16, 4, "train"), "prefill": ShapeSpec("p", 16, 2, "prefill"),
         "decode": ShapeSpec("d", 16, 2, "decode")}


def _real_args(args, cfg, seed: int = 0):
    """CPU tensors in place of the ``meta`` arguments: params from the model's init, the rest seeded."""
    gen = torch.Generator().manual_seed(seed)

    def real(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, min(cfg.vocab_size, 8), tuple(t.shape), generator=gen, dtype=t.dtype)
        if t.dtype == torch.bool:
            return torch.zeros(tuple(t.shape), dtype=torch.bool)
        return (0.02 * torch.randn(tuple(t.shape), generator=gen)).to(t.dtype)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return real(x)
        if x is None or isinstance(x, (bool, int, float)):
            return x
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return {k: walk(v) for k, v in x.items()}

    return tuple(walk(a) for a in args)


@pytest.mark.parametrize("arch,kind", TRACE_CASES, ids=[f"{a}-{k}" for a, k in TRACE_CASES])
def test_meta_trace_equals_the_real_cpu_step(arch, kind):
    cfg = get_config(arch).reduced().replace(**F32)
    mesh = Mesh.abstract((1, 1), ("data", "model"))
    shape = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    kw = dict(cfg=cfg, spec=SMALL[kind], microbatches=2 if kind == "train" else None)
    step, args, _ = dryrun.cell_step(arch, shape, mesh, loss_chunk=8, **kw)
    _, meta_cost = dryrun.trace(step, *args)
    step, _, _ = dryrun.cell_step(arch, shape, mesh, loss_chunk=8, **kw)
    real = _real_args(args, cfg)
    if kind == "decode":  # a decode step at position 5 of a filled cache
        real = real[:3] + (torch.tensor(5, dtype=torch.int32),)
    _, cpu_cost = dryrun.trace(step, *real)
    assert meta_cost.ops == cpu_cost.ops > 0
    assert (meta_cost.flops, meta_cost.bytes) == (cpu_cost.flops, cpu_cost.bytes)
    assert meta_cost.flops_by_site == cpu_cost.flops_by_site
    assert meta_cost.bytes_by_site == cpu_cost.bytes_by_site
    assert meta_cost.memory() == cpu_cost.memory()


# ---------------------------------------------------------------------------
# flops against the reference's compiled HLO
# ---------------------------------------------------------------------------


def _hlo_flops(arch: str, kind: str, B: int, L: int) -> dict:
    rcfg = ref_get_config(arch).reduced().replace(num_layers=2, **F32)
    jm = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rm = ref_build_model(rcfg)
    if kind == "train":
        opt = RefAdamW()
        fn = jax.jit(ref_train.make_train_step(rm, opt, ref_module.TRAIN_RULES, jm))
        lowered = fn.lower(ref_train.abstract_train_state(rm, opt), ref_train.abstract_batch(rcfg, B, L))
    else:
        fn = jax.jit(ref_lm_serve.make_prefill_step(rm, ref_module.SERVE_RULES, jm))
        lowered = fn.lower(rm.abstract(), jax.ShapeDtypeStruct((B, L), jnp.int32), rm.abstract_cache(B, L))
    return analyze(lowered.compile().as_text(), top_sites=50)


def _port_flops(arch: str, kind: str, B: int, L: int) -> op_analysis.OpCostModel:
    cfg = get_config(arch).reduced().replace(num_layers=2, **F32)
    mesh = Mesh.abstract((1, 1), ("data", "model"))
    shape = "train_4k" if kind == "train" else "prefill_32k"
    # the reference's prefill here runs without flash_q_parallel: at one rank there is nothing to split
    step, args, _ = dryrun.cell_step(arch, shape, mesh, cfg=cfg, spec=ShapeSpec("s", L, B, kind), microbatches=1)
    return dryrun.trace(step, *args)[1]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_attention_flops_equal_the_reference_hlo(kind):
    B, L = 2, 64
    ref, port = _hlo_flops("gemma-2b", kind, B, L), _port_flops("gemma-2b", kind, B, L)
    assert port.flops == ref["flops"] > 0  # tolerance 0: the same dots on both sides


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_ssm_flops_against_the_reference_hlo(kind):
    B, L = 2, 64
    ref, port = _hlo_flops("mamba2-130m", kind, B, L), _port_flops("mamba2-130m", kind, B, L)
    cfg = get_config("mamba2-130m").reduced()
    rep = cfg.ssm_heads // cfg.ssm_ngroups
    if kind == "prefill":
        # the gap is one term: C·Bᵀ, per head in the reference, per group here; compared on its own
        ref_cb = sum(v for k, v in ref["top_flop_sites"] if "bihn,bjhn->bijh" in k)
        port_cb = sum(v for k, v in port.flops_by_site.items() if k.startswith("models/mamba2.py:ssd_chunked")
                      and k.endswith(":bmm") and _is_cb_site(k))
        assert ref_cb == rep * port_cb > 0
        assert ref["flops"] - ref_cb == port.flops - port_cb
    else:
        # 5.86% below the reference here: the same C·Bᵀ term in the forward and the recompute, and the
        # SSD's backward products, which the two sides take in different orders and sizes (not split)
        assert abs(port.flops / ref["flops"] - 1.0) < 0.06


def _is_cb_site(site: str) -> bool:
    import inspect

    from repro_torch.models import mamba2

    lines, start = inspect.getsourcelines(mamba2.ssd_chunked)
    cb_line = start + next(i for i, s in enumerate(lines) if "CB = Cg @ Bg" in s)
    return site.split(":")[2] == str(cb_line)


# ---------------------------------------------------------------------------
# collectives: wire bytes
# ---------------------------------------------------------------------------


def test_wire_bytes_equal_the_reference_formulas(ref_dryrun):
    ops = {"all-gather": "all-gather", "all-reduce": "all-reduce", "reduce-scatter": "reduce-scatter",
           "all-to-all": "all-to-all", "collective-permute": "collective-permute"}
    for op in ops:
        for S in (1, 2, 4, 16, 256):
            result = 4096
            line = f"  %c = f32[{result // 4}]{{0}} {op}(f32[64]{{0}} %x), replica_groups=[1,{S}]<=[{S}]"
            got = op_analysis.wire_bytes(op, result, S)
            hlo = HloCostModel("ENTRY %e () -> f32[] {\n" + line + "\n}\n")
            assert got == hlo._collective(hlo.comps["e"].ops[0])[1], (op, S)
            if S > 1:
                assert got == ref_dryrun.collective_stats(line)["by_op"][op]["wire_bytes"], (op, S)
    # a payload's result: gathered S times, scattered to one block, else itself
    assert op_analysis.result_bytes("all-gather", 64, 4) == 256
    assert op_analysis.result_bytes("reduce-scatter", 64, 4) == 16
    assert op_analysis.result_bytes("all-reduce", 64, 4) == 64


def test_abstract_groups_have_the_shapes_and_record_the_payloads():
    from repro_torch.models import collectives

    mesh = Mesh.abstract((2, 4), ("data", "model"), rank=6)
    g = mesh.group(("model",))
    assert (g.size, g.index, g.members, g.abstract) == (4, 2, (4, 5, 6, 7), True)
    x = torch.empty(3, 8, dtype=torch.bfloat16, device="meta")
    before = dict(collectives.STATS)
    with op_analysis.OpCostModel() as cost:
        assert collectives.gather_raw(x, 1, g).shape == (3, 32)
        assert collectives.reduce_raw(x, g).shape == (3, 8)
        assert collectives.reduce_scatter_raw(x, 1, g).shape == (3, 2)
    assert collectives.STATS == before  # nothing really ran
    assert [(c["op"], c["payload_bytes"]) for c in cost.collectives] == [
        ("all-gather", 48), ("all-reduce", 48), ("reduce-scatter", 48)]
    assert all(c["node_local"] for c in cost.collectives)  # ranks 4..7 share a node
    wide = Mesh.abstract((2, 8), ("data", "model"), rank=3)
    assert wide.group(("data",)).members == (3, 11)  # two nodes of 8 ranks
    assert op_analysis.node_local(wide.group(("model",)).members)
    assert not op_analysis.node_local(wide.group(("data",)).members)


# ---------------------------------------------------------------------------
# the BPMF ring
# ---------------------------------------------------------------------------


def test_bpmf_ring_permute_bytes_and_gram_flops():
    w = fig_merge_comm.workload(smoke=True)
    cfg = fig_merge_comm.base_config(w).replace(name="ring", num_sweeps=1)
    engine = BPMFEngine(cfg, device="cpu")
    engine.prepare(fig_merge_comm.load_task(w))
    S = engine.backend.ring.num_shards
    meter = common.metered_sweep(engine)
    core = BPMFConfig(K=w["K"], comm_mode="ring", gram_impl="auto")
    for rank in (S - 1,):
        ring = bpmf_ring_from(Mesh.abstract((S,), ("ring",), rank=rank))
        data = dryrun.abstract_shard_of(engine.backend.data, rank)
        sweep, args = dryrun.bpmf_sweep(ring, data, core)
        _, cost = dryrun.trace(sweep, *args)
        permute = [c for c in cost.collectives if c["op"] == "collective-permute"]
        assert len(permute) == 2 * (S - 1)
        assert S * sum(c["payload_bytes"] for c in permute) == meter["rotate_bytes"] > 0
        assert ring.rotation_bytes_sent * S == meter["rotate_bytes"]
        # the fused kernel's work for every (side, step) layout of this shard: every slot a rating
        K = w["K"]
        want = 0.0
        for side in (data.users, data.movies):
            for per_step in side.steps:
                C = sum(b.B * -(-b.P // 128) for b in per_step[0])
                want += -(-C // 8) * 8 * 128 * K * (K + 3)
        got = sum(v for k, v in cost.flops_by_site.items() if k.startswith("kernel:"))
        assert got == want > 0


# ---------------------------------------------------------------------------
# deep train cells: extrapolation
# ---------------------------------------------------------------------------


def test_extrapolation_equals_a_full_trace():
    cfg = get_config("gemma-2b").reduced().replace(num_layers=3, **F32)
    mesh = Mesh.abstract((2, 2), ("data", "model"))
    spec = ShapeSpec("t", 16, 12, "train")  # 12 rows over 4 ranks: 3 microbatches
    assert dryrun.train_plan(cfg, mesh, spec.global_batch)[1] == 3
    ext, meta = dryrun.trace_train_extrapolated("gemma-2b", "train_4k", mesh, loss_chunk=8, cfg=cfg, spec=spec)
    assert meta["extrapolated"] == {"depths": [1, 2], "layers": 3, "peak_microbatches": 2}
    full, _ = dryrun.lower_cell("gemma-2b", "train_4k", mesh, loss_chunk=8, cfg=cfg, spec=spec)
    assert (ext.flops, ext.bytes, ext.ops) == (full.flops, full.bytes, full.ops)
    assert ext.flops_by_site == full.flops_by_site and ext.bytes_by_site == full.bytes_by_site
    assert ext.coll_by_site == full.coll_by_site
    assert ext.coll_by_op == {op: {k: v for k, v in d.items()} for op, d in full.coll_by_op.items()}
    assert dryrun.Counts(ext).groups == dryrun.Counts(full).groups
    # the peak (never extrapolated), traced at full depth over 2 microbatches of the cell's size: from
    # the second on each holds the same tensors, and each further one keeps only its metrics' scalars
    got, want = ext.memory(), full.memory()
    assert got["argument_bytes"] == want["argument_bytes"] and got["output_bytes"] == want["output_bytes"]
    assert 0 <= want["peak_bytes_est"] - got["peak_bytes_est"] <= 16 * 4


# ---------------------------------------------------------------------------
# roofline and the CLI
# ---------------------------------------------------------------------------


def test_roofline_table_and_cli(ref_dryrun, tmp_path, monkeypatch):
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out-dir", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k", "--out-dir", str(tmp_path)]) == 1
    ok = json.loads((tmp_path / "pod16x16" / "gemma-2b__decode_32k.json").read_text())
    bad = json.loads((tmp_path / "pod16x16" / "no-such-arch__decode_32k.json").read_text())
    assert (ok["status"], bad["status"]) == ("ok", "error") and "Traceback" in bad["traceback"]
    # the reference's keys, with lower_s and compile_s as trace_s and no xla_cost_analysis
    top = {"arch", "shape", "kind", "global_batch", "seq_len", "num_params", "active_params",
           "model_flops_global", "mesh", "num_devices", "status", "trace_s", "roofline"}
    roof = {"compute_s", "memory_s", "collective_s", "dominant", "hlo_flops_per_device", "hlo_bytes_per_device",
            "collectives", "model_flops_per_device", "useful_flops_ratio", "memory", "fits_hbm",
            "roofline_fraction"}
    assert top <= set(ok) and roof <= set(ok["roofline"])
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes_est"} == set(
        ok["roofline"]["memory"])
    assert {"by_op", "wire_bytes_per_device"} <= set(ok["roofline"]["collectives"])
    assert ok["num_devices"] == 256 and ok["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    rows, md = roofline.table("pod16x16", str(tmp_path))
    monkeypatch.setattr(ref_roofline, "DRYRUN_DIR", str(tmp_path))
    ref_rows, ref_md = ref_roofline.table("pod16x16")
    assert md == ref_md and [r["status"] for r in rows] == [r["status"] for r in ref_rows] == ["ok", "error"]
