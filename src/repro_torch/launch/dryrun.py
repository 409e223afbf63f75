"""Dry run: every (architecture x input shape) cell, and the BPMF ring, traced for one rank of a production mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all                  # 16x16 mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod      # 2x16x16 mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch bpmf --shape ring   # the paper's own program

The counterpart of ``repro.launch.dryrun``, with its names, flags and
output keys. The reference lowers and compiles each cell with 512 fake XLA
host devices and reads its roofline terms from the partitioned HLO. Here
each cell's real step is built as a run on the mesh builds it
(``make_train_step(..., rules=, mesh=)`` with its microbatches and
``loss_chunk``; ``make_prefill_step`` with ``flash_q_parallel``;
``make_decode_step`` under ``DECODE_RULES`` at temperature 0), over
``Mesh.abstract`` of the production shape seen from one rank (``--rank``,
default 0), on that rank's shards as ``meta`` tensors, and run once under
the op-level cost model (:mod:`repro_torch.launch.op_analysis`). Nothing
is allocated and no card is needed. The step is SPMD (every rank runs the
same program on same-shaped shards), so one rank's trace gives the
per-device terms; its collectives return their group's shapes and move
nothing. What surfaces here is what surfaces in the reference's: sharding
mismatches, memory that does not fit, a host read inside a step (an op
that cannot run on ``meta``).

The steps take the whole batch and return whole outputs (the port's steps
over a mesh), so ``argument_bytes`` counts the whole batch where the
reference's counts a shard.

Results land in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``
(``lower_s`` and ``compile_s`` become ``trace_s``; the reference's
``xla_cost_analysis`` has no counterpart) and feed
``benchmarks_torch/roofline.py``. A failing cell is written with
``status: error`` and its traceback, and ``main`` returns 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.registry import ShapeSpec, cell_runnable
from repro_torch.launch.mesh import bpmf_ring_from, make_production_mesh
from repro_torch.launch.op_analysis import OpCostModel, analyze
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel, build_model
from repro_torch.models.module import (
    DECODE_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    ZERO_RULES,
    ShardingRules,
    resolve_spec,
)
from repro_torch.training.lm_serve import make_decode_step, make_prefill_step
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import abstract_batch, abstract_train_state, make_train_step

# NVIDIA H100 80GB HBM3 (SXM), the card chip_smoke.py reports, at its 700 W
# limit; datasheet figures, per card: dense bf16 tensor-core peak, HBM3
# bandwidth and capacity; NVLink 4 (450 GB/s each direction) inside a node
# of 8 cards; one 400 Gb/s network adapter per card across nodes.
H100 = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "hbm_bytes": 80e9, "nvlink_bw": 450e9, "net_bw": 50e9}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")
TOP_SITES = 10


# ---------------------------------------------------------------------------
# Optimizer / rules defaults
# ---------------------------------------------------------------------------


def default_optimizer(cfg: ModelConfig, num_params: int) -> AdamW:
    """bf16 moments above 50B params, the reference's HBM fit for nemotron and grok."""
    moment_dtype = torch.bfloat16 if num_params > 50e9 else torch.float32
    return AdamW(learning_rate=1e-4, moment_dtype=moment_dtype)


def train_plan(cfg: ModelConfig, mesh: Any, global_batch: int) -> tuple[ShardingRules, int]:
    """(rules, microbatches) for a train cell, as the reference plans them.

    Small and medium dense, SSM, hybrid and encoder configs train under
    ``ZERO_RULES`` (batch over every axis, weights gathered at use); MoE
    and dense configs with more than 1.5 GB of bf16 weights a layer under
    ``TRAIN_RULES``. Microbatches give each rank one sequence per
    microbatch under the batch split the mesh resolves (a quarter as many
    for MoE).
    """
    model = build_model(cfg)
    per_layer_bytes = 2 * (model.num_params() - cfg.padded_vocab * cfg.d_model) / max(cfg.num_layers, 1)
    rules = TRAIN_RULES if (cfg.num_experts or per_layer_bytes > 1.5e9) else ZERO_RULES
    names = resolve_spec((global_batch,), ("batch",), rules, mesh).axes(0)
    ways = math.prod(mesh.shape[n] for n in names)
    mb = max(1, global_batch // max(ways, 1))
    if cfg.num_experts:
        mb = max(1, mb // 4)
    return rules, mb


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------


def rules_name(rules: ShardingRules) -> str:
    """The name of one of the four rule tables (``"custom"`` for another)."""
    names = {id(r): n for n, r in (("TRAIN_RULES", TRAIN_RULES), ("ZERO_RULES", ZERO_RULES),
                                   ("SERVE_RULES", SERVE_RULES), ("DECODE_RULES", DECODE_RULES))}
    return names.get(id(rules), "custom")


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_tokens(cfg: ModelConfig, B: int, L: int) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        return _meta((B, L), torch.int32)
    return _meta((B, L, cfg.frame_dim), torch.bfloat16)


def trace(fn, *args) -> tuple[Any, OpCostModel]:
    """Run ``fn(*args)`` once under an :class:`OpCostModel` (``args``: the step's arguments); (result, model)."""
    with OpCostModel() as cost:
        cost.arguments(*args)
        out = fn(*args)
        cost.outputs(out)
    return out, cost


def cell_step(arch: str, shape_name: str, mesh: Any, loss_chunk: int = 512,
              rules_train: ShardingRules | None = None, microbatches: int | None = None,
              rules_serve: ShardingRules = SERVE_RULES, cfg: ModelConfig | None = None,
              spec: ShapeSpec | None = None) -> tuple:
    """(step, its abstract arguments, meta) of one cell, as a run on ``mesh`` builds them.

    ``cfg`` overrides the registry's config and ``spec`` the shape (a cut
    depth, a reduced config, a small batch); the meta then counts theirs.
    """
    cfg = cfg or get_config(arch)
    spec = spec or SHAPES[shape_name]
    model = build_model(cfg)
    B, L = spec.global_batch, spec.seq_len
    n_params = model.num_params()
    plan: dict = {}
    if spec.kind == "train":
        plan_rules, plan_mb = train_plan(cfg, mesh, B)
        rules = rules_train or plan_rules
        mb = microbatches or plan_mb
        opt = default_optimizer(cfg, n_params)
        step = make_train_step(model, opt, mb, loss_chunk=loss_chunk, rules=rules, mesh=mesh)
        args = (abstract_train_state(model, opt, rules, mesh), abstract_batch(cfg, B, L))
        model_flops = 6.0 * model.matmul_params() * B * L
        plan = {"rules": rules_name(rules), "microbatches": mb, "moment_dtype": str(opt.moment_dtype).replace("torch.", "")}
    elif spec.kind == "prefill":
        cfg = cfg.replace(flash_q_parallel=True)
        model = build_model(cfg)
        params = _abstract_params(model, rules_serve, mesh)
        if cfg.is_encoder:
            ctx = model.ctx(rules_serve, mesh).with_batch(B)

            @torch.no_grad()
            def step(p, x):
                return model.forward(p, ctx.rows(x), ctx=ctx)[0]

            args = (params, _abstract_tokens(cfg, B, L))
        else:
            step = make_prefill_step(model, rules_serve, mesh, L)
            cache = model.abstract_cache(B, L, model.ctx(rules_serve, mesh).with_batch(B, L))
            args = (params, _abstract_tokens(cfg, B, L), cache)
        model_flops = 2.0 * model.matmul_params() * B * L
        plan = {"rules": rules_name(rules_serve)}
    elif spec.kind == "decode":
        rules = DECODE_RULES if rules_serve is SERVE_RULES else rules_serve
        step = make_decode_step(model, rules=rules, mesh=mesh, max_len=L)
        cache = model.abstract_cache(B, L, model.ctx(rules, mesh).with_batch(B, L))
        args = (_abstract_params(model, rules, mesh), _abstract_tokens(cfg, B, 1), cache, _meta((), torch.int32))
        model_flops = 2.0 * model.matmul_params() * B
        plan = {"rules": rules_name(rules)}
    else:
        raise ValueError(spec.kind)
    meta = {
        "arch": arch, "shape": shape_name, "kind": spec.kind,
        "global_batch": B, "seq_len": L,
        "num_params": n_params, "active_params": model.active_params(),
        "model_flops_global": model_flops, "num_layers": cfg.num_layers, "rank": mesh.rank, "plan": plan,
    }
    return step, args, meta


def _abstract_params(model: LMModel, rules: ShardingRules, mesh: Any) -> Any:
    return abstract_train_state(model, AdamW(), rules, mesh).params


def lower_cell(arch: str, shape_name: str, mesh: Any, loss_chunk: int = 512,
               rules_train: ShardingRules | None = None, microbatches: int | None = None,
               rules_serve: ShardingRules = SERVE_RULES, cfg: ModelConfig | None = None,
               spec: ShapeSpec | None = None) -> tuple[OpCostModel, dict]:
    """Build and trace one (arch x shape) cell on ``mesh`` (this traces; nothing compiles). Returns (cost, meta)."""
    step, args, meta = cell_step(arch, shape_name, mesh, loss_chunk, rules_train, microbatches, rules_serve, cfg,
                                 spec)
    _, cost = trace(step, *args)
    return cost, meta


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


def collective_seconds(cost: OpCostModel) -> float:
    """Each collective's wire bytes over NVLink when its group lies in one node, else over the network."""
    return sum(c["wire_bytes"] / (H100["nvlink_bw"] if c["node_local"] else H100["net_bw"])
               for c in cost.collectives)


def roofline_terms(cost: OpCostModel, meta: dict, num_devices: int) -> dict:
    """The reference's roofline terms from one rank's trace, at the H100's datasheet rates."""
    res = analyze(cost, TOP_SITES)
    flops, nbytes = float(res["flops"]), float(res["bytes"])
    terms = {
        "compute_s": flops / H100["peak_flops"],
        "memory_s": nbytes / H100["hbm_bw"],
        "collective_s": collective_seconds(cost),
    }
    dominant = max(terms, key=terms.get)
    model_flops_dev = meta["model_flops_global"] / num_devices
    mem = cost.memory()
    return {
        **terms,
        "dominant": dominant,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "collectives": {"by_op": res["collectives_by_op"], "wire_bytes_per_device": res["collective_wire_bytes"],
                        "nvlink_wire_bytes": sum(c["wire_bytes"] for c in cost.collectives if c["node_local"]),
                        "network_wire_bytes": sum(c["wire_bytes"] for c in cost.collectives if not c["node_local"])},
        "model_flops_per_device": model_flops_dev,
        "useful_flops_ratio": (model_flops_dev / flops) if flops > 0 else None,
        "memory": mem,
        "fits_hbm": mem["peak_bytes_est"] <= H100["hbm_bytes"],
        "roofline_fraction": (model_flops_dev / H100["peak_flops"]) / max(max(terms.values()), 1e-30),
        "ops": res["ops"],
        "top_flop_sites": res["top_flop_sites"],
        "top_byte_sites": res["top_byte_sites"],
        "top_coll_sites": res["top_coll_sites"],
    }


# ---------------------------------------------------------------------------
# Deep train cells: the layers traced at two depths, the update and the peak at full depth
# ---------------------------------------------------------------------------

#: a train cell with more than this many (layer x microbatch) passes is traced at two cut depths
EXTRAPOLATE_ABOVE = 128
PEAK_MICROBATCHES = 2


def _period(cfg: ModelConfig) -> int:
    """The layers of one repeat of the stack: a layer (the hybrid's segment), times the remat group."""
    seg = cfg.shared_attn_every if cfg.family == "hybrid" else 1
    return seg * max(cfg.remat_group, 1)


def extrapolates(cfg: ModelConfig, mesh: Any, shape_name: str, spec: ShapeSpec | None = None) -> bool:
    """Whether the cell is a train cell deep enough to be traced at two cut depths."""
    spec = spec or SHAPES[shape_name]
    if spec.kind != "train":
        return False
    _, mb = train_plan(cfg, mesh, spec.global_batch)
    return cfg.num_layers * mb > EXTRAPOLATE_ABOVE and cfg.num_layers > 2 * _period(cfg)


class Counts:
    """A trace's additive counts: flops, bytes, ops, per-site sums and collectives by group.

    Collectives are kept by (op, axes, size, node-local) as count, payload
    and wire bytes, which grow linearly with the layers where single calls'
    payloads do not key alike.
    """

    def __init__(self, cost: Any = None):
        self.flops = float(cost.flops) if cost is not None else 0.0
        self.bytes = float(cost.bytes) if cost is not None else 0.0
        self.ops = float(cost.ops) if cost is not None else 0.0
        self.sites = {name: dict(getattr(cost, name)) if cost is not None else {}
                      for name in ("flops_by_site", "bytes_by_site", "coll_by_site")}
        self.groups: dict[tuple, list[float]] = {}
        for c in cost.collectives if cost is not None else ():
            g = self.groups.setdefault((c["op"], tuple(c["axes"]), c["size"], c["node_local"]), [0.0, 0.0, 0.0])
            g[0] += c.get("count", 1)
            g[1] += c["payload_bytes"]
            g[2] += c["wire_bytes"]

    def plus(self, other: "Counts", a: float = 1.0) -> "Counts":
        """``self + a * other``, key by key."""
        out = Counts()
        out.flops, out.bytes, out.ops = (self.flops + a * other.flops, self.bytes + a * other.bytes,
                                         self.ops + a * other.ops)
        for name in self.sites:
            mine, theirs = self.sites[name], other.sites[name]
            out.sites[name] = {k: v for k in {**mine, **theirs}
                               if (v := mine.get(k, 0.0) + a * theirs.get(k, 0.0))}
        for key in {**self.groups, **other.groups}:
            mine, theirs = self.groups.get(key, [0.0] * 3), other.groups.get(key, [0.0] * 3)
            v = [m + a * t for m, t in zip(mine, theirs)]
            if any(v):
                out.groups[key] = v
        return out


class ExtrapolatedCost:
    """An :class:`OpCostModel`'s results for a deep train step, from traces at depths k and 2k.

    ``loss_and_grads`` grows linearly with the layers of a homogeneous
    stack, so its counts at depth L are ``c(k) + (L / k - 1) (c(2k) -
    c(k))``, the reference's "body x trip count". The optimizer update
    (whose chunking does not grow linearly) and the step counter are
    traced at full depth. The peak is never extrapolated: ``memory`` comes
    from a trace of the whole step at full depth.
    """

    def __init__(self, at_k: Counts, at_2k: Counts, tail: Counts, layers: int, k: int, memory: dict):
        total = at_k.plus(at_2k.plus(at_k, -1.0), layers / k - 1).plus(tail)
        self.flops, self.bytes, self.ops = total.flops, total.bytes, int(round(total.ops))
        self.flops_by_site = total.sites["flops_by_site"]
        self.bytes_by_site = total.sites["bytes_by_site"]
        self.coll_by_site = total.sites["coll_by_site"]
        self.collectives = [{"op": op, "axes": list(axes), "size": size, "node_local": local,
                             "count": int(round(n)), "payload_bytes": int(round(p)), "wire_bytes": w}
                            for (op, axes, size, local), (n, p, w) in sorted(total.groups.items())]
        self.coll_by_op: dict[str, dict] = {}
        for c in self.collectives:
            d = self.coll_by_op.setdefault(c["op"], {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
            for f in d:
                d[f] += c[f]
        self.coll_wire_bytes = sum(c["wire_bytes"] for c in self.collectives)
        self._memory = memory

    def memory(self) -> dict:
        """The full-depth step's memory (``OpCostModel.memory``)."""
        return self._memory


def _meta_like(tree: Any, dtype: torch.dtype | None) -> Any:
    from repro_torch.training.optimizer import tree_map

    return tree_map(lambda p: _meta(tuple(p.shape), dtype or p.dtype), tree)


def trace_train_extrapolated(arch: str, shape_name: str, mesh: Any, loss_chunk: int = 512,
                             cfg: ModelConfig | None = None, spec: ShapeSpec | None = None,
                             ) -> tuple[ExtrapolatedCost, dict]:
    """A deep train cell: ``loss_and_grads`` at depths k and 2k, the update, the counter and the peak at full depth."""
    from repro_torch.training.train import apply_update, loss_and_grads

    cfg = cfg or get_config(arch)
    spec = spec or SHAPES[shape_name]
    B, L = spec.global_batch, spec.seq_len
    rules, mb = train_plan(cfg, mesh, B)
    opt = default_optimizer(cfg, build_model(cfg).num_params())
    k = _period(cfg)

    def grads_at(depth: int) -> Counts:
        model = build_model(cfg.replace(num_layers=depth))
        ctx, specs = model.ctx(rules, mesh), model.specs(rules, mesh)
        _, cost = trace(lambda s, b: loss_and_grads(model, s.params, b, mb, 1e-4, loss_chunk, ctx, specs),
                        abstract_train_state(model, opt, rules, mesh), abstract_batch(cfg, B, L))
        return Counts(cost)

    at_k, at_2k = grads_at(k), grads_at(2 * k)
    model = build_model(cfg)
    ctx, specs = model.ctx(rules, mesh), model.specs(rules, mesh)
    state = abstract_train_state(model, opt, rules, mesh)
    grads = _meta_like(state.params, torch.float32 if mb > 1 else None)

    _, upd = trace(lambda g, s: apply_update(opt, g, s, ctx, specs), grads, state)
    # the peak: the whole step at full depth over PEAK_MICROBATCHES microbatches of the cell's own size
    # (from the second on, each holds the same tensors), with the whole batch as its argument
    _, full_args, meta = cell_step(arch, shape_name, mesh, loss_chunk, cfg=cfg, spec=spec)
    peak_mb = min(mb, PEAK_MICROBATCHES)
    cut = dataclasses.replace(spec, global_batch=peak_mb * (B // mb))
    step, args, _ = cell_step(arch, shape_name, mesh, loss_chunk, rules, peak_mb, cfg=cfg, spec=cut)
    _, whole = trace(step, *args)
    meta["extrapolated"] = {"depths": [k, 2 * k], "layers": cfg.num_layers, "peak_microbatches": peak_mb}
    memory = whole.memory(OpCostModel().arguments(*full_args))
    return ExtrapolatedCost(at_k, at_2k, Counts(upd), cfg.num_layers, k, memory), meta


# ---------------------------------------------------------------------------
# BPMF dry run (the paper's own program on the production mesh)
# ---------------------------------------------------------------------------


def abstract_bpmf_data(num_shards: int, num_users: int, num_movies: int, nnz: int, K: int,
                       pads=(32, 128, 512), steps_with_work: int = 8, rank: int = 0):
    """This rank's shard of the reference's stand-in ``DistBPMFData``, as ``meta`` tensors.

    Bucket shapes follow the reference's workload model for a ChEMBL-like
    skew: at each of the first ``steps_with_work`` ring steps one bucket
    per pad of ``max(8, nnz / S / (steps_with_work * pad * len(pads)))``
    rows (rounded up to 8), and one ``[8, pads[0]]`` bucket at every later
    step. The reference's arrays stack the S shards' blocks (``[S * B,
    ...]``); a shard holds ``[B, ...]`` of them. No host build is made.
    """
    from repro_torch.core.distributed import DistBPMFData, DistTestSet, RingSide
    from repro_torch.core.types import Bucket

    S = num_shards

    def bucket(rows: int, pad: int) -> Bucket:
        return Bucket(item_ids=_meta((rows,), torch.int32), nbr=_meta((rows, pad), torch.int32),
                      val=_meta((rows, pad), torch.float32), nnz=_meta((rows,), torch.int32))

    def side(num_items: int, nnz_side: int) -> RingSide:
        cap = -(-num_items // S)
        per_shard_nnz = nnz_side // S
        steps = []
        for t in range(S):
            if t < steps_with_work:
                rows = [-(-max(8, per_shard_nnz // (steps_with_work * pad * len(pads))) // 8) * 8 for pad in pads]
                steps.append(((tuple(bucket(r, p) for r, p in zip(rows, pads))),))
            else:
                steps.append(((bucket(8, pads[0]),),))
        return RingSide(steps=tuple(steps), orig_ids=(_meta((cap,), torch.int32),), cap=cap,
                        num_items=num_items, shard_offset=rank)

    T = 10000
    return DistBPMFData(
        users=side(num_users, nnz), movies=side(num_movies, nnz),
        test=DistTestSet(rows=_meta((T,), torch.int32), cols=_meta((T,), torch.int32),
                         vals=_meta((T,), torch.float32)),
        mean_rating=_meta((), torch.float32), num_shards=S, min_rating=1.0, max_rating=5.0,
    )


def abstract_shard_of(data: Any, rank: int) -> Any:
    """Shard ``rank`` of a whole ring's ``DistBPMFData`` (one process, all S shards) as ``meta`` tensors.

    The same bucket, id and test shapes, no plans and no values: what a
    rank of that ring would hold, for :func:`bpmf_sweep`.
    """
    meta_like = lambda t: _meta(tuple(t.shape), t.dtype)  # noqa: E731

    def bucket(b):
        return dataclasses.replace(b, **{f.name: meta_like(getattr(b, f.name)) for f in dataclasses.fields(b)})

    def side(s):
        return dataclasses.replace(s, steps=tuple((tuple(bucket(b) for b in per_step[rank]),) for per_step in s.steps),
                                   orig_ids=(meta_like(s.orig_ids[rank]),), plans=(), shard_offset=rank)

    test = dataclasses.replace(data.test, **{f: meta_like(getattr(data.test, f)) for f in ("rows", "cols", "vals")})
    return dataclasses.replace(data, users=side(data.users), movies=side(data.movies), test=test,
                               mean_rating=meta_like(data.mean_rating))


def bpmf_sweep(ring: Any, data: Any, cfg: Any) -> tuple:
    """(sweep, its abstract arguments) of one distributed Gibbs sweep of ``data`` on an abstract ``ring``."""
    from repro_torch.core.distributed import DistState, _sweep_step, place_data
    from repro_torch.core.prediction import PredictionState
    from repro_torch.core.types import HyperParams

    data = place_data(data, ring, cfg)
    K = cfg.K
    hyper = lambda: HyperParams(mu=_meta((K,), torch.float32), Lam=_meta((K, K), torch.float32))  # noqa: E731
    state = DistState(U=(_meta((data.users.cap, K), torch.float32),), V=(_meta((data.movies.cap, K), torch.float32),),
                      hyper_U=hyper(), hyper_V=hyper(), sweep=_meta((), torch.int32))
    T = data.test.rows.shape[0]
    pred = PredictionState(sum_pred=_meta((T,), torch.float32), num_samples=_meta((), torch.int32))
    key = _meta((2,), torch.uint32)
    prior = cfg.prior("meta")

    def sweep(key, state, pred):
        return _sweep_step(key, state, pred, data, cfg, ring, prior)

    return sweep, (key, state, pred)


def lower_bpmf(mesh: Any, K: int = 32, comm_mode: str = "ring", num_users: int = 483_500,
               num_movies: int = 5_775, nnz: int = 1_023_952) -> tuple[OpCostModel, dict]:
    """Trace one rank's distributed Gibbs sweep (ChEMBL-20 scale by default) on the mesh flattened to the ring."""
    from repro_torch.core.types import BPMFConfig

    ring = bpmf_ring_from(mesh)
    S = ring.num_shards
    cfg = BPMFConfig(K=K, comm_mode=comm_mode, gram_impl="auto")
    data = abstract_bpmf_data(S, num_users, num_movies, nnz, K, rank=ring.shard_offset)
    sweep, args = bpmf_sweep(ring, data, cfg)
    _, cost = trace(sweep, *args)
    meta = {
        "arch": "bpmf", "shape": f"chembl_K{K}_{comm_mode}", "kind": "bpmf_sweep",
        "num_users": num_users, "num_movies": num_movies, "nnz": nnz, "K": K, "rank": ring.shard_offset,
        # one sweep updates every user and movie: Gram 2K^2 flops a rating a side,
        # and per item a Cholesky solve ~ (2/3) K^3 + 4 K^2
        "model_flops_global": 2 * (2.0 * K * K * nnz) + (num_users + num_movies)
        * ((2.0 / 3.0) * K**3 + 4.0 * K * K),
    }
    return cost, meta


# ---------------------------------------------------------------------------
# Runner / CLI
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, loss_chunk: int = 512,
             rank: int = 0) -> dict:
    """Trace one cell on the production mesh seen from ``rank`` and write its JSON; the result dict."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
    n_dev = mesh.size
    t0 = time.time()
    try:
        if arch == "bpmf":
            cost, meta = lower_bpmf(mesh, comm_mode=shape_name or "ring")
        elif extrapolates(get_config(arch), mesh, shape_name):
            cost, meta = trace_train_extrapolated(arch, shape_name, mesh, loss_chunk)
        else:
            cost, meta = lower_cell(arch, shape_name, mesh, loss_chunk=loss_chunk)
        t_trace = time.time() - t0
        result = {
            **meta, "mesh": mesh_name, "num_devices": n_dev, "status": "ok",
            "trace_s": round(t_trace, 2),
            "roofline": roofline_terms(cost, meta, n_dev),
        }
    except Exception as e:  # noqa: BLE001 — every failure is a recorded result
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "num_devices": n_dev, "rank": rank,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:], "trace_s": round(time.time() - t0, 2),
        }
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name, f"{arch}__{shape_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def _print_result(r: dict) -> None:
    if r["status"] != "ok":
        print(f"[FAIL] {r['arch']:16s} {r['shape']:12s} {r['mesh']}: {r['error']}", flush=True)
        return
    rf = r["roofline"]
    useful = rf["useful_flops_ratio"]
    print(
        f"[ok] {r['arch']:16s} {r['shape']:12s} {r['mesh']:10s} "
        f"compute={rf['compute_s']:.3e}s memory={rf['memory_s']:.3e}s "
        f"coll={rf['collective_s']:.3e}s dom={rf['dominant']:9s} "
        f"useful={useful if useful is None else round(useful, 3)} "
        f"hbm={rf['memory']['peak_bytes_est'] / 1e9:.2f}GB fit={rf['fits_hbm']} "
        f"(trace {r['trace_s']}s)", flush=True
    )


def _cell_worker(job: tuple) -> dict:
    torch.set_num_threads(1)
    return run_cell(*job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", help="architecture id (or 'bpmf')")
    ap.add_argument("--shape", help="shape id (or comm_mode for --arch bpmf: ring | allgather)")
    ap.add_argument("--all", action="store_true", help="run every runnable cell")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (else 16x16)")
    ap.add_argument("--out-dir", default=os.path.normpath(OUT_DIR))
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--rank", type=int, default=0, help="the rank whose program is traced")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once, in worker processes")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in list_archs():
            cfg = get_config(arch)
            for shape in SHAPES.values():
                ok, why = cell_runnable(cfg, shape)
                if ok:
                    cells.append((arch, shape.name))
                else:
                    print(f"[skip] {arch:16s} {shape.name:12s} — {why}")
        cells.append(("bpmf", "ring"))
        cells.append(("bpmf", "allgather"))
    elif args.arch:
        cells.append((args.arch, args.shape or ("ring" if args.arch == "bpmf" else "train_4k")))
    else:
        ap.error("--arch or --all required")

    jobs = [(arch, shape, args.multi_pod, args.out_dir, args.loss_chunk, args.rank) for arch, shape in cells]
    failures = 0
    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.jobs, maxtasksperchild=1) as pool:
            for r in pool.imap_unordered(_cell_worker, jobs):
                _print_result(r)
                failures += r["status"] != "ok"
    else:
        for job in jobs:
            r = run_cell(*job)
            _print_result(r)
            failures += r["status"] != "ok"
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
