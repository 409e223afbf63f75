"""The port's LM sharding rules against the JAX package's, in one process with no ranks.

For all ten configs at full size (descriptors only), the four rule tables
and six meshes (``(1,1)``, ``(2,2)``, ``(4,2)``, ``(3,2)`` for the
divisibility fallback, ``(16,16)`` and ``(2,16,16)`` with ``pod``), every
spec the port resolves equals the reference's: ``model.specs``, the cache
specs, ``batch_specs``, ``state_specs`` and ``serve_input_specs``. The
reference's mesh is a ``jax.sharding.AbstractMesh`` (``resolve_spec`` reads
only its shape), the port's a ``Mesh.abstract``. The use-time spec of
``ShardingCtx.weight`` is the storage minus ``FSDP_AXES``, or
``ZERO_RULES.use_table``'s. ``shard_init``'s shards, one per rank of a
``(2, 2)`` mesh, reassemble to ``init_params`` bit for bit for one reduced
config per family, with the draw cut into many pieces.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as ref_get_config
from repro.models import module as ref_module
from repro.models.model import build_model as ref_build_model
from repro.training.lm_serve import serve_input_specs as ref_serve_input_specs
from repro.training.optimizer import AdamW as RefAdamW
from repro.training.train import batch_specs as ref_batch_specs
from repro.training.train import state_specs as ref_state_specs
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core import prng
from repro_torch.models import module
from repro_torch.models.collectives import Mesh
from repro_torch.models.model import build_model
from repro_torch.models.module import FSDP_AXES, flatten_descs, local_box
from repro_torch.training.lm_serve import serve_input_specs
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train import batch_specs, state_specs

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((3, 2), ("data", "model")), ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
TABLES = ["TRAIN_RULES", "SERVE_RULES", "DECODE_RULES", "ZERO_RULES"]
# one config per family for the draws: MQA with a tied vocabulary, MLA, MoE, SSM, hybrid
FAMILIES = ["gemma-2b", "minicpm3-4b", "mixtral-8x22b", "mamba2-130m", "zamba2-2.7b"]
# (batch, seq): decode_32k's shape (its batch splits as train_4k's 256 does on every mesh here), and sizes
# that divide nothing
BATCHES = [(128, 32768), (3, 100)]


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops on one thread: beside other test workers, more threads only spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes():
    return [(AbstractMesh(shape, names), Mesh.abstract(shape, names)) for shape, names in MESHES]


def _ref_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _leaves(tree) -> list:
    """Specs of a port tree (nested dicts, cache dataclasses) in the reference's leaf order."""
    if isinstance(tree, module.PartitionSpec):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree) if not isinstance(getattr(tree, f.name), bool)
                for leaf in _leaves(getattr(tree, f.name))]
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g) == tuple(w), (g, w)


def test_the_rule_tables_are_the_reference_s():
    for name in TABLES:
        mine, ref = getattr(module, name), getattr(ref_module, name)
        assert dict(mine.table) == dict(ref.table), name
        assert (None if mine.use_table is None else dict(mine.use_table)) == (
            None if ref.use_table is None else dict(ref.use_table)), name
    assert FSDP_AXES == ref_module.FSDP_AXES


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_spec_equals_the_reference_s(arch, table):
    rules, ref_rules = getattr(module, table), getattr(ref_module, table)
    model, ref_model = build_model(get_config(arch)), ref_build_model(ref_get_config(arch))
    for ref_mesh, mesh in _meshes():
        _same(_leaves(model.specs(rules, mesh)), _ref_leaves(ref_model.specs(ref_rules, ref_mesh)))
        st, ref_st = state_specs(model, AdamW(), rules, mesh), ref_state_specs(ref_model, RefAdamW(), ref_rules,
                                                                               ref_mesh)
        _same([*_leaves(st.params), *_leaves(st.opt.mu), *_leaves(st.opt.nu), st.opt.count, st.step],
              _ref_leaves(ref_st))
        for batch, seq in BATCHES:
            _same(_leaves(batch_specs(model.cfg, rules, mesh, batch, seq)),
                  _ref_leaves(ref_batch_specs(ref_model.cfg, ref_rules, ref_mesh, batch, seq)))
            assert tuple(serve_input_specs(model, rules, mesh, batch)) == tuple(
                ref_serve_input_specs(ref_model, ref_rules, ref_mesh, batch))
            if model.cfg.is_encoder:
                assert model.cache_specs(rules, mesh, batch, seq) is None
                continue
            _same(_leaves(model.cache_specs(rules, mesh, batch, seq)),
                  _ref_leaves(ref_model.cache_specs(ref_rules, ref_mesh, batch, seq)))


@pytest.mark.parametrize("table", TABLES)
def test_a_weight_is_used_as_stored_minus_the_fsdp_axes_or_by_the_use_table(table):
    rules, ref_rules = getattr(module, table), getattr(ref_module, table)
    for arch in ARCHS:
        model = build_model(get_config(arch))
        for ref_mesh, mesh in _meshes():
            ctx = model.ctx(rules, mesh)
            for path, d in flatten_descs(model.descs()):
                store, use = ctx.weight_specs(d)
                ref_store = ref_module.resolve_spec(d.shape, d.axes, ref_rules, ref_mesh)
                assert tuple(store) == tuple(ref_store), path
                ref_use = (ref_module.resolve_spec(d.shape, d.axes, ref_rules, ref_mesh, use=True)
                           if ref_rules.use_table is not None else _drop(ref_store, FSDP_AXES))
                # no use spec splits over the FSDP axes: under DECODE_RULES a weight stored over "data" is
                # gathered at use, where the reference's use_table keeps it in place
                assert tuple(use) == _drop(ref_use, FSDP_AXES), (arch, path)
                if table != "DECODE_RULES":
                    assert _drop(ref_use, FSDP_AXES) == _drop(ref_use, ()), (arch, path)


def _drop(spec, axes) -> tuple:
    """A reference spec's entries without ``axes``, trailing ``None`` entries dropped."""
    out = []
    for e in spec:
        names = tuple(a for a in (() if e is None else (e,) if isinstance(e, str) else e) if a not in axes)
        out.append(None if not names else names[0] if len(names) == 1 else names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_init_reassembles_to_init_params_bit_for_bit(monkeypatch, arch):
    # pieces of 7,919 elements, not 2**24: a reduced leaf is drawn in many pieces, and a shard's flat
    # range starts and ends inside them
    monkeypatch.setattr(module, "_DRAW_PIECE", 7919)
    model = build_model(get_config(arch).reduced())
    key = prng.key(3)
    full = module.init_params(key, model.descs(), "cpu")
    full_leaves = {p: t for p, t in zip([p for p, _ in flatten_descs(model.descs())],
                                        _tensor_leaves(full))}
    for rules in (module.TRAIN_RULES, module.ZERO_RULES):
        rebuilt = {p: torch.full_like(t, float("nan")) for p, t in full_leaves.items()}
        sizes, names = (2, 2), ("data", "model")
        for rank in range(4):
            mesh = Mesh(sizes, names, rank=rank)
            shards = module.shard_init(key, model.descs(), rules, mesh, "cpu")
            for (path, d), shard in zip(flatten_descs(model.descs()), _tensor_leaves(shards)):
                box = local_box(d.shape, module.resolve_spec(d.shape, d.axes, rules, mesh), mesh)
                assert tuple(shard.shape) == tuple(b - a for a, b in box), path
                rebuilt[path][tuple(slice(a, b) for a, b in box)] = shard
        for path, t in full_leaves.items():
            assert torch.equal(_bits(rebuilt[path]), _bits(t)), (path, rules)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in _tensor_leaves(tree[k])]
