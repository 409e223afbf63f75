"""Carry state and data between the JAX package and this one.

The interchange form is a *tree*: nested dicts (and tuples, for buckets)
whose keys are the field names of the JAX package's pytree dataclasses and
whose leaves are numpy arrays or Python numbers. ``dataclasses.asdict`` of
a ``repro`` container gives such a tree (its leaves need only
``np.asarray``), and a tree from :func:`to_tree` rebuilds a ``repro``
container field by field. This module imports neither JAX nor ``repro``;
it only reads and writes trees:

* ``*_from_tree`` builds this package's :class:`BPMFState`,
  :class:`PredictionState`, :class:`PosteriorAccum` or :class:`BPMFData`
  (CPU tensors; ``.to(device)`` moves them);
* :func:`to_tree` turns any of them back into a tree of numpy arrays, with
  the JAX package's dtypes (int32 counters, float32 factors);
* :func:`merge_accum_from_tree` builds ``posterior_merge``'s
  :class:`MergeAccum` from a ``repro.core.subset_merge.MergeAccum`` tree
  (its per-chain states, predictions and data convert chain by chain with
  the functions above);
* ``dist_*_from_tree`` build the distributed sampler's per-shard
  :class:`DistState`, :class:`DistBPMFData` and :class:`DistPlan` from the
  JAX package's ring-sharded ones: each global ``[S * n, ...]`` array is
  split into S blocks of n rows, one per shard;
* :func:`key_from_data` / :func:`key_to_data` convert a key to and from
  ``jax.random.key_data``'s two uint32 words;
* :func:`lm_params_from_tree` / :func:`lm_params_to_tree` carry an LM's
  params (``repro.models.model.LMModel``'s nested dicts, leaves as
  ``jax.tree.map(np.asarray, params)`` gives them) to this package's
  tensors and back, with equal shapes and dtypes. numpy has no bfloat16 of
  its own: a bfloat16 leaf is the ``ml_dtypes`` array JAX hands out, read
  through its bits and written back as one (``ml_dtypes`` is imported only
  then).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.balance import Partition
from repro_torch.core.distributed import (
    DistBPMFData,
    DistPlan,
    DistState,
    DistTestSet,
    RingSide,
)
from repro_torch.core.prediction import PredictionState
from repro_torch.core.subset_merge import MergeAccum
from repro_torch.core.types import (
    BPMFData,
    BPMFState,
    Bucket,
    BucketedSide,
    HyperParams,
    PosteriorAccum,
    TestSet,
)

# counters: 0-d int32 arrays in both packages
_INT_SCALARS = {"sweep", "num_samples", "count", "filled"}


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _counter(x: Any) -> torch.Tensor:
    """A 0-dim int32 counter tensor from a tree leaf."""
    return torch.from_numpy(np.array(np.asarray(x), np.int32).reshape(()))


def key_from_data(data: Any) -> torch.Tensor:
    """A key tensor from the ``[2]`` uint32 words of ``jax.random.key_data``."""
    return _t(np.asarray(data, np.uint32).astype(np.int64))


def key_to_data(key: torch.Tensor) -> np.ndarray:
    """The ``[2]`` uint32 words ``jax.random.wrap_key_data`` takes."""
    return key.cpu().numpy().astype(np.uint32)


def to_tree(obj: Any) -> Any:
    """Tree of numpy leaves with the JAX package's field names and dtypes.

    Fields the port alone has (``metadata={"port_only": True}``: the Gram
    dispatch decided for the data) are left out.
    """
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.metadata.get("port_only"):
                continue
            v = getattr(obj, f.name)
            out[f.name] = np.asarray(to_tree(v), np.int32) if f.name in _INT_SCALARS else to_tree(v)
        return out
    if isinstance(obj, tuple):
        return tuple(to_tree(v) for v in obj)
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    return obj


def _hyper(tree: Mapping) -> HyperParams:
    return HyperParams(mu=_t(tree["mu"]), Lam=_t(tree["Lam"]))


def state_from_tree(tree: Mapping) -> BPMFState:
    """:class:`BPMFState` from a ``repro.core.types.BPMFState`` tree."""
    return BPMFState(
        U=_t(tree["U"]), V=_t(tree["V"]),
        hyper_U=_hyper(tree["hyper_U"]), hyper_V=_hyper(tree["hyper_V"]),
        sweep=_counter(tree["sweep"]),
    )


def prediction_from_tree(tree: Mapping) -> PredictionState:
    """:class:`PredictionState` from a ``repro.core.prediction.PredictionState`` tree."""
    return PredictionState(
        sum_pred=_t(tree["sum_pred"]), num_samples=_counter(tree["num_samples"])
    )


def accum_from_tree(tree: Mapping) -> PosteriorAccum:
    """:class:`PosteriorAccum` from a ``repro.core.types.PosteriorAccum`` tree."""
    return PosteriorAccum(
        U_sum=_t(tree["U_sum"]), V_sum=_t(tree["V_sum"]),
        count=_counter(tree["count"]), filled=_counter(tree["filled"]),
        U_window=_t(tree["U_window"]), V_window=_t(tree["V_window"]),
    )


def merge_accum_from_tree(tree: Mapping) -> MergeAccum:
    """:class:`MergeAccum` from a ``repro.core.subset_merge.MergeAccum`` tree."""
    return MergeAccum(chains=tuple(accum_from_tree(t) for t in tree["chains"]))


def _side(tree: Mapping) -> BucketedSide:
    buckets = tuple(
        Bucket(item_ids=_t(b["item_ids"]), nbr=_t(b["nbr"]), val=_t(b["val"]), nnz=_t(b["nnz"]))
        for b in tree["buckets"]
    )
    return BucketedSide(buckets=buckets, num_items=int(tree["num_items"]))


def data_from_tree(tree: Mapping) -> BPMFData:
    """:class:`BPMFData` from a ``repro.core.types.BPMFData`` tree."""
    test = tree["test"]
    return BPMFData(
        users=_side(tree["users"]),
        movies=_side(tree["movies"]),
        test=TestSet(rows=_t(test["rows"]), cols=_t(test["cols"]), vals=_t(test["vals"])),
        mean_rating=_t(np.asarray(tree["mean_rating"], np.float32)),
        num_users=int(tree["num_users"]),
        num_movies=int(tree["num_movies"]),
        min_rating=float(tree["min_rating"]),
        max_rating=float(tree["max_rating"]),
    )


def _blocks(x: Any, S: int) -> tuple[torch.Tensor, ...]:
    """The S row blocks of a ring-sharded ``[S * n, ...]`` array."""
    return tuple(_t(b) for b in np.split(np.asarray(x), S))


def dist_state_from_tree(tree: Mapping, num_shards: int) -> DistState:
    """:class:`DistState` from a ``repro.core.distributed.DistState`` tree."""
    return DistState(
        U=_blocks(tree["U"], num_shards), V=_blocks(tree["V"], num_shards),
        hyper_U=_hyper(tree["hyper_U"]), hyper_V=_hyper(tree["hyper_V"]),
        sweep=_counter(tree["sweep"]),
    )


def _ring_side(tree: Mapping, S: int) -> RingSide:
    steps = []
    for per_step in tree["steps"]:
        split = [
            {f: _blocks(b[f], S) for f in ("item_ids", "nbr", "val", "nnz")} for b in per_step
        ]
        steps.append(tuple(
            tuple(Bucket(**{f: parts[f][d] for f in parts}) for parts in split) for d in range(S)
        ))
    return RingSide(
        steps=tuple(steps), orig_ids=_blocks(tree["orig_ids"], S),
        cap=int(tree["cap"]), num_items=int(tree["num_items"]),
    )


def dist_data_from_tree(tree: Mapping) -> DistBPMFData:
    """:class:`DistBPMFData` (CPU tensors) from a ``repro.core.distributed.DistBPMFData`` tree.

    ``repro_torch.core.distributed.place_data`` puts it on a ring.
    """
    S = int(tree["num_shards"])
    test = tree["test"]
    return DistBPMFData(
        users=_ring_side(tree["users"], S),
        movies=_ring_side(tree["movies"], S),
        test=DistTestSet(rows=_t(test["rows"]), cols=_t(test["cols"]), vals=_t(test["vals"])),
        mean_rating=_t(np.asarray(tree["mean_rating"], np.float32)),
        num_shards=S,
        min_rating=float(tree["min_rating"]),
        max_rating=float(tree["max_rating"]),
    )


def _partition(tree: Mapping) -> Partition:
    return Partition(
        shards=[np.asarray(s) for s in tree["shards"]],
        perm=np.asarray(tree["perm"]), inv_perm=np.asarray(tree["inv_perm"]),
        cap=int(tree["cap"]), loads=np.asarray(tree["loads"]),
    )


def dist_plan_from_tree(tree: Mapping) -> DistPlan:
    """:class:`DistPlan` from a ``repro.core.distributed.DistPlan`` tree (per-host fields dropped)."""
    return DistPlan(
        part_users=_partition(tree["part_users"]), part_movies=_partition(tree["part_movies"]),
        num_shards=int(tree["num_shards"]), strategy=str(tree["strategy"]),
    )


def _bf16_numpy_dtype() -> np.dtype:
    import ml_dtypes  # JAX's numpy bfloat16; needed only to hand bfloat16 leaves back

    return np.dtype(ml_dtypes.bfloat16)


def lm_params_from_tree(tree: Mapping) -> dict:
    """An LM param tree (nested dicts of numpy arrays) as CPU tensors of the same shapes and dtypes."""
    if not isinstance(tree, Mapping):
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
        return _t(a)
    return {k: lm_params_from_tree(v) for k, v in tree.items()}


def lm_params_to_tree(params: Mapping) -> dict:
    """This package's LM params as nested dicts of numpy arrays (bfloat16 as ``ml_dtypes.bfloat16``)."""
    if not isinstance(params, Mapping):
        t = params.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_bf16_numpy_dtype())
        return t.numpy().copy()
    return {k: lm_params_to_tree(v) for k, v in params.items()}
