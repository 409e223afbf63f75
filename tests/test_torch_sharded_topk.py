"""The item-sharded top-k of the port against its replicated scan and the JAX package's sharded top-k.

* ``top_k`` over S item shards (S in 1, 3, 4, 7 on the CPU, shards of
  unequal rows and empty ones, k below, at and above a shard's rows, tied
  scores) returns the replicated scan's ids and scores bit for bit;
* on the same V the port's answers equal the JAX package's
  ``build_local_topk`` + ``merge_topk`` (ids exactly, scores within 1e-5:
  JAX scores with a matrix product, the port with its fixed-order sum), and
  the port's ``merge_topk`` equals the JAX package's on the same candidates;
* ``topk_mode="auto"`` shards only with several item shards and a catalog
  of at least 1,024 items; ``serve_devices`` places shard i on device
  ``i % n``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.serve import sharded_topk as jsharded
from repro_torch.serve import ArtifactMeta, PosteriorPredictor
from repro_torch.serve.predictor import serve_devices
from repro_torch.serve.sharded_topk import merge_topk, shard_items

USERS, K = 40, 6


def _predictor(movies: int, seed: int = 0, shards: int = 1, ties: bool = True, mode: str = "auto"):
    rng = np.random.default_rng(seed)
    U = rng.normal(scale=0.5, size=(USERS, K)).astype(np.float32)
    V = rng.normal(scale=0.5, size=(movies, K)).astype(np.float32)
    if ties and movies > 8:
        V[movies // 2] = V[1]  # equal scores across shards: the lower id first
        V[movies - 1] = V[2]
    arrays = {"U_mean": U, "V_mean": V, "U_samples": U[None], "V_samples": V[None]}
    meta = ArtifactMeta(USERS, movies, K, 3.5, 1.0, 5.0, 1, 1, "synthetic", 1, 0)
    return PosteriorPredictor(meta, arrays, "cpu", topk_mode=mode, item_devices=serve_devices(shards, "cpu"))


@pytest.mark.parametrize("movies,shards", [(37, 1), (37, 3), (37, 4), (5, 7), (64, 4)])
@pytest.mark.parametrize("k", [1, 5, 12, 37])
def test_sharded_top_k_equals_the_replicated_scan_bit_for_bit(movies, shards, k):
    p = _predictor(movies, shards=shards)
    users = np.arange(USERS)
    ids, vals = p.top_k(users, k, sharded=True)
    want_ids, want_vals = p.top_k(users, k, sharded=False)
    assert ids.dtype == want_ids.dtype == np.int32 and vals.dtype == want_vals.dtype == np.float32
    np.testing.assert_array_equal(ids, want_ids)
    assert vals.tobytes() == want_vals.tobytes()
    one_ids, one_vals = p.top_k(7, k, sharded=True)  # a scalar user: one row
    np.testing.assert_array_equal(one_ids, want_ids[7])
    np.testing.assert_array_equal(one_vals, want_vals[7])


def test_sharded_top_k_matches_the_jax_package():
    p = _predictor(37, seed=3, shards=3, ties=False)
    U, V = p._U.numpy(), p._V.numpy()
    mesh = Mesh(np.asarray(jax.devices()), ("serve",))
    users = np.arange(USERS, dtype=np.int32)
    fn = jsharded.build_local_topk(mesh, V.shape[0])
    cand_ids, cand_vals = fn(jnp.asarray(U), jsharded.shard_items(V, mesh), jnp.asarray(users),
                             jnp.float32(3.5), 5, 1.0, 5.0)
    want_ids, want_vals = jsharded.merge_topk(np.asarray(cand_ids), np.asarray(cand_vals), 5)
    ids, vals = p.top_k(users, 5, sharded=True)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-5)
    # the merge itself, on the port's candidates (padding of a short shard included)
    shards = shard_items(p._V, [torch.device("cpu")] * 5)
    assert [s.offset for s in shards] == [0, 8, 16, 24, 32] and shards[-1].Vt.shape == (K, 5)
    rng = np.random.default_rng(1)
    cids = rng.permutation(40).reshape(4, 1, 10).repeat(3, axis=1).astype(np.int32)
    cvals = np.round(rng.normal(size=(4, 3, 10)), 1).astype(np.float32)  # rounding makes ties
    cvals[3, :, 7:] = -np.inf
    for got, want in zip(merge_topk(cids, cvals, 9), jsharded.merge_topk(cids, cvals, 9)):
        np.testing.assert_array_equal(got, want)


def test_auto_mode_shards_only_several_shards_and_large_catalogs():
    for movies, shards, sharded in ((1024, 2, True), (1023, 2, False), (2048, 1, False)):
        p = _predictor(movies, shards=shards)
        ids, vals = p.top_k(np.arange(4), 10)
        assert (p._local_topk is not None) == sharded
        want = p.top_k(np.arange(4), 10, sharded=not sharded)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(vals, want[1])
    assert _predictor(37, mode="replicated").top_k(0, 3)[0].shape == (3,)
    assert serve_devices(3, "cpu") == [torch.device("cpu")] * 3 and serve_devices(0, "cpu") == [torch.device("cpu")]
