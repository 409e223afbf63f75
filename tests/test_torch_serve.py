"""The port's serving stack: request schema, micro-batcher, predictor, server, client, CLIs.

The cases of tests/test_server.py and tests/test_serve.py run against
``repro_torch.serve`` on the CPU, at their shapes (a 64 x 37, K = 4
artifact; 37 items). A coalesced answer must equal the same request run
alone bit for bit (the predictor sums every score in one fixed order,
whatever the batch), hot-swap is batch-atomic, a torn export is rejected,
and the HTTP front answers bit for bit what the predictor does. The
request schema is the JAX package's: a request parses alike in both.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import parse_request as j_parse_request
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import serve_server as serve_server_cli
from repro_torch.serve import (
    ArtifactMeta,
    BPMFServer,
    MicroBatcher,
    PosteriorPredictor,
    PredictorHandle,
    RequestError,
    ServeClient,
    ServeRequestError,
    parse_request,
    run_request,
    save_artifact,
)
from repro_torch.serve.client import parse_address
from repro_torch.serve.schema import PredictRequest, TopKRequest, error_response
from repro_torch.serve.sharded_topk import merge_topk

USERS, MOVIES, K, KEPT = 64, 37, 4, 3


def _meta(**kw) -> ArtifactMeta:
    base = dict(
        num_users=USERS, num_movies=MOVIES, K=K, mean_rating=3.5, min_rating=1.0,
        max_rating=5.0, num_mean_samples=4, num_kept_samples=KEPT, backend="synthetic",
        num_sweeps_done=5, seed=0,
    )
    base.update(kw)
    return ArtifactMeta(**base)


def _arrays(seed: int, kept: int = KEPT) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "U_mean": rng.normal(scale=0.5, size=(USERS, K)).astype(np.float32),
        "V_mean": rng.normal(scale=0.5, size=(MOVIES, K)).astype(np.float32),
        "U_samples": rng.normal(scale=0.5, size=(kept, USERS, K)).astype(np.float32),
        "V_samples": rng.normal(scale=0.5, size=(kept, MOVIES, K)).astype(np.float32),
    }


@pytest.fixture()
def artifact(tmp_path):
    return save_artifact(str(tmp_path / "artifact"), _meta(), _arrays(seed=1))


def _server(artifact, **kw) -> BPMFServer:
    return BPMFServer(artifact, device="cpu", **kw)


# ---------- request schema ----------


@pytest.mark.parametrize("payload", [
    "not a dict",
    {},
    {"rows": [0, 1], "cols": [0]},          # length mismatch
    {"rows": [], "cols": []},               # empty batch
    {"rows": [0], "cols": ["x"]},           # non-integer ids
    {"user": 0, "users": [1], "k": 3},      # both scalar and batch form
    {"user": [0, 1], "k": 3},               # scalar form with a batch
    {"users": [], "k": 3},                  # empty users
    {"users": [0], "k": 0},                 # non-positive k
    {"users": [0], "k": True},              # bool is not an int here
])
def test_parse_request_rejects(payload):
    with pytest.raises(RequestError) as ours:
        parse_request(payload)
    with pytest.raises(ValueError) as theirs:
        j_parse_request(payload)
    assert str(ours.value) == str(theirs.value)
    assert error_response(ours.value) == {"error": str(ours.value)}


def test_parse_request_shapes():
    req = parse_request({"rows": [0, 1], "cols": [2, 3], "std": True})
    assert isinstance(req, PredictRequest)
    assert req.std and req.size == 2 and req.batch_key() == ("predict", True)
    req = parse_request({"user": 7, "k": 3})
    assert isinstance(req, TopKRequest)
    assert req.scalar and req.size == 1 and req.batch_key() == ("top_k", 3)
    req = parse_request({"users": [7, 8]})  # k defaults to 10
    assert not req.scalar and req.batch_key() == ("top_k", 10)
    assert error_response(KeyError("x")) == {"error": "KeyError: 'x'"}


# ---------- micro-batcher (no device code) ----------


def _echo_group(key, requests):
    return [(key, r) for r in requests]


def test_batcher_groups_by_key_and_preserves_order():
    calls = []

    def run_group(key, requests):
        calls.append((key, len(requests)))
        return [(key, r) for r in requests]

    b = MicroBatcher(run_group, deadline_ms=80.0, adaptive=False)
    try:
        reqs = [parse_request(p) for p in (
            {"rows": [0], "cols": [1]}, {"user": 2, "k": 3},
            {"rows": [4, 5], "cols": [6, 7]}, {"user": 8, "k": 3},
        )]
        tickets = [b.submit(r) for r in reqs]
        results = [t.wait(timeout=10) for t in tickets]
    finally:
        b.stop()
    assert sorted(calls) == [(("predict", False), 2), (("top_k", 3), 2)]
    for r, (key, got) in zip(reqs, results):
        assert key == r.batch_key() and got is r
    s = b.stats()
    assert s["cycles"] == 1 and s["requests"] == 4 and s["coalesced_requests"] == 4


@pytest.mark.parametrize("deadline_ms,max_batch,adaptive", [
    (60_000.0, 4, False),  # only the row cap can release the batch in time
    (60_000.0, 1024, True),  # sparse traffic: the adaptive skip, no deadline wait
])
def test_batcher_dispatches_before_a_far_deadline(deadline_ms, max_batch, adaptive):
    b = MicroBatcher(_echo_group, deadline_ms=deadline_ms, max_batch=max_batch, adaptive=adaptive)
    try:
        t0 = time.monotonic()
        tickets = [b.submit(parse_request({"rows": [0, 1], "cols": [0, 1]})) for _ in range(2 if max_batch == 4 else 1)]
        for t in tickets:
            t.wait(timeout=10)
        assert time.monotonic() - t0 < 5.0
    finally:
        b.stop()
    with pytest.raises(ValueError, match="deadline_ms"):
        MicroBatcher(_echo_group, deadline_ms=-1.0)


def test_batcher_error_fans_out_to_every_ticket():
    def boom(key, requests):
        raise RuntimeError("device fell over")

    b = MicroBatcher(boom, deadline_ms=40.0, adaptive=False)
    try:
        tickets = [b.submit(parse_request({"user": u, "k": 2})) for u in (0, 1)]
        for t in tickets:
            with pytest.raises(RuntimeError, match="device fell over"):
                t.wait(timeout=10)
    finally:
        b.stop()


def test_batcher_stop_flushes_queue_and_rejects_new_submits():
    release = threading.Event()

    def slow_group(key, requests):
        release.wait(5)
        return [None] * len(requests)

    b = MicroBatcher(slow_group, deadline_ms=0.0)
    tickets = [b.submit(parse_request({"user": u, "k": 2})) for u in range(6)]
    release.set()
    b.stop()  # must flush everything still queued
    for t in tickets:
        assert t.wait(timeout=0) is None  # resolved, not dropped
    with pytest.raises(RuntimeError):
        b.submit(parse_request({"user": 0, "k": 2}))


# ---------- the predictor ----------


def test_predictor_answers_do_not_depend_on_the_batch(artifact):
    """Each answer of a batch has the bits of the same query alone."""
    p = PosteriorPredictor.load(artifact, device="cpu")
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, USERS, 50), rng.integers(0, MOVIES, 50)
    preds, std = p.predict(rows, cols, return_std=True)
    ids, vals = p.top_k(rows, 6)
    for i in range(0, 50, 7):
        one, one_std = p.predict(rows[i:i + 1], cols[i:i + 1], return_std=True)
        assert one.tobytes() == preds[i:i + 1].tobytes() and one_std.tobytes() == std[i:i + 1].tobytes()
        one_ids, one_vals = p.top_k(int(rows[i]), 6)
        np.testing.assert_array_equal(one_ids, ids[i])
        assert one_vals.tobytes() == vals[i].tobytes()
    a = _arrays(seed=1)
    want = np.clip((a["U_mean"][rows] * a["V_mean"][cols]).sum(-1) + 3.5, 1.0, 5.0)
    np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)
    per = np.clip(np.einsum("sbk,sbk->sb", a["U_samples"][:, rows], a["V_samples"][:, cols]) + 3.5, 1.0, 5.0)
    np.testing.assert_allclose(std, per.std(0), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, MOVIES])
def test_top_k_follows_merge_topk_order(k):
    """Score descending, ties to the lower id: merge_topk's order over two item shards."""
    a = _arrays(seed=3)
    a["V_mean"][::3] = a["V_mean"][0]  # equal scores for items 0, 3, 6, ...
    a["V_mean"][1::9] = 4.0  # and clipped ones
    p = PosteriorPredictor(_meta(), a, "cpu")
    users = np.arange(USERS)
    ids, vals = p.top_k(users, k)
    all_ids, all_vals = p.top_k(users, MOVIES)
    scores = np.empty((USERS, MOVIES), np.float32)
    scores[users[:, None], all_ids] = all_vals
    # two shards of 19 candidates each: items 0..18, and 19..36 with one
    # padding slot (id 37, score -inf) that sorts last
    padded = np.c_[scores, np.full(USERS, -np.inf, np.float32)]
    shards = (np.arange(0, 19), np.arange(19, MOVIES + 1))
    cand_ids = np.stack([np.broadcast_to(h, (USERS, 19)) for h in shards])
    cand_vals = np.stack([padded[:, h] for h in shards])
    want_ids, want_vals = merge_topk(cand_ids, cand_vals, k)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(vals, want_vals)
    assert (vals[:, :-1] >= vals[:, 1:]).all()


def test_predictor_validates_queries_and_modes(artifact, tmp_path):
    p = PosteriorPredictor.load(artifact, device="cpu")
    for call, match in (
        (lambda: p.predict([USERS], [0]), "user ids"),
        (lambda: p.predict([0], [MOVIES]), "movie ids"),
        (lambda: p.predict([0, 1], [0]), "mismatch"),
        (lambda: p.top_k(-1, 3), "user ids"),
        (lambda: p.top_k(0, 0), "k >= 1"),
    ):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match="topk_mode"):
        PosteriorPredictor.load(artifact, device="cpu", topk_mode="blocked")
    # the item-sharded scan (ported, Queue 1 item 9) answers as the replicated one
    sharded = PosteriorPredictor.load(artifact, device="cpu", topk_mode="sharded")
    for got, want in zip(sharded.top_k(0, 3), p.top_k(0, 3, sharded=False)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(p.top_k(0, 3, sharded=True), p.top_k(0, 3, sharded=False)):
        np.testing.assert_array_equal(got, want)
    assert p.top_k(0, 3, sharded=False)[0].shape == (3,)
    nostd = save_artifact(str(tmp_path / "nostd"), _meta(num_kept_samples=0), _arrays(seed=2, kept=0))
    q = PosteriorPredictor.load(nostd, device="cpu")
    with pytest.raises(ValueError, match="keep_factor_samples"):
        q.predict([0], [0], return_std=True)
    assert q.predict([0], [0]).shape == (1,)


def test_predictor_handle_swap_bumps_generation(artifact):
    p1 = PosteriorPredictor.load(artifact, device="cpu")
    p2 = PosteriorPredictor.load(artifact, device="cpu")
    h = PredictorHandle(p1)
    assert h.get() is p1 and h.generation == 0
    assert h.swap(p2) == 1
    got, gen = h.get_with_generation()
    assert got is p2 and gen == 1


# ---------- the server ----------


def test_coalesced_responses_bitwise_equal_isolated(artifact):
    reference = PosteriorPredictor.load(artifact, device="cpu")
    rng = np.random.default_rng(0)
    payloads = []
    for size in (1, 2, 3, 5, 8, 1, 4, 2):
        payloads.append({"rows": rng.integers(0, USERS, size).tolist(),
                         "cols": rng.integers(0, MOVIES, size).tolist(), "std": size % 2 == 0})
    for _ in range(4):
        payloads.append({"user": int(rng.integers(0, USERS)), "k": 5})
    payloads.append({"users": rng.integers(0, USERS, 3).tolist(), "k": 5})
    expected = [run_request(reference, parse_request(p)) for p in payloads]

    # adaptive off: every request waits the full deadline, so concurrent submitters coalesce
    with _server(artifact, deadline_ms=300.0, adaptive=False, watch=False) as srv:
        barrier = threading.Barrier(len(payloads))
        results: list = [None] * len(payloads)

        def client(i):
            barrier.wait()
            results[i] = srv.handle_request(payloads[i], timeout=30)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = srv.batcher.stats()
    assert stats["coalesced_requests"] > 0, "nothing actually coalesced"
    for (status, got), want in zip(results, expected):
        assert status == 200 and got == want  # dict equality on floats: f32 bit for bit


def test_hot_swap_is_batch_atomic_under_concurrent_clients(artifact, tmp_path):
    new_arrays = _arrays(seed=2)
    staged = save_artifact(str(tmp_path / "staged"), _meta(seed=1), new_arrays)
    payload = {"rows": [3, 9, 17, 40], "cols": [0, 5, 11, 36]}
    p_old = run_request(PosteriorPredictor.load(artifact, device="cpu"), parse_request(payload))["predictions"]
    p_new = run_request(PosteriorPredictor.load(staged, device="cpu"), parse_request(payload))["predictions"]
    assert p_old != p_new  # the swap must be observable

    with _server(artifact, deadline_ms=1.0, watch=False) as srv:
        stop = threading.Event()
        bad: list = []
        seen = {"old": 0, "new": 0}

        def hammer():
            while not stop.is_set():
                status, resp = srv.handle_request(payload, timeout=30)
                preds = resp.get("predictions")
                if status != 200:
                    bad.append((status, resp))
                elif preds == p_old:
                    seen["old"] += 1
                elif preds == p_new:
                    seen["new"] += 1
                else:
                    bad.append(("torn", preds))

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        save_artifact(artifact, _meta(seed=1), new_arrays)  # re-export over the live directory
        assert srv.poll_artifact_now() is True
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not bad, bad[:3]
        assert seen["old"] > 0 and seen["new"] > 0, seen
        assert srv.generation == 1
        assert srv.handle_request(payload, timeout=30) == (200, {"predictions": p_new})


def test_watcher_rejects_torn_export_and_keeps_serving(artifact):
    payload = {"rows": [0, 1], "cols": [2, 3]}
    with _server(artifact, watch=False) as srv:
        _, want = srv.handle_request(payload, timeout=30)
        meta_path = os.path.join(artifact, "artifact.json")
        good = open(meta_path).read()
        with open(meta_path, "w") as f:
            f.write('{"truncated": ')
        assert srv.poll_artifact_now() is False
        assert srv._swap_failures == 1 and srv.generation == 0
        assert srv.handle_request(payload, timeout=30) == (200, want)  # the old posterior still serves
        with open(meta_path, "w") as f:
            f.write(good)
        save_artifact(artifact, _meta(seed=1), _arrays(seed=4))
        assert srv.poll_artifact_now() is True and srv.generation == 1
        assert srv.poll_artifact_now() is False  # nothing new since


def test_http_roundtrip_bitwise_and_health(artifact):
    reference = PosteriorPredictor.load(artifact, device="cpu")
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, USERS, 7), rng.integers(0, MOVIES, 7)
    with _server(artifact, watch=False) as srv:
        host, port = srv.address
        c = ServeClient(f"{host}:{port}")
        preds, std = c.predict(rows, cols, return_std=True)
        want, want_std = reference.predict(rows, cols, return_std=True)
        assert preds.tobytes() == want.tobytes() and std.tobytes() == want_std.tobytes()
        ids, scores = c.top_k(3, k=5)
        want_ids, want_scores = reference.top_k(3, 5)
        np.testing.assert_array_equal(ids, want_ids)
        assert scores.tobytes() == want_scores.tobytes()
        ids, _ = c.top_k([3, 4], k=5)
        np.testing.assert_array_equal(ids, reference.top_k([3, 4], 5)[0])

        h = c.health()
        assert h["status"] == "ok" and h["generation"] == 0
        assert h["artifact"]["num_movies"] == MOVIES
        s = c.stats()
        assert s["batcher"]["requests"] >= 3 and s["swap_failures"] == 0
        with pytest.raises(ServeRequestError):
            c.predict([USERS + 5], [0])  # out-of-range id -> 400 error body
        assert "error" in c.request({"nonsense": 1})
        c.close()


def test_parse_address_forms():
    assert parse_address("127.0.0.1:8642") == ("127.0.0.1", 8642)
    assert parse_address("http://localhost:80/") == ("localhost", 80)
    assert parse_address(":8642") == ("127.0.0.1", 8642)
    for bad in ("nope", "host:", "host:http", ""):
        with pytest.raises(ValueError):
            parse_address(bad)


# ---------- CLIs and the device rule ----------


def test_serve_cli_server_mode_and_sources(artifact, capsys):
    reference = PosteriorPredictor.load(artifact, device="cpu")
    with _server(artifact, watch=False) as srv:
        host, port = srv.address
        assert serve_cli.main(["--server", f"{host}:{port}", "--user", "3", "--top-k", "4"]) == 0
        out = json.loads(capsys.readouterr().out)
        want_ids, want_scores = reference.top_k(3, 4)
        assert out["items"] == want_ids.tolist() and out["scores"] == want_scores.tolist()
    assert serve_cli.main(["--server", f"{host}:{port}", "--user", "3"]) == 1
    assert "cannot reach server" in capsys.readouterr().err
    assert serve_cli.main(["--user", "0"]) == 2
    assert serve_cli.main(["--artifact", artifact, "--server", "h:1", "--user", "0"]) == 2
    assert serve_cli.main(["--device", "cpu", "--artifact", artifact, "--rows", "0,1", "--cols", "2,3",
                           "--std"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == run_request(reference, parse_request({"rows": [0, 1], "cols": [2, 3], "std": True}))
    assert serve_cli.main(["--device", "cpu", "--artifact", artifact + "-none", "--user", "0"]) == 1
    assert "cannot load artifact" in capsys.readouterr().err


def test_serving_entry_points_need_cuda_unless_cpu_is_asked(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: PosteriorPredictor.load(artifact),
        lambda: BPMFServer(artifact, watch=False),
        lambda: serve_cli.main(["--artifact", artifact, "--user", "0"]),
        lambda: serve_server_cli.main(["--artifact", artifact, "--port", "0"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert PosteriorPredictor.load(artifact, device="cpu").device.type == "cpu"


def test_serve_cli_jsonl_subprocess(artifact):
    """``python -m repro_torch.launch.serve --device cpu --jsonl``: one response per line, errors inline."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    lines = [{"rows": [0, 5, 11], "cols": [1, 7, 36], "std": True}, {"user": 3, "k": 4},
             {"rows": [0, USERS], "cols": [0, 0]}]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--artifact", artifact, "--jsonl"],
        input="".join(json.dumps(x) + "\n" for x in lines) + "definitely not json\n",
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "device=cpu" in proc.stderr
    got = [json.loads(x) for x in proc.stdout.splitlines() if x.strip()]
    reference = PosteriorPredictor.load(artifact, device="cpu")
    assert got[:2] == [run_request(reference, parse_request(x)) for x in lines[:2]]
    assert "user ids" in got[2]["error"] and "error" in got[3]
