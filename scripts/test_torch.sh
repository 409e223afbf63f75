#!/usr/bin/env bash
# The PyTorch port's test entry point: the docstring gate, optional smoke
# stanzas, then the port's tests.
#
# The port-side counterpart of scripts/test.sh's smoke stanzas. Every
# stanza drives a `python -m repro_torch.launch.*` CLI and the matching
# `benchmarks_torch.* --smoke` driver on --device (default cuda: without a
# card and without `--device cpu` the first CLI raises), writes only to
# temporary directories, and checks each driver's JSON with
# scripts/check_bench_schema_torch.py both at its temporary path (--path)
# and as the committed experiments/bench_torch file.
#
#   scripts/test_torch.sh --device cpu                 # gate + pytest tests/test_torch_*.py
#   scripts/test_torch.sh --device cpu -k bench         # pytest arguments pass through;
#                                                       #   test paths replace tests/test_torch_*.py
#   scripts/test_torch.sh --bench-smoke      # 2-sweep ring_async CLI run; fig3_multicore
#                                            #   and rmse_convergence --smoke + schema
#   scripts/test_torch.sh --autotune-smoke   # fig2 driver (2 shapes, its own cache)
#                                            #   + schema of the JSON and the cache
#   scripts/test_torch.sh --serve-smoke      # train -> export -> serve one-shot + JSONL;
#                                            #   serve_latency --smoke + schema
#   scripts/test_torch.sh --block-smoke      # 2-block ring run -> export -> serve;
#                                            #   sweep_throughput --smoke + schema
#   scripts/test_torch.sh --server-smoke     # train -> export -> serve_server -> client
#                                            #   burst -> hot-swap -> clean shutdown;
#                                            #   serve_latency --smoke --load + schema
#   scripts/test_torch.sh --merge-smoke      # 2-partition posterior_merge run -> export
#                                            #   -> serve; fig_merge_comm --smoke + schema
#   scripts/test_torch.sh --overlap-smoke    # depth-2 pipelined run with a checkpoint ->
#                                            #   resume -> export; fig5_overlap --smoke + schema
#   scripts/test_torch.sh --multiproc-smoke  # 2-process ring gang -> checkpoint -> restart
#                                            #   at 1 process -> export -> serve;
#                                            #   fig4_scaling --smoke + schema
#
# On the GPU machine (the default device; tests/test_torch_cuda.py is the card's test file):
#   scripts/test_torch.sh --serve-smoke --merge-smoke tests/test_torch_cuda.py
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src:.${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cuda
STANZAS=()
ARGS=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    --device) DEVICE="$2"; shift 2 ;;
    --device=*) DEVICE="${1#--device=}"; shift ;;
    --bench-smoke|--autotune-smoke|--serve-smoke|--block-smoke|--server-smoke|--merge-smoke|--overlap-smoke|--multiproc-smoke)
      STANZAS+=("$1"); shift ;;
    *) ARGS+=("$1"); shift ;;
  esac
done
has() { [[ " ${STANZAS[*]-} " == *" $1 "* ]]; }
TINY=(--device "$DEVICE" --dataset synthetic --K 4 --users 80 --movies 40 --nnz 800)
TMP="$(mktemp -d)"
trap 'rm -rf "$TMP"' EXIT

# bench_smoke NAME [driver args...]: the driver at its smoke size, then its schema
# at the temporary path and as the committed file
bench_smoke() {
  local name="$1" module="$2"; shift 2
  python -m "benchmarks_torch.$module" --smoke --device "$DEVICE" --out "$TMP/$name.json" "$@"
  python scripts/check_bench_schema_torch.py "$name" --path "$TMP/$name.json"
  python scripts/check_bench_schema_torch.py "$name"
}

python scripts/check_docstrings_torch.py

if has --bench-smoke; then
  echo "== bench smoke: 2-sweep ring_async on synthetic =="
  python -m repro_torch.launch.bpmf "${TINY[@]}" --backend ring_async --num-shards 4 \
    --pipeline-depth 2 --sweeps 2 --burn-in 1
  bench_smoke fig3_multicore fig3_multicore
  bench_smoke rmse_convergence rmse_convergence
fi

if has --autotune-smoke; then
  echo "== autotune smoke: fig2 driver, 2 shapes, its own cache =="
  bench_smoke fig2_item_update fig2_item_update
  python scripts/check_bench_schema_torch.py gram_cuda --path "$TMP/gram_cuda.json"
fi

if has --serve-smoke; then
  echo "== serve smoke: train -> export -> serve queries =="
  ART="$TMP/serve/artifact"
  python -m repro_torch.launch.bpmf "${TINY[@]}" --sweeps 2 --burn-in 1 --export-artifact "$ART"
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$ART" --rows 0,1,2 --cols 0,1,2 --std
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$ART" --user 0 --top-k 5
  printf '{"rows": [3, 4], "cols": [5, 6]}\n{"user": 1, "k": 3}\n' | \
    python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$ART" --jsonl
  bench_smoke serve_latency serve_latency --artifact "$ART"
fi

if has --block-smoke; then
  echo "== block smoke: 2-block ring run -> export -> serve =="
  BART="$TMP/block/artifact"
  python -m repro_torch.launch.bpmf "${TINY[@]}" --backend ring --num-shards 4 --sweeps 8 \
    --sweeps-per-block 4 --burn-in 2 --export-artifact "$BART"
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$BART" --rows 0,1,2 --cols 0,1,2 --std
  bench_smoke sweep_throughput sweep_throughput
fi

if has --server-smoke; then
  echo "== server smoke: train -> export -> persistent server =="
  SART="$TMP/server/artifact"
  python -m repro_torch.launch.bpmf "${TINY[@]}" --sweeps 2 --burn-in 1 --export-artifact "$SART"
  python -m repro_torch.launch.serve_server --device "$DEVICE" --artifact "$SART" --port 0 \
    --poll-interval 0.2 >"$TMP/server.log" 2>&1 &
  SRV_PID=$!
  trap 'kill "$SRV_PID" 2>/dev/null || true; rm -rf "$TMP"' EXIT
  ADDR=""
  for _ in $(seq 300); do
    ADDR="$(sed -n 's,.*http://\([0-9.]*:[0-9]*\).*,\1,p' "$TMP/server.log" | head -1)"
    [[ -n "$ADDR" ]] && break
    kill -0 "$SRV_PID" 2>/dev/null || break
    sleep 0.2
  done
  if [[ -z "$ADDR" ]]; then
    echo "server did not start:"; cat "$TMP/server.log"; exit 1
  fi
  echo "== concurrent client burst against $ADDR =="
  python - "$ADDR" <<'PY'
import sys, threading
import numpy as np
from repro_torch.serve import ServeClient

addr = sys.argv[1]
errors = []

def worker(i):
    c = ServeClient(addr)
    rng = np.random.default_rng(i)
    for _ in range(25):
        r = c.request({"rows": rng.integers(0, 80, 3).tolist(), "cols": rng.integers(0, 40, 3).tolist()})
        if "error" in r or len(r.get("predictions", [])) != 3:
            errors.append(r)
        r = c.request({"user": int(rng.integers(0, 80)), "k": 5})
        if "error" in r or len(r.get("items", [])) != 5:
            errors.append(r)
    c.close()

threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
for t in threads: t.start()
for t in threads: t.join(timeout=120)
assert not any(t.is_alive() for t in threads), "a client thread hung"
assert not errors, errors[:3]
st = ServeClient(addr).stats()["batcher"]
print(f"burst OK: {st['requests']} requests in {st['cycles']} cycles (occupancy {st['occupancy']:.2f})")
PY
  python -m repro_torch.launch.serve --server "$ADDR" --user 0 --top-k 5
  echo "== hot-swap: re-export into the live artifact directory =="
  python -m repro_torch.launch.bpmf "${TINY[@]}" --sweeps 4 --burn-in 1 --export-artifact "$SART"
  python - "$ADDR" <<'PY'
import sys, threading, time
import numpy as np
from repro_torch.serve import ServeClient

addr = sys.argv[1]
stop = threading.Event()
errors = []

def hammer(i):
    c = ServeClient(addr)
    rng = np.random.default_rng(i)
    while not stop.is_set():
        r = c.request({"user": int(rng.integers(0, 80)), "k": 5})
        if "error" in r:
            errors.append(r)
    c.close()

threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
for t in threads: t.start()
probe = ServeClient(addr)
deadline = time.time() + 60
h = probe.health()
while h["generation"] < 1 and time.time() < deadline:
    time.sleep(0.2)
    h = probe.health()
stop.set()
for t in threads: t.join(timeout=60)
assert h["generation"] >= 1, f"no hot-swap observed: {h}"
assert h["swap_failures"] == 0, h
assert not errors, errors[:3]
print(f"hot-swap OK: generation {h['generation']}, no request errors under concurrent load")
PY
  kill -TERM "$SRV_PID"
  wait "$SRV_PID"
  trap 'rm -rf "$TMP"' EXIT
  grep -q "server stopped cleanly" "$TMP/server.log"
  echo "clean shutdown OK"
  bench_smoke serve_load serve_latency --load
fi

if has --merge-smoke; then
  echo "== merge smoke: 2-partition posterior_merge run -> export -> serve =="
  MART="$TMP/merge/artifact"
  python -m repro_torch.launch.bpmf "${TINY[@]}" --backend posterior_merge --num-partitions 2 \
    --sweeps 6 --sweeps-per-block 3 --burn-in 2 --export-artifact "$MART"
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$MART" --rows 0,1,2 --cols 0,1,2 --std
  bench_smoke fig_merge_comm fig_merge_comm
fi

if has --overlap-smoke; then
  echo "== overlap smoke: depth-2 pipelined run -> checkpoint -> resume -> export =="
  OART="$TMP/overlap/artifact"
  RING=(--backend ring --num-shards 4 --sweeps 8 --sweeps-per-block 2 --pipeline-blocks 2 --burn-in 2)
  python -m repro_torch.launch.bpmf "${TINY[@]}" "${RING[@]}" \
    --checkpoint-dir "$TMP/overlap/ckpt" --checkpoint-every 3
  test -d "$TMP/overlap/ckpt/step_00000006"
  python -m repro_torch.launch.bpmf "${TINY[@]}" "${RING[@]}" \
    --checkpoint-dir "$TMP/overlap/ckpt" --resume --export-artifact "$OART"
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$OART" --rows 0,1,2 --cols 0,1,2
  # the copies-not-donated path stays runnable
  python -m repro_torch.launch.bpmf "${TINY[@]}" --sweeps 2 --burn-in 1 \
    --pipeline-blocks 2 --donate-blocks off --sync-checkpoint-writes
  bench_smoke fig5_overlap fig5_overlap
fi

if has --multiproc-smoke; then
  echo "== multiproc smoke: 2-process ring gang -> checkpoint -> 1-process restart -> serve =="
  MPART="$TMP/mp/artifact"
  python -m repro_torch.launch.multiproc --num-processes 2 --timeout 600 -- \
    "${TINY[@]}" --backend ring --num-shards 4 --sweeps 4 --sweeps-per-block 2 --burn-in 2 \
    --checkpoint-dir "$TMP/mp/ckpt" --checkpoint-every 2
  test -d "$TMP/mp/ckpt/step_00000004"
  # the same checkpoint at another process count (the same shard count), on to the end
  python -m repro_torch.launch.multiproc --num-processes 1 --timeout 600 -- \
    "${TINY[@]}" --backend ring --num-shards 4 --sweeps 8 --sweeps-per-block 2 --burn-in 2 \
    --checkpoint-dir "$TMP/mp/ckpt" --resume --export-artifact "$MPART"
  python -m repro_torch.launch.serve --device "$DEVICE" --artifact "$MPART" --rows 0,1,2 --cols 0,1,2
  bench_smoke fig4_scaling fig4_scaling --processes 1,2
fi

# test files or directories among the arguments replace the default set
# (the GPU machine has no JAX: there, name tests/test_torch_cuda.py)
TARGETS=()
OPTS=()
for a in ${ARGS[@]+"${ARGS[@]}"}; do
  if [[ -e "$a" || "$a" == tests/*::* ]]; then TARGETS+=("$a"); else OPTS+=("$a"); fi
done
[[ ${#TARGETS[@]} -gt 0 ]] || TARGETS=(tests/test_torch_*.py)
python -m pytest -q "${TARGETS[@]}" ${OPTS[@]+"${OPTS[@]}"}
