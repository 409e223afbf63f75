"""End-to-end driver of the PyTorch port: BPMF on a ChEMBL-IC50-shaped dataset, with checkpoints.

    PYTHONPATH=src python examples_torch/bpmf_chembl.py --scale 0.05 --sweeps 40     # on the card
    PYTHONPATH=src python examples_torch/bpmf_chembl.py --device cpu --scale 0.01 --sweeps 10

The port's counterpart of ``examples/bpmf_chembl.py``: the paper's
drug-discovery benchmark shape (``--scale 1.0`` is the full 483,500 x 5,775
/ 1 M activities), driven through the distributed sampler's own functions
(``repro_torch.core.distributed``: build, place, init, one sweep at a
time) over a ring of ``--num-shards`` shards (4, the reference's forced
device count; on one card all of them share it), saving ``U``, ``V`` and
the sweep every ``--checkpoint-every`` sweeps through
``repro_torch.checkpoint.CheckpointManager`` into ``--checkpoint-dir``
(a fresh temporary directory by default). Asserts that the RMSE reaches
2.5 x the generative noise and prints ``ok``.
"""
import argparse
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import distributed as dist
from repro_torch.core import prng
from repro_torch.core.prediction import PredictionState
from repro_torch.core.types import BPMFConfig
from repro_torch.data.synthetic import CHEMBL_LIKE, SyntheticSpec, synthetic_ratings
from repro_torch.launch.mesh import bpmf_ring
from repro_torch.utils import resolve_device


def main(argv: list[str] | None = None) -> None:
    """Sample, checkpoint, check the RMSE, print ``ok``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where to run (default cuda)")
    ap.add_argument("--scale", type=float, default=0.05, help="fraction of ChEMBL size")
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--num-shards", type=int, default=4)
    ap.add_argument("--checkpoint-dir", default=None, help="default: a fresh temporary directory")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = CHEMBL_LIKE
    spec = SyntheticSpec(
        num_users=max(64, int(base.num_users * args.scale)),
        num_movies=max(32, int(base.num_movies * args.scale)),
        nnz=max(2000, int(base.nnz * args.scale)),
        discretize=False,
        noise_std=base.noise_std,
    )
    print(f"ChEMBL-shaped: {spec.num_users} compounds x {spec.num_movies} targets, "
          f"{spec.nnz} activities (scale={args.scale}) on {device}")
    coo, _ = synthetic_ratings(spec)

    ring = bpmf_ring(args.num_shards, device)
    cfg = BPMFConfig(K=args.k, num_sweeps=args.sweeps, burn_in=max(2, args.sweeps // 5))
    t0 = time.perf_counter()
    host, plan = dist.build_distributed_data(coo, num_shards=ring.num_shards, seed=0)
    data = dist.place_data(host, ring, cfg)
    print(f"partition+bucket: {time.perf_counter() - t0:.1f}s; LPT balance "
          f"{plan.part_users.balance_ratio():.3f}/{plan.part_movies.balance_ratio():.3f}")

    key = prng.key(0, ring.home)
    state = dist.init_dist_state(key, data, cfg, ring)
    pred = PredictionState.init(data.test.rows.shape[0], ring.home)
    checkpoint_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="bpmf-chembl-ckpt-")
    manager = CheckpointManager(checkpoint_dir, keep=2)

    t0 = time.perf_counter()
    try:
        for sweep in range(args.sweeps):
            state, pred, metrics = dist.dist_gibbs_sweep(key, state, pred, data, cfg, ring)
            if (sweep + 1) % 10 == 0 or sweep == 0:
                ups = (coo.num_users + coo.num_movies) * (sweep + 1) / (time.perf_counter() - t0)
                print(f"sweep {sweep + 1:4d} rmse(avg)={metrics.rmse_avg:.4f} ({ups:,.0f} updates/s)")
            if (sweep + 1) % args.checkpoint_every == 0:
                U, V = dist.gather_factors(state, plan)
                manager.save(sweep + 1, {"U": U, "V": V, "sweep": state.sweep.cpu().numpy()})
    finally:
        manager.close()
    final = metrics.rmse_avg
    print(f"done: rmse={final:.4f} noise floor ~{spec.noise_std}; checkpoints in {checkpoint_dir}")
    assert final < 2.5 * spec.noise_std
    print("ok")


if __name__ == "__main__":
    main()
