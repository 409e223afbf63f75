"""Quickstart of the PyTorch port: BPMF on a synthetic MovieLens-100k-shaped dataset.

    PYTHONPATH=src python examples_torch/quickstart.py                # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu

The port's counterpart of ``examples/quickstart.py``. Factorizes
``R ~ U V^T`` with the Gibbs sampler (paper Algorithm 1) through the
``repro_torch.bpmf`` engine and shows the RMSE dropping toward the
generative noise floor, then exports the posterior and serves a few
queries from it (DESIGN.md §9), checking that the served predictions are
the engine's. The same script runs distributed by changing
``name="sequential"`` to ``"ring"``: see ``examples_torch/distributed_bpmf.py``.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.bpmf import BPMFConfig, BPMFEngine
from repro_torch.data.synthetic import small_test_ratings
from repro_torch.serve import PosteriorPredictor


def main(argv: list[str] | None = None) -> None:
    """Fit, check convergence, export, serve, and print ``ok``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where to run (default cuda)")
    ap.add_argument("--sweeps", type=int, default=25)
    args = ap.parse_args(argv)

    coo, truth = small_test_ratings(num_users=400, num_movies=300, nnz=12_000, noise_std=0.35)
    cfg = BPMFConfig().replace(name="sequential", K=16, num_sweeps=args.sweeps, burn_in=5)

    print(f"R: {coo.num_users} x {coo.num_movies}, {coo.nnz} ratings; K={cfg.model.K}; device {args.device}")
    engine = BPMFEngine(cfg, device=args.device)
    for m in engine.sample(coo):
        if int(m.sweep) % 5 == 0:
            print(f"  sweep {int(m.sweep):3d}  rmse(sample)={m.rmse_sample:.4f}  rmse(avg)={m.rmse_avg:.4f}")
    print(f"final averaged-prediction RMSE: {engine.rmse:.4f} (generative noise floor ~{truth['noise_std']})")
    assert engine.rmse < 2.5 * truth["noise_std"], "did not converge"

    # posterior-mean serving: export the artifact, load it back, query it
    artifact = engine.export(tempfile.mkdtemp(prefix="bpmf-quickstart-") + "/artifact")
    predictor = PosteriorPredictor.load(artifact, device=args.device)
    rows, cols = np.arange(5), np.arange(5)
    preds, std = predictor.predict(rows, cols, return_std=True)
    assert np.array_equal(preds, engine.predict(rows, cols)), "served != in-process"
    items, scores = predictor.top_k(user=0, k=3)
    print(f"served predictions {np.round(preds, 3)} (std {np.round(std, 3)})")
    print(f"top-3 movies for user 0: {items.tolist()} scores {np.round(scores, 3)}")
    print("ok")


if __name__ == "__main__":
    main()
