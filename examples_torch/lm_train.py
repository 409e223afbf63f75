"""Train a reduced assigned-architecture LM end to end with the port.

    PYTHONPATH=src python examples_torch/lm_train.py --arch yi-6b --steps 60              # on the card
    PYTHONPATH=src python examples_torch/lm_train.py --device cpu --arch gemma-2b --steps 20
    PYTHONPATH=src python examples_torch/lm_train.py --device cpu --arch minicpm3-4b --steps 20
    PYTHONPATH=src python examples_torch/lm_train.py --device cpu --arch mixtral-8x22b --steps 20

The port's counterpart of ``examples/lm_train.py``: the same train-step
and launcher path (``python -m repro_torch.launch.train --help`` lists all
knobs), at batch 8 and 64 tokens, with the reference's flags plus
``--device``. Every config runs: the attention family (gemma-2b, yi-6b,
chameleon-34b, nemotron-4-340b, hubert-xlarge), MLA (minicpm3-4b), MoE
(grok-1-314b, mixtral-8x22b), mamba2-130m and zamba2-2.7b. Exits 0 when
the loss fell.
"""
import argparse
import sys

from repro_torch.launch.train import main as train_main


def main(argv: list[str] | None = None) -> int:
    """Run the launcher on the reduced config; its exit code (0 = the loss fell)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="where to run (default cuda)")
    args, extra = ap.parse_known_args(argv)
    return train_main([
        "--arch", args.arch, "--reduced", "--steps", str(args.steps),
        "--batch", "8", "--seq", "64", "--device", args.device, *extra,
    ])


if __name__ == "__main__":
    sys.exit(main())
