"""LM training and serving steps: losses, AdamW, the train step, prefill and decode."""
from repro_torch.training.lm_serve import make_decode_step, make_prefill_step
from repro_torch.training.losses import lm_loss, total_loss
from repro_torch.training.optimizer import AdamW, OptState, warmup_cosine
from repro_torch.training.train import TrainState, init_train_state, make_train_step

__all__ = [
    "lm_loss",
    "total_loss",
    "AdamW",
    "OptState",
    "warmup_cosine",
    "TrainState",
    "make_train_step",
    "init_train_state",
    "make_prefill_step",
    "make_decode_step",
]
