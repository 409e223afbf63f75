"""Checkpoints in the JAX package's on-disk format (npy leaves + manifest)."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointSchemaError,
    ShardedHostLeaf,
    host_snapshot_leaf,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = [
    "CheckpointCorruptError",
    "CheckpointError",
    "CheckpointManager",
    "CheckpointSchemaError",
    "ShardedHostLeaf",
    "host_snapshot_leaf",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
