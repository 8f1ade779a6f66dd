"""Checkpoints in the JAX package's on-disk format (port of
``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpointing import (  # noqa: F401
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)
