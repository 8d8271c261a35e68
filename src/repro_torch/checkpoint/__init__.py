"""Atomic, hashed checkpoints (the port's `repro.checkpoint`), in the
reference's on-disk layout."""
from .manager import (  # noqa: F401
    CheckpointManager,
    read_atomic_dir,
    write_atomic_dir,
)
