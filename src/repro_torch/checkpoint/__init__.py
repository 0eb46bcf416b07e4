"""Atomic on-disk checkpoints of the port (``repro.checkpoint``'s format)."""

from .ckpt import (config_fingerprint, flatten, latest_step, prune,
                   read_leaf, restore, save, unflatten)

__all__ = ["save", "restore", "latest_step", "config_fingerprint",
           "read_leaf", "prune", "flatten", "unflatten"]
