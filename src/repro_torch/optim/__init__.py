"""AdamW and the learning-rate schedule of the port (``repro.optim``)."""

from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule"]
