"""The optimizer of the training path: AdamW and the cosine schedule.  The
port of ``repro.optim``."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]
