"""AdamW with a cosine schedule (the port's `repro.optim`)."""
from .adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
