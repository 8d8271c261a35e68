"""Step factories and the fault-tolerant training loop (the port's
`repro.runtime`)."""
from .steps import (  # noqa: F401
    TrainState,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
