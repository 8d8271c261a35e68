"""Fused SA step: K3 / K4 delta costs and the host Metropolis rule.

`ops.sa_step_deltas` reduces padded (C, T) — or (NP, C, T) — touched-bin
geometry to per-chain integer cost deltas."""
from .kernel import sa_step_deltas_cuda, sa_step_deltas_kinds_cuda  # noqa: F401
from .ops import metropolis_mask, sa_step_deltas  # noqa: F401
from .ref import sa_step_deltas_kinds_ref, sa_step_deltas_ref  # noqa: F401
