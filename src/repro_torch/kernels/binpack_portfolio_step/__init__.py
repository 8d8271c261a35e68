"""Fused portfolio step (K5): a stacked GA generation's population fitness
and one SA fleet step's delta costs in one launch — the device program
behind the island portfolio's fused barriers (`core.portfolio`)."""
from .kernel import portfolio_step_cuda, portfolio_step_kinds_cuda  # noqa: F401
from .ops import portfolio_step  # noqa: F401
from .ref import portfolio_step_kinds_ref, portfolio_step_ref  # noqa: F401
