"""Tile-grid memory planner (the port's ``repro.memory``): plan packed
parameter banks with the paper's packers and serve them from a
`PackedParameterStore`; `repro_torch.kernels.packed_gather` reads a bank."""
from .planner import BankPlan, InvalidPlan, PlanEntry, plan_packing, tile_efficiency  # noqa: F401
from .store import PackedParameterStore  # noqa: F401
from .tiles import TILE_ROWS, padded_bytes, tile_grid_problem  # noqa: F401
