"""Evolutionary bin packing for memory-efficient dataflow inference (the
PyTorch / CUDA port of `repro.core`).

Cardinality-constrained, variable-bin-size bin packing of parameter
memories onto physical RAM grids, solved with the Next-Fit Dynamic
heuristic hybridized into genetic algorithms and simulated annealing.  The
GA's population fitness and the SA's delta costs (and, in the island
portfolio, both at once) run through the hand-written CUDA kernels of
`repro_torch.kernels`; `pack_sweep` runs them over a fleet of problems, and
`pack_sweep` / `pack_portfolio` checkpoint and resume (`core.resume`).
"""
from .accelerators import (  # noqa: F401
    ACCELERATORS,
    OCM_DEVICES,
    PAPER_TABLE2,
    PAPER_TABLE3,
    PAPER_TABLE4,
    TABLE1_ROWS,
    get_buffers,
    get_ocm,
    get_problem,
    hyperparams,
)
from .api import ALGORITHMS, make_packer, pack, pack_sweep  # noqa: F401
from .dse import SweepResult, solve_batch, task_key  # noqa: F401
from .ga import GeneticPacker, buffer_swap, kind_reassign  # noqa: F401
from .nfd import nfd_from_scratch, nfd_pack_order, nfd_repack  # noqa: F401
from .portfolio import (  # noqa: F401
    DEFAULT_RACE_GRID,
    IslandSpec,
    TruncationWarning,
    pack_portfolio,
    pack_portfolio_threads,
)
from .problem import (  # noqa: F401
    BRAM18,
    BRAM18_CAPACITY_BITS,
    BRAM18_MODES,
    DEFAULT_INVENTORY_PENALTY,
    BRAM36,
    BRAMSpec,
    Buffer,
    LUTRAM64,
    OCMInventory,
    PackingProblem,
    PackingResult,
    ProblemBatch,
    RAM_KINDS,
    RAMKind,
    Solution,
    URAM288,
    batch_group_key,
    buffers_from_shape_rows,
    decode_problem_batch,
    encode_problem_batch,
    greedy_assign_kinds,
    register_ram_kind,
)
from .sa import SimulatedAnnealingPacker  # noqa: F401
