"""Evolutionary bin packing for memory-efficient dataflow inference (the
PyTorch / CUDA port of `repro.core`).

Cardinality-constrained, variable-bin-size bin packing of parameter
memories onto physical RAM grids, solved with the Next-Fit Dynamic
heuristic hybridized into genetic algorithms and simulated annealing.  The
GA's population fitness and the SA's delta costs run through the
hand-written CUDA kernels of `repro_torch.kernels`.
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
from .api import ALGORITHMS, make_packer, pack  # noqa: F401
from .ga import GeneticPacker, buffer_swap, kind_reassign  # noqa: F401
from .nfd import nfd_from_scratch, nfd_pack_order, nfd_repack  # noqa: F401
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
    encode_problem_batch,
    greedy_assign_kinds,
)
from .sa import SimulatedAnnealingPacker  # noqa: F401
