"""Launchers of the port (the counterpart of `repro.launch`): the 1-D
``("prob",)`` sweep mesh that `pack_sweep`, `solve_batch` and
`pack_portfolio` take as ``mesh=``, and the LM meshes (production and
host); `decode_demo` (batched LM serving, ``--packed`` through the memory
planner), `train` (the training launcher over
`repro_torch.runtime.loop.TrainLoop`) and the production-mesh dry run
(`specs`, `op_analysis`, `dryrun`, `report`) are modules of their own."""
from .mesh import (  # noqa: F401
    SweepMesh,
    make_host_mesh,
    make_production_mesh,
    make_sweep_mesh,
)
