"""Launchers of the port (the counterpart of `repro.launch`): the 1-D
``("prob",)`` sweep mesh that `pack_sweep`, `solve_batch` and
`pack_portfolio` take as ``mesh=``; `decode_demo` (batched LM serving,
``--packed`` through the memory planner) and `train` (the training
launcher over `repro_torch.runtime.loop.TrainLoop`) are modules of their
own."""
from .mesh import SweepMesh, make_sweep_mesh  # noqa: F401
