"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: `binpack_fitness` (K1 / K2, GA fitness), `binpack_sa_step`
(K3 / K4, SA delta cost), `binpack_portfolio_step` (K5, both at once
for the island portfolio's fused barriers) and `packed_gather` (K6, the
fused read of a packed parameter bank).  `build` compiles ``csrc/`` at
first use."""
from .. import obs


def kernel_wrappers() -> tuple:
    """The CUDA kernel wrappers, each counting its launches in the counter
    ``launch.<name>`` (`repro_torch.obs`)."""
    from .binpack_fitness import binpack_fitness_cuda, binpack_fitness_kinds_cuda
    from .binpack_portfolio_step import portfolio_step_cuda, portfolio_step_kinds_cuda
    from .binpack_sa_step import sa_step_deltas_cuda, sa_step_deltas_kinds_cuda
    from .packed_gather import packed_gather_cuda

    return (binpack_fitness_cuda, binpack_fitness_kinds_cuda,
            sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
            portfolio_step_cuda, portfolio_step_kinds_cuda, packed_gather_cuda)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last `reset_launch_counts`."""
    return {f.__name__: obs.counter("launch." + f.__name__) for f in kernel_wrappers()}


def reset_launch_counts() -> None:
    obs.reset_counters(["launch." + f.__name__ for f in kernel_wrappers()])
