"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: `binpack_fitness` (K1 / K2, GA fitness) and `binpack_sa_step`
(K3 / K4, SA delta cost).  `build` compiles ``csrc/`` at first use."""


def kernel_wrappers() -> tuple:
    """The four CUDA kernel wrappers, each counting its launches."""
    from .binpack_fitness import binpack_fitness_cuda, binpack_fitness_kinds_cuda
    from .binpack_sa_step import sa_step_deltas_cuda, sa_step_deltas_kinds_cuda

    return (binpack_fitness_cuda, binpack_fitness_kinds_cuda,
            sa_step_deltas_cuda, sa_step_deltas_kinds_cuda)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last `reset_launch_counts`."""
    return {f.__name__: f.launches for f in kernel_wrappers()}


def reset_launch_counts() -> None:
    for f in kernel_wrappers():
        f.launches = 0
