"""PyTorch / CUDA port of the evolutionary FPGA memory packer.

`repro_torch.core` mirrors `repro.core` (problem model, heuristics, GA,
SA, `pack`); `repro_torch.kernels` holds the hand-written CUDA kernels
that replace the reference's Pallas kernels, each beside its plain PyTorch
version.  The port imports neither JAX nor the `repro` package.
"""
