"""PyTorch / CUDA port of the evolutionary FPGA memory packer.

`repro_torch.core` mirrors `repro.core` (problem model, heuristics, GA,
SA, `pack`); `repro_torch.kernels` holds the hand-written CUDA kernels
that replace the reference's Pallas kernels, each beside its plain PyTorch
version.  `repro_torch.data`, `repro_torch.configs` and
`repro_torch.models` carry the data pipeline and the LM stack, served by
`repro_torch.launch.decode_demo` and trained by `repro_torch.launch.train`
(`repro_torch.optim`, `repro_torch.runtime`).  The port imports neither
JAX nor the `repro` package.
"""
