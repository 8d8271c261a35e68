"""Device and backend resolution for the port's entry points.

``device=None`` means ``"cuda"``, and a CUDA device on a host without CUDA
raises: the port never carries on silently on the CPU.  Callers that want
the host (the CPU tests) pass ``device="cpu"``.

Backends (the port's counterpart of ``repro.core.ga.BACKENDS``):

* ``"python"`` — host numpy, the reference's own code: the port's
  independent oracle (GA: incremental scalar costs; SA: numpy deltas).
* ``"torch"`` — the kernels' plain PyTorch versions on ``device``.
* ``"cuda"`` — the hand-written CUDA kernels (on a CPU device their
  wrappers take the plain versions).
* ``"auto"`` — ``"cuda"`` on a CUDA device, ``"torch"`` on the CPU.
* ``"legacy"`` — the seed's from-scratch scalar evaluation (no caches, no
  batched call, nothing launched on any device), kept as the benchmark
  baseline: GA costs from ``cost_full()``, SA on the scalar loop.

All backends are bit-identical per seed.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "python", "torch", "cuda", "legacy")


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; options: cuda, cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    return dev


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")


def resolve_backend(backend: str, device: torch.device) -> str:
    check_backend(backend)
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return backend
