"""Host->device staging for the ops layers: one copy per call.

The engines keep their state in host numpy, so every ops call moves a few
small int32 planes to the device.  Each copy from pageable memory costs a
staging pass and a synchronisation of its own, so ``stage`` packs all of a
call's planes into ONE host buffer and moves it with one asynchronous copy.
For a CUDA device the buffer comes from PyTorch's pinned caching allocator;
for a CPU device the same code runs on an ordinary buffer (what the CPU
tests drive).  The result comes back with one ``.cpu()``: a pinned result
buffer with a wait on an event was measured slower on the H100 (PERF.md).

Buffers are taken per call from the allocator, never kept in a module-level
buffer: the island portfolio's lane threads call the ops layer at once.
Nothing falls back: a pin or a copy that fails raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def host_buffer(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An uninitialised host tensor for a copy to ``device``: pinned
    (page-locked, from the caching host allocator) for a CUDA device,
    ordinary memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def stage(arrays, device) -> torch.Tensor:
    """The host ``arrays``, all of one shape ``(..., T)``, as one ``(P, R, T)``
    int32 tensor on ``device`` (``R`` the product of the leading axes):
    filled into one host buffer by one ``np.concatenate``, moved with one
    asynchronous copy.  ``out[i]`` is plane ``i``, a contiguous ``(R, T)``
    view."""
    device = torch.device(device)
    shape = np.shape(arrays[0])
    if not shape:
        raise ValueError("planes need at least one axis")
    if any(np.shape(a) != shape for a in arrays):
        raise ValueError(
            f"planes must share one shape, got {[np.shape(x) for x in arrays]}"
        )
    t = shape[-1]
    rows = math.prod(shape[:-1])
    host = host_buffer((len(arrays), rows, t), torch.int32, device)
    # the planes lie back to back along the buffer's first axis; int32 cast
    # as np.asarray(a, dtype=np.int32) casts
    np.concatenate(arrays, axis=0, casting="unsafe",
                   out=host.numpy().reshape((len(arrays) * shape[0],) + shape[1:]))
    return host.to(device, non_blocking=True)
