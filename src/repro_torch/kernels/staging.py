"""Host->device staging for the ops layers: one copy per call.

The engines keep their state in host numpy, so every ops call moves a few
small int32 planes to the device.  Each copy from pageable memory costs a
staging pass and a synchronisation of its own, so ``stage_groups`` packs
all of a call's planes, of one width or several, into ONE host buffer and
moves it with one asynchronous copy (``stage`` for planes of one shape).
For a CUDA device the buffer comes from PyTorch's pinned caching allocator;
for a CPU device the same code runs on an ordinary buffer (what the CPU
tests drive).  The result comes back with one ``.cpu()``: a pinned result
buffer with a wait on an event was measured slower on the H100 (PERF.md).

Buffers are taken per call from the allocator, never kept in a module-level
buffer: the island portfolio's lane threads call the ops layer at once.
Nothing falls back: a pin or a copy that fails raises.

Spans (`repro_torch.obs`): ``ops.alloc`` (sizing and taking the host
buffer), ``ops.fill`` (the planes into it), ``ops.copy`` (the copy's
enqueue and the device views of it).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs


def host_buffer(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An uninitialised host tensor for a copy to ``device``: pinned
    (page-locked, from the caching host allocator) for a CUDA device,
    ordinary memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _plane_shape(arrays) -> tuple[int, ...]:
    """The one shape of a group of planes; raises on mixed shapes."""
    shape = np.shape(arrays[0])
    if not shape:
        raise ValueError("planes need at least one axis")
    if any(np.shape(a) != shape for a in arrays):
        raise ValueError(
            f"planes must share one shape, got {[np.shape(x) for x in arrays]}"
        )
    return shape


def stage_groups(groups, device) -> tuple[torch.Tensor, ...]:
    """Groups of host planes, each group of one shape ``(..., T_g)`` (the
    widths may differ between groups, as the fused portfolio step's
    ``NB``-wide population planes and ``T``-wide step planes do), as int32
    tensors on ``device``: every plane filled into ONE flat host buffer
    (one ``np.concatenate`` a group) and moved with ONE asynchronous copy.
    Returns one ``(P_g, R_g, T_g)`` tensor per group (``R_g`` the product
    of the leading axes), each a contiguous view of the one device buffer,
    the groups back to back in the order given; plane ``i`` of a group is
    its contiguous ``(R_g, T_g)`` slice ``i``."""
    tok = obs.begin("ops.alloc")
    device = torch.device(device)
    shapes = [_plane_shape(arrays) for arrays in groups]
    sizes = [len(a) * math.prod(s) for a, s in zip(groups, shapes)]
    host = host_buffer((sum(sizes),), torch.int32, device)
    obs.end(tok)
    tok = obs.begin("ops.fill")
    flat = host.numpy()
    start = 0
    for arrays, shape, size in zip(groups, shapes, sizes):
        # the planes lie back to back along the group's first axis; int32
        # cast as np.asarray(a, dtype=np.int32) casts
        np.concatenate(arrays, axis=0, casting="unsafe",
                       out=flat[start:start + size].reshape((len(arrays) * shape[0],)
                                                             + shape[1:]))
        start += size
    obs.end(tok)
    tok = obs.begin("ops.copy")
    moved = host.to(device, non_blocking=True)
    out = tuple(
        part.view(len(arrays), math.prod(shape[:-1]), shape[-1])
        for part, arrays, shape in zip(moved.split(sizes), groups, shapes)
    )
    obs.end(tok)
    return out


def stage(arrays, device) -> torch.Tensor:
    """`stage_groups` for one group: the host ``arrays``, all of one shape
    ``(..., T)``, as one ``(P, R, T)`` int32 tensor on ``device``."""
    return stage_groups((arrays,), device)[0]
