"""Carry problem, packing and parameter state into the port from plain data.

The packing side's state is the problem (buffer geometry plus the RAM
inventory) and the packing (bins plus their RAM-kind lane); the memory
planner's is a model's parameter tree.  Every function takes plain numbers,
lists and numpy arrays — what ``repro``'s ``PackingProblem`` arrays,
``Solution.state_dict()`` and ``jax.device_get`` of its parameters hold — so
a test can rebuild the reference's problem, warm-start the port from a
reference packing and carry the reference's weights across without the
port importing ``repro``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.problem import (
    RAM_KINDS,
    Buffer,
    OCMInventory,
    PackingProblem,
    Solution,
)
from .device import resolve_device


def problem_from_arrays(
    widths: Sequence[int],
    depths: Sequence[int],
    layers: Sequence[int],
    ram_kind_names: Sequence[str] | None = None,
    counts: Sequence[int] | None = None,
    max_items: int = 4,
    name: str = "",
    ocm_name: str = "",
) -> PackingProblem:
    """A `PackingProblem` from per-buffer arrays.

    Without ``ram_kind_names`` the problem is the paper's single-kind
    BRAM18 model; with them, an `OCMInventory` of the named registry kinds
    (``RAM_KINDS``, kind-lane order as given) and per-kind ``counts``
    (``-1`` = unbounded).
    """
    if not len(widths) == len(depths) == len(layers):
        raise ValueError("widths, depths and layers must have equal length")
    bufs = [
        Buffer(width=int(w), depth=int(d), layer=int(l))
        for w, d, l in zip(widths, depths, layers)
    ]
    if ram_kind_names is None:
        if counts is not None:
            raise ValueError("counts needs ram_kind_names")
        return PackingProblem(bufs, max_items=max_items, name=name)
    if counts is None or len(counts) != len(ram_kind_names):
        raise ValueError("ram_kind_names and counts must have equal length")
    ocm = OCMInventory(
        kinds=tuple(RAM_KINDS[k] for k in ram_kind_names),
        counts=tuple(int(c) for c in counts),
        name=ocm_name,
    )
    return PackingProblem(bufs, max_items=max_items, name=name, ocm=ocm)


def solution_from_state(problem: PackingProblem, state: dict) -> Solution:
    """A `Solution` from a ``{"bins": [[...], ...], "kinds": [...]}`` state
    (the reference's ``Solution.state_dict()``); its geometry starts cold
    and re-derives every cost from the buffers."""
    return Solution.from_state_dict(problem, state)


def params_from_arrays(tree, device=None):
    """The port's parameter tree from the reference's: nested dicts (and
    lists / tuples) of numpy arrays, e.g. ``jax.device_get`` of
    ``repro.models.model.init_params(...)``, become the same structure of
    torch tensors on ``device`` (``None`` means ``"cuda"``), values and
    dtypes unchanged (numpy has no bfloat16 of its own: an ``ml_dtypes``
    bfloat16 array comes across bit for bit through its 16-bit pattern)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        if node is None:
            return None
        arr = np.array(node)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)

    return convert(tree)
