"""PackedParameterStore: materialize a BankPlan and serve logical views.

The store holds (a) fused 2-D bank tensors for packed tensors and (b) plain
tensors for everything else.  ``view(path)`` slices a logical tensor back
out (`repro_torch.kernels.packed_gather` is the fused read of a whole
bank).  ``unpack()`` rebuilds the full parameter tree.

As in ``repro.memory.PackedParameterStore``, a stacked leaf whose per-layer
slices (``path#k``) were packed is kept whole among the plain tensors as
well: ``unpack()`` returns it from there, ``physical_bytes()`` counts it
beside the banks, and only ``view(path#k)`` reads the bank.

Building the banks is the span ``memory.store.build`` (`repro_torch.obs`);
the counter ``memory.store.bytes`` adds the banks' bytes.
"""
from __future__ import annotations

import torch

from .. import obs
from . import tiles
from .planner import BankPlan, PlanEntry, leaves_with_paths


class PackedParameterStore:
    def __init__(self, params, plans: dict[int, BankPlan]):
        """Build every bank of ``plans`` from ``params`` (nested dicts of
        tensors) on the device of the bank's first entry, in that entry's
        dtype.  The plain tensors are the leaves themselves, not copies."""
        self._tree = params
        flat = list(leaves_with_paths(params))
        self._leaf_shapes = {p: tuple(leaf.shape) for p, leaf in flat}
        base = dict(flat)

        def by_path(path):
            """Resolves both plain paths and split-stacked 'path#k' slices."""
            if "#" in path:
                root, k = path.rsplit("#", 1)
                return base[root][int(k)]
            return base[path]

        self.plans = plans
        self.banks: dict[tuple[int, int], torch.Tensor] = {}
        self.entries: dict[str, tuple[int, int, PlanEntry]] = {}
        self.plain: dict[str, torch.Tensor] = {}
        packed_paths = set()
        tok = obs.begin("memory.store.build")
        for itemsize, plan in plans.items():
            sub = tiles.TILE_ROWS.get(itemsize, 8)
            for bi, bank in enumerate(plan.banks):
                rows = sum(e.rows for e in bank)
                cols = max(e.cols for e in bank)
                prows = -(-rows // sub) * sub
                pcols = -(-cols // tiles.LANES) * tiles.LANES
                first = by_path(bank[0].path)
                buf = torch.zeros((prows, pcols), dtype=first.dtype, device=first.device)
                for e in bank:
                    leaf = by_path(e.path)
                    if leaf.dtype != buf.dtype:
                        raise TypeError(
                            f"bank {bi}: {e.path} is {leaf.dtype}, the bank {buf.dtype}"
                        )
                    buf[e.row_offset:e.row_offset + e.rows, :e.cols] = leaf.reshape(
                        e.rows, e.cols
                    )
                    self.entries[e.path] = (itemsize, bi, e)
                    packed_paths.add(e.path)
                self.banks[(itemsize, bi)] = buf
                obs.count("memory.store.bytes", buf.numel() * buf.element_size())
        obs.end(tok)
        for path, leaf in base.items():
            if path not in packed_paths:
                self.plain[path] = leaf

    # ------------------------------------------------------------------ API
    def view(self, path: str) -> torch.Tensor:
        """The logical tensor at ``path`` (or its ``path#k`` slice).  A packed
        one is a view that aliases its bank -- unlike the reference's JAX
        slice, which is an immutable copy -- so writing to it writes the
        bank; a plain one is the leaf the store was built from."""
        if path in self.plain:
            return self.plain[path]
        itemsize, bi, e = self.entries[path]
        bank = self.banks[(itemsize, bi)]
        block = bank[e.row_offset:e.row_offset + e.rows, :e.cols]
        return block.reshape(e.shape)

    def unpack(self):
        """Rebuild the full parameter tree.  Every leaf is either plain or
        packed whole (a split-stacked leaf stays plain, see the module
        docstring), so the reference's re-stacking of ``path#k`` slices
        never runs and is left out."""
        leaves = {p: self.view(p).reshape(s) for p, s in self._leaf_shapes.items()}
        return _rebuild(self._tree, (), leaves)

    def physical_bytes(self) -> int:
        total = sum(b.numel() * b.element_size() for b in self.banks.values())
        total += sum(
            tiles.padded_bytes(tuple(a.shape), a.dtype.itemsize)
            for a in self.plain.values()
        )
        return total

    def stats(self) -> dict:
        out = {}
        for itemsize, plan in self.plans.items():
            out[itemsize] = dict(
                banks=len(plan.banks),
                packed_tensors=sum(len(b) for b in plan.banks),
                unpacked_tensors=len(plan.unpacked),
                padded_bytes_before=plan.padded_bytes_before,
                padded_bytes_after=plan.padded_bytes_after,
                saved_bytes=plan.saved_bytes,
                efficiency_before=plan.efficiency_before(),
                efficiency_after=plan.efficiency_after(),
            )
        return out


def _rebuild(tree, prefix, leaves):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (str(k),), leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, prefix + (f"layer_{i}",), leaves) for i, v in enumerate(tree)
        )
    if tree is None:
        return None
    return leaves["/".join(prefix)]
