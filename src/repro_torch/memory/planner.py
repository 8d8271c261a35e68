"""Bank planner: run the paper's packers over a model's parameter tree.

Only tensors that actually waste tile padding (efficiency below a threshold)
are candidates; large tile-aligned matmul weights are left in place.  The
planner returns a BankPlan that the PackedParameterStore materializes.

The parameter tree is nested dicts (and lists / tuples) of tensors; any
leaf with ``.shape`` and ``.dtype`` works, ``device="meta"`` tensors
included, so a plan can be made from shapes alone.  Leaves are visited in
the reference's order -- dict keys sorted, as ``jax.tree_util`` flattens
them, not in insertion order -- because the buffer order fixes the GA's
packing and with it every bank.
"""
from __future__ import annotations

import dataclasses

from .. import obs
from ..core import api
from ..device import check_backend, resolve_device
from . import tiles

# top-level collections whose leaves are stacked over their layers
STACKED = ("layers", "enc_layers", "mamba_layers", "attn_layers")


class InvalidPlan(ValueError):
    """The packer's answer breaks a guarantee (`Solution.validate`): no
    bank is laid out from it.  ``result`` is that answer."""

    def __init__(self, message: str, result):
        super().__init__(message)
        self.result = result


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    path: str
    row_offset: int
    rows: int
    cols: int
    shape: tuple[int, ...]


@dataclasses.dataclass
class BankPlan:
    itemsize: int
    banks: list[list[PlanEntry]]  # one inner list per physical bank
    unpacked: list[str]  # paths stored as plain tensors
    padded_bytes_before: int
    padded_bytes_after: int
    logical_bytes: int
    packer_result: object | None = None

    @property
    def bank_shapes(self) -> list[tuple[int, int]]:
        out = []
        sub = tiles.TILE_ROWS.get(self.itemsize, 8)
        for bank in self.banks:
            rows = sum(e.rows for e in bank)
            cols = max(e.cols for e in bank)
            out.append(
                (-(-rows // sub) * sub, -(-cols // tiles.LANES) * tiles.LANES)
            )
        return out

    @property
    def saved_bytes(self) -> int:
        return self.padded_bytes_before - self.padded_bytes_after

    def efficiency_before(self) -> float:
        return self.logical_bytes / max(1, self.padded_bytes_before)

    def efficiency_after(self) -> float:
        return self.logical_bytes / max(1, self.padded_bytes_after)


def tile_efficiency(shape: tuple[int, ...], itemsize: int) -> float:
    return tiles.logical_bytes(shape, itemsize) / max(
        1, tiles.padded_bytes(shape, itemsize)
    )


def leaves_with_paths(tree, prefix: tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in the reference's flatten order: dict keys
    sorted, list / tuple items as ``layer_{i}``, ``None`` an empty node."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (f"layer_{i}",))
    elif tree is not None:
        yield "/".join(prefix), tree


def _flatten_params(params, split_stacked: bool = False) -> list[tuple[str, tuple[int, ...], int]]:
    """(path, shape, itemsize) per logical buffer.

    With ``split_stacked`` every leaf under a stacked-layer collection
    (`STACKED`) is split into per-layer slices ``path#k`` -- the
    deployment-artifact view (per-layer weights, as in FINN's per-layer
    memories and HF checkpoints).
    """
    out = []
    for ps, leaf in leaves_with_paths(params):
        shape = tuple(int(s) for s in leaf.shape)
        itemsize = leaf.dtype.itemsize
        if split_stacked and ps.split("/", 1)[0] in STACKED and "/" in ps and shape:
            for k in range(shape[0]):
                out.append((f"{ps}#{k}", shape[1:] or (1,), itemsize))
        else:
            out.append((ps, shape, itemsize))
    return out


def plan_packing(
    params,
    algorithm: str = "ga-nfd",
    max_items: int = 4,
    eff_threshold: float = 0.9,
    intra_layer: bool = False,
    max_seconds: float = 5.0,
    seed: int = 0,
    split_stacked: bool = False,
    backend: str = "auto",
    device=None,
    **settings,
) -> dict[int, BankPlan]:
    """Plan packed banks per dtype class.  Returns {itemsize: BankPlan}.

    The same plan as ``repro.memory.plan_packing`` for the same tree, as
    long as the packer stops on patience and not on ``max_seconds``
    (check ``packer_result.wall_time_s``).  ``settings`` go to the packer
    as they are (`repro_torch.core.pack`'s hyperparameters and budgets:
    ``n_chains``, ``max_iterations``, ``patience``, ``sa_t0``, ...), so a
    step budget fixes a plan's work by its seed; without them the packer
    runs on its defaults, as the reference's does.  ``backend`` and
    ``device`` go to `repro_torch.core.pack`: ``device`` defaults to
    ``"cuda"`` and raises where CUDA is not available; on the card the
    GA's fitness and SA's step deltas run on the hand-written kernels.

    Spans (`repro_torch.obs`): the entry span ``memory.plan`` over the
    call, and inside it ``memory.plan.flatten`` (the tree's leaves),
    ``memory.plan.problem`` (a dtype class's candidates and its tile-grid
    problem) and ``memory.plan.banks`` (the bins' bank layout); counters
    ``memory.plan.candidates`` and ``memory.plan.banks``.
    """
    with obs.span("memory.plan", entry=True):
        device = resolve_device(device)
        check_backend(backend)
        with obs.span("memory.plan.flatten"):
            entries = _flatten_params(params, split_stacked=split_stacked)
        plans: dict[int, BankPlan] = {}
        for itemsize in sorted({e[2] for e in entries}):
            tok = obs.begin("memory.plan.problem")
            klass = [e for e in entries if e[2] == itemsize]
            candidates = [
                e for e in klass if tile_efficiency(e[1], itemsize) < eff_threshold
            ]
            chosen = {e[0] for e in candidates}
            skipped = [e for e in klass if e[0] not in chosen]
            before = sum(tiles.padded_bytes(e[1], itemsize) for e in klass)
            logical = sum(tiles.logical_bytes(e[1], itemsize) for e in klass)
            if len(candidates) < 2:
                obs.end(tok)
                plans[itemsize] = BankPlan(
                    itemsize=itemsize, banks=[], unpacked=[e[0] for e in klass],
                    padded_bytes_before=before, padded_bytes_after=before,
                    logical_bytes=logical,
                )
                continue
            prob, paths = tiles.tile_grid_problem(candidates, max_items=max_items)
            obs.end(tok)
            obs.count("memory.plan.candidates", len(candidates))
            result = api.pack(
                prob, algorithm, seed=seed, max_seconds=max_seconds,
                intra_layer=intra_layer, backend=backend, device=device, **settings,
            )
            try:
                result.solution.validate(intra_layer=intra_layer)
            except ValueError as e:
                raise InvalidPlan(str(e), result) from e
            tok = obs.begin("memory.plan.banks")
            shape_by_path = {e[0]: e[1] for e in candidates}
            banks: list[list[PlanEntry]] = []
            packed_bytes = 0
            sub = tiles.TILE_ROWS.get(itemsize, 8)
            for bin_items in result.solution.bins:
                bank = []
                row = 0
                cols = 0
                for idx in bin_items:
                    path = paths[idx]
                    r, c = tiles.fold_2d(shape_by_path[path])
                    bank.append(
                        PlanEntry(
                            path=path, row_offset=row, rows=r, cols=c,
                            shape=shape_by_path[path],
                        )
                    )
                    row += r
                    cols = max(cols, c)
                banks.append(bank)
                packed_bytes += (
                    -(-row // sub) * sub * -(-cols // tiles.LANES) * tiles.LANES * itemsize
                )
            after = packed_bytes + sum(
                tiles.padded_bytes(e[1], itemsize) for e in skipped
            )
            obs.end(tok)
            obs.count("memory.plan.banks", len(banks))
            plans[itemsize] = BankPlan(
                itemsize=itemsize, banks=banks, unpacked=[e[0] for e in skipped],
                padded_bytes_before=before, padded_bytes_after=after,
                logical_bytes=logical, packer_result=result,
            )
        return plans
