"""Core data model for the CNN-parameter-memory -> FPGA-OCM bin packing problem.

The PyTorch port's own copy of ``repro.core.problem`` (host numpy, no JAX,
no import of ``repro``): the cost model, packings, and the chain / problem
codecs that feed the CUDA kernels are the reference's, line for line, so
every cost and every RNG draw matches it bit for bit.

Faithful to Kroes et al., "Evolutionary Bin Packing for Memory-Efficient
Dataflow Inference Acceleration on FPGA" (2020):

* A *buffer* is one CNN parameter memory with a fixed word width (bits) and
  depth (words).  In FINN-style accelerators a layer with parallelism
  ``N_PE x (N_SIMD, D, W)`` contributes ``N_PE`` buffers of width
  ``N_SIMD * W`` bits and depth ``D``.
* A *bin* is a group of buffers co-located in one composed block-RAM
  structure.  Buffers in a bin are stacked in depth; the bin's width is the
  maximum buffer width and its height the sum of buffer depths.  A bin may
  hold at most ``max_items`` buffers (the paper's cardinality constraint,
  derived from the 2 physical BRAM ports; the paper evaluates with 4).
* A RAM primitive (:class:`RAMKind`) supports aspect-ratio modes; a
  (width x height) bin is implemented by tiling primitives in one mode and
  its implementation cost is

      cost(w, h) = min_m ceil(w / w_m) * ceil(h / d_m)

  and the paper's Eq. 1 mapping efficiency generalizes to

      E = stored_bits / (cost * CAPACITY_BITS).

Heterogeneous on-chip memory (following the authors' sequel
arXiv:2011.07317): real devices expose several primitive kinds — BRAM18,
BRAM36, URAM288 (fixed 72x4096 aspect), distributed LUTRAM — in fixed
per-device quantities.  An :class:`OCMInventory` lists the available kinds
and counts; every bin of a :class:`Solution` then carries a *RAM-kind lane*
selecting which primitive implements it.  Costs of different kinds are made
commensurable by expressing them in a shared *cost unit* (the gcd of the
kind capacities, so one BRAM18 = 1 unit and one URAM288 = 16 units on a
BRAM18+URAM288 device), and inventory feasibility is a soft constraint:
:meth:`Solution.inventory_overflow` measures the unit-weighted excess over
the per-kind counts, which the engines fold into fitness / acceptance.

The default single-kind BRAM18 problem (no ``ocm``) is bit-identical to the
homogeneous model of the paper — unit weight 1, kind lane all zeros, no
extra RNG draws anywhere.  `tests/test_core_problem.py` pins it against
every published baseline efficiency in the paper's Table 4; see
docs/DESIGN.md section 3 for the heterogeneous extension.
"""
from __future__ import annotations

import dataclasses
import math
from functools import reduce
from typing import Iterable, Sequence

import numpy as np

# Xilinx BRAM18: 16K data bits + 2K parity bits.  Parity bits are usable as
# data only for aspect widths >= 9, hence the capacity difference per mode.
BRAM18_MODES: tuple[tuple[int, int], ...] = (
    (1, 16384),
    (2, 8192),
    (4, 4096),
    (9, 2048),
    (18, 1024),
    (36, 512),
)
BRAM18_CAPACITY_BITS = 18 * 1024  # Eq. 1 denominator (18432), as in the paper

# Default weight of one unit of inventory overflow in the engines' penalized
# cost (heterogeneous OCM problems; see Solution.inventory_overflow).  The
# single source of truth — api/ga/sa/portfolio all import it, so the GA, the
# SA engines, and the portfolio's migration scoring can never drift apart.
DEFAULT_INVENTORY_PENALTY = 32.0


@dataclasses.dataclass(frozen=True)


class BRAMSpec:
    """A physical RAM primitive with configurable aspect-ratio modes.

    Retained as the single-kind interface (`PackingProblem(bram=...)`);
    heterogeneous problems use :class:`RAMKind` + :class:`OCMInventory`.
    """

    modes: tuple[tuple[int, int], ...] = BRAM18_MODES
    capacity_bits: int = BRAM18_CAPACITY_BITS

    @property
    def mode_widths(self) -> np.ndarray:
        return np.asarray([m[0] for m in self.modes], dtype=np.int64)

    @property
    def mode_depths(self) -> np.ndarray:
        return np.asarray([m[1] for m in self.modes], dtype=np.int64)


# ------------------------------------------------------------- RAM kinds


@dataclasses.dataclass(frozen=True)


class RAMKind:
    """One physical RAM primitive family (aspect modes + capacity)."""

    name: str
    modes: tuple[tuple[int, int], ...]
    capacity_bits: int


# Xilinx 7-series/UltraScale primitives.  BRAM36 is two cascaded BRAM18s
# (parity usable from width 9 -> 36K only at widths >= 9; we model the
# standard data aspects plus the x72 SDP mode).  URAM288 has a single fixed
# 72x4096 aspect.  LUTRAM64 models SLICEM distributed RAM at 64 bits.
BRAM18 = RAMKind("BRAM18", BRAM18_MODES, BRAM18_CAPACITY_BITS)
BRAM36_MODES: tuple[tuple[int, int], ...] = (
    (1, 32768),
    (2, 16384),
    (4, 8192),
    (9, 4096),
    (18, 2048),
    (36, 1024),
    (72, 512),
)
BRAM36 = RAMKind("BRAM36", BRAM36_MODES, 36 * 1024)
URAM288 = RAMKind("URAM288", ((72, 4096),), 288 * 1024)
LUTRAM64 = RAMKind("LUTRAM64", ((1, 64), (2, 32), (4, 16)), 64)

RAM_KINDS: dict[str, RAMKind] = {
    k.name: k for k in (BRAM18, BRAM36, URAM288, LUTRAM64)
}


@dataclasses.dataclass(frozen=True)


class OCMInventory:
    """Per-device on-chip-memory inventory: RAM kinds + primitive counts.

    ``counts[k] < 0`` means unbounded (no inventory pressure for that kind).
    Costs across kinds are expressed in a shared integer *cost unit* — the
    gcd of the kind capacities — so kind costs stay exactly comparable:
    ``weights[k] = capacity_bits[k] // unit_bits`` primitives-to-units.
    """

    kinds: tuple[RAMKind, ...]
    counts: tuple[int, ...]
    name: str = ""

    def __post_init__(self):
        if not self.kinds:
            raise ValueError("OCMInventory needs at least one RAM kind")
        if len(self.kinds) != len(self.counts):
            raise ValueError("kinds and counts must have equal length")
        if len({k.name for k in self.kinds}) != len(self.kinds):
            raise ValueError("duplicate RAM kind in inventory")

    @property
    def unit_bits(self) -> int:
        return reduce(math.gcd, (k.capacity_bits for k in self.kinds))

    @property
    def weights(self) -> tuple[int, ...]:
        u = self.unit_bits
        return tuple(k.capacity_bits // u for k in self.kinds)


@dataclasses.dataclass(frozen=True)


class Buffer:
    """One logical parameter memory."""

    width: int  # bits per word (= N_SIMD * W for FINN layers)
    depth: int  # words
    layer: int  # originating NN layer id (for intra-layer packing)
    name: str = ""

    @property
    def bits(self) -> int:
        return self.width * self.depth


class PackingProblem:
    """Immutable problem instance: a set of buffers + hardware constraints.

    ``ocm`` selects the heterogeneous model (kind lane active, costs in
    inventory units); without it the problem is the paper's single-kind
    model over ``bram`` (default BRAM18), with unit weight 1.
    """

    def __init__(
        self,
        buffers: Sequence[Buffer],
        bram: BRAMSpec | None = None,
        max_items: int = 4,
        name: str = "",
        ocm: OCMInventory | None = None,
    ):
        if not buffers:
            raise ValueError("PackingProblem needs at least one buffer")
        if max_items < 1:
            raise ValueError("max_items must be >= 1")
        if ocm is not None and bram is not None:
            raise ValueError("pass either bram= (single kind) or ocm=, not both")
        self.buffers = tuple(buffers)
        self.ocm = ocm
        if ocm is not None:
            self.ram_kinds = ocm.kinds
            self.kind_counts = tuple(int(c) for c in ocm.counts)
            self.kind_weights = ocm.weights
            self.cost_unit_bits = ocm.unit_bits
            k0 = ocm.kinds[0]
            self.bram = BRAMSpec(modes=k0.modes, capacity_bits=k0.capacity_bits)
        else:
            self.bram = bram or BRAMSpec()
            self.ram_kinds = (
                RAMKind("RAM", tuple(self.bram.modes), self.bram.capacity_bits),
            )
            self.kind_counts = (-1,)
            self.kind_weights = (1,)
            self.cost_unit_bits = self.bram.capacity_bits
        self.n_kinds = len(self.ram_kinds)
        self.max_items = int(max_items)
        self.name = name
        self.widths = np.asarray([b.width for b in buffers], dtype=np.int64)
        self.depths = np.asarray([b.depth for b in buffers], dtype=np.int64)
        self.layers = np.asarray([b.layer for b in buffers], dtype=np.int64)
        self.total_bits = int(np.sum(self.widths * self.depths))
        self._mode_w = self.bram.mode_widths  # (M,) kind-0 tables
        self._mode_d = self.bram.mode_depths  # (M,)
        # per-kind precomputed mode tables: the single source every cost
        # evaluator (scalar, numpy, torch plain version, CUDA kernel) derives from
        self._kind_modes_py = tuple(tuple(k.modes) for k in self.ram_kinds)
        self._kind_mode_w = [
            np.asarray([m[0] for m in k.modes], dtype=np.int64)
            for k in self.ram_kinds
        ]
        self._kind_mode_d = [
            np.asarray([m[1] for m in k.modes], dtype=np.int64)
            for k in self.ram_kinds
        ]
        self.kind_tables: tuple[tuple[int, tuple[tuple[int, int], ...]], ...] = (
            tuple(
                (int(w), tuple(k.modes))
                for w, k in zip(self.kind_weights, self.ram_kinds)
            )
        )
        self._kind_weights_arr = np.asarray(self.kind_weights, dtype=np.int64)
        self._kind_counts_arr = np.asarray(self.kind_counts, dtype=np.int64)
        self._any_bounded = bool(np.any(self._kind_counts_arr >= 0))
        self._kind_caps = np.asarray(
            [k.capacity_bits for k in self.ram_kinds], dtype=np.int64
        )
        self._cost_caches: list[dict[tuple[int, int], tuple[int, int, int, int]]]
        self._cost_caches = [dict() for _ in range(self.n_kinds)]
        # python-int copies for the scalar hot path (numpy scalars are slow)
        self.widths_py = tuple(int(w) for w in self.widths)
        self.depths_py = tuple(int(d) for d in self.depths)
        self.layers_py = tuple(int(l) for l in self.layers)
        self.bits_py = tuple(w * d for w, d in zip(self.widths_py, self.depths_py))

    @property
    def n(self) -> int:
        return len(self.buffers)

    # ------------------------------------------------------------------ cost
    def bin_cost_many(
        self, widths: np.ndarray, heights: np.ndarray, kinds: np.ndarray | None = None
    ) -> np.ndarray:
        """Vectorized unit cost for bins of given (width, height), best mode.

        ``kinds`` selects the per-bin RAM kind (default: kind 0, the paper's
        homogeneous path).  Costs are in inventory units (primitives x
        kind weight); single-kind problems have weight 1."""
        if kinds is None:
            w = np.asarray(widths, dtype=np.int64)[..., None]
            h = np.asarray(heights, dtype=np.int64)[..., None]
            per_mode = -(-w // self._mode_w) * -(-h // self._mode_d)  # ceil div
            c = np.min(per_mode, axis=-1)
            w0 = self.kind_weights[0]
            return c * w0 if w0 != 1 else c
        return self.bin_primitives_many(widths, heights, kinds, weighted=True)

    def bin_primitives_many(
        self,
        widths: np.ndarray,
        heights: np.ndarray,
        kinds: np.ndarray,
        weighted: bool = False,
    ) -> np.ndarray:
        """Vectorized per-kind primitive count (or unit cost if ``weighted``)."""
        w = np.asarray(widths, dtype=np.int64)[..., None]
        h = np.asarray(heights, dtype=np.int64)[..., None]
        k = np.asarray(kinds)
        out = np.zeros(np.broadcast(w[..., 0], k).shape, dtype=np.int64)
        for ki in range(self.n_kinds):
            per_mode = -(-w // self._kind_mode_w[ki]) * -(-h // self._kind_mode_d[ki])
            c = np.min(per_mode, axis=-1)
            if weighted and self.kind_weights[ki] != 1:
                c = c * self.kind_weights[ki]
            out = np.where(k == ki, c, out)
        return out

    def _cost_mode_gap(
        self, width: int, height: int, kind: int = 0
    ) -> tuple[int, int, int, int]:
        """(unit_cost, best_mode_index, grid_gap, primitives) for a bin.

        Pure-python scalar hot path with per-kind memoization — called
        millions of times inside NFD/GA/SA inner loops.  ``unit_cost`` is
        ``primitives * kind_weight`` (weight 1 on the default path)."""
        cache = self._cost_caches[kind]
        key = (width, height)
        hit = cache.get(key)
        if hit is not None:
            return hit
        best_cost = 1 << 62
        best_m = 0
        modes = self._kind_modes_py[kind]
        for m, (mw, md) in enumerate(modes):
            c = -(-width // mw) * -(-height // md)
            if c < best_cost:
                best_cost = c
                best_m = m
        md = modes[best_m][1]
        gap = -(-height // md) * md - height
        out = (best_cost * self.kind_weights[kind], best_m, gap, best_cost)
        cache[key] = out
        return out

    def bin_cost(self, width: int, height: int, kind: int = 0) -> int:
        return self._cost_mode_gap(width, height, kind)[0]

    def bin_primitives(self, width: int, height: int, kind: int = 0) -> int:
        """Raw primitive count of the bin on the given RAM kind."""
        return self._cost_mode_gap(width, height, kind)[3]

    def overflow_units(self, used: np.ndarray) -> np.ndarray:
        """Unit-weighted primitive usage beyond the inventory counts.

        ``used`` is (..., n_kinds); unbounded kinds (count < 0) never
        overflow.  The single source for the overflow formula — GA fitness,
        SA acceptance, and portfolio migration all score through it.
        """
        over = np.maximum(used - self._kind_counts_arr, 0)
        over = np.where(self._kind_counts_arr < 0, 0, over)
        return (over * self._kind_weights_arr).sum(axis=-1)

    def bin_stats(self, items: Sequence[int], kind: int = 0) -> tuple[int, int, int]:
        """(width, height, unit_cost) of a bin holding the given buffers."""
        w = 0
        h = 0
        for i in items:
            wi = self.widths_py[i]
            if wi > w:
                w = wi
            h += self.depths_py[i]
        return w, h, self._cost_mode_gap(w, h, kind)[0]

    # -------------------------------------------------------------- baseline
    def singleton_solution(self) -> "Solution":
        """The FINN-style unpacked baseline: one buffer per bin (kind 0)."""
        return Solution(self, [[i] for i in range(self.n)])

    def baseline_cost(self) -> int:
        return int(np.sum(self.bin_cost_many(self.widths, self.depths)))

    def lower_bound(self) -> int:
        """Information-theoretic minimum cost in units (capacity bound)."""
        return -(-self.total_bits // self.cost_unit_bits)


# geometry-matrix column indices (Solution._geom)
_GW, _GH, _GCOST, _GBITS, _GNL, _GPRIM = range(6)


class Solution:
    """A packing: partition of buffer indices into bins, plus a kind lane.

    The representation is a list of bins, each a list of buffer indices,
    with a parallel int64 ``kinds`` array assigning each bin a RAM kind
    (all zeros on single-kind problems — the kind lane then never affects
    costs or RNG streams).

    Per-bin aggregates live in a cached ``(nbins, 6)`` int64 *geometry
    matrix* with columns ``(width, height, unit_cost, bits, distinct_layers,
    primitives)`` and a parallel dirty mask.  Mutation operators that touch
    only a few bins (``buffer_swap``, ``nfd_repack``, kind reassignment)
    preserve the rows of untouched bins and mark the rest dirty via
    :meth:`touch` (or build the child solution with :meth:`_with_geometry`),
    so ``cost()`` and friends cost O(touched bins) of Python plus vectorized
    numpy over the rest — instead of the seed's full O(n buffers) rescan per
    evaluation.  ``cost_full()`` recomputes everything from scratch and is
    the reference the incremental path is tested against.

    Code that mutates ``bins`` or ``kinds`` directly must call :meth:`touch`
    with the affected bin indices — the aggregate methods trust the cache.
    """

    __slots__ = (
        "problem", "bins", "kinds", "_geom", "_dirty", "_any_dirty", "_total_cost",
    )

    def __init__(
        self,
        problem: PackingProblem,
        bins: Iterable[Iterable[int]],
        kinds: Iterable[int] | None = None,
    ):
        self.problem = problem
        materialized = [list(b) for b in bins]
        if kinds is None:
            self.bins = [b for b in materialized if b]
            self.kinds = np.zeros(len(self.bins), dtype=np.int64)
        else:
            ks = np.asarray(list(kinds), dtype=np.int64)
            if len(ks) != len(materialized):
                raise ValueError("kinds must align with bins")
            live = [i for i, b in enumerate(materialized) if b]
            self.bins = [materialized[i] for i in live]
            self.kinds = ks[live]
        n = len(self.bins)
        self._geom = np.empty((n, 6), dtype=np.int64)
        self._dirty = np.ones(n, dtype=bool)
        self._any_dirty = True
        self._total_cost: int | None = None

    @classmethod
    def _with_geometry(
        cls,
        problem: PackingProblem,
        bins: list[list[int]],
        geom: np.ndarray,
        dirty: np.ndarray,
        kinds: np.ndarray | None = None,
    ) -> "Solution":
        """Internal fast constructor: ``bins`` are non-empty lists taken by
        reference, ``geom``/``dirty``/``kinds`` aligned and owned by the new
        solution (``kinds=None`` -> all kind 0)."""
        self = object.__new__(cls)
        self.problem = problem
        self.bins = bins
        self.kinds = (
            kinds if kinds is not None else np.zeros(len(bins), dtype=np.int64)
        )
        self._geom = geom
        self._dirty = dirty
        self._any_dirty = bool(dirty.any())
        self._total_cost = None
        return self

    def state_dict(self) -> dict:
        """JSON-able serialization of the packing itself: bins + kind lane.

        Geometry caches are derived state and deliberately not serialized —
        a solution rebuilt by :meth:`from_state_dict` starts cold and
        re-derives the exact same integer costs (the checkpoint/resume
        layer in ``core.resume`` round-trips through this pair).
        """
        return {
            "bins": [[int(i) for i in b] for b in self.bins],
            "kinds": [int(k) for k in self.kinds],
        }

    @classmethod
    def from_state_dict(cls, problem: PackingProblem, state: dict) -> "Solution":
        return cls(problem, state["bins"], state["kinds"])

    def copy(self) -> "Solution":
        out = Solution._with_geometry(
            self.problem,
            [list(b) for b in self.bins],
            self._geom.copy(),
            self._dirty.copy(),
            self.kinds.copy(),
        )
        out._total_cost = self._total_cost
        return out

    # ----------------------------------------------------- geometry protocol
    def _refresh(self) -> None:
        """Recompute the geometry rows of dirty bins (O(touched buffers))."""
        if not self._any_dirty:
            return
        p = self.problem
        widths, depths = p.widths_py, p.depths_py
        bits, layers = p.bits_py, p.layers_py
        cmg = p._cost_mode_gap
        hetero = p.n_kinds > 1
        ks = self.kinds
        g = self._geom
        bins = self.bins
        for bi in np.flatnonzero(self._dirty):
            items = bins[bi]
            w = 0
            h = 0
            nb = 0
            for i in items:
                wi = widths[i]
                if wi > w:
                    w = wi
                h += depths[i]
                nb += bits[i]
            c = cmg(w, h, int(ks[bi])) if hetero else cmg(w, h)
            row = g[bi]
            row[_GW] = w
            row[_GH] = h
            row[_GCOST] = c[0]
            row[_GBITS] = nb
            row[_GNL] = len({layers[i] for i in items})
            row[_GPRIM] = c[3]
        self._dirty[:] = False
        self._any_dirty = False

    def touch(self, *bin_indices: int) -> None:
        """Mark bins dirty after their contents (or kind) were mutated."""
        for bi in bin_indices:
            self._dirty[bi] = True
        self._any_dirty = True
        self._total_cost = None

    def drop_empty(self) -> None:
        """Remove empty bins (and their geometry/kind rows) left by moves."""
        if all(self.bins):
            return
        live = np.asarray([bool(b) for b in self.bins])
        self.bins = [b for b in self.bins if b]
        self._geom = self._geom[live]
        self._dirty = self._dirty[live]
        self.kinds = self.kinds[live]
        self._total_cost = None

    def fill_geometry(self, wrow: np.ndarray, hrow: np.ndarray) -> int:
        """Write per-bin (width, height) into int32 rows, zero-padding the
        tail — the population-matrix update feeding the batched fitness
        kernel.  Returns the number of live bins."""
        self._refresh()
        nb = len(self.bins)
        wrow[:nb] = self._geom[:, _GW]
        hrow[:nb] = self._geom[:, _GH]
        wrow[nb:] = 0
        hrow[nb:] = 0
        return nb

    def fill_kinds(self, krow: np.ndarray) -> int:
        """Write the per-bin kind lane into an int32 row, zero-padding the
        tail (padded slots have width 0 and cost nothing on any kind)."""
        nb = len(self.bins)
        krow[:nb] = self.kinds
        krow[nb:] = 0
        return nb

    def scan_bin_geometry(
        self, bin_indices: Sequence[int]
    ) -> tuple[list[int], list[int]]:
        """Fresh (widths, heights) of the given bins from their *current*
        contents, bypassing (and not populating) the geometry cache.

        This is the "new geometry" probe of the in-place SA move protocol:
        after a move sequence mutated ``bins`` without ``touch()``, the
        cached rows still describe the pre-move state while this scan
        describes the candidate — the pair feeds the delta-cost kernel.
        An emptied bin reports (0, 0), which costs nothing.
        """
        widths, depths = self.problem.widths_py, self.problem.depths_py
        ws: list[int] = []
        hs: list[int] = []
        bins = self.bins
        for bi in bin_indices:
            w = 0
            h = 0
            for i in bins[bi]:
                wi = widths[i]
                if wi > w:
                    w = wi
                h += depths[i]
            ws.append(w)
            hs.append(h)
        return ws, hs

    # ------------------------------------------------------------ aggregates
    def cost(self) -> int:
        """Total cost in inventory units (the paper's BRAM count on the
        default single-kind path).

        O(dirty bins) row refresh + a vectorized sum; the seed implementation
        rescanned every buffer of every bin on each call."""
        if self._total_cost is None:
            self._refresh()
            self._total_cost = int(self._geom[:, _GCOST].sum())
        return self._total_cost

    def cost_full(self) -> int:
        """Seed-equivalent scalar evaluation: recompute every bin from its
        buffers, bypassing (and not populating) the geometry cache.  Used for
        cache-consistency tests and as the legacy benchmark baseline."""
        stats = self.problem.bin_stats
        if self.problem.n_kinds == 1:
            return sum(stats(b)[2] for b in self.bins)
        return sum(stats(b, int(k))[2] for b, k in zip(self.bins, self.kinds))

    def bin_costs(self) -> np.ndarray:
        self._refresh()
        return self._geom[:, _GCOST].copy()

    def used_primitives(self) -> np.ndarray:
        """Per-kind primitive usage, shape (n_kinds,) int64."""
        self._refresh()
        out = np.zeros(self.problem.n_kinds, dtype=np.int64)
        np.add.at(out, self.kinds, self._geom[:, _GPRIM])
        return out

    def inventory_overflow(self) -> int:
        """Unit-weighted primitive usage beyond the inventory counts.

        0 on problems without bounded counts (including every default
        single-kind problem); the engines fold this, scaled by their
        ``inventory_penalty``, into fitness / SA acceptance."""
        p = self.problem
        if not p._any_bounded:
            return 0
        return int(p.overflow_units(self.used_primitives()))

    def bin_efficiencies(self) -> np.ndarray:
        self._refresh()
        g = self._geom
        caps = self.problem._kind_caps[self.kinds]
        return g[:, _GBITS] / (g[:, _GPRIM] * caps.astype(np.float64))

    def efficiency(self) -> float:
        """Paper Eq. 1 generalized: stored bits / allocated RAM capacity."""
        return self.problem.total_bits / (self.cost() * self.problem.cost_unit_bits)

    def distinct_layers_per_bin(self) -> float:
        self._refresh()
        return float(self._geom[:, _GNL].sum()) / len(self.bins)

    # ------------------------------------------------------------ validation
    def validate(self, intra_layer: bool = False) -> None:
        """Raises if the packing is not implementable under the constraints."""
        p = self.problem
        seen: list[int] = sorted(i for b in self.bins for i in b)
        if seen != list(range(p.n)):
            raise ValueError("solution does not place every buffer exactly once")
        if len(self.kinds) != len(self.bins):
            raise ValueError("kind lane misaligned with bins")
        if len(self.kinds) and (
            int(self.kinds.min()) < 0 or int(self.kinds.max()) >= p.n_kinds
        ):
            raise ValueError("bin kind out of inventory range")
        for b in self.bins:
            if len(b) > p.max_items:
                raise ValueError(
                    f"bin of size {len(b)} exceeds cardinality {p.max_items}"
                )
            if intra_layer and len({int(p.layers[i]) for i in b}) > 1:
                raise ValueError("intra-layer constraint violated")


def greedy_assign_kinds(sol: Solution) -> Solution:
    """Inventory-aware greedy kind assignment, in place (init heuristic).

    Every bin starts on its cheapest kind (which, for capacity-commensurate
    kinds like BRAM18 vs URAM288, is always the finest-grained one); while a
    bounded kind is over its count, the resident bin with the smallest
    unit-cost regret per freed primitive moves to a kind with room.  Leaves
    residual overflow — if no feasible move exists — to the engines'
    inventory penalty.  No-op on single-kind problems; consumes no RNG.
    """
    p = sol.problem
    if p.n_kinds == 1 or not p._any_bounded:
        return sol
    sol._refresh()
    nb = len(sol.bins)
    nk = p.n_kinds
    g = sol._geom
    wc = np.empty((nb, nk), dtype=np.int64)
    prim = np.empty((nb, nk), dtype=np.int64)
    for bi in range(nb):
        w, h = int(g[bi, _GW]), int(g[bi, _GH])
        for k in range(nk):
            c = p._cost_mode_gap(w, h, k)
            wc[bi, k] = c[0]
            prim[bi, k] = c[3]
    kinds = np.argmin(wc, axis=1).astype(np.int64)
    counts = p._kind_counts_arr
    used = np.zeros(nk, dtype=np.int64)
    ar = np.arange(nb)
    np.add.at(used, kinds, prim[ar, kinds])
    # move selection is vectorized over bins per candidate target kind:
    # large heterogeneous inits (hundreds of bins x population size) would
    # otherwise spend seconds in nested python loops
    for _ in range(nb + 1):
        over = (counts >= 0) & (used > counts)
        if not over.any():
            break
        cur_wc = wc[ar, kinds]
        cur_prim = prim[ar, kinds]
        movable = over[kinds] & (cur_prim > 0)
        best = None  # (regret per freed primitive, bin, target kind)
        for j in range(nk):
            cand = movable & (kinds != j)
            if counts[j] >= 0:
                cand &= used[j] + prim[:, j] <= counts[j]
            if not cand.any():
                continue
            regret = np.where(cand, (wc[:, j] - cur_wc) / cur_prim, np.inf)
            bi = int(np.argmin(regret))
            if best is None or regret[bi] < best[0]:
                best = (float(regret[bi]), bi, j)
        if best is None:
            break
        _, bi, j = best
        used[kinds[bi]] -= prim[bi, kinds[bi]]
        kinds[bi] = j
        used[j] += prim[bi, j]
    changed = np.flatnonzero(kinds != sol.kinds)
    if changed.size:
        sol.kinds[:] = kinds
        sol.touch(*[int(b) for b in changed])
    return sol


def encode_chain_items(
    solutions: Sequence["Solution"], max_items: int, n_slots: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Encode C solutions as padded (C, n_slots, max_items) item matrices.

    Slot (c, b) holds the buffer indices of chain c's bin b, ``-1``-padded;
    a parallel (C, n_slots) count matrix gives each bin's fill.  This is the
    fully-vectorized chain representation of the multi-chain annealer:
    buffer-swap moves become fancy-indexed row edits, applied to every chain
    at once.  Bin order and within-bin slot order are preserved, so
    ``decode_chain_items`` round-trips exactly.
    """
    c = len(solutions)
    nb = max(len(s.bins) for s in solutions)
    if n_slots is not None:
        nb = max(nb, n_slots)
    items = np.full((c, nb, max_items), -1, dtype=np.int32)
    counts = np.zeros((c, nb), dtype=np.int32)
    for k, s in enumerate(solutions):
        for b, binlist in enumerate(s.bins):
            items[k, b, : len(binlist)] = binlist
            counts[k, b] = len(binlist)
    return items, counts


def decode_chain_items(
    prob: PackingProblem,
    items_row: np.ndarray,
    counts_row: np.ndarray,
    kinds_row: np.ndarray | None = None,
) -> "Solution":
    """Decode one chain row (n_slots, max_items) back into a `Solution`.

    Empty slots are dropped (along with their kind-lane entries); the
    result's geometry cache starts cold and is recomputed from the buffers,
    so a decoded solution independently re-derives the cost the incremental
    chain bookkeeping arrived at (the engine's consistency tests rely on
    this property).
    """
    live = [b for b in range(len(counts_row)) if counts_row[b] > 0]
    bins = [
        [int(x) for x in items_row[b, : int(counts_row[b])]] for b in live
    ]
    kinds = None if kinds_row is None else [int(kinds_row[b]) for b in live]
    return Solution(prob, bins, kinds=kinds)


def encode_chain_geometry(
    solutions: Sequence["Solution"], n_slots: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode C solutions as padded (C, n_slots) int32 chain matrices.

    Row c holds the per-bin (width, height) of ``solutions[c]``, zero-padded
    — the multi-chain SA analogue of the GA's population matrices.  Returns
    (W, H, live-bin counts).
    """
    c = len(solutions)
    w = np.zeros((c, n_slots), dtype=np.int32)
    h = np.zeros((c, n_slots), dtype=np.int32)
    nb = np.zeros(c, dtype=np.int64)
    for i, s in enumerate(solutions):
        nb[i] = s.fill_geometry(w[i], h[i])
    return w, h, nb


def encode_chain_kinds(solutions: Sequence["Solution"], n_slots: int) -> np.ndarray:
    """Encode C solutions' kind lanes as a padded (C, n_slots) int32 matrix
    (padded slots get kind 0; they carry width 0 and cost nothing)."""
    c = len(solutions)
    k = np.zeros((c, n_slots), dtype=np.int32)
    for i, s in enumerate(solutions):
        s.fill_kinds(k[i])
    return k


# ------------------------------------------------------------ problem batches


def batch_group_key(prob: PackingProblem) -> tuple:
    """Hashable cost-model signature for cross-problem batching.

    Problems sharing this key evaluate on identical per-kind mode tables and
    unit weights, so their bins can ride through one batched kernel call
    (``kind_tables`` reach the kernels as one small table); inventory *counts* may
    differ per problem — they only enter the host-side overflow penalty.
    The reference's ``core.dse.pack_sweep`` groups a mixed fleet by this
    key (docs/DESIGN.md section 10); here it guards `encode_problem_batch`.
    """
    return (prob.ram_kinds, prob.kind_tables)


@dataclasses.dataclass


class ProblemBatch:
    """A fleet of problems padded to one ``(n_max, cap_max)`` envelope.

    The cross-problem analogue of the chain codecs above: per-buffer tables
    become zero-padded ``(P, n_max)`` matrices with a parallel boolean
    ``mask`` (True where a real buffer lives), and per-problem scalars become
    ``(P,)`` vectors.  All member problems must share one cost-model
    signature (:func:`batch_group_key`) — the shared ``kind_tables`` are what
    lets a whole fleet go through one batched kernel call — while buffer
    counts, cardinality bounds (``max_items``), and inventory *counts* vary
    per problem.  Padded lanes are masked by construction: a padded buffer
    slot has width 0 and a padded problem row costs nothing on any backend.

    ``ext_tables`` appends the sentinel column the vectorized engines index
    with (slot id ``n_max`` -> width 0 / depth 0 / layer -1), mirroring the
    single-problem ``np.append(prob.widths, 0)`` convention.
    """

    widths: np.ndarray      # (P, n_max) int64, zero beyond problem p's count
    depths: np.ndarray      # (P, n_max) int64
    layers: np.ndarray      # (P, n_max) int64, -1 padded
    mask: np.ndarray        # (P, n_max) bool — True where a real buffer lives
    n: np.ndarray           # (P,) live buffer counts
    max_items: np.ndarray   # (P,) per-problem cardinality bounds
    kind_tables: tuple      # shared ((unit_weight, modes), ...) across the fleet
    kind_counts: np.ndarray  # (P, K) inventory counts (-1 = unbounded)
    ram_kinds: tuple        # shared RAMKind tuple (decode needs capacities)
    has_ocm: tuple          # per problem: built with an OCMInventory?
    names: tuple            # per-problem names
    ocm_names: tuple        # per-problem inventory names ("" without ocm)

    @property
    def size(self) -> int:
        return int(self.widths.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.widths.shape[1])

    @property
    def cap_max(self) -> int:
        return int(self.max_items.max())

    @property
    def n_kinds(self) -> int:
        return len(self.kind_tables)

    @property
    def kind_weights(self) -> np.ndarray:
        return np.asarray([w for w, _ in self.kind_tables], dtype=np.int64)

    def ext_tables(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(widths, depths, layers) as ``(P, n_max + 1)`` lookup tables whose
        last column is the empty-slot sentinel (0 / 0 / -1)."""
        p = self.size
        w = np.concatenate([self.widths, np.zeros((p, 1), np.int64)], axis=1)
        d = np.concatenate([self.depths, np.zeros((p, 1), np.int64)], axis=1)
        l = np.concatenate([self.layers, np.full((p, 1), -1, np.int64)], axis=1)
        return w, d, l

    def overflow_rows(self, used: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Unit-weighted inventory overflow with per-row counts.

        ``used`` is (R, K) per-kind primitive usage, ``rows`` maps each row
        to its problem index — the fleet generalization of
        :meth:`PackingProblem.overflow_units`.
        """
        counts = self.kind_counts[rows]
        over = np.maximum(used - counts, 0)
        over = np.where(counts < 0, 0, over)
        return (over * self.kind_weights).sum(axis=-1)


def encode_problem_batch(problems: Sequence[PackingProblem]) -> ProblemBatch:
    """Pad a fleet of cost-model-compatible problems into a `ProblemBatch`.

    Raises ``ValueError`` on an empty fleet or mixed cost models (different
    RAM kinds / mode tables) — callers solving a mixed fleet should first
    group by :func:`batch_group_key` (``pack_sweep`` does).
    """
    if not problems:
        raise ValueError("encode_problem_batch needs at least one problem")
    key = batch_group_key(problems[0])
    for prob in problems[1:]:
        if batch_group_key(prob) != key:
            raise ValueError(
                "problems mix cost models (RAM kinds / mode tables); group "
                "them with batch_group_key before batching"
            )
    p = len(problems)
    n_max = max(prob.n for prob in problems)
    widths = np.zeros((p, n_max), dtype=np.int64)
    depths = np.zeros((p, n_max), dtype=np.int64)
    layers = np.full((p, n_max), -1, dtype=np.int64)
    mask = np.zeros((p, n_max), dtype=bool)
    for j, prob in enumerate(problems):
        widths[j, : prob.n] = prob.widths
        depths[j, : prob.n] = prob.depths
        layers[j, : prob.n] = prob.layers
        mask[j, : prob.n] = True
    return ProblemBatch(
        widths=widths,
        depths=depths,
        layers=layers,
        mask=mask,
        n=np.asarray([prob.n for prob in problems], dtype=np.int64),
        max_items=np.asarray([prob.max_items for prob in problems], dtype=np.int64),
        kind_tables=problems[0].kind_tables,
        kind_counts=np.stack([prob._kind_counts_arr for prob in problems]),
        ram_kinds=problems[0].ram_kinds,
        has_ocm=tuple(prob.ocm is not None for prob in problems),
        names=tuple(prob.name for prob in problems),
        ocm_names=tuple(
            prob.ocm.name if prob.ocm is not None else "" for prob in problems
        ),
    )


@dataclasses.dataclass


class PackingResult:
    """Outcome of one packer run (algorithm-agnostic)."""

    solution: Solution
    cost: int
    efficiency: float
    wall_time_s: float
    algorithm: str
    # (seconds since start, best cost so far); on heterogeneous problems the
    # value is the inventory-penalized cost, keeping the curve monotone
    trace: list[tuple[float, int]]
    iterations: int
    params: dict

    @property
    def baseline_cost(self) -> int:
        return self.solution.problem.baseline_cost()

    @property
    def baseline_efficiency(self) -> float:
        p = self.solution.problem
        return p.total_bits / (p.baseline_cost() * p.cost_unit_bits)

    @property
    def delta_bram(self) -> float:
        """Paper Table 4's memory-footprint reduction factor."""
        return self.baseline_cost / max(self.cost, 1)

    def summary(self) -> str:
        return (
            f"{self.algorithm}: cost={self.cost} BRAM "
            f"(baseline {self.baseline_cost}, x{self.delta_bram:.2f} smaller), "
            f"eff={self.efficiency * 100:.1f}% "
            f"(baseline {self.baseline_efficiency * 100:.1f}%), "
            f"t={self.wall_time_s:.2f}s"
        )


def buffers_from_shape_rows(
    rows: Sequence[tuple[int, tuple[int, int, int]]]
) -> list[Buffer]:
    """Expand Table-1-style rows ``(N_PE, (N_SIMD, D, W))`` into buffers.

    Each row describes one layer; the row's ``N_PE`` parameter memories all
    belong to that layer (relevant for intra-layer packing).
    """
    out: list[Buffer] = []
    for layer, (n_pe, (n_simd, depth, wbits)) in enumerate(rows):
        for pe in range(n_pe):
            out.append(
                Buffer(
                    width=n_simd * wbits,
                    depth=depth,
                    layer=layer,
                    name=f"L{layer}PE{pe}",
                )
            )
    return out
