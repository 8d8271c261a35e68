"""Single entry point for all memory packers (the port's `repro.core.api`)."""
from __future__ import annotations

import time

import numpy as np

from .. import obs
from ..device import resolve_device
from . import baselines
from .dse import SweepResult, pack_sweep  # noqa: F401  (re-export)
from .ga import GeneticPacker
from .nfd import nfd_from_scratch
from .problem import (
    DEFAULT_INVENTORY_PENALTY,
    PackingProblem,
    PackingResult,
)
from .sa import SimulatedAnnealingPacker

ALGORITHMS = (
    "ga-nfd",
    "ga-s",
    "sa-nfd",
    "sa-s",
    "portfolio",
    "nfd",
    "ffd",
    "next-fit",
    "baseline",
)


def make_packer(
    algorithm: str,
    seed: int = 0,
    max_seconds: float = 30.0,
    intra_layer: bool = False,
    backend: str = "auto",
    device=None,
    **hyper,
):
    """Build a GA/SA packer from the paper's Table 2 hyperparameter names.

    Only the four evolutionary algorithms (``ga-nfd``/``ga-s``/``sa-nfd``/
    ``sa-s``) have packer objects; the one-shot heuristics are functions
    reached through :func:`pack`.  Keyword arguments:

    * ``seed`` — RNG seed; every engine/backend is deterministic per seed
      and bit-identical to ``repro.core.make_packer`` with the same seed.
    * ``max_seconds`` — wall-clock budget; pair with the ``max_iterations``
      (SA) / ``max_generations`` (GA) hyperparameters for reproducible,
      budget-independent runs.
    * ``intra_layer`` — enforce the paper's intra-layer packing scenario
      (a bin never mixes buffers from different layers).
    * ``backend`` — evaluation engine: ``auto`` (``cuda`` on a CUDA device,
      ``torch`` on the CPU), ``python`` (host numpy), ``torch`` (the plain
      PyTorch versions), ``cuda`` (the hand-written kernels), ``legacy``
      (the seed's from-scratch scalar loop, kept for benchmarking; it
      launches nothing); see `repro_torch.device`.  All backends are
      bit-identical per seed.
    * ``device`` — where the kernels run; ``None`` means ``"cuda"`` and
      raises where CUDA is not available.
    * ``hyper`` — Table-2 names (``n_pop``, ``n_tour``, ``p_mut``,
      ``p_adm_w``, ``p_adm_h``, ``sa_t0``, ``sa_rc``) plus the engine
      extensions (``n_chains``, ``exchange_every``, ``ladder_min/max``,
      ``patience``, ``swap_moves``, ``p_kind``, ``inventory_penalty``,
      ``max_iterations``, ``max_generations``).
    """
    algorithm = algorithm.lower()
    if algorithm in ("ga-nfd", "ga-s"):
        return GeneticPacker(
            mutation="nfd" if algorithm == "ga-nfd" else "swap",
            n_pop=hyper.get("n_pop", 50),
            n_tour=hyper.get("n_tour", 5),
            p_mut=hyper.get("p_mut", 0.4),
            p_adm_w=hyper.get("p_adm_w", 0.0),
            p_adm_h=hyper.get("p_adm_h", 0.1),
            nfd_threshold=hyper.get("nfd_threshold", 0.95),
            nfd_extra_frac=hyper.get("nfd_extra_frac", 0.01),
            nfd_max_bins=hyper.get("nfd_max_bins", 12),
            layer_weight=hyper.get("layer_weight", 0.01),
            intra_layer=intra_layer,
            max_seconds=max_seconds,
            max_generations=hyper.get("max_generations", 100_000),
            patience=hyper.get("patience", 200),
            seed=seed,
            backend=backend,
            p_kind=hyper.get("p_kind", 0.25),
            inventory_penalty=hyper.get(
                "inventory_penalty", DEFAULT_INVENTORY_PENALTY
            ),
            device=device,
        )
    if algorithm in ("sa-nfd", "sa-s"):
        return SimulatedAnnealingPacker(
            perturbation="nfd" if algorithm == "sa-nfd" else "swap",
            t0=hyper.get("sa_t0", 30.0),
            rc=hyper.get("sa_rc", 1.0),
            p_adm_w=hyper.get("p_adm_w", 0.0),
            p_adm_h=hyper.get("p_adm_h", 0.1),
            nfd_threshold=hyper.get("nfd_threshold", 0.95),
            nfd_extra_frac=hyper.get("nfd_extra_frac", 0.01),
            nfd_max_bins=hyper.get("nfd_max_bins", 8),
            swap_moves=hyper.get("swap_moves", 2),
            intra_layer=intra_layer,
            max_seconds=max_seconds,
            max_iterations=hyper.get("max_iterations", 2_000_000),
            patience=hyper.get("patience", 20_000),
            seed=seed,
            n_chains=hyper.get("n_chains", 1),
            backend=backend,
            exchange_every=hyper.get("exchange_every", 256),
            ladder_min=hyper.get("ladder_min", 0.25),
            ladder_max=hyper.get("ladder_max", 4.0),
            p_kind=hyper.get("p_kind", 0.15),
            inventory_penalty=hyper.get(
                "inventory_penalty", DEFAULT_INVENTORY_PENALTY
            ),
            device=device,
        )
    raise ValueError(f"no evolutionary packer named {algorithm!r}")


def pack(
    prob: PackingProblem,
    algorithm: str = "ga-nfd",
    seed: int = 0,
    max_seconds: float = 30.0,
    intra_layer: bool = False,
    backend: str = "auto",
    device=None,
    **hyper,
) -> PackingResult:
    """Pack `prob` with the named algorithm and return a PackingResult.

    Accepts the paper's Table 2 hyperparameter names: n_pop, n_tour, p_mut,
    p_adm_w, p_adm_h, sa_t0, sa_rc (see :func:`make_packer` for the full
    kwarg reference, including budgets, ``backend`` and ``device``).
    ``intra_layer=True`` enforces the paper's intra-layer packing scenario.
    ``"portfolio"`` runs the island portfolio (:func:`repro_torch.core.
    portfolio.pack_portfolio`; ``hyper`` then also takes its arguments).
    For the GA the batched backends (``torch``/``cuda``) evaluate each
    generation's fitness in one call; for "sa-s" the backend computes the
    per-step delta costs (pass ``n_chains=K`` for K temperature-laddered
    chains; "sa-nfd" and ``backend="legacy"`` run the scalar loop, the
    seed's, kept for benchmarking).  Results are
    bit-identical to ``repro.core.pack`` for the same seed and budget.

    ``device`` defaults to ``"cuda"`` for every algorithm and raises where
    CUDA is not available; pass ``device="cpu"`` to run on the host.  The
    call is the entry span ``api.pack`` (`repro_torch.obs`).
    """
    with obs.span("api.pack", entry=True):
        device = resolve_device(device)
        algorithm = algorithm.lower()
        if algorithm in ("ga-nfd", "ga-s", "sa-nfd", "sa-s"):
            packer = make_packer(
                algorithm,
                seed=seed,
                max_seconds=max_seconds,
                intra_layer=intra_layer,
                backend=backend,
                device=device,
                **hyper,
            )
            return packer.pack(prob)
        if algorithm == "portfolio":
            # the fleet-native island portfolio: deterministic per seed, with
            # migration at iteration/generation barriers
            from .portfolio import pack_portfolio

            return pack_portfolio(
                prob,
                seed=seed,
                max_seconds=max_seconds,
                intra_layer=intra_layer,
                backend=backend,
                device=device,
                **hyper,
            )

        # deterministic one-shot heuristics
        t0 = time.perf_counter()
        if algorithm == "nfd":
            sol = nfd_from_scratch(
                prob,
                np.random.default_rng(seed),
                p_adm_w=hyper.get("p_adm_w", 0.0),
                p_adm_h=hyper.get("p_adm_h", 0.1),
                intra_layer=intra_layer,
            )
        elif algorithm == "ffd":
            sol = baselines.first_fit_decreasing(prob, intra_layer=intra_layer)
        elif algorithm == "next-fit":
            sol = baselines.next_fit(prob)
        elif algorithm == "baseline":
            sol = baselines.singleton(prob)
        else:
            raise ValueError(f"unknown algorithm {algorithm!r}; options: {ALGORITHMS}")
        wall = time.perf_counter() - t0
        cost = sol.cost()
        return PackingResult(
            solution=sol,
            cost=cost,
            efficiency=sol.efficiency(),
            wall_time_s=wall,
            algorithm=algorithm + ("-intra" if intra_layer else ""),
            trace=[(wall, cost)],
            iterations=1,
            params=dict(seed=seed, **hyper),
        )
