"""Batched bin-cost fitness (GA generations): K1 / K2 and their plain
versions.  `ops.population_costs` reduces padded (P, NB) — or (NP, P, NB) —
bin-geometry matrices to per-individual totals in one call."""
from .kernel import binpack_fitness_cuda, binpack_fitness_kinds_cuda  # noqa: F401
from .ops import population_costs  # noqa: F401
from .ref import binpack_fitness_kinds_ref, binpack_fitness_ref  # noqa: F401
