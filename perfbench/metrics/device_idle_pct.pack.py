"""Share of the traced window in which no operation ran on the card.  The
spans below only name the host's layers in the trace's idle gaps."""
from perfbench.trace import idle_pct

SPANS = {
    "api.pack": "repro_torch.core.api:pack",
    "engines.ga.start": "repro_torch.core.ga:GeneticPacker._start_run",
    "engines.ga.mutation": "repro_torch.core.ga:GeneticPacker._mutation_phase",
    "engines.ga.selection": "repro_torch.core.ga:GeneticPacker._tournament",
    "engines.sa.start": "repro_torch.core.sa:SimulatedAnnealingPacker._block_start",
    "engines.sa.loop": "repro_torch.core.sa:SimulatedAnnealingPacker._block_run",
    "ops.population_costs": "repro_torch.kernels.binpack_fitness.ops:population_costs",
    "ops.sa_step_deltas": "repro_torch.kernels.binpack_sa_step.ops:sa_step_deltas",
}


def read(run):
    return idle_pct(run.trace)
