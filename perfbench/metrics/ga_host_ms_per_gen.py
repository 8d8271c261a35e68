"""Host milliseconds a GA generation outside the ops layer: mutation,
applying the fitness call's totals, best tracking and tournament
selection (the generation's one fitness call is what is left out)."""

SPANS = {
    "engines.ga.mutation": "repro_torch.core.ga:GeneticPacker._mutation_phase",
    "engines.ga.apply": "repro_torch.core.ga:GeneticPacker._apply_costs",
    "engines.ga.best": "repro_torch.core.ga:GeneticPacker._track_best",
    "engines.ga.selection": "repro_torch.core.ga:GeneticPacker._tournament",
}


def read(run):
    gens = run.count("engines.ga.selection")
    if not gens:
        return None
    return sum(run.seconds(k) for k in SPANS) / gens * 1e3
