"""Seconds a pack in its engine's start: the GA's population of NFD
packings (`_start_run`), the SA fleet's NFD chains and encodings
(`_block_start`)."""

SPANS = {
    "engines.ga.start": "repro_torch.core.ga:GeneticPacker._start_run",
    "engines.sa.start": "repro_torch.core.sa:SimulatedAnnealingPacker._block_start",
}


def read(run):
    packs = run.rec.get("packs")
    if not packs:
        return None
    return (run.seconds("engines.ga.start") + run.seconds("engines.sa.start")) / packs
