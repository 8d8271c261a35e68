"""Seconds a sweep in its SA fleet's start (`_block_start`: the NFD
chains of every candidate and their encodings)."""

SPANS = {"engines.sa.start": "repro_torch.core.sa:SimulatedAnnealingPacker._block_start"}


def read(run):
    sweeps = run.rec.get("sweeps")
    return run.seconds("engines.sa.start") / sweeps if sweeps else None
