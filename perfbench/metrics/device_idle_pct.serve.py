"""Share of the traced window in which no operation ran on the card.  The
spans below only name the host's layers in the trace's idle gaps (the
worker lane's solve, and inside it the SA fleet's phases)."""
from perfbench.trace import idle_pct

SPANS = {
    "service.solve": "repro_torch.serve.service:PackingService._solve",
    "engines.sa.start": "repro_torch.core.sa:SimulatedAnnealingPacker._block_start",
    "engines.sa.loop": "repro_torch.core.sa:SimulatedAnnealingPacker._block_run",
    "engines.sa.finish": "repro_torch.core.sa:SimulatedAnnealingPacker._block_finish",
    "ops.sa_step_deltas": "repro_torch.kernels.binpack_sa_step.ops:sa_step_deltas",
}


def read(run):
    return idle_pct(run.trace)
