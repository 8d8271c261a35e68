"""Host microseconds an SA step outside the ops layer: the fleet loop's
time (`_block_run`) less its delta calls, over the steps (one delta call
a step)."""

SPANS = {
    "engines.sa.loop": "repro_torch.core.sa:SimulatedAnnealingPacker._block_run",
    "ops.sa_step_deltas": "repro_torch.kernels.binpack_sa_step.ops:sa_step_deltas",
}


def read(run):
    steps = run.count("ops.sa_step_deltas")
    if not steps:
        return None
    return (run.seconds("engines.sa.loop") - run.seconds("ops.sa_step_deltas")) / steps * 1e6
