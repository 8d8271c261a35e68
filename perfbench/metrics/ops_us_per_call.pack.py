"""Mean host microseconds of an ops-layer call (staging fill, the copy to
the card, the launch, the kernel and the copy back, which it waits for)."""

SPANS = {
    "ops.population_costs": "repro_torch.kernels.binpack_fitness.ops:population_costs",
    "ops.sa_step_deltas": "repro_torch.kernels.binpack_sa_step.ops:sa_step_deltas",
}


def read(run):
    n = sum(run.count(k) for k in SPANS)
    return sum(run.seconds(k) for k in SPANS) / n * 1e6 if n else None
