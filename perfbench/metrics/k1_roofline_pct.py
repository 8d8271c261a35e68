"""K1's share of its roofline: the least time the card could take for the
fitness calls K1 served (`perfbench/work.py`), over K1's device time in the
trace (kernel `fitness_rows_kernel<false>`)."""
from perfbench import work

SPANS = {"ops.population_costs": "repro_torch.kernels.binpack_fitness.ops:population_costs"}
NOTES = {"ops.population_costs": work.fitness_work}
KERNEL = "fitness_rows_kernel<false>"


def read(run):
    return work.roofline_pct(run, "ops.population_costs", "k1", KERNEL)
