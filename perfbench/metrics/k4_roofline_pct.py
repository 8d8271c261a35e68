"""K4's share of its roofline: the least time the card could take for the
kind-lane SA delta calls K4 served (`perfbench/work.py`), over K4's device
time in the trace (kernel `sa_step_lanes_kernel<true>`)."""
from perfbench import work

SPANS = {"ops.sa_step_deltas": "repro_torch.kernels.binpack_sa_step.ops:sa_step_deltas"}
NOTES = {"ops.sa_step_deltas": work.sa_step_work}
KERNEL = "sa_step_lanes_kernel<true>"


def read(run):
    return work.roofline_pct(run, "ops.sa_step_deltas", "k4", KERNEL)
