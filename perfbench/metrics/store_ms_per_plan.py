"""Milliseconds a plan's store spends building its banks on the device
(``memory.store.build``: each bank allocated and its tensors copied in),
mean over the half without the profiler."""
from perfbench import plan_spans, program

SPANS = plan_spans.SPANS
program.arm()


def read(run):
    return plan_spans.per_plan(run, ("memory.store.build",))
