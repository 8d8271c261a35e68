"""Milliseconds a plan spends laying its packer's bins out as banks
(``memory.plan.banks``), mean over the half without the profiler."""
from perfbench import plan_spans, program

SPANS = plan_spans.SPANS
program.arm()


def read(run):
    return plan_spans.per_plan(run, ("memory.plan.banks",))
