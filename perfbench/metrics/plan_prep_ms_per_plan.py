"""Milliseconds a plan spends before its packer runs: the tree's leaves
flattened and split per layer (``memory.plan.flatten``) and the
candidates' tile-grid problem built (``memory.plan.problem``), mean over
the half without the profiler."""
from perfbench import plan_spans, program

SPANS = plan_spans.SPANS
program.arm()


def read(run):
    return plan_spans.per_plan(run, ("memory.plan.flatten", "memory.plan.problem"))
