"""The memory planner's and the store's own spans (`repro_torch.obs`), as
the plan cell's per-layer readers read them.

The harness times each unit of work's two calls (``SPANS``:
`plan_packing` and the store's construction); the first half's records
are the recorder's records that start inside those calls.  A program
without these spans gives no records, and every reader returns ``None``.
"""
from __future__ import annotations

from perfbench import program

SPANS = {
    "plan.plan_packing": "repro_torch.memory.planner:plan_packing",
    "plan.store": "repro_torch.memory.store:PackedParameterStore.__init__",
}
PLAN = "memory.plan"


def first_half(run):
    """Records that start inside one of ``SPANS``' calls of ``run``."""
    def pick(recs):
        iv = sorted((t, t + d) for label in SPANS for t, d, _ in run.spans.get(label, ()))
        starts = [a for a, _ in iv]
        return program._view([r for r in recs if program._inside(r.start_ns / 1e9, iv, starts)])
    return program._memo(run, "plan_first", pick)


def per_plan(run, names, scale: float = 1e3):
    """``scale`` times the first half's seconds in ``names`` spans over its
    count of plans; ``None`` where either is missing."""
    v = first_half(run)
    n = v.count(PLAN) if v is not None else 0
    if not n or not any(v.count(x) for x in names):
        return None
    report(run, v)
    return sum(v.seconds(x) for x in names) / n * scale


def report(run, v) -> None:
    """Once a run: every span's count, seconds and self seconds, and the
    counters' increase, on standard error."""
    memo = program._state(run)
    if memo.get("plan_reported"):
        return
    memo["plan_reported"] = True
    names = sorted(v.spans, key=lambda n: -v.self_s[n])
    program.log("plan cell: span count, seconds, self seconds: "
                + ", ".join(f"{n} {v.count(n)} {v.seconds(n):.4f} {v.self_s[n]:.4f}"
                            for n in names))
