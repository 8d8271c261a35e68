"""Distinct candidates solved a second over the whole window (a
deduplicated or cached candidate is not work and is not counted)."""


def read(run):
    n = run.rec.get("candidates")
    return n / run.rec["window_s"] if n else None
