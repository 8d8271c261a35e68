"""Seconds a pack: the whole window over the packs completed in it (the
window ends with its last pack, so it holds whole packs only, each with
its engine's start)."""


def read(run):
    packs = run.rec.get("packs")
    return run.rec["window_s"] / packs if packs else None
