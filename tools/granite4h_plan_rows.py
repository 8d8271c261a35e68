#!/usr/bin/env python
"""The plan cell's buffer rows: granite-4.0-h-small's memory-planner
candidates, from its parameter shapes.

    python tools/granite4h_plan_rows.py            # print the rows
    python tools/granite4h_plan_rows.py --write \\
        perfbench/configs/granite-4.0-h-small.ep8.json   # set them in the file

The tree is `init_meta_params` of the port's ``granite-4.0-h-small`` (one
chip's EP-8 share: shapes only, nothing allocated), split per layer as
``plan_packing(..., split_stacked=True)`` splits it (and the same for
its smoke twin, which the plan driver runs on the CPU).  The rows are that
call's own tile-grid problem (a one-shot NFD plan on the host), one
candidate tensor a row in the planner's order: ``[1, [cols, rows, 1]]``,
so a row's width is the tensor's columns and its depth its rows, as
`repro_torch.memory.tiles.tile_grid_problem` builds them.  ``--write``
replaces the file's ``accelerators`` (both row sets) and ``model.smoke``
(the smoke twin's published keys, `perfbench.drivers.plan.published`)
and rewrites it, one row a line.  Run from the repository's root.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

ARCH = "granite-4.0-h-small"
ACCELERATOR = "granite-4.0-h-small.ep8.bf16"
SMOKE_ACCELERATOR = "granite-4.0-h-small.smoke.bf16"


def plan_rows(smoke: bool = False, max_items: int = 4, eff_threshold: float = 0.9) -> list:
    """The rows of the arch's config (its smoke twin with ``smoke``)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.memory import plan_packing
    from repro_torch.models.model import init_meta_params

    tree = init_meta_params((get_smoke_config if smoke else get_config)(ARCH))
    plans = plan_packing(tree, "nfd", max_items=max_items, eff_threshold=eff_threshold,
                         split_stacked=True, device="cpu")
    (plan,) = plans.values()
    prob = plan.packer_result.solution.problem
    return [[1, [int(b.width), int(b.depth), 1]] for b in prob.buffers]


def render(config: dict) -> str:
    """The configuration as JSON, a top-level key a line and a row a line."""
    lines = []
    for key, value in config.items():
        if key == "accelerators":
            accs = []
            for name, rows in value.items():
                body = ",\n   ".join(json.dumps(r) for r in rows)
                accs.append(f'  {json.dumps(name)}: [\n   {body}\n  ]')
            lines.append(' "accelerators": {\n' + ",\n".join(accs) + "\n }")
        else:
            lines.append(f" {json.dumps(key)}: {json.dumps(value)}")
    return "{\n" + ",\n".join(lines) + "\n}\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", metavar="CONFIG", help="set the rows in this configuration file")
    args = ap.parse_args(argv)
    rows = plan_rows()
    if not args.write:
        for r in rows:
            print(json.dumps(r))
        return 0
    from perfbench.drivers.plan import published
    from repro_torch.configs import get_smoke_config

    with open(args.write) as f:
        config = json.load(f)
    keys, start = published(get_smoke_config(ARCH))
    config["model"]["smoke"] = dict(keys, expert_start=start)
    config["accelerators"] = {ACCELERATOR: rows, SMOKE_ACCELERATOR: plan_rows(smoke=True)}
    with open(args.write, "w") as f:
        f.write(render(config))
    print(f"{len(rows)} rows written to {args.write}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
