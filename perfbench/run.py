"""Run one cell of the benchmark once, on the card this process finds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (and, traced,
``breakdown``), and last ``checks``: each number the correctness check
compared, with its limit.  The same numbers end standard error.  Exits
non-zero, printing no result, where CUDA is missing or has fewer cards than
the cell asks for, and where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, one host thread for the math libraries: the program's host
# path is single-threaded Python, and idle pool threads spinning on a
# shared host only add noise to its clock
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench import bench, check

    manifest = bench.load_manifest()
    cell, _, _ = bench.cell_parts(manifest, args.workload)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START, manifest=manifest, log=log)
    loaded = bench.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in check.lines({k: v["value"] for k, v in result["checks"].items()}):
        print(f"[check] {line}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
