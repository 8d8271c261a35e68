"""The paper's motivating use-case on the port: memory packing inside a DSE
inner loop, with `repro_torch.core` (on the card, the annealer's delta
costs run on the hand-written CUDA kernels).

A design-space exploration sweeps per-layer parallelism (folding) and
target-device candidates; each needs a packed OCM estimate fast (paper
section 2.3).  Instead of packing candidates one at a time, the whole
fold x device grid goes through ONE ``pack_sweep`` call: candidates sharing
a cost model are batched into a single vectorized annealer run (every
candidate still gets its exact standalone-seeded trajectory), duplicates
are served from the fingerprint cache, and the result is a ready-made
efficiency/Pareto table for the DSE scorer.

    PYTHONPATH=src python examples/dse_loop_torch.py
    PYTHONPATH=src python examples/dse_loop_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.core as core  # noqa: E402
from repro_torch.core import PackingProblem, buffers_from_shape_rows  # noqa: E402


def fold_candidates():
    """Fold the CNV-W1A1 accelerator: more PEs = more throughput = wider,
    shallower memories (lower baseline mapping efficiency)."""
    base = core.TABLE1_ROWS["CNV-W1A1"]
    for fold in (1, 2, 4):
        rows = []
        for n_pe, (n_simd, depth, w) in base:
            rows.append((n_pe * fold, (n_simd, max(8, depth // fold), w)))
        yield fold, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-iterations", type=int, default=1500)
    args = ap.parse_args(argv)

    # the DSE grid: folding factor x target device (None = unbounded BRAM18)
    devices = (None, "ZU7EV", "U50")
    problems = []
    for fold, rows in fold_candidates():
        bufs = buffers_from_shape_rows(rows)
        for dev in devices:
            problems.append(
                PackingProblem(
                    bufs,
                    name=f"fold{fold}" + (f"@{dev}" if dev else ""),
                    ocm=core.get_ocm(dev) if dev else None,
                )
            )
    cache: dict = {}
    kw = dict(seed=0, n_chains=8, max_seconds=1e9, max_iterations=args.max_iterations,
              patience=10**9, cache=cache, device=args.device)
    sweep = core.pack_sweep(problems, "sa-s", **kw)
    print(sweep.table())
    # the DSE outer loop revisits candidates constantly — cached re-sweeps
    # are effectively free
    again = core.pack_sweep(problems, "sa-s", **kw)
    print(f"re-sweep: {again.summary()}")
    print("one pack_sweep call scores the whole fold x device grid — fast "
          "enough to sit inside the DSE scoring loop")
    return sweep, again


if __name__ == "__main__":
    main()
