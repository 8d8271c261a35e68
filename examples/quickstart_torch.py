"""Quickstart on the port: pack ResNet-50's parameter memories into FPGA
BRAM with `repro_torch.core` (on the card, GA-NFD's population fitness runs
on the hand-written CUDA kernel).

Reproduces the paper's headline result (Table 4, RN50-W1A2): GA-NFD packs
896 parameter memories from ~64% baseline mapping efficiency to ~85%+,
around a 1.35x BRAM reduction, in seconds.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.core as core  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-seconds", type=float, default=20.0)
    ap.add_argument("--max-generations", type=int, default=None,
                    help="stop after this many GA generations (default: "
                         "the wall-clock budget alone)")
    args = ap.parse_args(argv)

    prob = core.get_problem("RN50-W1A2")
    print(f"ResNet-50 accelerator: {prob.n} parameter memories, "
          f"{prob.total_bits / 8 / 1024:.0f} KiB of weights")
    baseline = prob.singleton_solution()
    print(f"baseline (one memory per BRAM group): {baseline.cost()} BRAM, "
          f"{baseline.efficiency() * 100:.1f}% efficient")

    hp = core.hyperparams("RN50-W1A2")
    if args.max_generations is not None:
        hp["max_generations"] = args.max_generations
    result = core.pack(prob, "ga-nfd", seed=0, max_seconds=args.max_seconds,
                       device=args.device, **hp)
    result.solution.validate()
    print(result.summary())
    print(f"largest bin holds {result.solution.max_items_per_bin()} memories "
          f"(cardinality limit {prob.max_items} = BRAM port constraint)")
    print("paper's result for reference: 1374 BRAM @ 86.9% (inter-layer)")
    return result


if __name__ == "__main__":
    main()
