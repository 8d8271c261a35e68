"""Probe the SA fleet step's compiled host loop (``core/sa_native.py``)
against the numpy body on this host.

    python tools/sa_step_probe_torch.py [--steps 2000]

Prints one JSON line:

* ``load_s`` — the helper's first use (its build by ``cc`` if
  ``build/host/`` holds no library for the source);
* ``cases`` — for each shape the benchmark's SA cells run, (64, 4)
  single-kind (RN152-W1A2 on BRAM18, 64 chains), (64, 4) @U50 (the same on
  an Alveo U50's inventory) and (128, 4) over 16 problems (the 8 Table-1
  accelerators x 2 seeds, 8 chains each): the host microseconds a step
  outside the delta call (``us_per_step``, helper and numpy body, each from
  the same start), whether both ended in equal states (``equal``), and the
  step counters ``sa.step.native`` / ``sa.step.python`` each run added.

The delta call is answered on the host (``backend="python"``) and its time
is left out, so the numbers are the step's own host code; no card is used.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

import repro_torch.core as c  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import sa_native  # noqa: E402
from repro_torch.core.sa import SimulatedAnnealingPacker  # noqa: E402

NAME = "RN152-W1A2"
COUNTERS = ("sa.step.native", "sa.step.python")


def start(names, device, n_chains, steps):
    hp = c.hyperparams(NAME)
    packer = SimulatedAnnealingPacker(
        perturbation="swap", n_chains=n_chains, t0=hp["sa_t0"], rc=hp["sa_rc"],
        max_iterations=steps, max_seconds=1e9, patience=10**9, backend="python",
        device="cpu")
    probs = [c.get_problem(n, device=device) for n in names]
    rngs = [np.random.default_rng(j) for j in range(len(probs))]
    return packer, packer._block_start(probs, rngs, [[] for _ in probs], "python")


def host_us_per_step(packer, st):
    """Drive one `_block_gen` to its end; the host time a step outside the
    delta call, and the counters it added."""
    before = {k: obs.counter(k) for k in COUNTERS}
    gen = packer._block_gen(st)
    n, t_eval, t0 = 0, 0.0, time.perf_counter()
    req = next(gen, None)
    while req is not None:
        t = time.perf_counter()
        d_e = packer._block_eval(st, req)
        t_eval += time.perf_counter() - t
        n += 1
        try:
            req = gen.send(d_e)
        except StopIteration:
            req = None
    us = (time.perf_counter() - t0 - t_eval) / n * 1e6
    return us, {k: obs.counter(k) - before[k] for k in COUNTERS}


def case(names, device, n_chains, steps):
    packer, st = start(names, device, n_chains, steps)
    twin = copy.deepcopy(st)
    out = {"rows": st.n_rows, "width": 2 * st.n_moves}
    out["native_us_per_step"], out["native_counters"] = host_us_per_step(packer, st)
    saved = sa_native._lib
    sa_native._lib = None
    try:
        out["numpy_us_per_step"], out["numpy_counters"] = host_us_per_step(packer, twin)
    finally:
        sa_native._lib = saved
    out["equal"] = bool(
        all(np.array_equal(getattr(st, f), getattr(twin, f))
            for f in st.CODEC_ARRAYS + (st.CODEC_ARRAYS_HETERO if st.hetero else ()))
        and [r.bit_generator.state for r in st.rngs]
        == [r.bit_generator.state for r in twin.rngs])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    args = ap.parse_args()
    t = time.perf_counter()
    out = {"library": sa_native.library() is not None, "load_s": time.perf_counter() - t}
    out["cases"] = {
        "(64, 4) single-kind": case([NAME], None, 64, args.steps),
        "(64, 4) @U50": case([NAME], "U50", 64, args.steps),
        "(128, 4) x 16 problems": case(list(c.ACCELERATORS) * 2, None, 8, args.steps // 2),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
