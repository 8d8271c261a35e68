"""A whole run of each cell on the CPU at a small size, past the harness's
look for a card: sound, it comes out correct and reports its metrics; with
the timed path broken underneath it comes out not correct, once for each
fault the cell can have.  (No cell spans chips, so none can lose an
exchange between them.)"""
import json
import time

import numpy as np
import pytest

from perfbench import bench, control

# the service's open loop has no cell (PERF.md, Open questions): it is
# driven here through a manifest that adds one, with its metrics
MANIFEST = bench.load_manifest()
MANIFEST["workloads"].append(dict(name="u50.serve-sa", config="table1.u50", traffic="serve-sa",
                                  chips=1, why="the service's open loop"))
MANIFEST["end_to_end"].append(dict(name="request_ms.p95", unit="ms", better="lower",
                                   bound=0.25, source="host_clock", workloads=["u50.serve-sa"]))
MANIFEST["per_layer"] += [
    dict(name=name, unit=unit, better=better, source=source, layer=layer,
         moves="request_ms.p95", workloads=["u50.serve-sa"])
    for name, unit, better, source, layer in [
        ("batch_occupancy.serve", "requests", "higher", "program_counter", "service"),
        ("device_idle_pct.serve", "%", "lower", "device_trace", "device")]]
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SMALL = ["CNV-W1A1", "CNV-W2A2", "Tincy-YOLO"]


def shrink(traffic):
    t = json.loads(json.dumps(traffic))
    t["accelerators"] = SMALL[:1] if t["entry"] == "pack" else SMALL
    s = t["settings"]
    if "max_generations" in s:
        s["max_generations"] = 8
    else:
        s["max_iterations"] = 40
    if t["entry"] == "serve":
        t["rate_hz"] = 20.0
        t["check"]["sample"] = 4
    return t


def run(cell, seed=2**31 + 11, trace=False):
    return bench.run_cell(cell, seed, 0.4, trace, "cpu", time.perf_counter(),
                          manifest=MANIFEST, traffic_override=shrink, log=lambda m: None)


def _alg(cell):
    return bench.cell_parts(MANIFEST, cell)[2]["algorithm"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell, trace):
    r = run(cell, trace=trace)
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks" and all(v["value"] == 0 for v in r["checks"].values())
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in MANIFEST[group] if bench.applies(m, cell)}
    # without a card the device-trace metrics have nothing to read
    want -= {m["name"] for m in MANIFEST[group] if m["source"] == "device_trace"}
    assert want <= set(r["metrics"]) and want


def _frozen_step(mp, cell):
    """Every step returns its state unchanged."""
    if _alg(cell) == "ga-nfd":
        from repro_torch.core.ga import GeneticPacker

        mp.setattr(GeneticPacker, "_mutation_phase", lambda self, run: [])
        return
    from repro_torch.kernels.binpack_sa_step import ops

    orig = ops.sa_step_deltas
    mp.setattr(ops, "sa_step_deltas",
               lambda *a, **k: np.full_like(np.asarray(orig(*a, **k)), 10**9))


def _half_batch(mp, cell):
    """Half of each batched call's rows left out, the mean of the rest in
    their place (the GA's population, the SA fleet's chains)."""
    from repro_torch.kernels.binpack_fitness import ops as fops
    from repro_torch.kernels.binpack_sa_step import ops as sops

    mod, name = (fops, "population_costs") if _alg(cell) == "ga-nfd" else (sops, "sa_step_deltas")
    orig = getattr(mod, name)

    def half(*a, **k):
        out = np.asarray(orig(*a, **k))
        flat = out.reshape(-1).copy()
        h = max(len(flat) // 2, 1)
        flat[h:] = np.round(flat[:h].mean())
        return flat.reshape(out.shape)
    mp.setattr(mod, name, half)


def _altered_answer(mp, cell):
    """The answer altered where it is produced: one buffer of the best
    packing moved into a full bin (or dropped)."""
    import repro_torch.core as rc
    from repro_torch.core.ga import GeneticPacker
    from repro_torch.core.sa import SimulatedAnnealingPacker

    def alter(sol):
        bins = control.break_guarantee(sol.bins, sol.problem.max_items)
        return rc.Solution(sol.problem, bins, kinds=list(sol.kinds))

    if _alg(cell) == "ga-nfd":
        orig = GeneticPacker._finish_run

        def finish(self, run):
            res = orig(self, run)
            res.solution = alter(res.solution)
            return res
        mp.setattr(GeneticPacker, "_finish_run", finish)
        return
    orig = SimulatedAnnealingPacker._block_finish

    def block_finish(self, st):
        outs = orig(self, st)
        for o in outs:
            o.best = alter(o.best)
        return outs
    mp.setattr(SimulatedAnnealingPacker, "_block_finish", block_finish)


@pytest.mark.parametrize("fault", [_frozen_step, _half_batch, _altered_answer],
                         ids=["frozen_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    r = run(cell)
    assert r["correct"] is False
    assert r["checks"]["mismatched"]["value"] + r["checks"]["invalid"]["value"] >= 1
