"""The plain reference against the port's ``python`` backend on small
Table-1 problems, and the judge and the control against broken packings
(CPU only)."""
import json
from pathlib import Path

import pytest

from perfbench import check, control
from perfbench.drivers import Solve, program_problem
from perfbench.reference import search
from perfbench.reference.problem import judge, load_config, problem_from_config

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {n: load_config(ROOT / "perfbench" / "configs" / f"{n}.json")
           for n in ("table1.bram18", "table1.u50")}
SETTINGS = dict(max_seconds=1e9, patience=10**9)
CASES = [
    ("table1.bram18", "CNV-W1A1", "ga-nfd", dict(max_generations=12), 3),
    ("table1.bram18", "Tincy-YOLO", "ga-nfd", dict(max_generations=6), 2**31 + 9),
    ("table1.u50", "CNV-W2A2", "ga-nfd", dict(max_generations=10), 5),
    ("table1.u50", "CNV-W1A1", "sa-s", dict(n_chains=8, max_iterations=300), 4),
    ("table1.u50", "Tincy-YOLO", "sa-s", dict(n_chains=4, max_iterations=260), 6),
    ("table1.bram18", "CNV-W2A2", "sa-s", dict(n_chains=8, max_iterations=300), 8),
    ("table1.bram18", "DoReFaNet", "sa-s", dict(n_chains=3, max_iterations=100), 10),
]


def _port(cfg, acc, alg, kw, seed):
    import repro_torch.core as rc

    hp = dict(cfg["hyperparameters"][acc], **kw, **SETTINGS)
    return rc.pack(program_problem(cfg, acc), alg, seed=seed, backend="python",
                   device="cpu", **hp), hp


@pytest.mark.parametrize("name,acc,alg,kw,seed", CASES)
def test_reference_replay_equals_the_port(name, acc, alg, kw, seed):
    cfg = CONFIGS[name]
    res, hp = _port(cfg, acc, alg, kw, seed)
    want = search.SEARCHES[alg](problem_from_config(cfg, acc), seed, **hp)
    got = check.signature(res)
    assert {k: want[k] for k in got} == got
    faults, cost, ovf = judge(problem_from_config(cfg, acc), want["bins"], want["kinds"])
    assert faults == [] and cost == res.cost and ovf == int(res.params.get("overflow", 0))


@pytest.mark.parametrize("acc", ["CNV-W1A1", "ReBNet", "RN152-W1A2"])
def test_judge_works_cost_out_as_the_program_does(acc):
    import repro_torch.core as rc

    for name, cfg in CONFIGS.items():
        prob = program_problem(cfg, acc)
        sol = rc.nfd_from_scratch(prob, __import__("numpy").random.default_rng(1))
        faults, cost, ovf = judge(problem_from_config(cfg, acc), sol.bins, list(sol.kinds))
        assert faults == [] and cost == sol.cost() and ovf == sol.inventory_overflow()
        assert problem_from_config(cfg, acc).n == prob.n


@pytest.mark.parametrize("how", ["moved_into_full", "dropped", "doubled", "kind"])
def test_judge_rejects_a_broken_packing(how):
    cfg = CONFIGS["table1.u50"]
    prob = problem_from_config(cfg, "CNV-W1A1")
    want = search.sa_s(prob, 1, n_chains=4, max_iterations=50)
    bins, kinds = [list(b) for b in want["bins"]], list(want["kinds"])
    assert judge(prob, bins, kinds)[0] == []
    if how == "moved_into_full":
        bins = control.break_guarantee(bins, prob.max_items)
    elif how == "dropped":
        bins[0] = bins[0][:-1] or bins[1][:1]
    elif how == "doubled":
        bins[1].append(bins[0][0])
    else:
        kinds[0] = prob.n_kinds
    assert judge(prob, bins, kinds)[0]


def _solves(name, acc, alg, kw, seeds):
    out = []
    cfg = CONFIGS[name]
    for s in seeds:
        res, hp = _port(cfg, acc, alg, kw, s)
        out.append(Solve(acc, s, hp, res))
    return out


@pytest.mark.parametrize("name,acc,alg,kw", [c[:4] for c in CASES[::3]])
def test_control_comes_out_not_correct(name, acc, alg, kw):
    """The program's answers pass; the reference in their place with one
    guarantee broken fails on both numbers, on three seeds."""
    cfg = CONFIGS[name]
    traffic = dict(algorithm=alg, check=dict(sample=3))
    solves = _solves(name, acc, alg, kw, [21, 22, 23])
    ok = check.check(cfg, traffic, solves, 5)
    assert check.passed(ok["values"]) and ok["replayed"] == 3
    bad = check.check(cfg, traffic, control.control_solves(cfg, traffic, solves), 5)
    assert bad["values"]["invalid"] == 3 and bad["values"]["mismatched"] == 3
    assert not check.passed(bad["values"])


def test_replay_needs_a_step_budget():
    t = json.loads((ROOT / "perfbench" / "traffic" / "pack-ga.json").read_text())
    check.replay_ready(t)
    for bad in ({"max_seconds": 30.0}, {"patience": 50}):
        with pytest.raises(ValueError):
            check.replay_ready(dict(t, settings=dict(t["settings"], **bad)))
