"""The comparison that decides a run's ``correct``.

Every answer of the window is judged by what it says (`reference.problem.
judge`): each buffer placed exactly once, no bin over ``max_items``, each
bin's kind in the inventory and, on a bounded inventory, each kind's
primitives within its count, and the cost and overflow the program stated
equal to the ones worked out again from the buffers and the inventory.  A
sample of the answers, drawn from the seed with the largest accelerator's
answer in it, is also held to the plain reference's replay of the same
search from the same seed: the packing, its kind lane, the cost, every
cost on the trace, the steps run and, for SA, the uphill moves proposed and
accepted must all be equal.  The search does exact integer arithmetic and
draws on the host, so the limit on every number is 0.
"""
from __future__ import annotations

import time

import numpy as np

from . import schedule
from .reference import search
from .reference.problem import judge, problem_from_config

LIMITS = {"invalid": 0, "mismatched": 0, "missing": 0}


def replay_ready(traffic: dict) -> None:
    """The replay follows a search to its step budget: a wall clock or a
    patience stop in the settings would make the program's answer depend on
    the host's speed.  Raise on such settings."""
    s = traffic["settings"]
    budget = s.get("max_generations", s.get("max_iterations"))
    if budget is None or s.get("max_seconds", 0) < 1e9 or s.get("patience", 0) < budget:
        raise ValueError("the traffic's settings need a step budget, max_seconds >= 1e9 "
                         "and patience >= the budget")


def signature(res) -> dict:
    out = dict(cost=int(res.cost), bins=[[int(i) for i in b] for b in res.solution.bins],
               kinds=[int(k) for k in res.solution.kinds],
               trace=[c for _, c in res.trace], iterations=int(res.iterations))
    if "uphill_proposed" in res.params:
        out["uphill"] = (int(res.params["uphill_proposed"]), int(res.params["uphill_accepted"]))
    return out


def check(config: dict, traffic: dict, solves, seed: int, missing: int = 0) -> dict:
    """The numbers compared, each with its limit, and what was looked at."""
    probs = {}
    invalid, notes = 0, []
    for sv in solves:
        p = probs.get(sv.accelerator)
        if p is None:
            p = probs[sv.accelerator] = problem_from_config(config, sv.accelerator)
        sol = sv.result.solution
        faults, cost, ovf = judge(p, sol.bins, list(sol.kinds))
        if cost is not None and cost != int(sv.result.cost):
            faults.append(f"stated cost {int(sv.result.cost)}, worked out {cost}")
        stated = sv.result.params.get("overflow", 0)
        if ovf is not None and ovf != int(stated):
            faults.append(f"stated overflow {stated}, worked out {ovf}")
        if ovf:
            faults.append(f"{ovf} units over the inventory")
        if faults:
            invalid += 1
            notes.append(f"{sv.accelerator} seed {sv.seed}: " + "; ".join(faults[:3]))
    t = time.perf_counter()
    mismatched, sampled = 0, sample(solves, traffic["check"]["sample"], seed,
                                    lambda a: probs[a].n)
    replay = search.SEARCHES[traffic["algorithm"]]
    for sv in sampled:
        want = replay(probs[sv.accelerator], sv.seed, **sv.settings)
        got = signature(sv.result)
        diff = [k for k in got if got[k] != want.get(k)]
        if diff:
            mismatched += 1
            notes.append(f"{sv.accelerator} seed {sv.seed}: replay differs in {', '.join(diff)}")
    return dict(values=dict(invalid=invalid, mismatched=mismatched, missing=missing),
                judged=len(solves), replayed=len(sampled),
                replay_s=time.perf_counter() - t, notes=notes)


def sample(solves, k: int, seed: int, size_of) -> list:
    """``k`` answers drawn from the seed, the first answer of the largest
    accelerator among them."""
    if not solves:
        return []
    rng = np.random.default_rng(schedule.entropy(seed, 3))
    largest = max(range(len(solves)), key=lambda i: (size_of(solves[i].accelerator), -i))
    rest = [i for i in range(len(solves)) if i != largest]
    picks = [largest] + [int(i) for i in rng.permutation(rest)[: max(k - 1, 0)]]
    return [solves[i] for i in sorted(picks)]


def passed(values: dict) -> bool:
    return all(values[k] <= LIMITS[k] for k in LIMITS)


def lines(values: dict) -> list[str]:
    return [f"{k} {values[k]} limit {LIMITS[k]}" for k in LIMITS]
