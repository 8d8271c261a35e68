"""Traffic from a seed: the general generator every traffic file feeds.

A traffic file (``perfbench/traffic/<name>.json``) is data only: which
entry of the program it drives (``perfbench/drivers/<entry>.py``), the
accelerators it picks from, the algorithm and its budget, and for an open
loop the arrivals.  This module turns it and ``--seed`` into the work of a
run.  Every pack, sweep candidate and request gets a fresh seed from one
stream made from ``--seed``, so no answer is ever a repeat.

Open-loop arrivals are Poisson in rate and Zipf in popularity, as the
program's own traffic model draws them (``serve/traffic.py``'s
``make_workload``, copied here and frozen), with one change: every seed
gets the same multiset of gaps and of accelerators, in its own order.  The
gaps are the exponential distribution's quantiles at ``(i + 0.5) / n``,
and each accelerator's count is its Zipf share of ``n`` by largest
remainder; so the seed moves which request comes when, never how much
work a run holds.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SEED_SPACE = 2**62


def entropy(seed: int, salt: int) -> list[int]:
    """``--seed`` (any whole number, of any size) and a salt as a NumPy seed."""
    seed = int(seed)
    return [seed % 2**64, (seed // 2**64) % 2**64, salt]


class SeedStream:
    """Fresh solver seeds from ``--seed``."""

    def __init__(self, seed: int, salt: int = 0):
        self.rng = np.random.default_rng(entropy(seed, salt))

    def next(self) -> int:
        return int(self.rng.integers(SEED_SPACE))


@dataclass(frozen=True)
class Arrival:
    due_s: float  # offset from the window's start
    accelerator: str
    seed: int


def zipf_counts(n: int, n_ranks: int, a: float) -> list[int]:
    """``n`` requests over ranks 1..n_ranks in proportion to ``r ** -a``,
    rounded by largest remainder."""
    p = np.arange(1, n_ranks + 1, dtype=np.float64) ** -a
    share = n * p / p.sum()
    counts = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - counts), kind="stable")[: n - int(counts.sum())]:
        counts[i] += 1
    return [int(c) for c in counts]


def open_loop(traffic: dict, accelerators: list[str], seed: int, seconds: float,
              part: int = 0) -> list[Arrival]:
    """The requests due in ``[0, seconds)``: ``rate_hz * seconds`` of them.
    Each ``part`` of a run (a traced run measures in two) draws its own
    order and solver seeds from the same ``seed``."""
    n = int(round(traffic["rate_hz"] * seconds))
    if n < 1:
        return []
    rng = np.random.default_rng(entropy(seed, 1 + 2 * part))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / traffic["rate_hz"]
    gaps *= seconds / gaps.sum()
    gaps = rng.permutation(gaps)
    due = np.cumsum(gaps) - gaps[0]  # the first at 0, all before ``seconds``
    counts = zipf_counts(n, len(accelerators), traffic["zipf_a"])
    picks = rng.permutation(np.repeat(np.arange(len(accelerators)), counts))
    seeds = SeedStream(seed, salt=2 + 2 * part)
    return [Arrival(float(t), accelerators[int(i)], seeds.next()) for t, i in zip(due, picks)]


def accelerators(traffic: dict, config: dict) -> list[str]:
    """The traffic's accelerators, ``"all"`` meaning the configuration's
    in Table-1 order."""
    names = traffic["accelerators"]
    return list(config["accelerators"]) if names == "all" else list(names)


def solver_settings(traffic: dict, config: dict, accelerator: str) -> dict:
    """Hyperparameters of one solve: the configuration's Table-2 row for the
    accelerator where the traffic asks for it, then the traffic's own."""
    out = dict(config["hyperparameters"][accelerator]) if traffic.get("table2") else {}
    out.update(traffic["settings"])
    return out
