"""Synthetic service traffic (the port's `repro.serve.traffic`): Poisson
arrivals over a Zipf problem mix.

Models the service's request profile — many accelerator/CNN/folding variants
of the same underlying problems arriving concurrently — as a seeded,
reproducible workload:

* a corpus of random problems (optionally heterogeneous, i.e. carrying an
  OCM inventory so kind lanes are exercised);
* **Zipf-distributed popularity** over the corpus (rank-``r`` problem drawn
  with probability proportional to ``r**-zipf_a``) — hot problems repeat,
  which is what makes micro-batching, coalescing, and the result store
  earn their keep;
* **Poisson arrivals** at ``rate_hz`` (i.i.d. exponential gaps);
* a small seed pool per request, so duplicate fingerprints arrive both
  with equal seeds (dedup/coalesce/cache path) and different ones
  (distinct tasks that still share a micro-batch).

``make_problems`` and ``make_workload`` draw from numpy's
``default_rng`` in the reference's order, so one seed gives the
reference's corpus (equal fingerprints) and schedule.  ``run_traffic``
drives a :class:`repro_torch.serve.PackingService` with the workload under
a client-concurrency bound and returns per-request records plus
throughput/latency summaries; ``verify_parity`` replays every unique task
through standalone ``repro_torch.core.pack`` on the service's device and
backend and bit-compares.  Shared by ``tools/serve_traffic_torch.py``
(CLI / kill-restart lane) and ``chip_smoke.py``'s service phase.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass

import numpy as np

from ..core.api import pack
from ..core.problem import (
    BRAM18,
    URAM288,
    Buffer,
    OCMInventory,
    PackingProblem,
    PackingResult,
)
from .service import PackingService
from .stats import LatencyStats


def result_signature(res: PackingResult) -> tuple:
    """Canonical bit-parity signature of a packing result.

    Everything deterministic per (problem, seed, settings): packing, kind
    lanes, cost, convergence trace, iteration count.  Wall time is
    excluded — it is the one legitimately run-dependent field.
    """
    return (
        int(res.cost),
        tuple(tuple(b) for b in res.solution.bins),
        tuple(int(k) for k in res.solution.kinds),
        tuple(int(cost) for _, cost in res.trace),
        int(res.iterations),
    )


def make_problems(
    n: int, seed: int = 0, hetero: bool = False, max_buffers: int = 24
) -> list[PackingProblem]:
    """Seeded corpus of small random problems (the traffic's "model zoo")."""
    rng = np.random.default_rng(seed)
    probs = []
    for i in range(n):
        nb = int(rng.integers(2, max_buffers))
        bufs = [
            Buffer(
                width=int(rng.integers(1, 80)),
                depth=int(rng.integers(1, 40_000)),
                layer=int(rng.integers(0, 5)),
            )
            for _ in range(nb)
        ]
        ocm = (
            OCMInventory(
                (BRAM18, URAM288),
                (int(rng.integers(-1, 200)), int(rng.integers(-1, 64))),
                name=f"dev{i}",
            )
            if hetero
            else None
        )
        probs.append(
            PackingProblem(
                bufs, max_items=int(rng.integers(1, 6)), name=f"traffic{i}",
                ocm=ocm,
            )
        )
    return probs


@dataclass(frozen=True)
class Arrival:
    at_s: float  # offset from traffic start
    prob_idx: int
    seed: int


def make_workload(
    n_requests: int,
    n_problems: int,
    *,
    rate_hz: float = 200.0,
    zipf_a: float = 1.2,
    n_seeds: int = 2,
    seed: int = 0,
) -> list[Arrival]:
    """Seeded arrival schedule: Poisson timing, Zipf problem popularity."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n_requests)
    at = np.cumsum(gaps)
    ranks = np.arange(1, n_problems + 1, dtype=np.float64)
    popularity = ranks ** -zipf_a
    popularity /= popularity.sum()
    idx = rng.choice(n_problems, size=n_requests, p=popularity)
    seeds = rng.integers(0, n_seeds, size=n_requests)
    return [
        Arrival(float(a), int(i), int(s)) for a, i, s in zip(at, idx, seeds)
    ]


async def run_traffic(
    service: PackingService,
    problems: list[PackingProblem],
    workload: list[Arrival],
    *,
    concurrency: int = 32,
    deadline_ms: float | None = None,
    deadline_every: int = 0,
    on_response=None,
) -> dict:
    """Drive ``service`` with ``workload``; returns records + summary.

    Arrivals are held to their schedule (a client sleeps until its arrival
    offset), then bounded by ``concurrency`` in-flight clients.  With
    ``deadline_every=k`` every k-th request carries ``deadline_ms`` — the
    latency-sensitive slice of the traffic.  ``on_response(record)`` fires
    as each response lands (the kill-restart lane uses it to die mid-run).
    """
    sem = asyncio.Semaphore(concurrency)
    lat = LatencyStats()
    records: list[dict] = []
    t0 = service._clock()

    async def one(i: int, a: Arrival) -> None:
        delay = a.at_s - (service._clock() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        dl = (
            deadline_ms
            if deadline_ms is not None and deadline_every
            and i % deadline_every == 0
            else None
        )
        async with sem:
            sent = service._clock()
            res = await service.pack(
                problems[a.prob_idx], seed=a.seed, deadline_ms=dl
            )
            dt = service._clock() - sent
        lat.record(dt)
        rec = {
            "i": i,
            "arrival_s": a.at_s,
            "prob_idx": a.prob_idx,
            "seed": a.seed,
            "latency_s": dt,
            "deadline_ms": dl,
            "cost": int(res.cost),
        }
        records.append(rec)
        if on_response is not None:
            on_response(rec)

    await asyncio.gather(*(one(i, a) for i, a in enumerate(workload)))
    wall = service._clock() - t0
    return {
        "records": sorted(records, key=lambda r: r["i"]),
        "wall_s": wall,
        "rps": len(workload) / wall if wall > 0 else 0.0,
        "latency": lat.summary(),
    }


def verify_parity(
    service: PackingService,
    problems: list[PackingProblem],
    workload: list[Arrival],
    responses: dict[tuple[int, int], PackingResult] | None = None,
    backend: str | None = None,
) -> dict:
    """Replay every unique (problem, seed) standalone and bit-compare.

    Compares against the service's memory/result-store state (or explicit
    ``responses`` keyed by ``(prob_idx, seed)``), using the same solver
    settings the service was built with.  The replay runs on the service's
    backend unless ``backend`` names another: results are bit-identical
    across backends, so ``backend="python"`` holds a kernel-backed
    service's answers to the host code.  Returns ``{"parity": bool,
    "tasks": n, "mismatches": [...]}``.
    """
    unique = sorted({(a.prob_idx, a.seed) for a in workload})
    mismatches = []
    for idx, seed in unique:
        prob = problems[idx]
        if responses is not None:
            served = responses.get((idx, seed))
        else:
            key = service.task_key(prob, seed)
            served = service._results.get(key)
            if served is None and service.store is not None:
                served = service.store.get(key, prob)
        if served is None:
            mismatches.append({"prob_idx": idx, "seed": seed,
                               "error": "no served result"})
            continue
        ref = pack(
            prob,
            service.algorithm,
            seed=seed,
            max_seconds=service.max_seconds,
            intra_layer=service.intra_layer,
            backend=service.backend if backend is None else backend,
            device=service.device,
            **service.hyper,
        )
        if result_signature(served) != result_signature(ref):
            mismatches.append({"prob_idx": idx, "seed": seed,
                               "error": "signature mismatch"})
    return {
        "parity": not mismatches,
        "tasks": len(unique),
        "mismatches": mismatches,
    }
