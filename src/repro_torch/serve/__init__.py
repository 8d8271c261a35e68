"""Packing as a service: async micro-batching front-end over the sweep core
(the port's `repro.serve`, name for name).  Quickstart::

    from repro_torch.serve import PackingService

    async with PackingService("sa-s", store_dir="./pack_store",
                              device="cuda", max_iterations=200,
                              patience=10**9, max_seconds=1e9) as svc:
        res = await svc.pack(problem, seed=3)      # == pack(problem, ...)
        print(svc.stats()["latency_solved"])

``device`` defaults to ``"cuda"`` (solves launch K3 / K4 for SA-S, K1 / K2
for the GA) and raises at construction where CUDA is not available; pass
``device="cpu"`` to run on the host.
"""
from .batching import MicroBatcher, Request  # noqa: F401
from .service import PackingService  # noqa: F401
from .stats import Histogram, LatencyStats  # noqa: F401
from .store import ResultStore  # noqa: F401
from .traffic import (  # noqa: F401
    Arrival,
    make_problems,
    make_workload,
    result_signature,
    run_traffic,
    verify_parity,
)
