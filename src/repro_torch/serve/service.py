"""Packing-as-a-service: async front-end over the batched sweep core (the
port's `repro.serve.service`).

:class:`PackingService` accepts ``pack`` requests from many concurrent
asyncio clients and answers each one bit-identically to a standalone
``repro_torch.core.pack(problem, seed=s)`` call with the service's solver
settings (and so to the reference's ``repro.core.pack``).  The pipeline,
in lookup order per request:

1. **coalesce** — an identical request (same task key: fingerprint +
   algorithm + seed + settings) already in flight shares its future; N
   concurrent duplicates cost exactly one solve;
2. **memory cache** — previously answered this process, served instantly;
3. **result store** — previously answered *any* process over this store
   dir (:class:`repro_torch.serve.store.ResultStore`; the reference's
   layout, so either package's entries serve), digest-verified read;
4. **solve** — enqueued (bounded queue → backpressure), micro-batched by
   ``batch_group_key`` under the :class:`repro_torch.serve.batching.
   MicroBatcher` policy, and executed as one
   ``repro_torch.core.dse.solve_batch`` fleet on a single-dispatch worker
   lane (one thread, one batch at a time — the evaluation engines own the
   parallelism; on a CUDA device the fleet's SA deltas run on K3 / K4 and
   the GA's fitness on K1 / K2, launched on that thread's current stream).

Bit-parity argument: per-problem RNG streams make every fleet candidate
bit-identical to its standalone run (pinned by tests/test_torch_dse.py),
so batch composition — who you share a micro-batch with, cache hits,
coalescing — is an execution-shape knob, never a semantics change.
``tests/test_torch_serve_property.py`` pins this end to end.

Solver settings (algorithm, backend, device, budgets, hyperparameters) are
fixed per service instance; requests carry only ``(problem, seed,
deadline_ms)``.  ``device`` is resolved at construction (``None`` means
``"cuda"`` and raises where CUDA is not available, before any request);
the task key holds the backend as given and no device, because results
are bit-identical across backends and devices.  A ``deadline_ms`` too
tight for the batching window skips it (single-candidate fallback; see
batching.py).  ``stats()`` is the observability surface;
``drain()``/``stop()`` finish accepted work before shutdown.
"""
from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..core import dse
from ..core.problem import PackingProblem, PackingResult, batch_group_key
from ..device import resolve_device
from .batching import MicroBatcher, Request
from .stats import Histogram, LatencyStats
from .store import ResultStore

_CLOSE = object()  # queue sentinel: no more requests will arrive


class PackingService:
    def __init__(
        self,
        algorithm: str = "sa-s",
        store_dir: str | Path | None = None,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        max_seconds: float = 30.0,
        intra_layer: bool = False,
        backend: str = "auto",
        device=None,
        clock=time.monotonic,
        **hyper,
    ):
        self.device = resolve_device(device)
        self.algorithm = algorithm.lower()
        self.max_seconds = float(max_seconds)
        self.intra_layer = bool(intra_layer)
        self.backend = backend
        self.hyper = dse.normalize_hyper(self.algorithm, hyper)
        self.store = (
            ResultStore(store_dir, memory_cache=False) if store_dir is not None else None
        )
        self.max_queue = int(max_queue)
        self._clock = clock
        self._batcher = MicroBatcher(max_batch=max_batch, max_wait_ms=max_wait_ms)
        self._queue: asyncio.Queue | None = None
        self._batch_task: asyncio.Task | None = None
        self._solve_tasks: set[asyncio.Task] = set()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="pack-serve"
        )
        self._inflight: dict[tuple, asyncio.Future] = {}
        self._results: dict[tuple, PackingResult] = {}
        self._closed = False
        # ----------------------------------------------- observability
        self.n_requests = 0
        self.n_coalesced = 0
        self.n_mem_hits = 0
        self.n_store_hits = 0
        self.n_solved = 0
        self.n_batches = 0
        self.n_deadline_fallbacks = 0
        self.occupancy = Histogram()
        self.lat_cached = LatencyStats()
        self.lat_solved = LatencyStats()

    # ------------------------------------------------------------ lifecycle
    async def __aenter__(self) -> "PackingService":
        self._ensure_started()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def _ensure_started(self) -> None:
        if self._closed:
            raise RuntimeError("PackingService is stopped")
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=self.max_queue)
            self._batch_task = asyncio.create_task(self._batch_loop())

    async def drain(self) -> None:
        """Wait until every accepted request has been answered."""
        while self._queue is not None and (
            not self._queue.empty()
            or self._batcher.pending()
            or self._solve_tasks
            or self._inflight
        ):
            tasks = list(self._solve_tasks)
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            else:
                # waiting on a batching window, not on solver work
                await asyncio.sleep(self._batcher.max_wait_s / 4 or 0.001)

    async def stop(self) -> None:
        """Drain accepted work, stop the loops, release the worker lane."""
        if self._closed:
            return
        self._closed = True
        if self._queue is not None:
            await self._queue.put(_CLOSE)
            await self._batch_task
            if self._solve_tasks:
                await asyncio.gather(*list(self._solve_tasks),
                                     return_exceptions=True)
        self._pool.shutdown(wait=True)

    # -------------------------------------------------------------- request
    def task_key(self, prob: PackingProblem, seed: int) -> tuple:
        return dse.task_key(
            prob,
            self.algorithm,
            seed,
            intra_layer=self.intra_layer,
            backend=self.backend,
            max_seconds=self.max_seconds,
            hyper=self.hyper,
        )

    async def pack(
        self,
        prob: PackingProblem,
        seed: int = 0,
        deadline_ms: float | None = None,
    ) -> PackingResult:
        """Answer one packing request (bit-identical to standalone pack).

        Awaiting may block on the bounded request queue when the service is
        saturated — that *is* the backpressure contract: admission slows to
        the worker lane's pace instead of queueing unboundedly.
        """
        self._ensure_started()
        t0 = self._clock()
        self.n_requests += 1
        key = self.task_key(prob, seed)

        fut = self._inflight.get(key)
        if fut is not None:
            self.n_coalesced += 1
            res = await asyncio.shield(fut)
            self.lat_solved.record(self._clock() - t0)
            return res

        res = self._results.get(key)
        if res is not None:
            self.n_mem_hits += 1
            self.lat_cached.record(self._clock() - t0)
            return res

        if self.store is not None:
            res = self.store.get(key, prob)
            if res is not None:
                self.n_store_hits += 1
                self._results[key] = res
                self.lat_cached.record(self._clock() - t0)
                return res

        fut = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        req = Request(
            prob=prob,
            seed=seed,
            key=key,
            group=batch_group_key(prob),
            future=fut,
            arrival=t0,
            flush_at=t0,
            deadline_at=(
                t0 + float(deadline_ms) / 1e3 if deadline_ms is not None
                else None
            ),
        )
        try:
            await self._queue.put(req)  # bounded: blocks when saturated
        except BaseException:
            # never admitted: drop the in-flight slot so later duplicates
            # don't coalesce onto a future nobody will resolve
            if self._inflight.get(key) is fut:
                del self._inflight[key]
            raise
        res = await asyncio.shield(fut)
        self.lat_solved.record(self._clock() - t0)
        return res

    # ------------------------------------------------------------- batching
    async def _batch_loop(self) -> None:
        closing = False
        while not closing:
            flush_at = self._batcher.next_flush_at()
            timeout = (
                None if flush_at is None
                else max(0.0, flush_at - self._clock())
            )
            item: object | None
            try:
                item = await asyncio.wait_for(self._queue.get(), timeout)
            except asyncio.TimeoutError:
                item = None
            # drain whatever else arrived in the same loop tick — cheaper
            # batches and no spurious window churn
            while item is not None:
                if item is _CLOSE:
                    closing = True
                else:
                    self._batcher.admit(item, self._clock())
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    item = None
            batches = (
                self._batcher.drain() if closing
                else self._batcher.pop_ready(self._clock())
            )
            for batch in batches:
                task = asyncio.create_task(self._run_batch(batch))
                self._solve_tasks.add(task)
                task.add_done_callback(self._solve_tasks.discard)

    async def _run_batch(self, batch: list[Request]) -> None:
        self.n_batches += 1
        self.occupancy.record(len(batch))
        if any(r.deadline_rushed for r in batch):
            self.n_deadline_fallbacks += 1
        probs = [r.prob for r in batch]
        seeds = [r.seed for r in batch]
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(
                self._pool, self._solve, probs, seeds
            )
        except Exception as e:
            for r in batch:
                self._inflight.pop(r.key, None)
                if not r.future.done():
                    r.future.set_exception(e)
            return
        for r, res in zip(batch, results):
            self._results[r.key] = res
            if self.store is not None:
                self.store.put(r.key, res)
            self.n_solved += 1
            self._inflight.pop(r.key, None)
            if not r.future.done():
                r.future.set_result(res)

    def _solve(self, probs, seeds) -> list[PackingResult]:
        # worker-lane thread; ThreadPoolExecutor(max_workers=1) serializes
        # batches so the engines never contend for the evaluation backend
        return dse.solve_batch(
            probs,
            algorithm=self.algorithm,
            seeds=seeds,
            max_seconds=self.max_seconds,
            intra_layer=self.intra_layer,
            backend=self.backend,
            device=self.device,
            **self.hyper,
        )

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        hits = self.n_coalesced + self.n_mem_hits + self.n_store_hits
        return {
            "requests": self.n_requests,
            "coalesced": self.n_coalesced,
            "cache_hits_mem": self.n_mem_hits,
            "cache_hits_store": self.n_store_hits,
            "hit_rate": hits / self.n_requests if self.n_requests else 0.0,
            "solved": self.n_solved,
            "batches": self.n_batches,
            "deadline_fallbacks": self.n_deadline_fallbacks,
            "queue_depth": self._queue.qsize() if self._queue else 0,
            "pending": self._batcher.pending(),
            "inflight": len(self._inflight),
            "batch_occupancy": self.occupancy.summary(),
            "latency_cached": self.lat_cached.summary(),
            "latency_solved": self.lat_solved.summary(),
            "store": self.store.stats() if self.store is not None else None,
        }
