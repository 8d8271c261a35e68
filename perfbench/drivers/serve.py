"""``serve``: open loop: requests into one `repro_torch.serve.PackingService`
on a fixed schedule drawn from the seed, each timed from its due time."""
from __future__ import annotations

import asyncio

from .. import schedule
from . import Driver, Solve


class ServeDriver(Driver):
    """Requests due on the schedule, sent at their due time whatever the
    service is doing; a request's latency runs from its due time to its
    answer, so a stalled service also delays the requests behind it.  After
    the window the driver waits up to ``drain_s`` for answers still owed;
    one that never comes, or raises, counts as missing every limit.
    Arrivals are Poisson at ``rate_hz``, popularity Zipf ``zipf_a``
    (`schedule.open_loop`); ``knee`` records the sweep that set the rate."""

    EXTRA_KEYS = frozenset({"rate_hz", "zipf_a", "service", "drain_s", "knee"})
    windows = 0  # run so far: each window draws its own requests from the seed

    def _service(self, warm=False):
        from repro_torch.serve import PackingService

        settings = dict(self.traffic["settings"], **(self.traffic["warmup"] if warm else {}))
        return PackingService(self.traffic["algorithm"], backend=self.backend, device=self.device,
                              **self.traffic["service"], **settings)

    def setup(self):
        # one batch of each size the traffic can form, on the first
        # accelerator: the fleet shapes (k problems x chains) of the window
        async def warm():
            async with self._service(warm=True) as svc:
                first = self.problems[self.accelerators[0]]
                for k in range(1, self.traffic["service"]["max_batch"] + 1):
                    await asyncio.gather(*(svc.pack(first, seed=self.seeds.next())
                                           for _ in range(k)))
        asyncio.run(warm())

    def window(self, seconds: float) -> dict:
        arrivals = schedule.open_loop(self.traffic, self.accelerators, self.seed, seconds,
                                      part=self.windows)
        self.windows += 1
        self.arrivals = arrivals
        return asyncio.run(self._run(arrivals, seconds))

    async def _run(self, arrivals, seconds):
        svc = self._service()
        kw = self.traffic["settings"]
        lat = [None] * len(arrivals)
        late = []
        answers = [None] * len(arrivals)
        loop = asyncio.get_running_loop()

        async def one(i, a, due):
            try:
                res = await svc.pack(self.problems[a.accelerator], seed=a.seed)
            except Exception:  # a refused or failed request: missing
                return
            lat[i] = loop.time() - due
            answers[i] = res

        tasks = []
        async with svc:
            t0 = loop.time()
            for i, a in enumerate(arrivals):
                due = t0 + a.due_s
                delay = due - loop.time()
                if delay > 0:
                    await asyncio.sleep(delay)
                late.append(loop.time() - due)
                tasks.append(asyncio.create_task(one(i, a, due)))
            t_close = t0 + seconds
            if loop.time() < t_close:
                await asyncio.sleep(t_close - loop.time())
            window_s = loop.time() - t0
            done, pending = await asyncio.wait(tasks, timeout=self.traffic["drain_s"])
            for t in pending:
                t.cancel()
            await asyncio.gather(*pending, return_exceptions=True)
            stats = svc.stats()
        for a, res in zip(arrivals, answers):
            if res is not None:
                self.solves.append(Solve(a.accelerator, a.seed, kw, res))
        missing = sum(x is None for x in lat)
        return dict(window_s=window_s, requests=len(arrivals), latencies_s=lat,
                    lateness_s=late, missing=missing, attempted=len(arrivals),
                    failed=missing, service_stats=stats)


DRIVER = ServeDriver
