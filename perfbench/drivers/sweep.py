"""``sweep``: a design-space exploration, closed loop:
`repro_torch.core.dse.pack_sweep` back to back over the traffic's
accelerators, each candidate a fresh seed."""
from __future__ import annotations

import time

from . import Driver, Solve


class SweepDriver(Driver):
    """Back-to-back sweeps over the traffic's accelerators, each with
    ``seeds_per_candidate`` fresh seeds, so every candidate is distinct."""

    EXTRA_KEYS = frozenset({"seeds_per_candidate"})

    def _sweep(self, names, seeds, kw):
        probs = [self.problems[a] for a in names]
        return self._dse.pack_sweep(probs, self.traffic["algorithm"], seeds=seeds,
                                    backend=self.backend, device=self.device, **kw)

    def setup(self):
        from repro_torch.core import dse

        self._dse = dse
        # the fleet's shape (candidates x chains) on the cheapest accelerator
        n = len(self.accelerators) * self.traffic["seeds_per_candidate"]
        first = self.accelerators[0]
        self._sweep([first] * n, [self.seeds.next() for _ in range(n)],
                    self.settings(first, warm=True))

    def window(self, seconds: float) -> dict:
        kw = self.settings(self.accelerators[0])
        sweeps = candidates = positions = 0
        each = []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            names, seeds = [], []
            for _ in range(self.traffic["seeds_per_candidate"]):
                s = self.seeds.next()
                names += self.accelerators
                seeds += [s] * len(self.accelerators)
            sw = self._sweep(names, seeds, kw)
            each.append(time.perf_counter() - t)
            sweeps += 1
            candidates += len(sw.fresh)
            positions += len(names)
            self.solves += [Solve(a, s, kw, r) for a, s, r in zip(names, seeds, sw.results)]
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(window_s=time.perf_counter() - t0, sweeps=sweeps, candidates=candidates,
                    each_s=each, positions=positions, attempted=positions, failed=0)


DRIVER = SweepDriver
