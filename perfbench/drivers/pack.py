"""``pack``: one designer, closed loop: `repro_torch.core.api.pack` back to
back on one accelerator, each pack a fresh seed."""
from __future__ import annotations

import time

from . import Driver, Solve, program_problem


class PackDriver(Driver):
    """Back-to-back packs of one accelerator until ``seconds`` have passed;
    the window ends with the last pack, so it holds whole packs only."""

    EXTRA_KEYS = frozenset({"warmup_accelerator"})

    def setup(self):
        # called through its module, so a traced run's span reaches it
        from repro_torch.core import api

        self._api = api
        (acc,) = self.accelerators
        self.acc = acc
        # an SA fleet's kernel shapes (chains x touched bins) do not depend
        # on the problem, so a traffic file may warm up on a smaller one
        warm = self.traffic.get("warmup_accelerator", acc)
        if warm not in self.problems:
            self.problems[warm] = program_problem(self.config, warm)
        api.pack(self.problems[warm], self.traffic["algorithm"], seed=self.seeds.next(),
                 backend=self.backend, device=self.device, **self.settings(warm, warm=True))

    def window(self, seconds: float) -> dict:
        acc, prob = self.acc, self.problems[self.acc]
        kw = self.settings(acc)
        each = []
        t0 = time.perf_counter()
        while True:
            s = self.seeds.next()
            t = time.perf_counter()
            res = self._api.pack(prob, self.traffic["algorithm"], seed=s, backend=self.backend,
                                 device=self.device, **kw)
            each.append(time.perf_counter() - t)
            self.solves.append(Solve(acc, s, kw, res))
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(window_s=time.perf_counter() - t0, packs=len(each),
                    each_s=each, attempted=len(each), failed=0)


DRIVER = PackDriver
