"""``plan``: one deployer, closed loop: the memory planner over a model's
parameter tree held on the device, then the packed store it plans, back
to back, each plan a fresh seed.

A unit of work is `repro_torch.memory.planner.plan_packing` on the tree
(split per layer, the traffic's algorithm and settings passed through to
the packer) followed by `repro_torch.memory.store.PackedParameterStore`
of the plan, the device synchronised.  Each plan's packer answer is kept
as the window's `Solve`, so the harness's check judges it and replays a
sample from the configuration's rows.

The tree is the configuration's ``model.arch`` of the port, drawn on the
device from ``--seed``; the configuration's accelerator ``model.rows``
holds its planner candidates in the planner's order, one a row, and the
driver asserts that the planner's problem is exactly those rows.  A CPU
cannot hold a chip's share of a model: on the CPU (the harness's own
tests, which shrink a traffic's ``accelerators`` to the Table-1 networks)
the tree is the arch's smoke twin and the rows ``model.smoke_rows``,
whatever the traffic names; on a CUDA device ``accelerators`` must name
``model.rows``.

Two checks count in the window's ``missing``, each outside the window's
clock: every store's views equal their leaves bit for bit (checked as its
plan's clock stops, then the store is dropped, as a deployer replaces a
store by the next), and, once a run, after the window, the decode through
the run's first store's ``unpack()`` agrees with the plain float32
reference (`perfbench.decode_check`, the traffic's ``decode``).
"""
from __future__ import annotations

import sys
import time

from . import Driver, Solve


def published(cfg) -> tuple[dict, int]:
    """The configuration file's keys that the port's config ``cfg`` must
    hold (the published ones the plain reference reads, the experts held
    and the vocabulary), and its first held expert."""
    keys = dict(cfg.plain_keys())
    start = keys.pop("expert_start")
    keys.update(num_hidden_layers=cfg.n_layers, intermediate_size=cfg.d_ff,
                shared_intermediate_size=cfg.shared_d_ff, num_local_experts=cfg.n_experts,
                n_experts=cfg.held_experts, vocab_size=cfg.vocab_size)
    return keys, start


class PlanDriver(Driver):
    EXTRA_KEYS = frozenset({"plan", "decode"})

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch

        self.on_cpu = torch.device(device).type == "cpu"
        model = config["model"]
        self.rows = model["smoke_rows" if self.on_cpu else "rows"]
        if not self.on_cpu and list(traffic["accelerators"]) != [self.rows]:
            raise ValueError(f"the plan entry's tree gives the rows {self.rows!r}")
        super().__init__(config, dict(traffic, accelerators=[self.rows]), seed, device)
        self.traffic = traffic
        self.acc = self.rows

    def setup(self):
        from repro_torch import configs
        from repro_torch.memory import planner, store
        from repro_torch.models import model as M

        model = self.config["model"]
        get = configs.get_smoke_config if self.on_cpu else configs.get_config
        cfg = get(model["arch"])
        keys, start = published(cfg)
        held = model["smoke"] if self.on_cpu else self.config
        plain = {k: held[k] for k in keys}
        if plain != keys or start != model["held"]["expert_start"]:
            raise ValueError(f"the port's {model['arch']} is not the configuration file's")
        self.cfg, self.plain = cfg, dict(plain, expert_start=start)
        self._planner, self._store = planner, store
        self.tree = M.init_params(cfg, self.seed % 2**63, device=self.device)
        try:
            plans = self._plan(self.seeds.next(), warm=True)
            result = plans[2].packer_result
        except planner.InvalidPlan as e:  # the window's answers are judged
            plans, result = None, e.result
        got = [[1, [int(b.width), int(b.depth), 1]] for b in result.solution.problem.buffers]
        if plans is not None and set(plans) != {2} or got != self.config["accelerators"][self.rows]:
            raise ValueError("the planner's problem is not the configuration's rows")
        if plans is not None:
            store.PackedParameterStore(self.tree, plans)
        self._sync()
        self._decoded = False
        self.decode = None

    def _sync(self):
        if not self.on_cpu:
            import torch

            torch.cuda.synchronize(self.device)

    def _plan(self, seed: int, warm: bool = False):
        p = self.traffic["plan"]
        # called through its module, so a traced run's span reaches it
        return self._planner.plan_packing(
            self.tree, self.traffic["algorithm"], seed=seed, max_items=self.config["max_items"],
            eff_threshold=p["eff_threshold"], split_stacked=p["split_stacked"],
            backend=self.backend, device=self.device, **self.settings(self.acc, warm=warm))

    def window(self, seconds: float) -> dict:
        kw = self.settings(self.acc)
        each, failed, bad, first = [], 0, 0, None
        checking = 0.0  # seconds of store checks, outside the window's clock
        t0 = time.perf_counter()
        while True:
            s = self.seeds.next()
            t = time.perf_counter()
            try:
                plans = self._plan(s)
            except self._planner.InvalidPlan as e:
                # the answer is kept, so the check judges it
                failed += 1
                self.solves.append(Solve(self.acc, s, kw, e.result))
                st = None
            else:
                st = self._store.PackedParameterStore(self.tree, plans)
                self._sync()
                self.solves.append(Solve(self.acc, s, kw, plans[2].packer_result))
            t1 = time.perf_counter()
            each.append(t1 - t)
            if st is not None:
                # the plan's clock has stopped: its store is checked, then
                # dropped (the first kept for the decode check), as a
                # deployer replaces a store by the next
                bad += not self._verify_store(st)
                if first is None and not self._decoded:
                    first = st
                del st
            checking += time.perf_counter() - t1
            if time.perf_counter() - t0 - checking >= seconds:
                break
        window_s = time.perf_counter() - t0 - checking
        decode_bad = 0
        if first is not None:
            self._decoded = True
            decode_bad = int(bool(self._verify_decode(first)))
        return dict(window_s=window_s, packs=len(each), each_s=each, attempted=len(each),
                    failed=failed, missing=bad + decode_bad, stores_unequal=bad,
                    decode=self.decode)

    def _verify_store(self, st) -> bool:
        """Every view of the store equals its leaf bit for bit."""
        import torch

        for path in st.entries:
            root, _, k = path.rpartition("#")
            leaf = _leaf(self.tree, root)[int(k)] if root else _leaf(self.tree, path)
            if not torch.equal(st.view(path), leaf):
                return False
        return True

    def _verify_decode(self, st) -> list[str]:
        """The decode check on ``st``'s unpacked tree; the comparisons over
        their limits (each value is kept in ``self.decode``)."""
        from perfbench import decode_check

        d = self.traffic["decode"]
        self.decode = decode_check.run(self.cfg, self.plain, st.unpack(), d["batch"],
                                       d["prompt_len"], d["steps"], self.seed % 2**63,
                                       self.device)
        over = decode_check.failed(self.decode)
        lim = decode_check.LIMITS
        print("[decode] " + ", ".join(
            f"{k} {v:.3e}" + (f" limit {lim[k]:.0e}" if k in lim else " (not judged)")
            for k, v in self.decode["values"].items())
            + f"; moe.dropped {self.decode['dropped']}"
            + f"; tokens left out of the layer checks at a near-tie route "
            f"{self.decode['masked']} of {self.decode['tokens']} x {self.cfg.n_layers}; "
            f"over the limit: {', '.join(over) or 'none'}", file=sys.stderr, flush=True)
        return over


def _leaf(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


DRIVER = PlanDriver
