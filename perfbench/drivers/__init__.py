"""The entries a cell's window drives, one module each, found by the
traffic file's ``entry``: ``perfbench/drivers/<entry>.py`` holds a class
``DRIVER``.  Those here are ``pack`` (closed loop, one designer:
`repro_torch.core.api.pack` back to back), ``sweep`` (closed loop:
`repro_torch.core.dse.pack_sweep` back to back) and ``serve`` (open loop:
requests into one `repro_torch.serve.PackingService` on a fixed schedule,
each timed from the moment it was due).  A new entry is a new file.

A driver builds the program's problems from the configuration file's
buffer rows and inventory (the same data the plain reference reads), warms
up the shapes its traffic uses, runs the window, and keeps every answer
for the check.  ``window`` may be called more than once (a traced run
measures in two parts); each call reports its own counts and draws fresh
seeds.  Nothing here is timed by the program: the window's clock, the
packs counted and each request's latency are the benchmark's own.
"""
from __future__ import annotations

import importlib
import re
from dataclasses import dataclass
from pathlib import Path

from .. import schedule

HERE = Path(__file__).resolve().parent


@dataclass
class Solve:
    """One answer of the window, with what it was asked."""

    accelerator: str
    seed: int
    settings: dict
    result: object  # the program's PackingResult


def program_problem(config: dict, accelerator: str):
    """The configuration's accelerator as the program's `PackingProblem`."""
    import repro_torch.core as rc

    kinds = tuple(
        rc.RAMKind(k, tuple(tuple(int(x) for x in m) for m in config["ram_kinds"][k]["modes"]),
                   int(config["ram_kinds"][k]["capacity_bits"]))
        for k in config["kinds"]
    )
    buffers = [rc.Buffer(width=n_simd * wbits, depth=depth, layer=layer)
               for layer, (n_pe, (n_simd, depth, wbits)) in enumerate(config["accelerators"][accelerator])
               for _ in range(n_pe)]
    inv = config["inventory"]
    if inv is None:
        return rc.PackingProblem(buffers, bram=rc.BRAMSpec(modes=kinds[0].modes,
                                                            capacity_bits=kinds[0].capacity_bits),
                                 max_items=config["max_items"], name=accelerator)
    ocm = rc.OCMInventory(kinds, tuple(int(inv[k]) for k in config["kinds"]), name=config["device"])
    return rc.PackingProblem(buffers, max_items=config["max_items"],
                             name=f"{accelerator}@{config['device']}", ocm=ocm)


def load(entry: str):
    """The driver class of ``perfbench/drivers/<entry>.py``."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", entry) or not (HERE / f"{entry}.py").is_file():
        raise KeyError(f"no driver for entry {entry!r} (perfbench/drivers/<entry>.py)")
    return importlib.import_module(f"{__name__}.{entry}").DRIVER


class Driver:
    # the traffic file's keys every driver reads (``about`` is prose); a
    # driver adds its own in ``EXTRA_KEYS``, and a key that none reads is
    # refused, so a setting the driver does not implement never runs unseen
    KEYS = frozenset({"entry", "accelerators", "algorithm", "backend", "table2", "settings",
                      "warmup", "check", "about"})
    EXTRA_KEYS: frozenset = frozenset()

    @classmethod
    def check_keys(cls, traffic: dict) -> None:
        unknown = set(traffic) - cls.KEYS - cls.EXTRA_KEYS
        if unknown:
            raise ValueError(f"traffic keys {sorted(unknown)} are not read by the "
                             f"{traffic.get('entry')!r} driver")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.check_keys(traffic)
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.accelerators = schedule.accelerators(traffic, config)
        self.problems = {a: program_problem(config, a) for a in set(self.accelerators)}
        self.seeds = schedule.SeedStream(seed)
        self.solves: list[Solve] = []
        self.backend = traffic["backend"]

    def settings(self, accelerator: str, warm: bool = False) -> dict:
        out = schedule.solver_settings(self.traffic, self.config, accelerator)
        if warm:
            out.update(self.traffic["warmup"])
        return out
