#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises (non-zero exit,
no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed);
3. hold each kernel (K1-K4) against its plain PyTorch version on the card,
   exactly equal: the main path's own inputs (the RN152-W1A2 GA population,
   the 64-chain SA step), ragged shapes, random mode tables, the U50 kind
   tables and the 3-D problem axis;
4. the main path at full width: ``pack`` on RN152-W1A2 and RN152-W1A2@U50,
   GA-NFD, 64-chain and single-chain SA-S, once through the kernels
   (``backend="cuda"``, launch counts reset just before each run and read
   just after) and once through host numpy (``backend="python"``); the two
   must agree bit for bit;
5. timing: each kernel per launch (CUDA events around a CUDA graph of
   launches) and per wrapper call, its plain version, the ops layer per
   call with the host<->device copies, and those copies on their own;
   then each engine's generation / step loop alone (set-up excluded),
   ``python`` and ``cuda`` in turns, split per step into host time and
   ops-layer time;
6. one cuda loop of each engine under ``torch.profiler``: the device's
   busy share of the loop and its time in kernels and in copies.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA card and ``nvcc``; imports
nothing of JAX or the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM INT32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, one
# counted operation per instruction.  The data sheet quotes no integer rate;
# its float32 67 TFLOP/s is the same clock with 128 lanes and an FMA as two.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
PROBLEM = "RN152-W1A2"
DEVICE_U50 = "U50"
GA_GENS = 40
SA_CHAINS = 64
SA_ITERS = 2000
SA1_ITERS = 2000

KERNELS = {
    # wrapper name: (source, replaced Pallas kernel)
    "binpack_fitness_cuda": (
        "src/repro_torch/kernels/csrc/binpack_fitness.cu",
        "src/repro/kernels/binpack_fitness/kernel.py:58",
    ),
    "binpack_fitness_kinds_cuda": (
        "src/repro_torch/kernels/csrc/binpack_fitness.cu",
        "src/repro/kernels/binpack_fitness/kernel.py:86",
    ),
    "sa_step_deltas_cuda": (
        "src/repro_torch/kernels/csrc/binpack_sa_step.cu",
        "src/repro/kernels/binpack_sa_step/kernel.py:47",
    ),
    "sa_step_deltas_kinds_cuda": (
        "src/repro_torch/kernels/csrc/binpack_sa_step.cu",
        "src/repro/kernels/binpack_sa_step/kernel.py:85",
    ),
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def main_path_inputs(device):
    """The kernels' inputs exactly as the main path builds them: the GA's
    initial (n_pop, n) population geometry and the SA fleet's first
    (64, 2 * swap_moves) step request, on RN152-W1A2 and its U50 variant."""
    import numpy as np

    import repro_torch.core as rc

    hp = rc.hyperparams(PROBLEM)
    out = {}
    for dev in (None, DEVICE_U50):
        prob = rc.get_problem(PROBLEM, device=dev)
        ga = rc.make_packer("ga-nfd", seed=0, backend="cuda", device=device, **hp)
        run = ga._start_run(prob, np.random.default_rng(0), None, "cuda")
        sa = rc.make_packer("sa-s", seed=0, backend="cuda", device=device,
                            n_chains=SA_CHAINS, **hp)
        st = sa._block_start([prob], [np.random.default_rng(0)], [[]], "cuda")
        gen = sa._block_gen(st)
        req = next(gen)
        gen.close()
        out[dev] = dict(prob=prob, W=run.W, H=run.H, K=run.Km, req=req)
    return out


def random_kind_tables(rng):
    tables = []
    for _ in range(int(rng.integers(1, 4))):
        modes = tuple(
            (int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
            for _ in range(int(rng.integers(1, 7)))
        )
        tables.append((int(rng.integers(1, 32)), modes))
    return tuple(tables)


def random_planes(rng, shape, n_kinds=1):
    import numpy as np

    w = rng.integers(0, 100, shape).astype(np.int32)
    w[rng.random(shape) < 0.25] = 0
    h = np.where(w > 0, rng.integers(1, 70_000, shape), 0).astype(np.int32)
    k = rng.integers(0, n_kinds, shape).astype(np.int32)
    return w, h, k


# ----------------------------------------------------------------- phase 3
def check_kernels(inputs, device) -> dict:
    """Every kernel against its plain version on the card; returns the
    largest |kernel - plain| per kernel (all must be 0)."""
    import numpy as np
    import torch

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
        binpack_fitness_kinds_ref, binpack_fitness_ref, population_costs,
    )
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas, sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
        sa_step_deltas_kinds_ref, sa_step_deltas_ref,
    )

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
                for a in arrays]

    err = {name: 0 for name in KERNELS}
    n_cases = {name: 0 for name in KERNELS}

    def record(name, got, want, label):
        torch.cuda.synchronize()
        if got.dtype != torch.int64 or got.shape != want.shape:
            raise AssertionError(f"{name} {label}: {got.dtype} {tuple(got.shape)} "
                                 f"vs {want.dtype} {tuple(want.shape)}")
        e = int((got - want).abs().max()) if got.numel() else 0
        err[name] = max(err[name], e)
        n_cases[name] += 1
        if e != 0:
            raise AssertionError(f"{name} {label}: max |kernel - plain| = {e}")

    def k1(w, h, modes, label):
        w, h = dev(w, h)
        record("binpack_fitness_cuda", binpack_fitness_cuda(w, h, modes),
               binpack_fitness_ref(w, h, modes).sum(1), label)

    def k2(w, h, k, kt, label):
        w, h, k = dev(w, h, k)
        record("binpack_fitness_kinds_cuda", binpack_fitness_kinds_cuda(w, h, k, kt),
               binpack_fitness_kinds_ref(w, h, k, kt).sum(1), label)

    def k3(ow, oh, nw, nh, modes, label):
        ow, oh, nw, nh = dev(ow, oh, nw, nh)
        record("sa_step_deltas_cuda", sa_step_deltas_cuda(ow, oh, nw, nh, modes),
               sa_step_deltas_ref(ow, oh, nw, nh, modes), label)

    def k4(ow, oh, ok, nw, nh, nk, kt, label):
        t = dev(ow, oh, ok, nw, nh, nk)
        record("sa_step_deltas_kinds_cuda", sa_step_deltas_kinds_cuda(*t, kt),
               sa_step_deltas_kinds_ref(*t, kt), label)

    # the main path's own inputs
    hom, het = inputs[None], inputs[DEVICE_U50]
    kt_u50 = het["prob"].kind_tables
    k1(hom["W"], hom["H"], hom["prob"].kind_tables[0][1], f"GA population {hom['W'].shape}")
    k2(het["W"], het["H"], het["K"], kt_u50, f"GA population @U50 {het['W'].shape}")
    ow, oh, nw, nh, _, _ = hom["req"]
    k3(ow, oh, nw, nh, BRAM18_MODES, f"SA step {ow.shape}")
    ow, oh, nw, nh, ok, nk = het["req"]
    k4(ow, oh, ok, nw, nh, nk, kt_u50, f"SA step @U50 {ow.shape}")

    # ragged shapes, random mode tables, the U50 tables
    rng = np.random.default_rng(7)
    for p, nb in [(1, 1), (1, 2253), (3, 37), (13, 300), (75, 1000), (77, 2253), (300, 129)]:
        w, h, _ = random_planes(rng, (p, nb))
        k1(w, h, BRAM18_MODES, f"ragged {(p, nb)}")
        w, h, k = random_planes(rng, (p, nb), n_kinds=2)
        k2(w, h, k, kt_u50, f"ragged U50 {(p, nb)}")
    for c, t in [(1, 1), (1, 4), (3, 4), (9, 130), (64, 4), (200, 6), (1000, 2)]:
        ow, oh, ok = random_planes(rng, (c, t), n_kinds=2)
        nw, nh, nk = random_planes(rng, (c, t), n_kinds=2)
        k3(ow, oh, nw, nh, BRAM18_MODES, f"ragged {(c, t)}")
        k4(ow, oh, ok, nw, nh, nk, kt_u50, f"ragged U50 {(c, t)}")
    # int32 extremes: the kernels' unsigned 32-bit ceil-division stays exact
    big = (2**31 - 1000, 2**31)
    modes_big = ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))
    kt_big = ((1, modes_big), (5, ((2**31 - 1, 2**31 - 1),)))
    w, h, k = (rng.integers(*big, (5, 300)).astype(np.int32),
               rng.integers(*big, (5, 300)).astype(np.int32),
               rng.integers(0, 2, (5, 300)).astype(np.int32))
    k1(w, h, modes_big, "int32 extremes")
    k2(w, h, k, kt_big, "int32 extremes")
    k3(w[:, :4], h[:, :4], w[:, 4:8], h[:, 4:8], modes_big, "int32 extremes")
    k4(w[:, :4], h[:, :4], k[:, :4], w[:, 4:8], h[:, 4:8], k[:, 4:8], kt_big,
       "int32 extremes")
    for seed in range(12):
        r = np.random.default_rng(100 + seed)
        kt = random_kind_tables(r)
        p, nb = int(r.integers(1, 80)), int(r.integers(1, 600))
        w, h, k = random_planes(r, (p, nb), n_kinds=len(kt))
        k1(w, h, kt[0][1], f"random modes seed {seed}")
        k2(w, h, k, kt, f"random tables seed {seed}")
        ow, oh, ok = random_planes(r, (p, 4), n_kinds=len(kt))
        nw, nh, nk = random_planes(r, (p, 4), n_kinds=len(kt))
        k3(ow, oh, nw, nh, kt[0][1], f"random modes seed {seed}")
        k4(ow, oh, ok, nw, nh, nk, kt, f"random tables seed {seed}")

    # the (NP, P, NB) / (NP, C, T) problem axis through the ops layer
    w, h, k = random_planes(rng, (3, 5, 129), n_kinds=2)
    a = population_costs(w, h, backend="cuda", device=device)
    b = population_costs(w, h, backend="torch", device=device)
    if a.shape != (3, 5) or not np.array_equal(a, b):
        raise AssertionError("population_costs 3-D: cuda != torch")
    a = population_costs(w, h, backend="cuda", kinds=k, kind_tables=kt_u50, device=device)
    b = population_costs(w, h, backend="torch", kinds=k, kind_tables=kt_u50, device=device)
    if a.shape != (3, 5) or not np.array_equal(a, b):
        raise AssertionError("population_costs 3-D kinds: cuda != torch")
    ow, oh, ok = random_planes(rng, (4, 64, 4), n_kinds=2)
    nw, nh, nk = random_planes(rng, (4, 64, 4), n_kinds=2)
    for kw in ({}, dict(old_k=ok, new_k=nk, kind_tables=kt_u50)):
        a = sa_step_deltas(ow, oh, nw, nh, backend="cuda", device=device, **kw)
        b = sa_step_deltas(ow, oh, nw, nh, backend="python", **kw)
        if a.shape != (4, 64) or not np.array_equal(a, b):
            raise AssertionError(f"sa_step_deltas 3-D {sorted(kw)}: cuda != python")
    for name in KERNELS:
        print(f"[kernels] {name}: {n_cases[name]} cases, max |kernel - plain| = {err[name]}")
    return err


# ----------------------------------------------------------------- phase 4
def result_key(r):
    return (
        r.cost,
        [list(b) for b in r.solution.bins],
        [int(k) for k in r.solution.kinds],
        r.iterations,
        [c for _, c in r.trace],
    )


def main_path_runs(device) -> dict:
    """GA-NFD, 64-chain and single-chain SA-S on RN152-W1A2 and
    RN152-W1A2@U50 through the kernels, then through host numpy.  Launch
    counts are set to 0 just before each kernel run and read just after;
    each run must have launched its own kernel.  Returns the counts summed
    over the kernel runs."""
    import repro_torch.core as rc
    from repro_torch import kernels

    hp = rc.hyperparams(PROBLEM)
    algs = (
        ("ga-nfd", dict(max_generations=GA_GENS), "binpack_fitness"),
        ("sa-s", dict(n_chains=SA_CHAINS, max_iterations=SA_ITERS), "sa_step_deltas"),
        ("sa-s", dict(n_chains=1, max_iterations=SA1_ITERS), "sa_step_deltas"),
    )
    runs = [(dev, alg, kw, kernel) for dev in (None, DEVICE_U50) for alg, kw, kernel in algs]

    def go(backend):
        out = []
        for dev, alg, kw, _ in runs:
            kernels.reset_launch_counts()
            t = time.perf_counter()
            r = rc.pack(rc.get_problem(PROBLEM, device=dev), alg, seed=0,
                        max_seconds=1e9, backend=backend, device=device,
                        **dict(hp, **kw))
            out.append((r, time.perf_counter() - t, kernels.launch_counts()))
        return out

    cuda_runs = go("cuda")
    py_runs = go("python")
    launches = {name: 0 for name in KERNELS}
    for (dev, alg, kw, kernel), (rk, tk, nk), (rp, tp, np_) in zip(runs, cuda_runs, py_runs):
        label = f"{alg} {PROBLEM}{'@' + dev if dev else ''} {kw}"
        for r in (rk, rp):
            r.solution.validate()
            if r.solution.cost() != r.solution.cost_full() or r.cost != r.solution.cost():
                raise AssertionError(f"{label}: cost bookkeeping disagrees")
        if rk.params["backend"] != "cuda":
            raise AssertionError(f"{label}: ran on backend {rk.params['backend']}")
        if result_key(rk) != result_key(rp):
            raise AssertionError(f"{label}: cuda and python backends diverge")
        own = kernel + ("_kinds_cuda" if dev else "_cuda")
        if nk[own] <= 0 or any(np_.values()):
            raise AssertionError(f"{label}: launches {nk} through cuda, {np_} "
                                 f"through python; expected {own} only through cuda")
        for name, n in nk.items():
            launches[name] += n
        print(f"[main] {label}: cost={rk.cost} bins={len(rk.solution.bins)} "
              f"iterations={rk.iterations} trace_len={len(rk.trace)} "
              f"cuda {tk:.3f}s python {tp:.3f}s  (bit-identical) launches {json.dumps(nk)}")
    print(f"[main] launches: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return launches


# ----------------------------------------------------------------- phase 5
def time_events(fn, n: int, warm: int = 5) -> float:
    """Milliseconds per ``fn()`` call, CUDA events around ``n`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_graph(fn, n: int) -> float:
    """Device milliseconds per launch: ``n`` launches captured in one CUDA
    graph, replayed between CUDA events (no host launch cost inside)."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_events(g.replay, 5, warm=1) / n


def time_host(fn, n: int) -> float:
    fn()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e3


def kernel_timings(inputs, device) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
        binpack_fitness_kinds_ref, binpack_fitness_ref, population_costs,
    )
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas, sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
        sa_step_deltas_kinds_ref, sa_step_deltas_ref,
    )

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
                for a in arrays]

    hom, het = inputs[None], inputs[DEVICE_U50]
    kt = het["prob"].kind_tables
    n_modes_hom = len(BRAM18_MODES)
    n_modes_het = sum(len(m) for _, m in kt)
    W, H = dev(hom["W"], hom["H"])
    Wk, Hk, Kk = dev(het["W"], het["H"], het["K"])
    sa_hom = dev(*hom["req"][:4])
    sa_het = dev(*het["req"])  # ow, oh, nw, nh, ok, nk
    ow, oh, nw, nh, ok, nk = sa_het

    def live(w):
        return int((w > 0).sum())

    # Bytes the function must move: every width read once (it says which
    # slots are live), the other planes read only at live slots (an empty
    # slot costs 0 whatever its height or kind), the int64 output written
    # once.  Operations: 4 per mode per live slot (two ceil-divisions, a
    # product, a min), on that slot's own mode table.
    cases = {
        "binpack_fitness_cuda": dict(
            kernel=lambda: binpack_fitness_cuda(W, H, BRAM18_MODES),
            plain=lambda: binpack_fitness_ref(W, H, BRAM18_MODES).sum(1),
            ops=lambda: population_costs(hom["W"], hom["H"], backend="cuda", device=device),
            host=(hom["W"], hom["H"]),
            bytes=4 * W.numel() + 4 * live(W) + 8 * W.shape[0],
            ops_count=4 * n_modes_hom * live(W),
            shape=tuple(W.shape),
        ),
        "binpack_fitness_kinds_cuda": dict(
            kernel=lambda: binpack_fitness_kinds_cuda(Wk, Hk, Kk, kt),
            plain=lambda: binpack_fitness_kinds_ref(Wk, Hk, Kk, kt).sum(1),
            ops=lambda: population_costs(het["W"], het["H"], backend="cuda",
                                         kinds=het["K"], kind_tables=kt, device=device),
            host=(het["W"], het["H"], het["K"]),
            bytes=4 * Wk.numel() + 8 * live(Wk) + 8 * Wk.shape[0],
            ops_count=4 * sum(len(m) * int(((Wk > 0) & (Kk == i)).sum())
                              for i, (_, m) in enumerate(kt)),
            shape=tuple(Wk.shape),
        ),
        "sa_step_deltas_cuda": dict(
            kernel=lambda: sa_step_deltas_cuda(*sa_hom, BRAM18_MODES),
            plain=lambda: sa_step_deltas_ref(*sa_hom, BRAM18_MODES),
            ops=lambda: sa_step_deltas(*hom["req"][:4], backend="cuda", device=device),
            host=hom["req"][:4],
            bytes=4 * (sa_hom[0].numel() + sa_hom[2].numel())
            + 4 * (live(sa_hom[0]) + live(sa_hom[2])) + 8 * sa_hom[0].shape[0],
            ops_count=4 * n_modes_hom * (live(sa_hom[0]) + live(sa_hom[2])),
            shape=tuple(sa_hom[0].shape),
        ),
        "sa_step_deltas_kinds_cuda": dict(
            kernel=lambda: sa_step_deltas_kinds_cuda(ow, oh, ok, nw, nh, nk, kt),
            plain=lambda: sa_step_deltas_kinds_ref(ow, oh, ok, nw, nh, nk, kt),
            ops=lambda: sa_step_deltas(*het["req"][:4], backend="cuda", device=device,
                                       old_k=het["req"][4], new_k=het["req"][5],
                                       kind_tables=kt),
            host=het["req"],
            bytes=4 * (ow.numel() + nw.numel()) + 8 * (live(ow) + live(nw))
            + 8 * ow.shape[0],
            ops_count=4 * sum(len(m) * int(((x > 0) & (k == i)).sum())
                              for i, (_, m) in enumerate(kt)
                              for x, k in ((ow, ok), (nw, nk))),
            shape=tuple(ow.shape),
        ),
    }
    out = {}
    for name, c in cases.items():
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = c["ops_count"] / INT32_OPS_PER_S * 1e3
        # alternate kernel and plain runs (kernel, plain, plain, kernel)
        k1 = time_graph(c["kernel"], 200)
        p1 = time_events(c["plain"], 200)
        p2 = time_events(c["plain"], 200)
        k2 = time_graph(c["kernel"], 200)
        # the ops layer's copies on their own: every host plane to the card
        # as `_plane` does it, and the (rows,) int64 result back
        host = [np.ascontiguousarray(x, dtype=np.int32) for x in c["host"]]
        res = c["kernel"]()

        def h2d():
            return [torch.from_numpy(x).to(device) for x in host]

        def h2d_sync():
            h2d()
            torch.cuda.synchronize()

        out[name] = dict(
            ms=min(k1, k2),
            call_ms=time_events(c["kernel"], 500),
            plain_ms=min(p1, p2),
            ops_ms=time_host(c["ops"], 200),
            h2d_ms=time_events(h2d, 200),
            h2d_host_ms=time_host(h2d_sync, 200),
            d2h_host_ms=time_host(res.cpu, 200),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=c["bytes"],
            operations=c["ops_count"],
            shape=c["shape"],
        )
        o = out[name]
        print(f"[timing] {name} {c['shape']}: kernel {o['ms']*1e3:.2f} us/launch "
              f"(graph), wrapper call {o['call_ms']*1e3:.2f} us, plain "
              f"{o['plain_ms']*1e3:.2f} us, ops layer with copies "
              f"{o['ops_ms']*1e3:.2f} us (host->device copies {o['h2d_ms']*1e3:.2f} us "
              f"by events, {o['h2d_host_ms']*1e3:.2f} us by host clock; "
              f"device->host {o['d2h_host_ms']*1e3:.2f} us), bound "
              f"{o['bound_ms']*1e3:.4f} us ({o['bound_by']}: {o['bytes']} B, "
              f"{o['operations']} ops)")
    return out


class OpsTimer:
    """Host-clock (entry time, duration) of every call the engines make to
    the ops layer (`population_costs`, `sa_step_deltas`) while active.  The
    engines import both at call time, so swapping the module attributes
    reaches every engine.  A cuda call ends in a synchronising copy back, so
    its duration holds the copies, the launch and the kernel."""

    def __enter__(self):
        from repro_torch.kernels.binpack_fitness import ops as fops
        from repro_torch.kernels.binpack_sa_step import ops as sops

        self.calls = []
        self._saved = [(fops, "population_costs", fops.population_costs),
                       (sops, "sa_step_deltas", sops.sa_step_deltas)]
        for mod, attr, fn in self._saved:
            setattr(mod, attr, self._timed(fn))
        return self

    def _timed(self, fn):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            self.calls.append((t, time.perf_counter() - t))
            return out
        return timed

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def engine_loop(alg, kw, prob, backend, device, around):
    """Set up one engine on ``prob``, then run its generation / step loop
    alone inside the context ``around()``.  Returns the loop's wall time,
    per-step wall times, per-step ops-layer times (0 for a step without an
    ops call), the steps' chain count and the best cost (equal across
    backends: same seed, same budget)."""
    import numpy as np

    import repro_torch.core as rc

    hp = dict(rc.hyperparams(PROBLEM), max_seconds=1e9, **kw)
    eng = rc.make_packer(alg, seed=0, backend=backend, device=device, **hp)
    eng_backend = eng._resolve_backend()
    ops = OpsTimer()
    if alg == "ga-nfd":
        run = eng._start_run(prob, np.random.default_rng(eng.seed), None, eng_backend)
        eng._eval_init(run)
        steps, ops_s = [], []
        with ops, around():
            t0 = time.perf_counter()
            # GeneticPacker.pack's loop body, without its wall-clock and
            # patience stops (the budget is the generation count)
            while run.gen < eng.max_generations:
                t, n_calls = time.perf_counter(), len(ops.calls)
                run.gen += 1
                mutated = eng._mutation_phase(run)
                if run.batched and mutated:
                    eng._apply_costs(run, eng._batched_costs(run), mutated)
                eng._track_best(run)
                eng._tournament(run)
                steps.append(time.perf_counter() - t)
                ops_s.append(sum(d for _, d in ops.calls[n_calls:]))
            loop = time.perf_counter() - t0
        return dict(loop=loop, steps=steps, ops=ops_s, chains=1, key=run.best_cost)
    eng._hetero = prob.n_kinds > 1  # as SimulatedAnnealing.pack sets it
    if eng.n_chains == 1:
        st = eng._single_start(prob, None, eng_backend)
        body = eng._single_run
    else:
        st = eng._block_start([prob], [np.random.default_rng(eng.seed)], [[]], eng_backend)
        body = eng._block_run
    with ops, around():
        t0 = time.perf_counter()
        body(st)
        loop = time.perf_counter() - t0
    # every step makes one ops call: a step is one entry to the next
    entries = [t for t, _ in ops.calls] + [t0 + loop]
    steps = list(np.diff(entries))
    key = st.best_cost if eng.n_chains == 1 else int(st.gbest_cost[0])
    return dict(loop=loop, steps=steps, ops=[d for _, d in ops.calls],
                chains=eng.n_chains, key=key)


LOOPS = {
    # label: (algorithm, budget), each loop timed alone after its set-up
    "ga-nfd": ("ga-nfd", dict(max_generations=GA_GENS)),
    "sa-s x64": ("sa-s", dict(n_chains=SA_CHAINS, max_iterations=1000)),
    "sa-s x1": ("sa-s", dict(n_chains=1, max_iterations=3000)),
}


def loop_breakdown(device) -> dict:
    """Each main-path loop timed alone (set-up excluded), backends in turns
    (python, cuda, cuda, python).  Both backends walk the same trajectory,
    so step i does the same host work in every sample: per step, the lower
    of a backend's two samples is compared with the other backend's
    (``paired``: median of cuda - python).  ``host`` is a step's time
    outside the ops-layer call."""
    import contextlib

    import numpy as np

    import repro_torch.core as rc

    out = {}
    for dev in (None, DEVICE_U50):
        prob_name = PROBLEM + (f"@{dev}" if dev else "")
        for label, (alg, kw) in LOOPS.items():
            got = {"python": [], "cuda": []}
            for backend in ("python", "cuda", "cuda", "python"):
                got[backend].append(engine_loop(
                    alg, kw, rc.get_problem(PROBLEM, device=dev), backend, device,
                    contextlib.nullcontext))
            keys = {r["key"] for rs in got.values() for r in rs}
            if len(keys) != 1:
                raise AssertionError(f"{label} {prob_name}: loops diverge {keys}")
            rec = {}
            best_step = {}
            for backend, rs in got.items():
                n = min(len(r["steps"]) for r in rs)
                step = np.min([r["steps"][:n] for r in rs], axis=0)
                best_step[backend] = step
                rec[backend] = dict(
                    rate=[len(r["steps"]) * r["chains"] / r["loop"] for r in rs],
                    step_us=[float(np.median(r["steps"])) * 1e6 for r in rs],
                    ops_us=[float(np.median(r["ops"])) * 1e6 for r in rs],
                    host_us=[float(np.median(np.subtract(r["steps"], r["ops"]))) * 1e6
                             for r in rs],
                )
            n = min(len(v) for v in best_step.values())
            diff = best_step["cuda"][:n] - best_step["python"][:n]
            rec["paired_us"] = float(np.median(diff)) * 1e6
            rec["cuda_slower_share"] = float(np.mean(diff > 0))
            rec["steps"] = int(n)
            out[f"{label} {prob_name}"] = rec
            unit = "gens/s" if alg.startswith("ga") else "chain-steps/s"
            print(f"[loop] {label} {prob_name}, {n} steps, loop alone ({unit}; median "
                  f"us per step = host + ops layer), two samples each: " + "; ".join(
                      f"{b} {' '.join(f'{v:.1f}' for v in rec[b]['rate'])} "
                      f"(step {' '.join(f'{v:.1f}' for v in rec[b]['step_us'])} = host "
                      f"{' '.join(f'{v:.1f}' for v in rec[b]['host_us'])} + ops "
                      f"{' '.join(f'{v:.1f}' for v in rec[b]['ops_us'])})"
                      for b in ("python", "cuda"))
                  + f"; paired cuda - python {rec['paired_us']:.1f} us per step, "
                  f"cuda slower on {rec['cuda_slower_share']:.3f} of steps")
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_loops(device) -> dict:
    """One cuda loop of each main-path engine under ``torch.profiler`` (CPU
    and CUDA activities): the device's busy time (the union of its kernel
    and copy intervals) over the loop's wall time, and the device time by
    kind.  Profiling slows the host, so the busy share is a lower bound
    on the unprofiled run's.  Where the profiler records no device event,
    the device numbers are reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as rc

    short = {
        "ga-nfd": ("ga-nfd", dict(max_generations=10)),
        "sa-s x64": ("sa-s", dict(n_chains=SA_CHAINS, max_iterations=200)),
        "sa-s x1": ("sa-s", dict(n_chains=1, max_iterations=500)),
    }
    out = {}
    for dev in (None, DEVICE_U50):
        prob_name = PROBLEM + (f"@{dev}" if dev else "")
        for label, (alg, kw) in short.items():
            holder = {}

            def around():
                holder["prof"] = profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                return holder["prof"]

            r = engine_loop(alg, kw, rc.get_problem(PROBLEM, device=dev), "cuda",
                            device, around)
            by_kind = {"kernel": [], "HtoD": [], "DtoH": [], "other": []}
            for e in holder["prof"].events():
                if "CUDA" not in str(getattr(e, "device_type", "")):
                    continue
                iv = (e.time_range.start, e.time_range.end)
                kind = ("HtoD" if "HtoD" in e.name else "DtoH" if "DtoH" in e.name
                        else "other" if e.name.startswith(("Memcpy", "Memset"))
                        else "kernel")
                by_kind[kind].append(iv)
            wall_us = r["loop"] * 1e6
            every = [iv for ivs in by_kind.values() for iv in ivs]
            key = f"{label} {prob_name}"
            if not every:
                out[key] = dict(wall_us=wall_us, device="not measured")
                print(f"[profile] {key}: no device events recorded; device time "
                      f"not measured")
                continue
            busy = _union_us(every)
            out[key] = dict(
                wall_us=wall_us, steps=len(r["steps"]), busy_us=busy,
                busy_share=busy / wall_us,
                **{f"{k}_us": sum(b - a for a, b in v) for k, v in by_kind.items()},
                **{f"{k}_n": len(v) for k, v in by_kind.items()},
            )
            o = out[key]
            print(f"[profile] {key}, {o['steps']} steps: loop {wall_us:.0f} us "
                  f"(profiled), device busy {busy:.0f} us = {o['busy_share']:.4f}; "
                  f"kernels {o['kernel_us']:.0f} us / {o['kernel_n']}, HtoD "
                  f"{o['HtoD_us']:.0f} us / {o['HtoD_n']}, DtoH {o['DtoH_us']:.0f} us "
                  f"/ {o['DtoH_n']}, other {o['other_us']:.0f} us / {o['other_n']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from repro_torch.kernels import build

    t = time.perf_counter()
    reports = build.build()
    print(f"[build] {len(reports)} libraries in {time.perf_counter() - t:.1f}s -> "
          f"{build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    inputs = main_path_inputs(device)
    errs = check_kernels(inputs, device)
    launches = main_path_runs(device)
    timings = kernel_timings(inputs, device)
    loops = loop_breakdown(device)
    profiled = profile_loops(device)

    record = []
    for name, (source, replaces) in KERNELS.items():
        tm = timings[name]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
            bound_by=tm["bound_by"], library_ms=None,
            call_ms=tm["call_ms"], ops_ms=tm["ops_ms"], h2d_ms=tm["h2d_ms"],
            h2d_host_ms=tm["h2d_host_ms"], d2h_host_ms=tm["d2h_host_ms"],
            shape=tm["shape"],
        ))
    print(f"[loops] {json.dumps(loops)}")
    print(f"[profile] {json.dumps(profiled)}")
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
