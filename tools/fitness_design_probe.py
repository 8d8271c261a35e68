#!/usr/bin/env python3
"""Time K1 / K2's redesign against the designs it was chosen over, on one
CUDA card:

    python3 tools/fitness_design_probe.py

Builds ``tools/fitness_design_probe.cu`` (which includes the port's
``csrc/binpack_fitness.cu``) with the port's nvcc flags into
``build/kernels/``, holds every variant exactly against the plain version
(the GA's main-path inputs, ragged and cluster-edge shapes, int32
extremes), then prints per-launch device times (CUDA graphs of 200
launches, the lower of two rounds run in turns) at the GA's main-path
shapes (RN152-W1A2 and @U50, 75 rows x 2253 slots) and at the all-empty
(1, 1) input:

* the port's kernels (the wrappers: one 1024-thread block per row) and
  the first design's row body (K5, ``portfolio_step``, with no SA chains);
* the port's design with its 32-bit product path switched off;
* each row over a thread-block cluster of up to 8 blocks, with and without
  the 32-bit product path and the ``st.async`` row sum;
* empty kernels, plain and as clusters, with and without a cluster
  barrier: what a launch costs before any work.

K1 is also timed at two more shapes: 300 rows of 2253 slots, and 50 rows of
609 (the memory planner's hymba-1.5b shape, here with random geometry).

The last line is a JSON object of every time in microseconds.  Imports
nothing of JAX or the reference package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fitness_design_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels import build
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda, binpack_fitness_kinds_ref,
        binpack_fitness_ref,
    )
    from repro_torch.kernels.binpack_portfolio_step import (
        portfolio_step_cuda, portfolio_step_kinds_cuda,
    )

    dev = torch.device("cuda")
    print(f"[card] {cs.nvidia_smi()}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = Path(__file__).with_suffix(".cu")
    lib_path = build.BUILD_DIR / "fitness_design_probe.so"
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
                          str(lib_path), str(src)], capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    P, I, T = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(build.FitnessTables)
    lib.probe_block_row_launch.argtypes = [I, P, P, P, P, I, I, T, I, P]
    lib.probe_cluster_launch.argtypes = [I, P, P, P, P, I, I, T, I, P]
    lib.probe_empty_launch.argtypes = [I, I, I, I, P]
    for fn in (lib.probe_block_row_launch, lib.probe_cluster_launch, lib.probe_empty_launch):
        fn.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run(launch, *args, w, h, k, kt):
        """One probe kernel on (P, NB) planes; ``k`` None for K1."""
        totals = torch.empty(w.shape[0], dtype=torch.int64, device=dev)
        tables = build.fitness_tables_struct(kt)
        rc = launch(*args, w.data_ptr(), h.data_ptr(), None if k is None else k.data_ptr(),
                    totals.data_ptr(), w.shape[0], w.shape[1], ctypes.byref(tables),
                    int(k is not None), stream())
        if rc != 0:
            raise RuntimeError(f"probe launch failed with error {rc}")
        return totals

    z4 = torch.zeros((0, 4), dtype=torch.int32, device=dev)
    # name -> (C entry point, variant bits: 1 the 32-bit product path, 2 st.async)
    designs = {
        "port design, 64-bit products": (lib.probe_block_row_launch, 0),
        "cluster, 64-bit products, cluster.sync": (lib.probe_cluster_launch, 0),
        "cluster, 32-bit products, cluster.sync": (lib.probe_cluster_launch, 1),
        "cluster, 64-bit products, st.async": (lib.probe_cluster_launch, 2),
        "cluster, 32-bit products, st.async": (lib.probe_cluster_launch, 3),
    }

    def variants(w, h, k, modes, kt):
        """name -> (K1 call, K2 call) on the same planes."""
        one = ((1, modes),)
        out = {
            "port": (lambda: binpack_fitness_cuda(w, h, modes),
                     lambda: binpack_fitness_kinds_cuda(w, h, k, kt)),
            "first design (K5, no chains)": (  # K5 returns (totals, deltas)
                lambda: portfolio_step_cuda(w, h, z4, z4, z4, z4, modes)[0],
                lambda: portfolio_step_kinds_cuda(w, h, k, z4, z4, z4, z4, z4, z4, kt)[0]),
        }
        for name, (fn, v) in designs.items():
            out[name] = (lambda fn=fn, v=v: run(fn, v, w=w, h=h, k=None, kt=one),
                         lambda fn=fn, v=v: run(fn, v, w=w, h=h, k=k, kt=kt))
        return out

    def planes(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
                for a in arrays]

    # exactness: every variant, the main path's planes and edge shapes
    inputs = cs.main_path_inputs(dev)
    hom, het = inputs[None], inputs[cs.DEVICE_U50]
    kt_u50 = het["prob"].kind_tables
    rng = np.random.default_rng(0)
    cases = [(het["W"], het["H"], het["K"], BRAM18_MODES, kt_u50)]
    for shape in [(1, 1), (3, 511), (77, 513), (5, 4097), (300, 2253), (7, 9000)]:
        cases.append((*cs.random_planes(rng, shape, n_kinds=2), BRAM18_MODES, kt_u50))
    big = rng.integers(2**31 - 1000, 2**31, (5, 1025)).astype(np.int32)
    modes_big = ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))
    cases.append((big, rng.integers(0, 2**31, big.shape), rng.integers(-1, 6, big.shape),
                  modes_big, ((1, modes_big), (5, ((2**31 - 1, 2**31 - 1),)))))
    n_checked = 0
    for w, h, k, modes, kt in cases:
        w, h, k = planes(w, h, k)
        want = (binpack_fitness_ref(w, h, modes).sum(1),
                binpack_fitness_kinds_ref(w, h, k, kt).sum(1))
        for name, calls in variants(w, h, k, modes, kt).items():
            for call, ref in zip(calls, want):
                got = call()
                torch.cuda.synchronize()
                if not torch.equal(got[: ref.shape[0]], ref):
                    raise AssertionError(f"{name} {tuple(w.shape)} differs from the plain version")
                n_checked += 1
    print(f"[exact] {n_checked} variant calls equal to the plain version")

    # timing, two rounds in turns; the lower of the two
    W, H = planes(hom["W"], hom["H"])
    Wk, Hk, Kk = planes(het["W"], het["H"], het["K"])
    z = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    main_k1 = variants(W, H, None, BRAM18_MODES, None)
    main_k2 = variants(Wk, Hk, Kk, BRAM18_MODES, kt_u50)
    floor = variants(z, z, z, BRAM18_MODES, ((1, BRAM18_MODES),))
    w300, h300 = planes(*cs.random_planes(rng, (300, 2253))[:2])
    w50, h50 = planes(*cs.random_planes(rng, (50, 609))[:2])
    rows300 = variants(w300, h300, None, BRAM18_MODES, None)
    rows50 = variants(w50, h50, None, BRAM18_MODES, None)
    s_main = 5  # the cluster design's blocks per 2253-slot row (512 slots a block)

    def empty(blocks, threads, cluster, sync):
        def go():
            rc = lib.probe_empty_launch(blocks, threads, cluster, sync, stream())
            if rc != 0:
                raise RuntimeError(f"empty launch failed with error {rc}")
        return go

    empties = {
        "empty, 1 block": empty(1, 128, 0, 0),
        f"empty, {75 * s_main} blocks": empty(75 * s_main, 128, 0, 0),
        "empty, 1 cluster of 1": empty(1, 128, 1, 0),
        f"empty, 75 clusters of {s_main}": empty(75 * s_main, 128, s_main, 0),
        "empty + cluster.sync, 1 cluster of 1": empty(1, 128, 1, 1),
        f"empty + cluster.sync, 75 clusters of {s_main}": empty(75 * s_main, 128, s_main, 1),
    }
    times: dict[str, list[float]] = {}
    for _ in range(2):
        for name in main_k1:
            times.setdefault(f"K1 {name}", []).append(cs.time_graph(main_k1[name][0], 200))
            times.setdefault(f"K2 {name}", []).append(cs.time_graph(main_k2[name][1], 200))
            times.setdefault(f"floor K1 {name}", []).append(cs.time_graph(floor[name][0], 200))
            times.setdefault(f"K1 (300, 2253) {name}", []).append(
                cs.time_graph(rows300[name][0], 200))
            times.setdefault(f"K1 (50, 609) {name}", []).append(cs.time_graph(rows50[name][0], 200))
        for name, fn in empties.items():
            times.setdefault(name, []).append(cs.time_graph(fn, 200))
    us = {name: min(v) * 1e3 for name, v in times.items()}
    for name, v in times.items():
        print(f"[time] {name}: {' '.join(f'{x * 1e3:.2f}' for x in v)} us per launch (graph)")
    print(cs.nvidia_smi())
    print(json.dumps({"card": cs.nvidia_smi(), "us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
