#!/usr/bin/env python3
"""Time K1 / K2's and K5's redesigns against the designs they were chosen
over, on one CUDA card:

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
  the first design's row body (K5 as it was before its redesign, kept in
  the probe's own source, with no SA chains);
* the port's design with its 32-bit product path switched off;
* each row over a thread-block cluster of up to 8 blocks, with and without
  the 32-bit product path and the ``st.async`` row sum;
* empty kernels, plain and as clusters, with and without a cluster
  barrier: what a launch costs before any work.

K1 is also timed at two more shapes: 300 rows of 2253 slots, and 50 rows of
609 (the memory planner's hymba-1.5b shape, here with random geometry).

K5 at the portfolio's main-path shapes (two islands' 150 rows x 2253 slots
plus the 8-chain fleet step of 4 slots, RN152-W1A2 and @U50), exact against
its plain version first: the port's K5 (the wrappers), the same K5 under
the other register bound (K5a held to 32 registers, K5b free), K5 before
its redesign (both roles), the
separate K1 + K3 (K2 + K4) launches it replaces, and K1 / K2 alone at 150
rows.

K3 / K4 at the SA main paths' three shapes (the 64-chain fleet step, the
portfolio's 8-chain step, one chain's step; T = 4), exact first: the port's
kernels (the slot cost shared with K1 / K2, `FitnessTables` read from the
parameter) in turns with K3 / K4 as they were before (`KindTables` staged
in shared memory, run-time divisions) and with K4 staging `FitnessTables`
in shared memory three ways, all kept in the probe's own source.

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
SOURCE = Path(__file__).with_suffix(".cu")


class KindTables(ctypes.Structure):
    """The raw mode tables the designs before the shared slot cost took by
    value (``struct KindTables`` in the probe's source)."""
    _fields_ = [
        ("n_kinds", ctypes.c_int32),
        ("n_modes", ctypes.c_int32 * 4),
        ("weight", ctypes.c_int32 * 4),
        ("mode_w", (ctypes.c_int32 * 8) * 4),
        ("mode_d", (ctypes.c_int32 * 8) * 4),
    ]


def kind_tables_struct(kind_tables) -> KindTables:
    """``((weight, ((mode_w, mode_d), ...)), ...)`` -> `KindTables`, built
    on every call as the kernels' wrappers built it before the shared slot
    cost; raises as ``build.check_kind_tables`` does."""
    from repro_torch.kernels import build

    frozen = build._frozen_tables(kind_tables)
    build.check_kind_tables(frozen)
    t = KindTables()
    t.n_kinds = len(frozen)
    for k, (weight, modes) in enumerate(frozen):
        t.n_modes[k], t.weight[k] = len(modes), weight
        for m, (mw, md) in enumerate(modes):
            t.mode_w[k][m], t.mode_d[k][m] = mw, md
    return t


def library_path() -> Path:
    from repro_torch.kernels import build

    return build.BUILD_DIR / "fitness_design_probe.so"


def start_build() -> subprocess.Popen:
    """Start the probe's nvcc (the port's flags, into ``build/kernels/``);
    `finish_build` waits for it.  ``chip_smoke.py`` starts it beside the
    port's own builds."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [build.KERNELS.compiler(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
         str(library_path()), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(proc: subprocess.Popen) -> ctypes.CDLL:
    """Wait for `start_build`'s nvcc (its register and spill lines are
    printed) and load the library with every entry point's argtypes."""
    from repro_torch.kernels import build

    out, _ = proc.communicate()
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] probe: {line.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{out}")
    lib = ctypes.CDLL(str(library_path()))
    P, I = ctypes.c_void_p, ctypes.c_int
    FT, KT = ctypes.POINTER(build.FitnessTables), ctypes.POINTER(KindTables)
    lib.probe_block_row_launch.argtypes = [I, P, P, P, P, I, I, FT, I, P]
    lib.probe_cluster_launch.argtypes = [I, P, P, P, P, I, I, FT, I, P]
    lib.probe_empty_launch.argtypes = [I, I, I, I, P]
    lib.probe_old_k5_launch.argtypes = [I, P, P, P, P, I, I, P, P, P, P, P, P, P, I, I, KT, P]
    lib.probe_k5_other_bound_launch.argtypes = [I, P, P, P, P, I, I, P, P, P, P, P, P, P, I, I,
                                               FT, P]
    lib.probe_old_k34_launch.argtypes = [I, P, P, P, P, P, P, P, I, I, KT, P]
    lib.probe_k4_stage_launch.argtypes = [I, P, P, P, P, P, P, P, I, I, FT, P]
    for fn in (lib.probe_block_row_launch, lib.probe_cluster_launch, lib.probe_empty_launch,
               lib.probe_old_k5_launch, lib.probe_k5_other_bound_launch,
               lib.probe_old_k34_launch, lib.probe_k4_stage_launch):
        fn.restype = ctypes.c_int
    return lib


def k5_launch(launch, w, h, k, step, kind_tables, first_design):
    """One probe K5 launch (``lib.probe_old_k5_launch``, the design before
    the redesign, or ``lib.probe_k5_other_bound_launch``) on (rows, NB) card
    planes and a (C, T) step ``(ow, oh, ok, nw, nh, nk)``; ``k`` None
    without kind lanes (``ok`` / ``nk`` then unread).  Returns (totals,
    deltas), views of one int64 tensor."""
    import torch

    from repro_torch.kernels import build

    rows, c = w.shape[0], step[0].shape[0]
    out = torch.empty(rows + c, dtype=torch.int64, device=w.device)
    tables = (kind_tables_struct(kind_tables) if first_design
              else build.fitness_tables_struct(kind_tables))
    kp, ok, nk = (None, None, None) if k is None else (
        k.data_ptr(), step[2].data_ptr(), step[5].data_ptr())
    rc = launch(int(k is not None), w.data_ptr(), h.data_ptr(), kp, out.data_ptr(), rows,
                w.shape[1], step[0].data_ptr(), step[1].data_ptr(), ok, step[3].data_ptr(),
                step[4].data_ptr(), nk, out[rows:].data_ptr(), c, step[0].shape[1],
                ctypes.byref(tables), torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe K5 launch failed with error {rc}")
    return out[:rows], out[rows:]


def old_k34(lib, step, kind_tables):
    """K3 / K4 as they were before the shared slot cost
    (``lib.probe_old_k34_launch``) on a (C, T) card step ``(ow, oh, ok, nw,
    nh, nk)``; ``ok`` None for K3 (``nk`` then unread).  Returns the (C,)
    int64 deltas."""
    import torch

    ow, oh, ok, nw, nh, nk = step
    out = torch.empty(ow.shape[0], dtype=torch.int64, device=ow.device)
    kinds = ok is not None
    rc = lib.probe_old_k34_launch(
        int(kinds), ow.data_ptr(), oh.data_ptr(), ok.data_ptr() if kinds else None,
        nw.data_ptr(), nh.data_ptr(), nk.data_ptr() if kinds else None, out.data_ptr(),
        ow.shape[0], ow.shape[1], ctypes.byref(kind_tables_struct(kind_tables)),
        torch.cuda.current_stream(ow.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe K3 / K4 launch failed with error {rc}")
    return out


K4_STAGING = {0: "staged, a loop", 1: "staged, loads before stores",
              2: "staged, a loop, >= 160 threads"}


def k4_stage(lib, variant, step, kind_tables):
    """K4 with its table staged in shared memory one of three ways
    (``K4_STAGING``; the port's K4 reads it from the parameter) on a (C, T)
    card step ``(ow, oh, ok, nw, nh, nk)``; the (C,) int64 deltas."""
    import torch

    from repro_torch.kernels import build

    out = torch.empty(step[0].shape[0], dtype=torch.int64, device=step[0].device)
    rc = lib.probe_k4_stage_launch(
        variant, *(x.data_ptr() for x in step), out.data_ptr(), step[0].shape[0],
        step[0].shape[1], ctypes.byref(build.fitness_tables_struct(kind_tables)),
        torch.cuda.current_stream(step[0].device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe K4 staging launch failed with error {rc}")
    return out


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
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas_cuda, sa_step_deltas_kinds_cuda, sa_step_deltas_kinds_ref,
        sa_step_deltas_ref,
    )

    dev = torch.device("cuda")
    print(f"[card] {cs.nvidia_smi()}")
    lib = finish_build(start_build())

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
    no_chains = (z4,) * 6
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
            "first design (K5 before its redesign, no chains)": (
                lambda: k5_launch(lib.probe_old_k5_launch, w, h, None, no_chains, one, True)[0],
                lambda: k5_launch(lib.probe_old_k5_launch, w, h, k, no_chains, kt, True)[0]),
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

    # K5: exact first, at the portfolio's main-path shapes and at K5's edges
    def k5_variants(w, h, k, step, modes, kt):
        """name -> (K5a call, K5b call), each returning (totals, deltas)."""
        one = ((1, modes),)
        hom = (step[0], step[1], step[3], step[4])
        return {
            "port": (lambda: portfolio_step_cuda(w, h, *hom, modes),
                     lambda: portfolio_step_kinds_cuda(w, h, k, *step, kt)),
            "port, the other register bound": (
                lambda: k5_launch(lib.probe_k5_other_bound_launch, w, h, None, step, one, False),
                lambda: k5_launch(lib.probe_k5_other_bound_launch, w, h, k, step, kt, False)),
            "before the redesign": (
                lambda: k5_launch(lib.probe_old_k5_launch, w, h, None, step, one, True),
                lambda: k5_launch(lib.probe_old_k5_launch, w, h, k, step, kt, True)),
            "separate K1 + K3 (K2 + K4)": (
                lambda: (binpack_fitness_cuda(w, h, modes), sa_step_deltas_cuda(*hom, modes)),
                lambda: (binpack_fitness_kinds_cuda(w, h, k, kt),
                         sa_step_deltas_kinds_cuda(*step, kt))),
        }

    def k5_step(req):
        ow, oh, nw, nh, ok, nk = req
        if ok is None:
            ok, nk = np.zeros_like(ow), np.zeros_like(nw)
        return planes(ow, oh, ok, nw, nh, nk)

    nb = hom["W2"].shape[-1]
    k5_cases = [(*planes(*(het[x].reshape(-1, nb) for x in ("W2", "H2", "K2"))),
                 k5_step(het["req8"]), BRAM18_MODES, kt_u50)]
    for (rows, nbx), (c, t) in [((150, 2253), (8, 4)), ((3, 9000), (40, 20)), ((0, 5), (7, 4)),
                                ((5, 300), (0, 4)), ((0, 3), (0, 4)), ((2, 1), (3000, 1))]:
        w, h, k = planes(*cs.random_planes(rng, (rows, nbx), n_kinds=2))
        k5_cases.append((w, h, k, planes(*(cs.random_planes(rng, (c, t), n_kinds=2)
                                            + cs.random_planes(rng, (c, t), n_kinds=2))),
                         BRAM18_MODES, kt_u50))
    n_checked = 0
    for w, h, k, step, modes, kt in k5_cases:
        ow, oh, ok, nw, nh, nk = step
        step = (ow, oh, ok, nw, nh, nk)
        hom_step = (ow, oh, nw, nh)
        want = ((binpack_fitness_ref(w, h, modes).sum(1), sa_step_deltas_ref(*hom_step, modes)),
                (binpack_fitness_kinds_ref(w, h, k, kt).sum(1),
                 sa_step_deltas_kinds_ref(*step, kt)))
        for name, calls in k5_variants(w, h, k, step, modes, kt).items():
            for call, ref in zip(calls, want):
                got = call()
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, ref)):
                    raise AssertionError(f"K5 {name} {tuple(w.shape)} + {tuple(ow.shape)} "
                                         "differs from the plain version")
                n_checked += 1
    print(f"[exact] {n_checked} K5 variant calls equal to the plain version")

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
    W2, H2 = planes(hom["W2"].reshape(-1, nb), hom["H2"].reshape(-1, nb))
    Wk2, Hk2, Kk2 = k5_cases[0][:3]
    k5_hom = k5_variants(W2, H2, None, k5_step(hom["req8"]), BRAM18_MODES, None)
    k5_het = k5_variants(Wk2, Hk2, Kk2, k5_cases[0][3], BRAM18_MODES, kt_u50)
    times: dict[str, list[float]] = {}
    for _ in range(2):
        for name in k5_hom:
            times.setdefault(f"K5a {name}", []).append(cs.time_graph(k5_hom[name][0], 200))
            times.setdefault(f"K5b {name}", []).append(cs.time_graph(k5_het[name][1], 200))
        times.setdefault("K1 alone (150, 2253)", []).append(
            cs.time_graph(lambda: binpack_fitness_cuda(W2, H2, BRAM18_MODES), 200))
        times.setdefault("K2 alone (150, 2253)", []).append(
            cs.time_graph(lambda: binpack_fitness_kinds_cuda(Wk2, Hk2, Kk2, kt_u50), 200))
        for name in main_k1:
            times.setdefault(f"K1 {name}", []).append(cs.time_graph(main_k1[name][0], 200))
            times.setdefault(f"K2 {name}", []).append(cs.time_graph(main_k2[name][1], 200))
            times.setdefault(f"floor K1 {name}", []).append(cs.time_graph(floor[name][0], 200))
            times.setdefault(f"K1 (300, 2253) {name}", []).append(
                cs.time_graph(rows300[name][0], 200))
            times.setdefault(f"K1 (50, 609) {name}", []).append(cs.time_graph(rows50[name][0], 200))
        for name, fn in empties.items():
            times.setdefault(name, []).append(cs.time_graph(fn, 200))
    # K3 / K4: the port's against the design before the shared slot cost,
    # exact at the SA main paths' shapes and edges, then timed in turns
    sa_shapes = {"sa-s x64": (hom["req"], het["req"]),
                 "portfolio fleet": (hom["req8"], het["req8"]),
                 "sa-s x1": (tuple(x[:1] for x in hom["req"][:4]),
                             tuple(x[:1] for x in het["req"]))}
    sa_steps = {}
    for label, (rh, rk) in sa_shapes.items():
        ow, oh, nw, nh = planes(*rh[:4])
        kow, koh, knw, knh, kok, knk = planes(*rk)
        sa_steps[label] = ((ow, oh, None, nw, nh, None), (kow, koh, kok, knw, knh, knk))
    for c, t in [(3, 17), (40, 33), (1, 1), (4095, 4)]:
        both = planes(*(cs.random_planes(rng, (c, t), n_kinds=3)
                        + cs.random_planes(rng, (c, t), n_kinds=3)))
        sa_steps[f"random ({c}, {t})"] = ((both[0], both[1], None, both[3], both[4], None),
                                          tuple(both))
    for label, (sh, sk) in sa_steps.items():
        hom4 = (sh[0], sh[1], sh[3], sh[4])
        for got, want in (
                (old_k34(lib, sh, ((1, BRAM18_MODES),)), sa_step_deltas_ref(*hom4, BRAM18_MODES)),
                (old_k34(lib, sk, kt_u50), sa_step_deltas_kinds_ref(*sk, kt_u50)),
                (sa_step_deltas_cuda(*hom4, BRAM18_MODES), sa_step_deltas_ref(*hom4, BRAM18_MODES)),
                (sa_step_deltas_kinds_cuda(*sk, kt_u50), sa_step_deltas_kinds_ref(*sk, kt_u50))):
            if not torch.equal(got, want):
                raise AssertionError(f"K3 / K4 {label} differs from the plain version")
        for v in K4_STAGING:
            if not torch.equal(k4_stage(lib, v, sk, kt_u50), sa_step_deltas_kinds_ref(*sk, kt_u50)):
                raise AssertionError(f"K4 staging {v} {label} differs from the plain version")
    print(f"[exact] K3 / K4, the port's and before the shared slot cost: "
          f"{4 * len(sa_steps)} calls equal to the plain version")
    z1 = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    sa_steps["floor (1, 1)"] = ((z1, z1, None, z1, z1, None), (z1,) * 6)
    for _ in range(2):
        for label in (*sa_shapes, "floor (1, 1)"):
            sh, sk = sa_steps[label]
            for v, vname in K4_STAGING.items():
                times.setdefault(f"K4 {vname} {label}", []).append(
                    cs.time_graph(lambda v=v: k4_stage(lib, v, sk, kt_u50), 200))
            hom4 = (sh[0], sh[1], sh[3], sh[4])
            for name, fn in (
                    (f"K3 port {label}", lambda: sa_step_deltas_cuda(*hom4, BRAM18_MODES)),
                    (f"K3 before the shared slot cost {label}",
                     lambda: old_k34(lib, sh, ((1, BRAM18_MODES),))),
                    (f"K4 port {label}", lambda: sa_step_deltas_kinds_cuda(*sk, kt_u50)),
                    (f"K4 before the shared slot cost {label}",
                     lambda: old_k34(lib, sk, kt_u50))):
                times.setdefault(name, []).append(cs.time_graph(fn, 200))
    us = {name: min(v) * 1e3 for name, v in times.items()}
    for name, v in times.items():
        print(f"[time] {name}: {' '.join(f'{x * 1e3:.2f}' for x in v)} us per launch (graph)")
    print(cs.nvidia_smi())
    print(json.dumps({"card": cs.nvidia_smi(), "us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
