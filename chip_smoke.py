#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises (non-zero exit,
no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and, beside
   them, ``tools/fitness_design_probe.cu`` (K5 as it was before its
   redesign and K3 / K4 before the shared slot cost, for the timings), one
   nvcc each, all started together (timed);
3. hold each kernel (K1-K5) against its plain PyTorch version on the card,
   exactly equal: the main paths' own inputs (the RN152-W1A2 GA population,
   the 64-chain SA step, the portfolio's stacked two-island population and
   8-chain fleet step), ragged shapes, random mode tables, the U50 kind
   tables, int32 extremes and the 3-D problem axis, and for K3 / K4 the
   edges of their lane groups (T of 15, 16, 17, 33 by C of 31, 32, 33,
   4095, and a 4 x 64 fleet), for K1 / K2 the edges of their row blocks
   (NB of 1, the block's 1024 threads +- 1, its 4096-slot pass +- 1, two
   passes + 1 and 2253, by P of 1, 75, 77 and 300; int32 extremes and
   random tables there too); K5 also against a K1/K2 launch plus a K3/K4
   launch on the same tensors, and at the edges of its grid (rows past one
   and two 4096-slot passes, T > 16 and T = 0, no rows, no chains, chain
   counts around a block's rows, 4 kinds of 8 modes, w * h past 2^32 on
   both halves);
4. the engines' main path at full width: ``pack`` on RN152-W1A2 and
   RN152-W1A2@U50, GA-NFD, 64-chain and single-chain SA-S, once through
   the kernels (``backend="cuda"``, launch counts reset just before each
   run and read just after) and once through host numpy
   (``backend="python"``); the two must agree bit for bit;
5. the portfolio's main path at full width: ``pack(prob, "portfolio")`` on
   both problems with the default lineup (4 islands: two GA-NFD, one
   8-chain SA-S fleet, one SA-NFD), fused barriers through K5 on ``cuda``
   against host numpy, and one ``auto=True`` race on RN152-W1A2; results,
   barriers, migrations, strides (and the race's ledger) bit-identical,
   launch counts read per run;
6. the memory planner's main path at full width: hymba-1.5b's 30
   parameter tensors (6.57 GB float32, seeded ``torch.randn`` on the card),
   ``plan_packing(..., split_stacked=True)`` through host numpy and through
   the kernels (the GA's fitness on K1), identical and stopped on
   patience, and equal to the reference's plan (609 tensors in 275 banks,
   cost 58854, 214 generations); the ``PackedParameterStore`` built on the
   card, ``unpack()`` and every packed view bit-equal to their sources; K6
   launched once per bank, each output within float32 rounding of the
   plain version and of a per-entry matvec; K6 against its plain version
   in seeded cases (the reference test's 20 shapes, ragged N, out-of-range
   segments, the largest bank); K6 timed at the largest bank, the most
   common one and the reference benchmark's (2048, 1024) x 4, beside its
   plain version and one cuBLAS GEMM + gather, then a whole pass over the
   store, and one pass under ``torch.profiler``;
6a. the DSE sweep's main path: ``pack_sweep`` over a fleet of 50
   positions (the 8 Table-1 accelerators with no device, on ZU7EV and on
   U50, seeds 0 and 1, plus two renamed copies: 48 solved in two
   cost-model groups, 2 fingerprint-dedup hits), SA-S x8 1000 iterations
   and GA-NFD 20 generations (RN152-W1A2's hyperparameters, n_pop 75),
   each through the kernels (launch counts reset just before the sweep
   and read just after: K3 and K4, or K1 and K2, and nothing else) and
   through host numpy, bit for bit; RN152-W1A2 and RN152-W1A2@U50 also
   against their own ``pack()``; a second SA sweep from the first one's
   cache, solving and launching nothing; K1-K4 exactly equal to their
   plain versions on each group's first input ((16, 75, 2253),
   (32, 75, 2253), (128, 4), (256, 4)); candidates/s per backend and one
   cuda sweep per algorithm under ``torch.profiler``;
6b. crash-safe resume, in a temporary directory removed at the end: the
   SA fleet checkpointed every 250 iterations, killed after its second
   snapshot (an exception from ``on_checkpoint``) and resumed, then its
   newest snapshot torn and resumed again; the GA fleet every 5
   generations, killed after snapshot 2 and resumed; the RN152-W1A2
   default-lineup portfolio every 8 barriers, killed after snapshot 2 and
   resumed; each resumed record equal to the uninterrupted cuda run (the
   portfolio's wall-time-ordered merged trace aside, as in the reference's
   contract); snapshot bytes and seconds per save;
6c. the packing service's main path, in a temporary store removed at the
   end: ``PackingService("sa-s", backend="cuda")`` with phase 6a's SA-S
   settings over 6a's 24 unique problems, 64 requests (Zipf a = 1.2,
   Poisson at 200 Hz, seeds 0 and 1, 32 clients, every 8th request with a
   1 ms deadline), micro-batches of up to 8: cold (launch counts reset just
   before the pass and read just after: K3 and K4 only), a warm replay and
   the same requests as one burst (memory cache: no solve, no launch), a
   fresh service over the same store (no solve, no launch) and one more
   cold pass under ``torch.profiler``; a GA-NFD service (K1 / K2 only) on
   RN152-W1A2 and @U50 at seeds 0 and 1, each asked twice; every response
   equal to phase 6a's record of its (accelerator, device, seed); then
   ``tools/serve_traffic_torch.py --hetero --smoke`` killed by SIGKILL
   after 8 responses, restarted (``--expect-warm --verify``) and run once
   more (``--expect-no-solves --verify``); requests/s, latencies,
   occupancy, hit rate and the device's busy share;
7. timing: each kernel per launch (CUDA events around a CUDA graph of
   launches) and per wrapper call, its plain version, the ops layer per
   call with the host<->device copies, and those copies on their own (for
   K5 also the separate K1 + K3 launches it replaces, its K1 alone at the
   same rows, and K5 as it was before its redesign; for K1 / K2 also that
   old K5 with no chains, the first design's row body, at the same shapes,
   and K1 at the memory planner's own shape); K1-K5's ops call also in
   turns with the pageable call path it replaced, K1-K4's with its result
   fetched by ``.cpu()`` or through a pinned buffer and an event, and K3 /
   K4 at the three shapes the main paths give them (64, 8 and 1 chains x 4
   slots) in turns with their body before the shared slot cost; K1-K4 at
   the DSE sweep's shapes with their bounds, K1 / K2 also with the staging
   of their (P, 75, 2253) planes alone and its copy alone;
   every kernel's launch floor (its wrapper at the smallest legal
   all-empty input, in the same graph harness); then each engine's
   generation / step loop alone (set-up excluded), ``python`` and ``cuda``
   in turns, split per step into host time and ops-layer time; the
   portfolio's wall time per engine group and per barrier, a second pair
   of runs in the other order;
8. one cuda loop of each engine, and one cuda portfolio run on each
   problem, under ``torch.profiler``: the device's busy share, its time
   in kernels and in copies, and the host<->device copies per step and per
   kernel launch (the staged ops layers make one each way per call); and 30
   fused ops calls per problem under it, which must show one host->device
   copy, one K5 launch and one device->host copy per call, in that order.

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
# the portfolio's main path: the default lineup at the paper's widths
PORTFOLIO = dict(
    n_islands=4, algorithms=("ga-nfd", "sa-s", "sa-nfd"), sa_chains=8,
    migration_every=64, patience=10**9, max_seconds=1e9,
    max_generations=40, max_iterations=1280,
)

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
    "portfolio_step_cuda": (
        "src/repro_torch/kernels/csrc/binpack_portfolio_step.cu",
        "src/repro/kernels/binpack_portfolio_step/kernel.py:28",
    ),
    "portfolio_step_kinds_cuda": (
        "src/repro_torch/kernels/csrc/binpack_portfolio_step.cu",
        "src/repro/kernels/binpack_portfolio_step/kernel.py:41",
    ),
    "packed_gather_cuda": (
        "src/repro_torch/kernels/csrc/packed_gather.cu",
        "src/repro/kernels/packed_gather/kernel.py:37",
    ),
}
# the kernel each main path must launch (the portfolio's odd cycles also
# launch the fitness and SA-delta kernels; the memory planner's GA launches
# the fitness kernel)
PORTFOLIO_KERNELS = ("portfolio_step_cuda", "portfolio_step_kinds_cuda")
GATHER = "packed_gather_cuda"  # the memory planner's own kernel
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# The memory planner's main path: hymba-1.5b at its published widths, the
# (path, shape) of every parameter as the reference's
# `param_specs(get_config("hymba-1.5b"))` gives them, all float32 (6.57 GB;
# src/repro/configs/hymba_1_5b.py).  A literal, because the card's machine
# has no JAX; tests/test_torch_memory.py holds it equal to param_specs.
HYMBA_1_5B_SHAPES = (
    ("embed", (32128, 1600)),
    ("final_norm/scale", (1600,)),
    ("layers/attn/k/kernel", (32, 1600, 320)),
    ("layers/attn/o/kernel", (32, 1600, 1600)),
    ("layers/attn/q/kernel", (32, 1600, 1600)),
    ("layers/attn/v/kernel", (32, 1600, 320)),
    ("layers/branch_a", (32, 1600)),
    ("layers/branch_s", (32, 1600)),
    ("layers/mlp/down/kernel", (32, 5504, 1600)),
    ("layers/mlp/gate/kernel", (32, 1600, 5504)),
    ("layers/mlp/up/kernel", (32, 1600, 5504)),
    ("layers/norm1/scale", (32, 1600)),
    ("layers/norm2/scale", (32, 1600)),
    ("layers/ssm/a_log", (32, 50)),
    ("layers/ssm/b_proj/kernel", (32, 1600, 16)),
    ("layers/ssm/c_proj/kernel", (32, 1600, 16)),
    ("layers/ssm/conv_b", (32, 4, 16)),
    ("layers/ssm/conv_b_bias", (32, 16)),
    ("layers/ssm/conv_c", (32, 4, 16)),
    ("layers/ssm/conv_c_bias", (32, 16)),
    ("layers/ssm/conv_x", (32, 4, 3200)),
    ("layers/ssm/conv_x_bias", (32, 3200)),
    ("layers/ssm/d_skip", (32, 50)),
    ("layers/ssm/dt_bias", (32, 50)),
    ("layers/ssm/dt_proj/kernel", (32, 1600, 50)),
    ("layers/ssm/norm_scale", (32, 3200)),
    ("layers/ssm/out_proj/kernel", (32, 3200, 1600)),
    ("layers/ssm/x_proj/kernel", (32, 1600, 3200)),
    ("layers/ssm/z_proj/kernel", (32, 1600, 3200)),
    ("lm_head/kernel", (1600, 32128)),
)
MEMORY_SEED = 0
# the planner's only budget is the wall clock; parity needs a patience stop
MEMORY_MAX_SECONDS = 600.0
# what the reference's plan_packing gives on this tree (split per layer,
# seed 0); tests/test_torch_memory.py holds these equal to the reference
HYMBA_REFERENCE_PLAN = dict(packed=609, banks=275, cost=58854, generations=214)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def main_path_inputs(device):
    """The kernels' inputs exactly as the main paths build them: the GA's
    initial (n_pop, n) population geometry and the SA fleet's first
    (64, 2 * swap_moves) step request; for the portfolio, its two GA
    islands' stacked (2, n_pop, n) geometry (seeds 0 and 3 of the default
    lineup) and its 8-chain fleet's first (8, 2 * swap_moves) request
    (seed 1) — on RN152-W1A2 and its U50 variant."""
    import numpy as np

    import repro_torch.core as rc
    from repro_torch.core.ga import stack_geometry

    hp = rc.hyperparams(PROBLEM)

    def first_request(prob, n_chains, seed, n_slots=None):
        sa = rc.make_packer("sa-s", seed=seed, backend="cuda", device=device,
                            n_chains=n_chains, **hp)
        sa._hetero = prob.n_kinds > 1
        st = sa._block_start([prob], [np.random.default_rng(seed)], [[]], "cuda",
                             n_slots=n_slots)
        gen = sa._block_gen(st)
        req = next(gen)
        gen.close()
        return req

    out = {}
    for dev in (None, DEVICE_U50):
        prob = rc.get_problem(PROBLEM, device=dev)
        runs = []
        for seed in (0, 3):
            ga = rc.make_packer("ga-nfd", seed=seed, backend="cuda", device=device, **hp)
            runs.append(ga._start_run(prob, np.random.default_rng(seed), None, "cuda"))
        run = runs[0]
        W2, H2, K2 = stack_geometry(runs)
        out[dev] = dict(
            prob=prob, W=run.W, H=run.H, K=run.Km, req=first_request(prob, SA_CHAINS, 0),
            W2=W2, H2=H2, K2=K2,
            req8=first_request(prob, PORTFOLIO["sa_chains"], 1, n_slots=prob.n),
        )
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
    from repro_torch.kernels.binpack_portfolio_step import (
        portfolio_step, portfolio_step_cuda, portfolio_step_kinds_cuda,
        portfolio_step_kinds_ref, portfolio_step_ref,
    )
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas, sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
        sa_step_deltas_kinds_ref, sa_step_deltas_ref,
    )

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
                for a in arrays]

    # K1-K5; K6 is checked with the memory planner's path (`memory_path`)
    err = {name: 0 for name in KERNELS if name != GATHER}
    n_cases = dict.fromkeys(err, 0)

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

    def k5(w, h, ow, oh, nw, nh, modes, label):
        """K5 against its plain version and against a K1 launch plus a K3
        launch on the same tensors (both halves)."""
        nb = np.shape(w)[-1]
        w, h = dev(np.reshape(w, (-1, nb)), np.reshape(h, (-1, nb)))
        step = dev(ow, oh, nw, nh)
        got = portfolio_step_cuda(w, h, *step, modes)
        for part, want, sep in zip(got, portfolio_step_ref(w, h, *step, modes),
                                   (binpack_fitness_cuda(w, h, modes),
                                    sa_step_deltas_cuda(*step, modes))):
            record("portfolio_step_cuda", part, want, label)
            record("portfolio_step_cuda", part, sep, label + " vs K1 + K3")

    def k5k(w, h, k, ow, oh, ok, nw, nh, nk, kt, label):
        nb = np.shape(w)[-1]
        w, h, k = dev(*(np.reshape(x, (-1, nb)) for x in (w, h, k)))
        step = dev(ow, oh, ok, nw, nh, nk)
        got = portfolio_step_kinds_cuda(w, h, k, *step, kt)
        for part, want, sep in zip(got, portfolio_step_kinds_ref(w, h, k, *step, kt),
                                   (binpack_fitness_kinds_cuda(w, h, k, kt),
                                    sa_step_deltas_kinds_cuda(*step, kt))):
            record("portfolio_step_kinds_cuda", part, want, label)
            record("portfolio_step_kinds_cuda", part, sep, label + " vs K2 + K4")

    # the main paths' own inputs
    hom, het = inputs[None], inputs[DEVICE_U50]
    kt_u50 = het["prob"].kind_tables
    k1(hom["W"], hom["H"], hom["prob"].kind_tables[0][1], f"GA population {hom['W'].shape}")
    k2(het["W"], het["H"], het["K"], kt_u50, f"GA population @U50 {het['W'].shape}")
    ow, oh, nw, nh, _, _ = hom["req"]
    k3(ow, oh, nw, nh, BRAM18_MODES, f"SA step {ow.shape}")
    ow, oh, nw, nh, ok, nk = het["req"]
    k4(ow, oh, ok, nw, nh, nk, kt_u50, f"SA step @U50 {ow.shape}")
    ow, oh, nw, nh, _, _ = hom["req8"]
    k5(hom["W2"], hom["H2"], ow, oh, nw, nh, hom["prob"].kind_tables[0][1],
       f"portfolio {hom['W2'].shape} + {ow.shape}")
    ow, oh, nw, nh, ok, nk = het["req8"]
    k5k(het["W2"], het["H2"], het["K2"], ow, oh, ok, nw, nh, nk, kt_u50,
        f"portfolio @U50 {het['W2'].shape} + {ow.shape}")

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
    for (a, p, nb), (c, t) in [((1, 1, 1), (1, 1)), ((2, 75, 2253), (8, 4)),
                               ((3, 5, 37), (0, 4)), ((0, 75, 300), (300, 6)),
                               ((4, 7, 129), (1000, 2)), ((1, 300, 64), (257, 130))]:
        w, h, k = random_planes(rng, (a, p, nb), n_kinds=2)
        ow, oh, ok = random_planes(rng, (c, t), n_kinds=2)
        nw, nh, nk = random_planes(rng, (c, t), n_kinds=2)
        k5(w, h, ow, oh, nw, nh, BRAM18_MODES, f"ragged {(a, p, nb)} + {(c, t)}")
        k5k(w, h, k, ow, oh, ok, nw, nh, nk, kt_u50, f"ragged U50 {(a, p, nb)} + {(c, t)}")
    # the edges of K5's grid (1024-thread blocks: the GA rows first, a block
    # each, then blocks of 1024 >> log2(L) chain rows, L lanes a row): a row
    # past one and two 4096-slot passes, T > 16 (the lane loop runs) and T
    # = 0, no rows, no chains, neither, chain counts around a block's rows;
    # on 4 kinds of 8 modes (with kinds one past the table: cost 0), and
    # on the U50 tables with w * h around and past 2^32 (slot_units' 64-bit
    # path) on both halves
    def full_tables(r):
        return tuple((int(r.integers(1, 32)),
                      tuple((int(r.integers(1, 96)), int(r.integers(1, 40_000)))
                            for _ in range(8))) for _ in range(4))

    for (rows, nb), (c, t) in [((3, 4097), (8, 4)), ((2, 9000), (5, 20)), ((1, 8193), (40, 33)),
                               ((0, 2253), (8, 4)), ((150, 2253), (0, 4)), ((0, 1), (0, 1)),
                               ((4, 300), (128, 4)), ((4, 300), (129, 4)), ((5, 33), (513, 1)),
                               ((1, 64), (1025, 0)), ((2, 100), (33, 17)), ((150, 2253), (8, 4))]:
        kt4 = full_tables(rng)
        w, h, k = random_planes(rng, (rows, nb), n_kinds=5)
        ow, oh, ok = random_planes(rng, (c, t), n_kinds=5)
        nw, nh, nk = random_planes(rng, (c, t), n_kinds=5)
        label = f"grid edge {(rows, nb)} + {(c, t)}"
        k5(w, h, ow, oh, nw, nh, kt4[0][1], label + " 8 modes")
        k5k(w, h, k, ow, oh, ok, nw, nh, nk, kt4, label + " 4 kinds x 8 modes")
    for (rows, nb), (c, t) in [((3, 5000), (16, 6)), ((150, 2253), (8, 4))]:
        w, h, k = random_planes(rng, (rows, nb), n_kinds=2)
        ow, oh, ok = random_planes(rng, (c, t), n_kinds=2)
        nw, nh, nk = random_planes(rng, (c, t), n_kinds=2)
        for x in (w, h, ow, oh, nw, nh):  # live slots of 2^15 .. 2^20 by 2^15 .. 2^20
            live = x > 0
            x[live] = rng.integers(2**15, 2**20, int(live.sum()))
        big = int((w.astype(np.int64) * h >= 2**32).sum())
        if not 0 < big < w.size:
            raise AssertionError(f"w * h >= 2^32 case: {big} of {w.size} slots past 2^32")
        label = f"w * h past 2^32 {(rows, nb)} + {(c, t)}"
        k5(w, h, ow, oh, nw, nh, BRAM18_MODES, label)
        k5k(w, h, k, ow, oh, ok, nw, nh, nk, kt_u50, label + " U50")
    # the edges of K3 / K4's lane groups (L = min(32, next power of two >= 2T)
    # lanes per chain row, 32 / L rows per warp): T around 2T = 16 and 32
    # lanes, C around a warp and a block's rows; and a 4 x 64 fleet as the
    # one (NP * C, T) call the ops layer makes of it
    for t in (15, 16, 17, 33):
        for c in (31, 32, 33, 4095):
            ow, oh, ok = random_planes(rng, (c, t), n_kinds=2)
            nw, nh, nk = random_planes(rng, (c, t), n_kinds=2)
            k3(ow, oh, nw, nh, BRAM18_MODES, f"lane-group edge {(c, t)}")
            k4(ow, oh, ok, nw, nh, nk, kt_u50, f"lane-group edge U50 {(c, t)}")
    ow, oh, ok = random_planes(rng, (4, 64, 4), n_kinds=2)
    nw, nh, nk = random_planes(rng, (4, 64, 4), n_kinds=2)
    k3(*(x.reshape(256, 4) for x in (ow, oh, nw, nh)), BRAM18_MODES, "4 x 64 fleet")
    k4(*(x.reshape(256, 4) for x in (ow, oh, ok, nw, nh, nk)), kt_u50, "4 x 64 fleet U50")
    # the edges of K1 / K2's row blocks (1024 threads, 4 slots a thread in
    # each 4096-slot pass, looping past one pass) by population sizes around
    # the GA's 75 rows; the int32 extremes (the magic-number division and
    # the 64-bit product path) and random tables across a pass edge
    from repro_torch.kernels.build import FITNESS_CHUNK as chunk, FITNESS_THREADS as threads
    edge_nb = (1, threads - 1, threads, threads + 1, chunk - 1, chunk, chunk + 1,
               2 * chunk + 1, 2253)
    for p in (1, 75, 77, 300):
        for nb in edge_nb:
            w, h, k = random_planes(rng, (p, nb), n_kinds=2)
            k1(w, h, BRAM18_MODES, f"row-block edge {(p, nb)}")
            k2(w, h, k, kt_u50, f"row-block edge U50 {(p, nb)}")
    for nb in (threads + 1, chunk + 1):
        w, h, k = (rng.integers(2**31 - 1000, 2**31, (5, nb)).astype(np.int32),
                   rng.integers(0, 2**31, (5, nb)).astype(np.int32),
                   rng.integers(-1, 6, (5, nb)).astype(np.int32))
        w[:, ::3] = rng.integers(1, 70_000, (5, (nb + 2) // 3))  # w * h < 2^32 too
        k1(w, h, ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1)), f"row-block edge int32 extremes {nb}")
        k2(w, h, k, ((1, ((1, 1), (2**31 - 1, 7), (3, 2**31 - 1))),
                     (5, ((2**31 - 1, 2**31 - 1),))), f"row-block edge int32 extremes {nb}")
        kt = random_kind_tables(rng)
        w, h, k = random_planes(rng, (77, nb), n_kinds=len(kt) + 1)  # a kind past the table
        k1(w, h, kt[0][1], f"row-block edge random modes {nb}")
        k2(w, h, k, kt, f"row-block edge random tables {nb}")
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
    k5(w, h, w[:, :4], h[:, :4], w[:, 4:8], h[:, 4:8], modes_big, "int32 extremes")
    k5k(w, h, k, w[:, :4], h[:, :4], k[:, :4], w[:, 4:8], h[:, 4:8], k[:, 4:8], kt_big,
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
        k5(w, h, ow, oh, nw, nh, kt[0][1], f"random modes seed {seed}")
        k5k(w, h, k, ow, oh, ok, nw, nh, nk, kt, f"random tables seed {seed}")

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
    w, h, k = hom["W2"], hom["H2"], het["K2"]
    ow, oh, ok = random_planes(rng, (8, 4), n_kinds=2)
    nw, nh, nk = random_planes(rng, (8, 4), n_kinds=2)
    for kw in ({}, dict(kinds=k, old_k=ok, new_k=nk, kind_tables=kt_u50)):
        a = portfolio_step(w, h, ow, oh, nw, nh, backend="cuda", device=device, **kw)
        b = portfolio_step(w, h, ow, oh, nw, nh, backend="python", **kw)
        if a[0].shape != w.shape[:2] or not all(map(np.array_equal, a, b)):
            raise AssertionError(f"portfolio_step 3-D {sorted(kw)}: cuda != python")
    for name in err:
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
        other_path = name in PORTFOLIO_KERNELS or name == GATHER
        if n <= 0 and not other_path:
            raise AssertionError(f"{name} was not launched on the main path")
        if n > 0 and other_path:
            raise AssertionError(f"{name} was launched outside its own path")
    return launches


# ----------------------------------------------------------------- phase 5
def portfolio_key(r):
    """Everything the portfolio's parity contract covers (the result and
    the barrier bookkeeping; racing adds its ledger), nothing wall-clock."""
    key = list(result_key(r)) + [r.params["barriers"], r.params["migrations"],
                           r.params["strides"]]
    race = r.params.get("race")
    if race is not None:
        key += [race["budget"], race["spent"], race["work"], race["survivors"],
                [(e["island"], e["barrier"], e["value"]) for e in race["eliminated"]]]
    return key


def portfolio_run(dev, backend, device, **kw):
    """One ``pack(prob, "portfolio")`` run with its launch counts (set to 0
    just before the run, read just after) and wall time."""
    import repro_torch.core as rc
    from repro_torch import kernels

    prob = rc.get_problem(PROBLEM, device=dev)
    kernels.reset_launch_counts()
    t = time.perf_counter()
    r = rc.pack(prob, "portfolio", seed=0, backend=backend, device=device,
                **dict(rc.hyperparams(PROBLEM), **PORTFOLIO, **kw))
    return r, time.perf_counter() - t, kernels.launch_counts()


def portfolio_runs(device) -> dict:
    """The portfolio's main path on RN152-W1A2 and RN152-W1A2@U50: the
    default lineup through the kernels (fused barriers through K5) and
    through host numpy, bit for bit; then one ``auto=True`` race on
    RN152-W1A2 the same way.  Returns the launch counts summed over the
    kernel runs, each run's record, and each cuda run's `portfolio_key`."""
    cases = [(None, {}), (DEVICE_U50, {}), (None, dict(auto=True))]
    launches = {name: 0 for name in KERNELS}
    runs, keys = {}, {}
    for dev, kw in cases:
        label = f"portfolio {PROBLEM}{'@' + dev if dev else ''}" + (" auto" if kw else "")
        rk, tk, nk = portfolio_run(dev, "cuda", device, **kw)
        rp, tp, np_ = portfolio_run(dev, "python", device, **kw)
        for r in (rk, rp):
            r.solution.validate()
            if r.solution.cost() != r.solution.cost_full() or r.cost != r.solution.cost():
                raise AssertionError(f"{label}: cost bookkeeping disagrees")
            if r.params["truncated_by_wallclock"]:
                raise AssertionError(f"{label}: stopped on the wall clock")
        if portfolio_key(rk) != portfolio_key(rp):
            raise AssertionError(f"{label}: cuda and python backends diverge")
        if any(np_.values()):
            raise AssertionError(f"{label}: python run launched kernels {np_}")
        kinds = "_kinds" if dev else ""
        if not kw:
            # the default lineup fuses its fleet and GA pair on the card; its
            # odd cycles (the fleet done while the GA runs on, the initial
            # evaluations) launch the fitness and SA-delta kernels
            if rk.params["fused"] is not True or rp.params["fused"] is not False:
                raise AssertionError(f"{label}: fused {rk.params['fused']} on cuda, "
                                     f"{rp.params['fused']} on python")
            need = (f"portfolio_step{kinds}_cuda", f"binpack_fitness{kinds}_cuda",
                    f"sa_step_deltas{kinds}_cuda")
        else:
            need = (f"binpack_fitness{kinds}_cuda", f"sa_step_deltas{kinds}_cuda")
        if any(nk[n] <= 0 for n in need):
            raise AssertionError(f"{label}: launches {nk}, expected each of {need}")
        for name, n in nk.items():
            launches[name] += n
        keys[label] = portfolio_key(rk)
        runs[label] = dict(
            cost=rk.cost, iterations=rk.iterations, barriers=rk.params["barriers"],
            migrations=rk.params["migrations"], strides=rk.params["strides"],
            fused=rk.params["fused"], launches=nk, seconds={"cuda": tk, "python": tp},
            group_seconds={"cuda": [rk.params["group_seconds"]],
                           "python": [rp.params["group_seconds"]]},
            barrier_seconds={"cuda": [sum(rk.params["barrier_seconds"])],
                             "python": [sum(rp.params["barrier_seconds"])]},
            race={k: rk.params["race"][k] for k in ("budget", "spent", "survivors",
                                                     "eliminated")}
            if kw else None,
        )
        print(f"[portfolio] {label}: cost={rk.cost} iterations={rk.iterations} "
              f"barriers={rk.params['barriers']} migrations={rk.params['migrations']} "
              f"strides={json.dumps(rk.params['strides'])} fused={rk.params['fused']} "
              f"cuda {tk:.3f}s python {tp:.3f}s (bit-identical) launches {json.dumps(nk)}"
              + (f" race {json.dumps(runs[label]['race'])}" if kw else ""))
    print(f"[portfolio] launches: {json.dumps(launches)}")
    for name in PORTFOLIO_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the portfolio's main path")
    if launches[GATHER]:
        raise AssertionError(f"{GATHER} was launched on the portfolio's path")
    return dict(launches=launches, runs=runs, keys=keys)


def portfolio_timing(runs, device) -> None:
    """A second cuda / python pair of each default-lineup run, in the other
    order (cuda first), so each backend has two samples of its wall time
    per engine group and per barrier.  Fills ``runs`` in place."""
    for dev in (None, DEVICE_U50):
        label = f"portfolio {PROBLEM}{'@' + dev if dev else ''}"
        rec = runs[label]
        for backend in ("cuda", "python"):
            r, t, _ = portfolio_run(dev, backend, device)
            if r.cost != rec["cost"] or r.iterations != rec["iterations"]:
                raise AssertionError(f"{label} {backend}: repeat run diverges")
            rec["group_seconds"][backend].append(r.params["group_seconds"])
            rec["barrier_seconds"][backend].append(sum(r.params["barrier_seconds"]))
        print(f"[portfolio-timing] {label}, seconds per engine group (two samples "
              f"each; a fused pair as gI+gJ:fused) and summed over barriers: " + "; ".join(
                  f"{b}: " + " | ".join(
                      json.dumps({k: round(v, 4) for k, v in g.items()})
                      for g in rec["group_seconds"][b])
                  + f" barriers {' '.join(f'{x:.3f}' for x in rec['barrier_seconds'][b])} s"
                  for b in ("python", "cuda")))


# ----------------------------------------------------------------- phase 6
def shape_tree(shapes, make):
    """Nested dicts from ``(path, shape)`` pairs, each leaf ``make(shape)``."""
    tree = {}
    for path, shape in shapes:
        *parents, name = path.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = make(shape)
    return tree


def plan_key(plans):
    """Everything the planner's parity covers: banks, unpacked paths, bytes
    and the packer's cost and generation count."""
    return {
        itemsize: dict(
            banks=[[(e.path, e.row_offset, e.rows, e.cols) for e in b] for b in p.banks],
            unpacked=list(p.unpacked), before=p.padded_bytes_before,
            after=p.padded_bytes_after, logical=p.logical_bytes,
            packer=None if p.packer_result is None
            else (p.packer_result.cost, p.packer_result.iterations),
        )
        for itemsize, p in plans.items()
    }


def bank_inputs(store, gen):
    """Per bank: a random (len(entries), C) activation block and the (R,)
    int32 segment ids (entry i's rows are i, the padding rows 0)."""
    import torch

    out = {}
    for (itemsize, bi), bank in store.banks.items():
        entries = store.plans[itemsize].banks[bi]
        seg = torch.zeros(bank.shape[0], dtype=torch.int32)
        for i, e in enumerate(entries):
            seg[e.row_offset:e.row_offset + e.rows] = i
        x = torch.randn(len(entries), bank.shape[1], generator=gen, device=bank.device)
        out[(itemsize, bi)] = (x, seg.to(bank.device))
    return out


class GatherCheck:
    """Holds K6 outputs against a reference under float32 rounding: each of
    a row's C products and partial sums rounds once, in whatever order, so
    |y - y_ref| <= 2 * C * 2**-23 * sum_c |bank[r, c] * x[seg[r], c]| + 1e-6."""

    def __init__(self):
        self.cases = 0
        self.max_abs_err = 0.0
        self.max_err_over_tol = 0.0

    def __call__(self, got, want, bank, x, seg, label):
        import torch

        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{GATHER} {label}: {got.dtype} {tuple(got.shape)} "
                                 f"vs {want.dtype} {tuple(want.shape)}")
        n = x.shape[0]
        s = seg.long()
        valid = (s >= 0) & (s < n)
        mag = torch.zeros(bank.shape[0], dtype=torch.float64, device=bank.device)
        if n:
            xs = x.double().abs()[s.clamp(0, n - 1)]
            mag = torch.where(valid, (bank.double().abs() * xs).sum(1), mag)
        tol = 2 * bank.shape[1] * 2.0**-23 * mag + 1e-6
        err = (got.double() - want.double()).abs()
        if got.numel():
            self.max_abs_err = max(self.max_abs_err, float(err.max()))
            self.max_err_over_tol = max(self.max_err_over_tol, float((err / tol).max()))
        self.cases += 1
        if not bool((err <= tol).all()):
            i = int((err - tol).argmax())
            raise AssertionError(f"{GATHER} {label}: row {i} |got - want| = "
                                 f"{float(err[i])} > tolerance {float(tol[i])}")


def check_packed_gather(largest, device, check) -> None:
    """K6 against its plain version on the card in seeded cases: the
    reference test's 20 random shapes, ragged N from 1 to 8, out-of-range
    segment ids (must give exactly 0), no activations at all, and the
    largest hymba bank with its own inputs."""
    import numpy as np
    import torch

    from repro_torch.kernels.packed_gather import packed_gather_cuda, packed_gather_ref

    def run(bank, x, seg, label):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             if isinstance(a, np.ndarray) else a for a in (bank, x, seg)]
        got = packed_gather_cuda(*t)
        check(got, packed_gather_ref(*t), *t, label)
        return got

    for seed in range(20):  # tests/test_kernels.py::test_packed_gather_property
        rng = np.random.default_rng(seed)
        r, c, n = 8 * int(rng.integers(1, 7)), 128 * int(rng.integers(1, 5)), int(rng.integers(1, 7))
        run(rng.normal(size=(r, c)).astype(np.float32),
            rng.normal(size=(n, c)).astype(np.float32),
            rng.integers(0, n, r).astype(np.int32), f"reference case {seed}")
    rng = np.random.default_rng(21)
    for n in range(1, 9):
        r, c = 8 * int(rng.integers(1, 65)), 128 * int(rng.integers(1, 9))
        run(rng.normal(size=(r, c)).astype(np.float32),
            rng.normal(size=(n, c)).astype(np.float32),
            rng.integers(0, n, r).astype(np.int32), f"ragged N={n} {(r, c)}")
    bank = rng.normal(size=(16, 256)).astype(np.float32)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    seg = np.array([3, -1, 5, 0, 1, 2, -7, 2**31 - 1] * 2, np.int32)
    got = run(bank, x, seg, "out-of-range segments").cpu().numpy()
    if not np.all(got[(seg < 0) | (seg >= 3)] == 0):
        raise AssertionError(f"{GATHER}: out-of-range segments did not give 0: {got}")
    got = run(bank, np.zeros((0, 256), np.float32), seg, "no activations")
    if bool(got.abs().max() != 0):
        raise AssertionError(f"{GATHER}: no activations did not give 0")
    run(*largest, f"largest hymba bank {tuple(largest[0].shape)}")


def gather_timings(store, inputs, device) -> dict:
    """K6 at the largest hymba bank, the most common one and the reference
    benchmark's (2048, 1024) x N=4: per launch in a CUDA graph of 200
    launches, cold (the launches rotate over copies of the inputs totalling
    more than the 50 MB L2, as a pass over the store finds them) and warm
    (one bank, L2-resident); the wrapper per call, the ops layer, the plain
    version and the library's GEMM + gather, each on the same rotation; and
    one whole pass over the store."""
    import collections
    import itertools

    import torch

    from repro_torch.kernels.packed_gather import (
        bank_matvec, packed_gather_cuda, packed_gather_ref,
    )

    shapes = collections.Counter(tuple(b.shape) for b in store.banks.values())
    largest = max(store.banks, key=lambda k: store.banks[k].numel())
    common = next(k for k, b in store.banks.items()
                  if tuple(b.shape) == shapes.most_common(1)[0][0])
    gen = torch.Generator(device=device).manual_seed(MEMORY_SEED + 1)
    bench_seg = torch.randint(0, 4, (2048,), generator=gen, device=device, dtype=torch.int32)
    cases = {
        "largest hymba bank": (store.banks[largest], *inputs[largest]),
        "most common hymba bank": (store.banks[common], *inputs[common]),
        "reference benchmark": (
            torch.randn(2048, 1024, generator=gen, device=device),
            torch.randn(4, 1024, generator=gen, device=device), bench_seg),
    }
    out = {}
    for label, (bank, x, seg) in cases.items():
        r, c = bank.shape
        n = x.shape[0]
        copies = max(2, -(-120 * 2**20 // (4 * bank.numel())))
        sets = [(bank.clone(), x.clone(), seg.clone()) for _ in range(copies)]
        sets64 = [(b, xx, s.long()[:, None]) for b, xx, s in sets]

        def rotate(fn, pool):
            it = itertools.cycle(pool)
            return lambda: fn(*next(it))

        kernel = rotate(packed_gather_cuda, sets)
        plain = rotate(packed_gather_ref, sets)
        library = rotate(lambda b, xx, s: (b @ xx.T).gather(1, s), sets64)
        # in turns: kernel, library, plain, plain, library, kernel
        k1 = time_graph(kernel, 200)
        l1 = time_graph(library, 200)
        p1 = time_events(plain, 200)
        p2 = time_events(plain, 200)
        l2 = time_graph(library, 200)
        k2 = time_graph(kernel, 200)
        n_bytes = 4 * r * c + 4 * n * c + 8 * r
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * r * c / FP32_FLOPS_PER_S * 1e3
        out[label] = o = dict(
            shape=(r, c, n), ms=min(k1, k2),
            warm_ms=time_graph(lambda: packed_gather_cuda(bank, x, seg), 200),
            call_ms=time_events(kernel, 500),
            ops_ms=time_events(rotate(lambda b, xx, s: bank_matvec(b, xx, s, backend="cuda"),
                                      sets), 500),
            plain_ms=min(p1, p2), library_ms=min(l1, l2),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=n_bytes, flops=2 * r * c, copies=copies,
        )
        print(f"[gather-timing] {label} (R, C, N) = {o['shape']}: kernel "
              f"{o['ms']*1e3:.2f} us/launch cold, {o['warm_ms']*1e3:.2f} us warm (graph); "
              f"wrapper call {o['call_ms']*1e3:.2f} us, ops {o['ops_ms']*1e3:.2f} us, plain "
              f"{o['plain_ms']*1e3:.2f} us, library GEMM + gather {o['library_ms']*1e3:.2f} us, "
              f"bound {o['bound_ms']*1e3:.3f} us ({o['bound_by']}: {n_bytes} B, "
              f"{o['flops']} flop)")
        del sets, sets64

    banks = list(store.banks.items())

    def one_pass(fn):
        return lambda: [fn(b, *inputs[k]) for k, b in banks]

    pass_bytes = sum(4 * b.numel() + 4 * inputs[k][0].numel() + 8 * b.shape[0]
                     for k, b in banks)
    kpass = one_pass(packed_gather_cuda)
    ppass = one_pass(packed_gather_ref)
    k1, p1 = time_graph(kpass, 5), time_events(ppass, 10)
    p2, k2 = time_events(ppass, 10), time_graph(kpass, 5)
    out["pass"] = o = dict(
        banks=len(banks), ms=min(k1, k2), call_ms=time_events(kpass, 10),
        plain_ms=min(p1, p2), bound_ms=pass_bytes / HBM_BYTES_PER_S * 1e3,
        bytes=pass_bytes,
    )
    print(f"[gather-timing] one pass over the store ({len(banks)} banks, {pass_bytes} B): "
          f"kernels {o['ms']*1e3:.1f} us (graph), wrapper calls {o['call_ms']*1e3:.1f} us, "
          f"plain {o['plain_ms']*1e3:.1f} us, bound {o['bound_ms']*1e3:.1f} us")
    return out


def memory_path(device) -> dict:
    """The memory planner's main path at hymba-1.5b's published widths:
    random float32 weights on the card; ``plan_packing`` through host numpy
    and then through the kernels (the GA's fitness on K1), identical and
    stopped on patience; the packed store built on the card, unpacked bit
    for bit and every packed view equal to its source; one K6 launch per
    bank, each output held against the plain version and a per-entry
    matvec.  Launch counts are set to 0 just before the ``cuda`` plan and
    read just after the pass over the store.  Then K6's seeded checks, its
    timings and a profiled pass."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.kernels.packed_gather import bank_matvec, packed_gather_ref
    from repro_torch.memory import PackedParameterStore, plan_packing
    from repro_torch.memory.planner import leaves_with_paths

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the per-entry check needs float32")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(MEMORY_SEED)
    tree = shape_tree(HYMBA_1_5B_SHAPES,
                      lambda shape: torch.randn(shape, generator=gen, device=device))
    leaves = dict(leaves_with_paths(tree))
    n_bytes = sum(x.numel() * x.element_size() for x in leaves.values())
    kw = dict(split_stacked=True, max_seconds=MEMORY_MAX_SECONDS, device=device)
    t = time.perf_counter()
    plans_py = plan_packing(tree, backend="python", **kw)
    t_py = time.perf_counter() - t

    # the shapes the planner's GA hands K1, and the inputs of the last call
    # of each shape (host copies), to time K1 at the planner's own shape
    from repro_torch.kernels.binpack_fitness import ops as fops

    k1_calls = collections.Counter()
    k1_inputs = {}
    k1_wrapper = fops.binpack_fitness_cuda

    def k1_recorded(w, h, modes):
        k1_calls[tuple(w.shape)] += 1
        k1_inputs[tuple(w.shape)] = (w.cpu().numpy(), h.cpu().numpy(), modes)
        return k1_wrapper(w, h, modes)

    fops.binpack_fitness_cuda = k1_recorded
    kernels.reset_launch_counts()
    try:
        t = time.perf_counter()
        plans = plan_packing(tree, backend="cuda", **kw)
        t_cuda = time.perf_counter() - t
    finally:
        fops.binpack_fitness_cuda = k1_wrapper
    store = PackedParameterStore(tree, plans)
    inputs = bank_inputs(store, gen)
    ys = {k: bank_matvec(b, *inputs[k], backend="cuda")
          for k, b in store.banks.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    if plan_key(plans) != plan_key(plans_py):
        raise AssertionError("memory plan: cuda and python backends diverge")
    for backend, ps in (("cuda", plans), ("python", plans_py)):
        for p in ps.values():
            r = p.packer_result
            if r is None:
                continue
            if r.params["backend"] != backend:
                raise AssertionError(f"memory plan ran on {r.params['backend']}")
            # the GA stops on its wall clock, its generation budget or patience
            if r.wall_time_s >= MEMORY_MAX_SECONDS or r.iterations >= 100_000:
                raise AssertionError(f"memory plan ({backend}) did not stop on patience")
    if launches[GATHER] != len(store.banks) or launches["binpack_fitness_cuda"] <= 0:
        raise AssertionError(f"memory path launches {launches}: expected {GATHER} "
                             f"{len(store.banks)} times and binpack_fitness_cuda")
    if any(n for name, n in launches.items()
           if name not in (GATHER, "binpack_fitness_cuda")):
        raise AssertionError(f"memory path launched other kernels: {launches}")

    unpacked = store.unpack()
    for path, got in leaves_with_paths(unpacked):
        if not torch.equal(got, leaves[path]):
            raise AssertionError(f"store.unpack() differs at {path}")
    for path in store.entries:
        root, _, k = path.partition("#")
        src = leaves[root][int(k)] if k else leaves[root]
        if not torch.equal(store.view(path), src.reshape(store.view(path).shape)):
            raise AssertionError(f"store.view({path}) differs from its source")

    check = GatherCheck()
    for key, bank in store.banks.items():
        x, seg = inputs[key]
        y = ys[key]
        check(y, packed_gather_ref(bank, x, seg), bank, x, seg, f"bank {key} vs plain")
        for i, e in enumerate(store.plans[key[0]].banks[key[1]]):
            block = store.view(e.path).reshape(e.rows, e.cols)
            rows = slice(e.row_offset, e.row_offset + e.rows)
            check(y[rows], block @ x[i, :e.cols], bank[rows], x, seg[rows],
                  f"bank {key} entry {e.path} vs matvec")
        used = sum(e.rows for e in store.plans[key[0]].banks[key[1]])
        if used < len(y) and bool(y[used:].abs().max() != 0):
            raise AssertionError(f"bank {key}: padding rows did not give 0")
    largest = max(store.banks, key=lambda k: store.banks[k].numel())
    check_packed_gather((store.banks[largest], *inputs[largest]), device, check)
    print(f"[memory] {GATHER}: {check.cases} cases, max |kernel - reference| = "
          f"{check.max_abs_err:.3g}, max error / tolerance = {check.max_err_over_tol:.3g}")

    plan = plans[4]
    r = plan.packer_result
    shapes = collections.Counter(tuple(b.shape) for b in store.banks.values())
    summary = dict(
        params=len(HYMBA_1_5B_SHAPES), param_bytes=n_bytes,
        entries=sum(len(b) for b in plan.banks) + len(plan.unpacked),
        packed=sum(len(b) for b in plan.banks), banks=len(plan.banks),
        bank_bytes=sum(b.numel() * 4 for b in store.banks.values()),
        padded_bytes_before=plan.padded_bytes_before,
        padded_bytes_after=plan.padded_bytes_after, saved_bytes=plan.saved_bytes,
        efficiency_before=plan.efficiency_before(), efficiency_after=plan.efficiency_after(),
        cost=r.cost, generations=r.iterations,
        plan_seconds={"python": t_py, "cuda": t_cuda},
        packer_seconds={"python": plans_py[4].packer_result.wall_time_s,
                        "cuda": r.wall_time_s},
        common_shapes=[[list(s), n] for s, n in shapes.most_common(4)],
        launches=launches,
        k1_shapes=[[list(s), n] for s, n in k1_calls.most_common()],
    )
    for k in HYMBA_REFERENCE_PLAN:
        if summary[k] != HYMBA_REFERENCE_PLAN[k]:
            raise AssertionError(f"memory plan {k} = {summary[k]}, the reference's "
                                 f"{HYMBA_REFERENCE_PLAN[k]}")
    print(f"[memory] hymba-1.5b ({summary['params']} tensors, {n_bytes} B float32, "
          f"{summary['entries']} per-layer entries): {summary['packed']} packed into "
          f"{summary['banks']} banks ({summary['bank_bytes']} B), efficiency "
          f"{summary['efficiency_before']:.6f} -> {summary['efficiency_after']:.6f}, "
          f"saved {summary['saved_bytes']} B; GA cost {r.cost} after {r.iterations} "
          f"generations (patience stop); plan python {t_py:.3f}s cuda {t_cuda:.3f}s "
          f"(packer {summary['packer_seconds']['python']:.3f}s / {r.wall_time_s:.3f}s), "
          f"bit-identical; most common banks {summary['common_shapes']}; "
          f"launches {json.dumps(launches)}; K1 shapes (P, NB): count "
          f"{summary['k1_shapes']}")

    timings = gather_timings(store, inputs, device)
    banks = list(store.banks.items())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for k, b in banks:
            bank_matvec(b, *inputs[k], backend="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    profiled = device_share(prof, wall * 1e6, "memory pass", f"{len(banks)} banks")
    print(f"[memory] phase took {time.perf_counter() - t_phase:.1f}s")
    return dict(summary=summary, launches=launches, timings=timings, profile=profiled,
                max_abs_err=check.max_abs_err, max_err_over_tol=check.max_err_over_tol,
                cases=check.cases, k1_input=k1_inputs[k1_calls.most_common(1)[0][0]])



class TimedSwap:
    """While active, each of ``targets`` (``(label, owner, attribute)``: a
    module function or a class's method; the engines look both up at call
    time) is swapped for a wrapper that logs every call's host-clock
    (entry time, duration) in ``calls`` and sums the durations by label in
    ``seconds``.  Where given, ``first_of(label, args, kwargs)`` names the
    key under which ``first`` keeps the first such call's ``(args,
    kwargs)``, and ``after(args, kwargs)`` is called after each call, its
    value logged in ``notes``."""

    def __init__(self, targets, first_of=None, after=None):
        self.targets, self.first_of, self.after = targets, first_of, after

    def __enter__(self):
        self.calls, self.notes, self.first = [], [], {}
        self.seconds = {label: 0.0 for label, _, _ in self.targets}
        self._saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in self.targets]
        for (label, owner, attr), (_, _, fn) in zip(self.targets, self._saved):
            setattr(owner, attr, self._timed(label, fn))
        return self

    def _timed(self, label, fn):
        def timed(*args, **kwargs):
            if self.first_of is not None:
                self.first.setdefault(self.first_of(label, args, kwargs), (args, kwargs))
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t
                self.calls.append((t, dt))
                self.seconds[label] += dt
                if self.after is not None:
                    self.notes.append(self.after(args, kwargs))
        return timed

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def ops_timer(capture=False, by_shape=False) -> TimedSwap:
    """Times every call the engines make to the ops layer
    (`population_costs`, `sa_step_deltas`).  A cuda call ends in a wait on
    its copy back, so its duration holds the copies, the launch and the
    kernel.  With ``capture`` it also keeps the first call's arguments per
    (function, kinds or not), and with ``by_shape`` per (function, kinds or
    not, first plane's shape): the kernels' inputs at the run's shapes."""
    from repro_torch.kernels.binpack_fitness import ops as fops
    from repro_torch.kernels.binpack_sa_step import ops as sops

    def first_of(label, args, kwargs):
        key = label, kwargs.get("kinds") is not None or kwargs.get("old_k") is not None
        return key + (tuple(args[0].shape),) if by_shape else key

    return TimedSwap([("population_costs", fops, "population_costs"),
                      ("sa_step_deltas", sops, "sa_step_deltas")],
                     first_of=first_of if capture else None)


# ---------------------------------------------------------------- phase 6a
# The DSE sweep's fleet: benchmarks/bench_dse.py's `_fleet` (every Table-1
# accelerator on ZU7EV and U50, seeds 0 and 1) plus the same accelerators
# with no device (BRAM18 only), so both cost models run: 16 single-kind and
# 32 ZU7EV / U50 candidates; then two renamed copies, so the fingerprint
# dedup has work (50 positions, 48 solved).
DSE_DEVICES = (None, "ZU7EV", "U50")
DSE_SEEDS = (0, 1)
DSE_RENAMED = (("CNV-W1A1", None, 0), ("RN50-W1A2", "U50", 1))
DSE_BUDGET = dict(max_seconds=1e9, patience=10**9)
# bench_dse.py anneals 2500 iterations; the GA takes RN152-W1A2's Table-2
# hyperparameters (n_pop=75) for every candidate
DSE_ALGS = {
    "sa-s": dict(n_chains=8, max_iterations=1000),
    "ga-nfd": dict(max_generations=20),
}
# one candidate per group and algorithm is also held against its own pack()
DSE_STANDALONE = ((PROBLEM, None, 0), (PROBLEM, DEVICE_U50, 0))
# each algorithm's kernels, BRAM18 group then ZU7EV / U50 group
DSE_KERNELS = {
    "sa-s": ("sa_step_deltas_cuda", "sa_step_deltas_kinds_cuda"),
    "ga-nfd": ("binpack_fitness_cuda", "binpack_fitness_kinds_cuda"),
}
# the resume phase: snapshot spacing per lane, and the snapshot after which
# each run is killed
RESUME_EVERY = {"sa-s": 250, "ga-nfd": 5, "portfolio": 8}
RESUME_KILL_AFTER = 2


def dse_fleet():
    """The fleet's problems, seeds and (name, device, seed) labels."""
    import repro_torch.core as rc

    probs, seeds, labels = [], [], []
    for dev in DSE_DEVICES:
        for s in DSE_SEEDS:
            for name in rc.ACCELERATORS:
                probs.append(rc.get_problem(name, device=dev))
                seeds.append(s)
                labels.append((name, dev, s))
    for name, dev, s in DSE_RENAMED:
        p = rc.get_problem(name, device=dev)
        probs.append(rc.PackingProblem(p.buffers, max_items=p.max_items,
                                       name=f"{p.name} (renamed)", ocm=p.ocm))
        seeds.append(s)
        labels.append((name, dev, s))
    return probs, seeds, labels


def dse_kwargs(alg):
    import repro_torch.core as rc

    hp = rc.hyperparams(PROBLEM) if alg == "ga-nfd" else {}
    return dict(hp, **DSE_BUDGET, **DSE_ALGS[alg])


def sweep_phases(alg):
    """What a sweep's host time is split into: SA — the fleet's start
    (NFD chains, codecs) and finish (decoding); GA — each run's start (its
    NFD population), the mutation phase, selection, and the stacking of
    the populations for one fitness call (the lockstep lane only)."""
    from repro_torch.core import ga
    from repro_torch.core.sa import SimulatedAnnealingPacker

    if alg == "sa-s":
        return [("start", SimulatedAnnealingPacker, "_block_start"),
                ("finish", SimulatedAnnealingPacker, "_block_finish")]
    return [("start", ga.GeneticPacker, "_start_run"),
            ("mutation", ga.GeneticPacker, "_mutation_phase"),
            ("selection", ga.GeneticPacker, "_tournament"),
            ("stack", ga, "stack_geometry")]


def sweep_key(sw):
    return [result_key(r) for r in sw.results]


def check_sweep(sw, label):
    for r in sw.results:
        r.solution.validate()
        if r.solution.cost() != r.solution.cost_full() or r.cost != r.solution.cost():
            raise AssertionError(f"{label}: cost bookkeeping disagrees")


def check_dse_kernels(first, device, where="the DSE sweep's") -> dict:
    """K1-K4 against their plain versions on the inputs the cuda sweeps
    gave them (each group's first call; ``ops_timer(capture=True)``'s
    ``first``), exactly; returns the largest |kernel - plain| per kernel
    and the inputs as card tensors.  ``where`` names the path in the
    messages."""
    import numpy as np
    import torch

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
        binpack_fitness_kinds_ref, binpack_fitness_ref,
    )
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
        sa_step_deltas_kinds_ref, sa_step_deltas_ref,
    )

    def dev(*arrays):
        out = []
        for a in arrays:
            a = np.ascontiguousarray(a, dtype=np.int32)
            out.append(torch.from_numpy(a.reshape(-1, a.shape[-1])).to(device))
        return out

    cases = {}
    for (fn, hetero), (args, kw) in first.items():
        if fn == "population_costs":
            host = (args[0], args[1]) + ((kw["kinds"],) if hetero else ())
            w, h, *k = dev(*host)
            if hetero:
                kt = kw["kind_tables"]
                name = "binpack_fitness_kinds_cuda"
                cases[name] = dict(
                    kernel=lambda w=w, h=h, k=k[0], kt=kt: binpack_fitness_kinds_cuda(w, h, k, kt),
                    plain=lambda w=w, h=h, k=k[0], kt=kt: binpack_fitness_kinds_ref(
                        w, h, k, kt).sum(1),
                    host=host, tables=kt)
            else:
                modes = kw.get("modes") or BRAM18_MODES
                name = "binpack_fitness_cuda"
                cases[name] = dict(
                    kernel=lambda w=w, h=h, m=modes: binpack_fitness_cuda(w, h, m),
                    plain=lambda w=w, h=h, m=modes: binpack_fitness_ref(w, h, m).sum(1),
                    host=host, tables=((1, modes),))
        else:
            if hetero:
                kt = kw["kind_tables"]
                host = tuple(args[:4]) + (kw["old_k"], kw["new_k"])
                ow, oh, nw, nh, ok, nk = dev(*host)
                name = "sa_step_deltas_kinds_cuda"
                cases[name] = dict(
                    kernel=lambda a=(ow, oh, ok, nw, nh, nk), kt=kt: sa_step_deltas_kinds_cuda(*a, kt),
                    plain=lambda a=(ow, oh, ok, nw, nh, nk), kt=kt: sa_step_deltas_kinds_ref(*a, kt),
                    host=host, tables=kt)
            else:
                modes = kw.get("modes") or BRAM18_MODES
                host = tuple(args[:4])
                planes = dev(*host)
                name = "sa_step_deltas_cuda"
                cases[name] = dict(
                    kernel=lambda a=planes, m=modes: sa_step_deltas_cuda(*a, m),
                    plain=lambda a=planes, m=modes: sa_step_deltas_ref(*a, m),
                    host=host, tables=((1, modes),))
        c = cases[name]
        c["shape"] = tuple(np.shape(c["host"][0]))
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        if got.dtype != torch.int64 or got.shape != want.shape:
            raise AssertionError(f"{name} at {where} shape {c['shape']}: {got.dtype} "
                                 f"{tuple(got.shape)} vs {tuple(want.shape)}")
        c["err"] = int((got - want).abs().max())
        if c["err"]:
            raise AssertionError(f"{name} at {where} shape {c['shape']}: "
                                 f"max |kernel - plain| = {c['err']}")
        print(f"[kernels] {name} at {where} shape {c['shape']}: "
              f"max |kernel - plain| = {c['err']}")
    return cases


def dse_path(device) -> dict:
    """The DSE sweep's main path: the 50-position fleet through `pack_sweep`
    with SA-S x8 and GA-NFD, once through the kernels (launch counts set to
    0 just before the sweep, read just after; the per-call ops-layer time
    and each group's first kernel input kept) and once through host numpy,
    bit for bit; RN152-W1A2 and RN152-W1A2@U50 also against their own
    ``pack()``; a second SA sweep served from the first one's cache with no
    launch; K1-K4 held against their plain versions at the sweep's shapes;
    one profiled cuda sweep per algorithm."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as rc
    from repro_torch import kernels

    t_phase = time.perf_counter()
    probs, seeds, labels = dse_fleet()
    n_unique = len(probs) - len(DSE_RENAMED)
    launches = {name: 0 for name in KERNELS}
    out = dict(records={}, results={}, sweeps={}, first={}, profile={})
    for alg in DSE_ALGS:
        kw = dse_kwargs(alg)
        cache: dict = {}
        kernels.reset_launch_counts()
        with ops_timer(capture=True) as ops, TimedSwap(sweep_phases(alg)) as host_k:
            sk = rc.pack_sweep(probs, alg, seeds=seeds, backend="cuda", device=device,
                               cache=cache, **kw)
        nk = kernels.launch_counts()
        kernels.reset_launch_counts()
        with ops_timer() as ops_p, TimedSwap(sweep_phases(alg)) as host_p:
            sp = rc.pack_sweep(probs, alg, seeds=seeds, backend="python", device=device,
                               **kw)
        np_ = kernels.launch_counts()
        label = f"dse {alg} x{len(probs)}"
        # two cost-model groups; the GA on python takes the serial lane
        for sw, groups in ((sk, 2), (sp, n_unique if alg == "ga-nfd" else 2)):
            check_sweep(sw, label)
            if (sw.n_solved, sw.params["dedup_hits"], sw.n_groups) != (n_unique, 2, groups):
                raise AssertionError(f"{label}: solved {sw.n_solved}, dedup "
                                     f"{sw.params['dedup_hits']}, groups {sw.n_groups}")
        if any(r.params["backend"] != "cuda" for r in sk.results):
            raise AssertionError(f"{label}: a candidate ran off the cuda backend")
        if sweep_key(sk) != sweep_key(sp):
            raise AssertionError(f"{label}: cuda and python sweeps diverge")
        own = DSE_KERNELS[alg]
        if any(nk[n] <= 0 for n in own) or any(v for n, v in nk.items() if n not in own):
            raise AssertionError(f"{label}: launches {nk}, expected each of {own} only")
        if any(np_.values()):
            raise AssertionError(f"{label}: python sweep launched kernels {np_}")
        for name, n in nk.items():
            launches[name] += n
        # one candidate per group against its standalone pack()
        for name, dev, s in DSE_STANDALONE:
            i = labels.index((name, dev, s))
            r = rc.pack(probs[i], alg, seed=s, backend="cuda", device=device,
                        **kw)
            if result_key(r) != result_key(sk.results[i]):
                raise AssertionError(f"{label}: {name}@{dev} seed {s} differs from pack()")
        if alg == "sa-s":
            kernels.reset_launch_counts()
            again = rc.pack_sweep(probs, alg, seeds=seeds, backend="cuda", device=device,
                                  cache=cache, **kw)
            nc = kernels.launch_counts()
            if again.n_solved or any(nc.values()) or sweep_key(again) != sweep_key(sk):
                raise AssertionError(f"{label}: cached re-sweep solved {again.n_solved}, "
                                     f"launched {nc}")
            out["cached_candidates_per_sec"] = again.candidates_per_sec
        ops_s = sum(d for _, d in ops.calls)
        out["records"][alg] = sweep_key(sk)
        # each (accelerator, device, seed)'s result: the service's oracle
        out["results"][alg] = {}
        for lab, r in zip(labels, sk.results):
            out["results"][alg].setdefault(lab, r)
        out["first"].update(ops.first)
        out["sweeps"][alg] = o = dict(
            positions=len(probs), solved=sk.n_solved, groups=sk.n_groups,
            dedup_hits=sk.params["dedup_hits"], launches=nk,
            seconds={"cuda": sk.wall_time_s, "python": sp.wall_time_s},
            candidates_per_sec={"cuda": sk.candidates_per_sec,
                                "python": sp.candidates_per_sec},
            ops_calls=len(ops.calls), ops_s=ops_s, host_s=sk.wall_time_s - ops_s,
            # seconds by phase, each backend; "ops" is the ops layer (the
            # numpy deltas / costs on python), "rest" everything else
            phases={b: dict(h.seconds, ops=sum(d for _, d in o.calls),
                            rest=sw.wall_time_s - sum(h.seconds.values())
                            - sum(d for _, d in o.calls))
                    for b, h, o, sw in (("cuda", host_k, ops, sk),
                                        ("python", host_p, ops_p, sp))},
            shapes={f"{fn}{' kinds' if het else ''}": list(map(int, a[0].shape))
                    for (fn, het), (a, _) in ops.first.items()},
        )
        print(f"[dse] {label}: {sk.n_solved} solved in {sk.n_groups} groups, "
              f"{sk.params['dedup_hits']} dedup hits; cuda {sk.wall_time_s:.3f}s "
              f"({sk.candidates_per_sec:.3f} candidates/s; {len(ops.calls)} ops calls "
              f"{ops_s:.3f}s, host {o['host_s']:.3f}s), python {sp.wall_time_s:.3f}s "
              f"({sp.candidates_per_sec:.3f}/s), bit-identical; standalone pack() equal "
              f"for {[f'{n}@{d}' for n, d, _ in DSE_STANDALONE]}; seconds by phase "
              f"{json.dumps({b: {k: round(v, 3) for k, v in ph.items()} for b, ph in o['phases'].items()})}"
              f"; first ops call shapes "
              f"{json.dumps(o['shapes'])}; launches {json.dumps(nk)}")
    print(f"[dse] cached SA re-sweep: 0 solved, 0 launches, "
          f"{out['cached_candidates_per_sec']:.1f} candidates/s")
    out["cases"] = check_dse_kernels(out["first"], device)
    for alg in DSE_ALGS:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sw = rc.pack_sweep(probs, alg, seeds=seeds, backend="cuda", device=device,
                               **dse_kwargs(alg))
        if sweep_key(sw) != out["records"][alg]:
            raise AssertionError(f"dse {alg}: the profiled sweep diverges")
        key = f"dse {alg} x{len(probs)}"
        out["profile"][key] = device_share(prof, sw.wall_time_s * 1e6, key,
                                           f"{sw.n_solved} candidates")
    print(f"[dse] launches: {json.dumps(launches)}")
    print(f"[dse] phase took {time.perf_counter() - t_phase:.1f}s")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 6b
class Killed(BaseException):
    """Raised from ``on_checkpoint`` to stop a run right after a durable
    snapshot, as a kill at that barrier would."""


def kill_after(n: int):
    def hook(step: int) -> None:
        if step >= n:
            raise Killed(f"killed after snapshot {step}")
    return hook


def save_timer() -> TimedSwap:
    """Times every checkpoint step the port's `CheckpointManager` writes;
    ``notes`` holds each step's bytes on disk."""
    from repro_torch.checkpoint.manager import CheckpointManager

    def step_bytes(args, kwargs):
        mgr, step = args[:2]
        return sum(f.stat().st_size for f in (mgr.dir / f"step_{step:08d}").iterdir())

    return TimedSwap([("save", CheckpointManager, "save")], after=step_bytes)


def tear_newest(ck_dir) -> Path:
    """Truncate the newest step's ``arrays.npz`` to half (a torn write)."""
    newest = sorted(p for p in Path(ck_dir).glob("step_*")
                    if p.is_dir() and p.suffix != ".tmp")[-1]
    f = newest / "arrays.npz"
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])
    return newest


def resume_path(device, dse, portfolio_key_cuda) -> dict:
    """Crash-safe resume on the card, in a temporary directory removed at
    the end: the DSE phase's SA-S fleet checkpointed every 250 iterations,
    killed after snapshot 2 and resumed, then its newest snapshot torn and
    resumed again; the GA-NFD fleet every 5 generations, killed after
    snapshot 2 and resumed; the RN152-W1A2 default-lineup portfolio every 8
    barriers, killed after snapshot 2 and resumed.  Every resumed record
    must equal the uninterrupted cuda run.  Launch counts are set to 0 just
    before the phase and read just after."""
    import shutil
    import tempfile

    import repro_torch.core as rc
    from repro_torch import kernels

    t_phase = time.perf_counter()
    probs, seeds, _ = dse_fleet()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    out = {}
    try:
        kernels.reset_launch_counts()
        with save_timer() as saves:
            for alg in DSE_ALGS:
                ck = root / alg

                def sweep(**ckw):
                    return rc.pack_sweep(probs, alg, seeds=seeds, backend="cuda",
                                         device=device, checkpoint_dir=ck,
                                         checkpoint_every=RESUME_EVERY[alg],
                                         **dse_kwargs(alg), **ckw)

                n0 = len(saves.calls)
                try:
                    sweep(on_checkpoint=kill_after(RESUME_KILL_AFTER))
                    raise AssertionError(f"resume {alg}: the run was not killed")
                except Killed:
                    pass
                resumed = sweep(resume=True)
                check_sweep(resumed, f"resume {alg}")
                if sweep_key(resumed) != dse["records"][alg]:
                    raise AssertionError(f"resume {alg}: the resumed sweep differs "
                                         "from the uninterrupted one")
                torn = None
                if alg == "sa-s":
                    torn = tear_newest(ck).name
                    again = sweep(resume=True)
                    if sweep_key(again) != dse["records"][alg]:
                        raise AssertionError(f"resume {alg}: the sweep resumed past a "
                                             "torn snapshot differs")
                mine = list(zip(saves.calls[n0:], saves.notes[n0:]))
                out[f"sweep {alg}"] = o = dict(
                    every=RESUME_EVERY[alg], killed_after=RESUME_KILL_AFTER,
                    torn=torn, saves=len(mine),
                    snapshot_bytes=[b for _, b in mine],
                    save_s=[d for (_, d), _ in mine], resumed_solved=resumed.n_solved,
                    resumed_cache_hits=resumed.cache_hits,
                )
                print(f"[resume] sweep {alg}: killed after snapshot {RESUME_KILL_AFTER}, "
                      f"resumed ({resumed.n_solved} solved, {resumed.cache_hits} served "
                      f"from the snapshot or dedup)"
                      + (f", newest snapshot {torn} torn and resumed again" if torn else "")
                      + f": equal to the uninterrupted cuda sweep; {len(mine)} saves, "
                      f"{max(o['snapshot_bytes'])} bytes at most, "
                      f"{sum(o['save_s']) / len(mine):.3f} s per save")
            ck = root / "portfolio"
            prob = rc.get_problem(PROBLEM)

            def portfolio(**ckw):
                return rc.pack(prob, "portfolio", seed=0, backend="cuda", device=device,
                               checkpoint_dir=ck, checkpoint_every=RESUME_EVERY["portfolio"],
                               **dict(rc.hyperparams(PROBLEM), **PORTFOLIO), **ckw)

            n0 = len(saves.calls)
            try:
                portfolio(on_checkpoint=kill_after(RESUME_KILL_AFTER))
                raise AssertionError("resume portfolio: the run was not killed")
            except Killed:
                pass
            r = portfolio(resume=True)
            # the merged trace orders the islands' improvements by wall time,
            # which restarts on resume: it is outside the resume contract
            # (the reference's tests/test_resume.py leaves it out too)
            if portfolio_key(r)[:4] + portfolio_key(r)[5:] != (
                    portfolio_key_cuda[:4] + portfolio_key_cuda[5:]):
                raise AssertionError("resume portfolio: the resumed run differs from "
                                     "phase 5's")
            mine = list(zip(saves.calls[n0:], saves.notes[n0:]))
            out["portfolio"] = o = dict(
                every=RESUME_EVERY["portfolio"], killed_after=RESUME_KILL_AFTER,
                barriers=r.params["barriers"], fused=r.params["fused"], saves=len(mine),
                snapshot_bytes=[b for _, b in mine], save_s=[d for (_, d), _ in mine],
            )
            print(f"[resume] portfolio {PROBLEM}: killed after snapshot "
                  f"{RESUME_KILL_AFTER} (barrier {RESUME_KILL_AFTER * o['every']}), resumed "
                  f"to barrier {o['barriers']} fused={o['fused']}: equal to phase 5's cuda "
                  f"run; {len(mine)} saves, {max(o['snapshot_bytes'])} bytes at most, "
                  f"{sum(o['save_s']) / len(mine):.3f} s per save")
        launches = kernels.launch_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    need = ("binpack_fitness_cuda", "binpack_fitness_kinds_cuda", "sa_step_deltas_cuda",
            "sa_step_deltas_kinds_cuda", "portfolio_step_cuda")
    if any(launches[n] <= 0 for n in need) or launches[GATHER]:
        raise AssertionError(f"resume path launches {launches}, expected each of {need}")
    print(f"[resume] launches: {json.dumps(launches)}")
    print(f"[resume] phase took {time.perf_counter() - t_phase:.1f}s")
    return dict(launches=launches, runs=out)



# ---------------------------------------------------------------- phase 6c
# The packing service's traffic: phase 6a's 24 unique problems (the 8
# Table-1 accelerators with no device, on ZU7EV and on U50) under a Zipf
# popularity, Poisson arrivals, request seeds 0 and 1 (6a's), every 8th
# request with a 1 ms deadline; solved with 6a's SA-S settings, so 6a's
# records are the oracle.  GA-NFD: RN152-W1A2 and @U50 at seeds 0 and 1,
# each asked twice, with 6a's GA settings.
SERVE_TRAFFIC = dict(n_requests=64, rate_hz=200.0, zipf_a=1.2, n_seeds=2, seed=0)
SERVE_CLIENTS = dict(concurrency=32, deadline_ms=1.0, deadline_every=8)
SERVE_BATCHING = dict(max_batch=8, max_wait_ms=5.0, max_queue=64)
SERVE_GA = tuple((PROBLEM, dev, s) for dev in (None, DEVICE_U50) for s in DSE_SEEDS) * 2
# the kill lane: tools/serve_traffic_torch.py killed after this many responses
SERVE_KILL_AFTER = 8


def serve_corpus():
    """Phase 6a's unique problems and their (accelerator, device) labels."""
    import repro_torch.core as rc

    labels = [(name, dev) for dev in DSE_DEVICES for name in rc.ACCELERATORS]
    return [rc.get_problem(name, device=dev) for name, dev in labels], labels


async def recorded_traffic(svc, probs, load, **clients):
    """``run_traffic`` over ``load`` with launch counts set to 0 just before
    and read just after; returns every response with its problem and seed,
    the traffic's record and the counts."""
    from repro_torch import kernels
    from repro_torch.serve import PackingService, run_traffic

    got = []

    async def pack(prob, seed=0, deadline_ms=None):
        res = await PackingService.pack(svc, prob, seed=seed, deadline_ms=deadline_ms)
        got.append((prob, seed, res))
        return res

    svc.pack = pack
    try:
        kernels.reset_launch_counts()
        res = await run_traffic(svc, probs, load, **clients)
        return got, res, kernels.launch_counts()
    finally:
        del svc.pack


def check_responses(got, want, label_of, what) -> int:
    """Every response ``result_signature``-equal to ``want[(accelerator,
    device, seed)]`` (phase 6a's cuda sweep); returns the number checked."""
    from repro_torch.serve import result_signature

    for prob, seed, res in got:
        name, dev = label_of[id(prob)]
        if result_signature(res) != result_signature(want[(name, dev, seed)]):
            raise AssertionError(f"{what}: {name}@{dev} seed {seed} differs from "
                                 "phase 6a's cuda record")
    return len(got)


def check_launches(counts, alg, what) -> None:
    own = DSE_KERNELS[alg]
    if any(counts[n] <= 0 for n in own) or any(v for n, v in counts.items() if n not in own):
        raise AssertionError(f"{what}: launches {counts}, expected each of {own} only")


def serve_pass_summary(out, stats) -> dict:
    return dict(rps=out["rps"], wall_s=out["wall_s"], solved=stats["solved"],
                batches=stats["batches"], occupancy=stats["batch_occupancy"]["mean"],
                occupancy_counts=stats["batch_occupancy"]["counts"],
                hit_rate=stats["hit_rate"], coalesced=stats["coalesced"],
                mem_hits=stats["cache_hits_mem"], store_hits=stats["cache_hits_store"],
                deadline_fallbacks=stats["deadline_fallbacks"],
                solved_latency=stats["latency_solved"], cached_latency=stats["latency_cached"])


def kill_lane(device, store) -> dict:
    """``tools/serve_traffic_torch.py --hetero --smoke`` three times over one
    store: killed by SIGKILL after ``SERVE_KILL_AFTER`` responses, then
    restarted (some answers must come from the store, every unique task
    equal to a standalone pack() on the host backend, ``python``: the
    hetero corpus's BRAM18 / URAM288 inventories are held to the host code
    there, not only cuda to cuda), then once more (no solve at all, equal
    to a standalone pack() on the service's cuda backend).  Each child loads
    the kernels this process built (`build.py`'s cache); they run one at a
    time."""
    import signal

    cmd = [sys.executable, str(ROOT / "tools" / "serve_traffic_torch.py"),
           "--device", device.type, "--hetero", "--smoke", "--store", str(store)]
    runs = (("killed", ["--die-after", str(SERVE_KILL_AFTER)], -signal.SIGKILL),
            ("restart", ["--expect-warm", "--verify", "--verify-backend", "python"], 0),
            ("warm", ["--expect-no-solves", "--verify"], 0))
    out = {}
    for name, extra, rc_want in runs:
        rec = store.with_name(f"{store.name}-{name}.json")
        t = time.perf_counter()
        proc = subprocess.run(cmd + extra + (["--out", str(rec)] if rc_want == 0 else []),
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t
        if proc.returncode != rc_want:
            raise AssertionError(f"kill lane {name}: exit {proc.returncode}, expected "
                                 f"{rc_want}\n{proc.stdout}\n{proc.stderr}")
        o = out[name] = dict(exit=proc.returncode, seconds=seconds)
        if rc_want == 0:
            r = json.loads(rec.read_text())
            st = r["stats"]
            if not r["parity"]["parity"]:
                raise AssertionError(f"kill lane {name}: parity {r['parity']}")
            o.update(rps=r["rps"], solved=st["solved"], store_hits=st["cache_hits_store"],
                     mem_hits=st["cache_hits_mem"], coalesced=st["coalesced"],
                     parity_tasks=r["parity"]["tasks"], parity_backend=r["verify_backend"])
        else:
            o["entries"] = len(list(store.glob("entry_*")))
        print(f"[serve] kill lane {name}: exit {proc.returncode} in {seconds:.1f}s; "
              + json.dumps({k: v for k, v in o.items() if k not in ("exit", "seconds")}))
    return out


def serve_path(device, dse) -> dict:
    """The packing service's main path on the card, in a temporary store
    directory removed at the end: the SA-S service (K3 / K4) over phase
    6a's 24 problems, cold (launch counts set to 0 just before the pass and
    read just after), a warm replay of the same traffic and the same
    traffic as one burst (memory cache: no solve, no launch), a fresh
    service over the same store (no solve, no launch, every unique task
    from the store), and one more cold pass under ``torch.profiler``
    (device busy share); a GA-NFD service (K1 / K2) on RN152-W1A2 and
    @U50; the SIGKILL lane.  Every response must equal phase 6a's cuda
    record of its (accelerator, device, seed).  The cold SA and the GA
    passes keep the first ops-layer call per kernel and shape, and K1-K4
    are held against their plain versions on those inputs afterwards;
    returns each kernel's largest |kernel - plain| in ``errs``."""
    import asyncio
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as rc
    from repro_torch.serve import Arrival, PackingService, make_workload

    t_phase = time.perf_counter()
    probs, labels = serve_corpus()
    label_of = {id(p): lab for p, lab in zip(probs, labels)}
    traffic = dict(SERVE_TRAFFIC)
    workload = make_workload(traffic.pop("n_requests"), len(probs), **traffic)
    burst = [Arrival(0.0, a.prob_idx, a.seed) for a in workload]
    n_unique = len({(a.prob_idx, a.seed) for a in workload})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    store = root / "store"
    launches = {name: 0 for name in KERNELS}
    out = {}
    # (function, kinds or not, shape) -> the first ops-layer call's arguments
    captured = {}

    def service(alg, **kw):
        return PackingService(alg, device=device, backend="cuda", **SERVE_BATCHING,
                              **dse_kwargs(alg), **kw)

    async def drive(svc, load):
        return await recorded_traffic(svc, probs, load, **SERVE_CLIENTS)

    # the cold pass's worker-lane time (each `solve_batch`), split into the
    # fleet's start and finish, the ops layer (staging, copies, K3 / K4)
    # and the SA steps' host code
    lane = [("lane", rc.dse, "solve_batch")] + sweep_phases("sa-s")

    async def cold_then_warm():
        async with service("sa-s", store_dir=store) as svc:
            with ops_timer(capture=True, by_shape=True) as ops, TimedSwap(lane) as host:
                cold = await drive(svc, workload)
            captured.update(ops.first)
            cold_stats = svc.stats()
            cold_stats["seconds"] = dict(host.seconds, ops=sum(d for _, d in ops.calls),
                                         ops_calls=len(ops.calls))
            warm = await drive(svc, workload)
            warm_stats = svc.stats()
            burst_run = await drive(svc, burst)
            return cold, cold_stats, warm, warm_stats, burst_run, svc.stats()

    async def once(**kw):
        async with service("sa-s", **kw) as svc:
            run = await drive(svc, workload)
            return run, svc.stats()

    want = dse["results"]["sa-s"]
    try:
        (got, res, nk), st, (got_w, res_w, nk_w), st_w, (got_b, res_b, nk_b), st_b = \
            asyncio.run(cold_then_warm())
        check_launches(nk, "sa-s", "serve sa-s cold")
        n_checked = check_responses(got, want, label_of, "serve sa-s cold")
        if st["solved"] != n_unique or st["requests"] != len(workload):
            raise AssertionError(f"serve sa-s cold: {st['solved']} solved of {n_unique} "
                                 f"unique tasks, {st['requests']} requests")
        for what, g, s0, s1, n in (("warm replay", got_w, st, st_w, nk_w),
                                   ("burst replay", got_b, st_w, st_b, nk_b)):
            check_responses(g, want, label_of, f"serve sa-s {what}")
            if (s1["solved"] != s0["solved"] or any(n.values())
                    or s1["cache_hits_mem"] - s0["cache_hits_mem"] != len(workload)):
                raise AssertionError(f"serve sa-s {what}: solved {s1['solved'] - s0['solved']}, "
                                     f"launched {n}, not all from the memory cache")
        for name, v in nk.items():
            launches[name] += v
        out["sa cold"] = serve_pass_summary(res, st)
        out["sa warm"] = dict(rps=res_w["rps"], wall_s=res_w["wall_s"],
                              latency=res_w["latency"])
        out["sa warm burst"] = dict(rps=res_b["rps"], wall_s=res_b["wall_s"],
                                    latency=res_b["latency"])
        out["sa cold"]["client_latency"] = res["latency"]
        sec = out["sa cold"]["seconds"] = st["seconds"]
        sec["steps_host"] = sec["lane"] - sec["start"] - sec["finish"] - sec["ops"]
        sec["off_lane"] = res["wall_s"] - sec["lane"]
        entries = len(list(store.glob("entry_*")))
        if entries != n_unique:
            raise AssertionError(f"serve sa-s: {entries} store entries, {n_unique} tasks")

        (got_r, res_r, nk_r), st_r = asyncio.run(once(store_dir=store))
        check_responses(got_r, want, label_of, "serve sa-s store restart")
        if (st_r["solved"] or any(nk_r.values()) or st_r["cache_hits_store"] != n_unique
                or st_r["cache_hits_store"] + st_r["cache_hits_mem"] != len(workload)):
            raise AssertionError(f"serve sa-s store restart: solved {st_r['solved']}, "
                                 f"launched {nk_r}, store hits {st_r['cache_hits_store']}")
        out["sa store restart"] = serve_pass_summary(res_r, st_r)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (got_p, res_p, nk_p), st_p = asyncio.run(once())
        check_launches(nk_p, "sa-s", "serve sa-s profiled")
        check_responses(got_p, want, label_of, "serve sa-s profiled")
        out["sa profiled"] = dict(rps=res_p["rps"], wall_s=res_p["wall_s"],
                                  solved=st_p["solved"], batches=st_p["batches"])
        out["sa profiled"]["profile"] = device_share(
            prof, res_p["wall_s"] * 1e6, "serve sa-s cold pass (profiled)",
            f"{len(workload)} requests, {st_p['solved']} solved in {st_p['batches']} batches")

        # GA-NFD: RN152-W1A2 and @U50, seeds 0 and 1, each asked twice at once
        ga_labels = [(PROBLEM, None), (PROBLEM, DEVICE_U50)]
        ga_probs = [rc.get_problem(name, device=dev) for name, dev in ga_labels]
        ga_load = [Arrival(0.0, ga_labels.index((name, dev)), s) for name, dev, s in SERVE_GA]

        async def ga_pass():
            async with service("ga-nfd") as svc:
                with ops_timer(capture=True, by_shape=True) as ops:
                    run = await recorded_traffic(svc, ga_probs, ga_load,
                                                 concurrency=len(ga_load))
                captured.update(ops.first)
                return run, svc.stats()

        (got_g, res_g, nk_g), st_g = asyncio.run(ga_pass())
        check_launches(nk_g, "ga-nfd", "serve ga-nfd")
        n_checked += check_responses(got_g, dse["results"]["ga-nfd"],
                                     {id(p): lab for p, lab in zip(ga_probs, ga_labels)},
                                     "serve ga-nfd")
        if st_g["solved"] != len(set(SERVE_GA)):
            raise AssertionError(f"serve ga-nfd: {st_g['solved']} solved")
        for name, v in nk_g.items():
            launches[name] += v
        out["ga"] = serve_pass_summary(res_g, st_g)

        # K1-K4 against their plain versions at every shape the service gave them
        errs, shapes = {}, {}
        for key, call in sorted(captured.items(), key=lambda kv: repr(kv[0])):
            for name, c in check_dse_kernels({key[:2]: call}, device, "the service's").items():
                errs[name] = max(errs.get(name, 0), c["err"])
                shapes.setdefault(name, []).append(list(c["shape"]))
        own = set(DSE_KERNELS["sa-s"] + DSE_KERNELS["ga-nfd"])
        if set(errs) != own:
            raise AssertionError(f"serve: kernels checked at the service's shapes "
                                 f"{sorted(errs)}, expected {sorted(own)}")
        out["kernel_shapes"] = shapes
        out["kill lane"] = kill_lane(device, root / "kill")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def lat(d):
        return f"p50 {d['p50_s'] * 1e3:.2f} / p99 {d['p99_s'] * 1e3:.2f} ms ({d['count']})"

    c, r = out["sa cold"], out["sa store restart"]
    print(f"[serve] sa-s x{len(workload)} requests over {len(probs)} problems "
          f"({n_unique} unique tasks): every response equal to phase 6a's cuda record "
          f"({n_checked} responses checked with the GA's)")
    print(f"[serve] requests/s: cold {c['rps']:.2f} ({c['wall_s']:.2f}s), warm replay "
          f"{out['sa warm']['rps']:.2f} (arrival-bound), warm burst "
          f"{out['sa warm burst']['rps']:.2f}, store restart {r['rps']:.2f}, "
          f"cold profiled {out['sa profiled']['rps']:.2f}")
    sec = c["seconds"]
    print(f"[serve] cold pass seconds: wall {c['wall_s']:.3f}, worker lane "
          f"{sec['lane']:.3f} (fleet start {sec['start']:.3f}, SA steps' host code "
          f"{sec['steps_host']:.3f}, ops layer {sec['ops']:.3f} over {sec['ops_calls']} "
          f"calls, finish {sec['finish']:.3f}), lane idle {sec['off_lane']:.3f}")
    print(f"[serve] latency: solved {lat(c['solved_latency'])}, cached "
          f"{lat(c['cached_latency'])} (cold pass); store restart cached "
          f"{lat(r['cached_latency'])}")
    print(f"[serve] cold pass: {c['solved']} solves in {c['batches']} batches, occupancy "
          f"{c['occupancy']:.3f} {json.dumps(c['occupancy_counts'])}, hit rate "
          f"{c['hit_rate']:.3f} ({c['coalesced']} coalesced, {c['mem_hits']} memory), "
          f"{c['deadline_fallbacks']} deadline fallbacks; launches {json.dumps(nk)}")
    print(f"[serve] warm replay and burst: 0 solves, 0 launches, all from the memory "
          f"cache; store restart: 0 solves, 0 launches, {r['store_hits']} from the "
          f"store, {r['mem_hits']} from memory")
    g = out["ga"]
    print(f"[serve] ga-nfd x{len(SERVE_GA)} requests: {g['solved']} solves in "
          f"{g['batches']} batches, {g['wall_s']:.2f}s, solved {lat(g['solved_latency'])}; "
          f"equal to phase 6a's cuda records; launches {json.dumps(nk_g)}")
    print(f"[serve] K1-K4 against their plain versions at the service's shapes "
          f"{json.dumps(shapes)}: max |kernel - plain| {json.dumps(errs)}")
    print(f"[serve] launches: {json.dumps(launches)}")
    print(f"[serve] phase took {time.perf_counter() - t_phase:.1f}s")
    return dict(launches=launches, runs=out, errs=errs)


# ----------------------------------------------------------------- phase 7
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


def sa_step_work(req, kind_tables) -> tuple[int, int]:
    """Bytes and operations of one SA delta step on the host request ``req``
    = (old_w, old_h, new_w, new_h, old_k, new_k) (kind lanes None on one
    kind, costed on ``kind_tables[0]``): every width read once (it says which
    slots are live), the heights (and kinds) at live slots only, the int64
    deltas written once; 4 operations per mode per live slot (two
    ceil-divisions, a product, a min), on that slot's own mode table."""
    import numpy as np

    ow, _, nw, _, ok, nk = req
    plane_bytes = 4 if ok is None else 8
    if ok is None:
        ok, nk = np.zeros_like(ow), np.zeros_like(nw)
    live = int((ow > 0).sum()) + int((nw > 0).sum())
    n_bytes = 4 * (ow.size + nw.size) + plane_bytes * live + 8 * ow.shape[0]
    ops = 4 * sum(len(m) * int(((x > 0) & (k == i)).sum())
                  for i, (_, m) in enumerate(kind_tables) for x, k in ((ow, ok), (nw, nk)))
    return n_bytes, ops


def bound_of(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the INT32 operations over their issue rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_host_rounds(fns: dict, rounds: int = 12, n: int = 50) -> dict:
    """Milliseconds per call of each of ``fns``, host clock to a
    synchronise: ``rounds`` rounds of ``n`` calls each, the functions in
    turns (order reversed every other round); the median round of each.
    The host is shared, so one long sample can land on a slow stretch."""
    import statistics

    import torch

    per = {k: [] for k in fns}
    names = list(fns)
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            fns[k]()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fns[k]()
            torch.cuda.synchronize()
            per[k].append((time.perf_counter() - t) / n * 1e3)
    return {k: statistics.median(v) for k, v in per.items()}


def kernel_timings(inputs, device, planner_k1, probe_lib) -> dict:
    """Every K1-K5 at its main-path shape (see the `[timing]` lines);
    ``planner_k1`` is one (W, H, modes) input of K1 at the memory planner's
    most common shape; ``probe_lib`` the loaded
    ``tools/fitness_design_probe.cu``, whose copy of K5 as it was before its
    redesign (both roles) is timed beside K1 / K2 (with no chains) and K5."""
    import fitness_design_probe as probe
    import numpy as np
    import torch

    from repro_torch.kernels import build

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
        binpack_fitness_kinds_ref, binpack_fitness_ref, population_costs,
    )
    from repro_torch.kernels.binpack_portfolio_step import (
        portfolio_step, portfolio_step_cuda, portfolio_step_kinds_cuda,
        portfolio_step_kinds_ref, portfolio_step_ref,
    )
    from repro_torch.kernels import staging
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
    # the portfolio's fused step: its stacked (2 * n_pop, n) populations and
    # its 8-chain fleet step, as K5 receives them
    nb = hom["W2"].shape[-1]
    W2, H2 = dev(hom["W2"].reshape(-1, nb), hom["H2"].reshape(-1, nb))
    Wk2, Hk2, Kk2 = dev(*(het[x].reshape(-1, nb) for x in ("W2", "H2", "K2")))
    p_hom = dev(*hom["req8"][:4])
    p_het = dev(*het["req8"])  # ow, oh, nw, nh, ok, nk
    pw, ph, pnw, pnh, pok, pnk = p_het
    p_het_args = (pw, ph, pok, pnw, pnh, pnk)

    def live(w):
        return int((w > 0).sum())

    def sa_bytes(ow, nw, plane_bytes):
        """An SA step's bytes: the widths in full, the other planes at live
        slots only, the int64 deltas written once."""
        return (4 * (ow.numel() + nw.numel()) + plane_bytes * (live(ow) + live(nw))
                + 8 * ow.shape[0])

    def kind_ops(pairs):
        return 4 * sum(len(m) * int(((x > 0) & (k == i)).sum())
                       for i, (_, m) in enumerate(kt) for x, k in pairs)

    k3_work = sa_step_work(hom["req"], ((1, BRAM18_MODES),))
    k4_work = sa_step_work(het["req"], kt)
    z4 = torch.zeros((0, 4), dtype=torch.int32, device=device)
    no_chains = (z4,) * 6

    def first_design(w, h, k, step, kt):
        """K5 as it was before its redesign (`tools/fitness_design_probe.cu`):
        with no chains, K1 / K2's first design."""
        return probe.k5_launch(probe_lib.probe_old_k5_launch, w, h, k, step, kt, True)

    one_kind = ((1, BRAM18_MODES),)
    zk = torch.zeros_like(p_hom[0])  # the old K5's step with (unread) kind lanes
    p_hom_step = (p_hom[0], p_hom[1], zk, p_hom[2], p_hom[3], zk)

    def pageable_k5(wrapper, pop, step, tables):
        """The fused ops call before staging: each host plane copied from pageable
        memory on its own, the wrapper, each half back with its own
        `.cpu()`."""
        nb, t = np.shape(pop[0])[-1], np.shape(step[0])[-1]
        planes = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32).reshape(-1, w))
                  .to(device) for x, w in [(x, nb) for x in pop] + [(x, t) for x in step]]
        totals, deltas = wrapper(*planes, tables)
        return (totals.cpu().numpy().astype(np.float64).reshape(np.shape(pop[0])[:-1]),
                deltas.cpu().numpy())

    def pageable(wrapper, arrays, *tables):
        """PR 14's fitness ops call: each host plane copied from pageable
        memory on its own, the wrapper, the totals back with `.cpu()`."""
        nb = np.shape(arrays[0])[-1]
        planes = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32).reshape(-1, nb))
                  .to(device) for x in arrays)
        return wrapper(*planes, *tables).cpu().numpy()

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
            staged=True,
            wrapper=lambda *planes: binpack_fitness_cuda(*planes, BRAM18_MODES),
            staged_host=(hom["W"], hom["H"]),
            pageable=lambda: pageable(binpack_fitness_cuda, (hom["W"], hom["H"]), BRAM18_MODES),
            # the first design's row body at the same shape: K5 as it was
            # before its redesign, with no chains
            old=lambda: first_design(W, H, None, no_chains, one_kind)[0],
            # the wrapper's by-value table: PR 14 built it on every call
            tables=(lambda: probe.kind_tables_struct(((1, BRAM18_MODES),)),
                    lambda: build.fitness_modes_struct(BRAM18_MODES)),
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
            staged=True,
            wrapper=lambda *planes: binpack_fitness_kinds_cuda(*planes, kt),
            staged_host=(het["W"], het["H"], het["K"]),
            pageable=lambda: pageable(binpack_fitness_kinds_cuda,
                                      (het["W"], het["H"], het["K"]), kt),
            old=lambda: first_design(Wk, Hk, Kk, no_chains, kt)[0],
            tables=(lambda: probe.kind_tables_struct(kt),
                    lambda: build.fitness_tables_struct(kt)),
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
            staged=True,
            # the ops layer's steps spelt out (stage, launch on the plane
            # views, fetch), to time two ways of fetching the result in turns
            wrapper=lambda *planes: sa_step_deltas_cuda(*planes, BRAM18_MODES),
            staged_host=hom["req"][:4],
            # the pageable call path the staged one replaced, for a comparison
            # on the same host: each plane copied from pageable memory, the
            # result back with `.cpu()`
            pageable=lambda: sa_step_deltas_cuda(
                *(torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
                  for x in hom["req"][:4]), BRAM18_MODES).cpu().numpy(),
            bytes=k3_work[0],
            ops_count=k3_work[1],
            shape=tuple(sa_hom[0].shape),
        ),
        "sa_step_deltas_kinds_cuda": dict(
            kernel=lambda: sa_step_deltas_kinds_cuda(ow, oh, ok, nw, nh, nk, kt),
            plain=lambda: sa_step_deltas_kinds_ref(ow, oh, ok, nw, nh, nk, kt),
            ops=lambda: sa_step_deltas(*het["req"][:4], backend="cuda", device=device,
                                       old_k=het["req"][4], new_k=het["req"][5],
                                       kind_tables=kt),
            host=het["req"],
            staged=True,
            wrapper=lambda *planes: sa_step_deltas_kinds_cuda(*planes, kt),
            staged_host=tuple(het["req"][i] for i in (0, 1, 4, 2, 3, 5)),
            pageable=lambda: sa_step_deltas_kinds_cuda(
                *(torch.from_numpy(np.ascontiguousarray(het["req"][i], dtype=np.int32))
                  .to(device) for i in (0, 1, 4, 2, 3, 5)), kt).cpu().numpy(),
            bytes=k4_work[0],
            ops_count=k4_work[1],
            shape=tuple(ow.shape),
        ),
        "portfolio_step_cuda": dict(
            kernel=lambda: portfolio_step_cuda(W2, H2, *p_hom, BRAM18_MODES),
            plain=lambda: portfolio_step_ref(W2, H2, *p_hom, BRAM18_MODES),
            ops=lambda: portfolio_step(hom["W2"], hom["H2"], *hom["req8"][:4],
                                       backend="cuda", device=device),
            # what one fused launch replaces: a K1 launch and a K3 launch;
            # K1 alone at the same rows; K5 as it was before its redesign
            separate=lambda: (binpack_fitness_cuda(W2, H2, BRAM18_MODES),
                              sa_step_deltas_cuda(*p_hom, BRAM18_MODES)),
            alone=lambda: binpack_fitness_cuda(W2, H2, BRAM18_MODES),
            old=lambda: first_design(W2, H2, None, p_hom_step, one_kind),
            host=(hom["W2"], hom["H2"], *hom["req8"][:4]),
            groups=((hom["W2"], hom["H2"]), hom["req8"][:4]),
            pageable=lambda: pageable_k5(portfolio_step_cuda, (hom["W2"], hom["H2"]),
                                         hom["req8"][:4], BRAM18_MODES),
            bytes=4 * W2.numel() + 4 * live(W2) + 8 * W2.shape[0]
            + sa_bytes(p_hom[0], p_hom[2], 4),
            ops_count=4 * n_modes_hom * (live(W2) + live(p_hom[0]) + live(p_hom[2])),
            shape=(tuple(hom["W2"].shape), tuple(p_hom[0].shape)),
        ),
        "portfolio_step_kinds_cuda": dict(
            kernel=lambda: portfolio_step_kinds_cuda(Wk2, Hk2, Kk2, *p_het_args, kt),
            plain=lambda: portfolio_step_kinds_ref(Wk2, Hk2, Kk2, *p_het_args, kt),
            ops=lambda: portfolio_step(het["W2"], het["H2"], *het["req8"][:4],
                                       backend="cuda", device=device, kinds=het["K2"],
                                       old_k=het["req8"][4], new_k=het["req8"][5],
                                       kind_tables=kt),
            separate=lambda: (binpack_fitness_kinds_cuda(Wk2, Hk2, Kk2, kt),
                              sa_step_deltas_kinds_cuda(*p_het_args, kt)),
            alone=lambda: binpack_fitness_kinds_cuda(Wk2, Hk2, Kk2, kt),
            old=lambda: first_design(Wk2, Hk2, Kk2, p_het_args, kt),
            host=(het["W2"], het["H2"], het["K2"], *het["req8"]),
            groups=((het["W2"], het["H2"], het["K2"]),
                    tuple(het["req8"][i] for i in (0, 1, 4, 2, 3, 5))),
            pageable=lambda: pageable_k5(portfolio_step_kinds_cuda,
                                         (het["W2"], het["H2"], het["K2"]),
                                         tuple(het["req8"][i] for i in (0, 1, 4, 2, 3, 5)),
                                         kt),
            bytes=4 * Wk2.numel() + 8 * live(Wk2) + 8 * Wk2.shape[0]
            + sa_bytes(pw, pnw, 8),
            ops_count=kind_ops(((Wk2, Kk2), (pw, pok), (pnw, pnk))),
            shape=(tuple(het["W2"].shape), tuple(pw.shape)),
        ),
    }
    def cpu_fetch(x):
        return x.cpu().numpy()

    def pinned_fetch(x):
        """The other way to fetch a result: one non-blocking copy into a
        pinned buffer, then a wait on an event recorded after it."""
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host.numpy()

    out = {}
    for name, c in cases.items():
        bound_ms, bound_by = bound_of(c["bytes"], c["ops_count"])
        # alternate kernel and plain runs (kernel, plain, plain, kernel)
        k1 = time_graph(c["kernel"], 200)
        p1 = time_events(c["plain"], 200)
        p2 = time_events(c["plain"], 200)
        k2 = time_graph(c["kernel"], 200)
        # the ops layer's copies on their own, as it makes them: K1-K4
        # stage every plane into one pinned buffer and copy it once
        # (`staging.stage`), K5 both halves' planes into one
        # (`staging.stage_groups`); all bring the int64 result back with one
        # `.cpu()` (K5 of both halves at once: timed here per half)
        host = [np.ascontiguousarray(x, dtype=np.int32) for x in c["host"]]
        res = c["kernel"]()
        res = res if isinstance(res, tuple) else (res,)  # K5 returns both halves

        def d2h():
            return [x.cpu() for x in res]

        if c.get("staged"):
            def h2d():
                return staging.stage(host, device)
        else:
            def h2d(c=c):
                return staging.stage_groups(c["groups"], device)

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
            d2h_host_ms=time_host(d2h, 200),
            bound_ms=bound_ms,
            bound_by=bound_by,
            bytes=c["bytes"],
            operations=c["ops_count"],
            shape=c["shape"],
        )
        o = out[name]
        if c.get("staged"):
            # in turns (medians of 12 rounds): the ops call, the pageable call
            # path it replaced, and its steps spelt out with the result
            # fetched by `.cpu()` (as the ops layer does) or through a pinned
            # buffer and an event; then the two fetches alone
            def staged_with(fetch, c=c):
                return lambda: fetch(c["wrapper"](
                    *staging.stage(c["staged_host"], device).unbind(0)))

            variants = {"ops": c["ops"], "pageable": c["pageable"],
                        "cpu_fetch": staged_with(cpu_fetch),
                        "pinned_fetch": staged_with(pinned_fetch)}
            want = c["ops"]()
            for k, fn in variants.items():
                if not np.array_equal(fn(), want):
                    raise AssertionError(f"{name}: the {k} call path disagrees with the ops call")
            r = time_host_rounds(variants)
            o.update(ops_turns_ms=r["ops"], ops_pageable_ms=r["pageable"],
                     ops_cpu_fetch_ms=r["cpu_fetch"], ops_pinned_fetch_ms=r["pinned_fetch"])
            r = time_host_rounds({"cpu": lambda: cpu_fetch(res[0]),
                                  "pinned": lambda: pinned_fetch(res[0])})
            o.update(d2h_cpu_ms=r["cpu"], d2h_pinned_ms=r["pinned"])
        elif "pageable" in c:
            # K5: the staged ops call in turns with the pageable one it replaced
            want = c["ops"]()
            if not all(map(np.array_equal, c["pageable"](), want)):
                raise AssertionError(f"{name}: the pageable call path disagrees with the ops call")
            r = time_host_rounds({"ops": c["ops"], "pageable": c["pageable"]})
            o.update(ops_turns_ms=r["ops"], ops_pageable_ms=r["pageable"])
        if "old" in c:
            # the first design's body at the same shape, in turns with two
            # more kernel samples (kernel, old, old, kernel)
            k3_ = time_graph(c["kernel"], 200)
            o["old_ms"] = min(time_graph(c["old"], 200), time_graph(c["old"], 200))
            o["ms"] = min(o["ms"], k3_, time_graph(c["kernel"], 200))
        if "tables" in c:
            uncached, cached = c["tables"]
            o["tables_uncached_ms"] = time_host(uncached, 200)
            o["tables_cached_ms"] = time_host(cached, 200)
        if "separate" in c:
            # the separate pair at the same shapes, timed like the kernel (a
            # graph of pairs, per pair), in turns with a third kernel sample
            s1 = time_graph(c["separate"], 200)
            o["ms"] = min(o["ms"], time_graph(c["kernel"], 200))
            o["separate_ms"] = min(s1, time_graph(c["separate"], 200))
            # its fitness kernel alone at the same rows
            o["alone_ms"] = min(time_graph(c["alone"], 200), time_graph(c["alone"], 200))
        print(f"[timing] {name} {c['shape']}: kernel {o['ms']*1e3:.2f} us/launch "
              f"(graph), wrapper call {o['call_ms']*1e3:.2f} us, plain "
              f"{o['plain_ms']*1e3:.2f} us, ops layer with copies "
              f"{o['ops_ms']*1e3:.2f} us (host->device copies {o['h2d_ms']*1e3:.2f} us "
              f"by events, {o['h2d_host_ms']*1e3:.2f} us by host clock; "
              f"device->host {o['d2h_host_ms']*1e3:.2f} us), bound "
              f"{o['bound_ms']*1e3:.4f} us ({o['bound_by']}: {o['bytes']} B, "
              f"{o['operations']} ops)"
              + (f"; the separate K1/K2 + K3/K4 pair it replaces "
                 f"{o['separate_ms']*1e3:.2f} us, its K1/K2 alone {o['alone_ms']*1e3:.2f} us, "
                 f"K5 before its redesign {o['old_ms']*1e3:.2f} us"
                 if "separate_ms" in o else "")
              + (f"; the first design's row body (K5 before its redesign, no chains) "
                 f"{o['old_ms']*1e3:.2f} us; the by-value table built per call "
                 f"{o['tables_uncached_ms']*1e3:.2f} us, cached "
                 f"{o['tables_cached_ms']*1e3:.2f} us" if "tables_cached_ms" in o else "")
              + (f"; in turns (medians of 12 rounds): ops layer staged "
                 f"{o['ops_turns_ms']*1e3:.2f} us, the pageable call path (a copy per "
                 f"plane, a `.cpu()` per half) {o['ops_pageable_ms']*1e3:.2f} us"
                 if "ops_turns_ms" in o and "ops_cpu_fetch_ms" not in o else "")
              + (f"; in turns (medians of 12 rounds): ops layer staged "
                 f"{o['ops_turns_ms']*1e3:.2f} us, the pageable call path (a copy per "
                 f"plane, `.cpu()` back) {o['ops_pageable_ms']*1e3:.2f} us, staged with "
                 f"a `.cpu()` fetch {o['ops_cpu_fetch_ms']*1e3:.2f} us / with a pinned "
                 f"fetch and an event {o['ops_pinned_fetch_ms']*1e3:.2f} us; the fetch "
                 f"alone by `.cpu()` {o['d2h_cpu_ms']*1e3:.2f} us / pinned + event "
                 f"{o['d2h_pinned_ms']*1e3:.2f} us"
                 if "ops_cpu_fetch_ms" in o else ""))

    # K1 at the memory planner's own shape, on one of its inputs, beside
    # the first design's body there
    pw, ph, pmodes = planner_k1
    pW, pH = dev(pw, ph)
    kern = lambda: binpack_fitness_cuda(pW, pH, pmodes)  # noqa: E731
    old = lambda: first_design(pW, pH, None, no_chains, ((1, pmodes),))[0]  # noqa: E731
    a, b, c2, d = time_graph(kern, 200), time_graph(old, 200), time_graph(old, 200), time_graph(kern, 200)
    n_bytes = 4 * pW.numel() + 4 * live(pW) + 8 * pW.shape[0]
    bound_ms, bound_by = bound_of(n_bytes, 4 * len(pmodes) * live(pW))
    out["binpack_fitness_cuda"]["planner"] = o = dict(
        shape=tuple(pW.shape), ms=min(a, d), old_ms=min(b, c2), bound_ms=bound_ms,
        bound_by=bound_by, bytes=n_bytes, modes=len(pmodes))
    print(f"[timing] binpack_fitness_cuda at the memory planner's shape {o['shape']} "
          f"({o['modes']} modes): kernel {o['ms']*1e3:.2f} us/launch (graph), the first "
          f"design's row body (K5 before its redesign, no chains) {o['old_ms']*1e3:.2f} us, "
          f"bound "
          f"{bound_ms*1e3:.4f} us ({bound_by}: {n_bytes} B)")
    return out


def sa_shape_timings(inputs, device, probe_lib) -> dict:
    """K3 and K4 at the three shapes the main paths give them: the 64-chain
    fleet's step (SA-S x64), the portfolio's 8-chain fleet step and one
    chain's step (SA-S x1, the first row of the 64-chain request).  Per
    shape: device time per launch (CUDA graph) of the kernel and of K3 / K4
    as they were before the shared slot cost (``probe_lib``'s
    `KindTables` kernels, exact first), in turns with the plain version
    (kernel / before / plain / plain / before / kernel), the ops layer per
    call with its staged copies (the median of six rounds), and the bound."""
    import fitness_design_probe as probe
    import numpy as np
    import torch

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas, sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
        sa_step_deltas_kinds_ref, sa_step_deltas_ref,
    )

    hom, het = inputs[None], inputs[DEVICE_U50]
    kt = het["prob"].kind_tables
    reqs = {
        "sa-s x64": (hom["req"], het["req"]),
        "portfolio fleet": (hom["req8"], het["req8"]),
        "sa-s x1": (tuple(x[:1] for x in hom["req"][:4]), tuple(x[:1] for x in het["req"])),
    }
    out = {"sa_step_deltas_cuda": {}, "sa_step_deltas_kinds_cuda": {}}
    for label, (rh, rk) in reqs.items():
        ow, oh, nw, nh = (torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
                          for x in rh[:4])
        kow, koh, knw, knh, kok, knk = (
            torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device) for x in rk)
        cases = {
            "sa_step_deltas_cuda": dict(
                kernel=lambda: sa_step_deltas_cuda(ow, oh, nw, nh, BRAM18_MODES),
                plain=lambda: sa_step_deltas_ref(ow, oh, nw, nh, BRAM18_MODES),
                old=lambda: probe.old_k34(probe_lib, (ow, oh, None, nw, nh, None),
                                          ((1, BRAM18_MODES),)),
                ops=lambda: sa_step_deltas(*rh[:4], backend="cuda", device=device),
                work=sa_step_work(tuple(rh[:4]) + (None, None), ((1, BRAM18_MODES),)),
            ),
            "sa_step_deltas_kinds_cuda": dict(
                kernel=lambda: sa_step_deltas_kinds_cuda(kow, koh, kok, knw, knh, knk, kt),
                plain=lambda: sa_step_deltas_kinds_ref(kow, koh, kok, knw, knh, knk, kt),
                old=lambda: probe.old_k34(probe_lib, (kow, koh, kok, knw, knh, knk), kt),
                ops=lambda: sa_step_deltas(*rk[:4], backend="cuda", device=device,
                                           old_k=rk[4], new_k=rk[5], kind_tables=kt),
                work=sa_step_work(rk, kt),
            ),
        }
        for name, c in cases.items():
            if not torch.equal(c["old"](), c["plain"]()):
                raise AssertionError(f"{name} {label}: the design before the shared slot "
                                     "cost differs from the plain version")
            k1 = time_graph(c["kernel"], 200)
            o1 = time_graph(c["old"], 200)
            p1 = time_events(c["plain"], 200)
            p2 = time_events(c["plain"], 200)
            o2 = time_graph(c["old"], 200)
            k2 = time_graph(c["kernel"], 200)
            n_bytes, n_ops = c["work"]
            bound_ms, bound_by = bound_of(n_bytes, n_ops)
            out[name][label] = o = dict(
                shape=tuple(np.shape(rh[0])), ms=min(k1, k2), old_ms=min(o1, o2),
                plain_ms=min(p1, p2),
                ops_ms=time_host_rounds({"ops": c["ops"]}, rounds=6)["ops"],
                bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, operations=n_ops,
            )
            print(f"[sa-timing] {name} {label} {o['shape']}: kernel {o['ms']*1e3:.2f} "
                  f"us/launch (graph), before the shared slot cost {o['old_ms']*1e3:.2f} "
                  f"us, plain {o['plain_ms']*1e3:.2f} us, ops layer with "
                  f"staged copies {o['ops_ms']*1e3:.2f} us, bound {bound_ms*1e3:.4f} us "
                  f"({bound_by}: {n_bytes} B, {n_ops} ops)")
    return out


def dse_shape_timings(cases, device) -> dict:
    """K1-K4 at the DSE sweep's shapes (each group's first call: K1 / K2
    the stacked (P, 75, 2253) populations, K3 / K4 the (P * 8, 4) fleet
    step): device time per launch (CUDA graph), the plain version, the ops
    layer per call with its staged copies (median of six rounds), and the
    bound; for K1 / K2 also the staging alone (the fill of the pinned
    buffer, its copy and a synchronise, host clock) and the copy alone
    (CUDA events around one copy of an already filled pinned buffer of the
    same size); the staging and the ops call are timed in turns."""
    import numpy as np
    import torch

    from repro_torch.kernels import staging
    from repro_torch.kernels.binpack_fitness import population_costs
    from repro_torch.kernels.binpack_sa_step import sa_step_deltas

    out = {}
    for name, c in cases.items():
        host, tables = c["host"], c["tables"]
        if name.startswith("binpack_fitness"):
            kinds = name.endswith("kinds_cuda")
            w = np.asarray(host[0])
            k = np.asarray(host[2]) if kinds else np.zeros_like(w)
            live = int((w > 0).sum())
            n_bytes = 4 * w.size + (8 if kinds else 4) * live + 8 * (w.size // w.shape[-1])
            n_ops = 4 * sum(len(m) * int(((w > 0) & (k == i)).sum())
                            for i, (_, m) in enumerate(tables))
            kw = dict(kinds=host[2], kind_tables=tables) if kinds else dict(modes=tables[0][1])
            ops = lambda host=host, kw=kw: population_costs(  # noqa: E731
                host[0], host[1], backend="cuda", device=device, **kw)
            pinned = staging.host_buffer((len(host) * w.size,), torch.int32, device)
            extra = dict(
                copy_ms=time_events(lambda p=pinned: p.to(device, non_blocking=True), 20),
                staged_bytes=4 * len(host) * w.size,
            )
            # the staging alone in turns with the whole ops call
            turns = time_host_rounds({"ops": ops, "stage": lambda host=host: (
                staging.stage(host, device), torch.cuda.synchronize())}, rounds=6, n=10)
        else:
            n_bytes, n_ops = sa_step_work(host if len(host) == 6 else tuple(host) + (None, None),
                                          tables)
            kw = (dict(old_k=host[4], new_k=host[5], kind_tables=tables) if len(host) == 6
                  else dict(modes=tables[0][1]))
            ops = lambda host=host, kw=kw: sa_step_deltas(  # noqa: E731
                *host[:4], backend="cuda", device=device, **kw)
            extra = {}
            turns = time_host_rounds({"ops": ops}, rounds=6, n=50)
        bound_ms, bound_by = bound_of(n_bytes, n_ops)
        k1 = time_graph(c["kernel"], 200)
        p1 = time_events(c["plain"], 50)
        p2 = time_events(c["plain"], 50)
        k2 = time_graph(c["kernel"], 200)
        out[name] = o = dict(
            shape=c["shape"], ms=min(k1, k2), plain_ms=min(p1, p2),
            ops_ms=turns["ops"], bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
            operations=n_ops, **extra,
            **({"stage_ms": turns["stage"]} if "stage" in turns else {}),
        )
        print(f"[dse-timing] {name} at {o['shape']}: kernel {o['ms']*1e3:.2f} us/launch "
              f"(graph), plain {o['plain_ms']*1e3:.2f} us, ops layer with staged copies "
              f"{o['ops_ms']*1e3:.2f} us"
              + (f" (staging alone {o['stage_ms']*1e3:.1f} us for {o['staged_bytes']} B, "
                 f"its copy alone {o['copy_ms']*1e3:.1f} us by events)" if extra else "")
              + f", bound {bound_ms*1e3:.4f} us ({bound_by}: {n_bytes} B, {n_ops} ops)")
    return out


def floor_timings(device) -> dict:
    """Each kernel's launch floor: its wrapper at the smallest legal input,
    every slot empty (K6: an (8, 128) bank of zeros, N = 1), per launch in
    the same CUDA-graph harness as its ``ms`` (200 launches, the lower of
    two samples)."""
    import torch

    from repro_torch.core.problem import BRAM18_MODES
    from repro_torch.kernels.binpack_fitness import (
        binpack_fitness_cuda, binpack_fitness_kinds_cuda,
    )
    from repro_torch.kernels.binpack_portfolio_step import (
        portfolio_step_cuda, portfolio_step_kinds_cuda,
    )
    from repro_torch.kernels.binpack_sa_step import (
        sa_step_deltas_cuda, sa_step_deltas_kinds_cuda,
    )
    from repro_torch.kernels.packed_gather import packed_gather_cuda

    kt = ((1, BRAM18_MODES),)
    z = torch.zeros((1, 1), dtype=torch.int32, device=device)
    bank = torch.zeros((8, 128), dtype=torch.float32, device=device)
    x = torch.zeros((1, 128), dtype=torch.float32, device=device)
    seg = torch.zeros(8, dtype=torch.int32, device=device)
    cases = {
        "binpack_fitness_cuda": lambda: binpack_fitness_cuda(z, z, BRAM18_MODES),
        "binpack_fitness_kinds_cuda": lambda: binpack_fitness_kinds_cuda(z, z, z, kt),
        "sa_step_deltas_cuda": lambda: sa_step_deltas_cuda(z, z, z, z, BRAM18_MODES),
        "sa_step_deltas_kinds_cuda": lambda: sa_step_deltas_kinds_cuda(z, z, z, z, z, z, kt),
        "portfolio_step_cuda": lambda: portfolio_step_cuda(z, z, z, z, z, z, BRAM18_MODES),
        "portfolio_step_kinds_cuda": lambda: portfolio_step_kinds_cuda(
            z, z, z, z, z, z, z, z, z, kt),
        "packed_gather_cuda": lambda: packed_gather_cuda(bank, x, seg),
    }
    out = {}
    for name, fn in cases.items():
        out[name] = min(time_graph(fn, 200), time_graph(fn, 200))
        print(f"[floor] {name}: {out[name]*1e3:.2f} us/launch (graph) at its smallest "
              f"all-empty input")
    return out


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
    ops = ops_timer()
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
        return dict(loop=loop, steps=steps, ops=ops_s, calls=len(ops.calls), chains=1,
                    key=run.best_cost)
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
    return dict(loop=loop, steps=steps, ops=[d for _, d in ops.calls], calls=len(ops.calls),
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
    """One cuda loop of each main-path engine, and one cuda portfolio run
    per problem, under ``torch.profiler`` (CPU and CUDA activities): the
    device's busy time (the union of its kernel and copy intervals) over
    the wall time, and the device time by kind (`device_share`).  Profiling slows the host, so the busy share is a lower bound
    on the unprofiled run's.  Where the profiler records no device event,
    the device numbers are reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core as rc

    short = {
        "ga-nfd": ("ga-nfd", dict(max_generations=20)),
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
            key = f"{label} {prob_name}"
            out[key] = o = device_share(holder["prof"], r["loop"] * 1e6, key,
                                        f"{len(r['steps'])} steps")
            if "HtoD_n" in o:
                # the staged ops layers make one copy each way per ops call,
                # and each call launches one kernel; an SA step makes one
                # call, a GA generation one (if it mutated).  The profile
                # records none of the first few calls' device events, so
                # the copies per recorded launch are the per-call count.
                n_steps, n_launches = len(r["steps"]), max(o["kernel_n"], 1)
                o.update(h2d_per_step=o["HtoD_n"] / n_steps, d2h_per_step=o["DtoH_n"] / n_steps,
                         h2d_per_launch=o["HtoD_n"] / n_launches,
                         d2h_per_launch=o["DtoH_n"] / n_launches, ops_calls=r["calls"])
                print(f"[profile] {key}: {o['h2d_per_step']:.3f} host->device and "
                      f"{o['d2h_per_step']:.3f} device->host copies per "
                      f"{'generation' if alg.startswith('ga') else 'step'} ({r['calls']} ops "
                      f"calls); {o['h2d_per_launch']:.3f} and {o['d2h_per_launch']:.3f} per "
                      f"recorded kernel launch ({o['kernel_n']})")
    # the portfolio's default lineup, the whole run (set-up included): the
    # main lane and the side-lane thread launch into one profile
    for dev in (None, DEVICE_U50):
        key = f"portfolio {PROBLEM}{'@' + dev if dev else ''}"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            r, wall, _ = portfolio_run(dev, "cuda", device)
        out[key] = o = device_share(prof, wall * 1e6, key, f"{r.params['barriers']} barriers")
        if "HtoD_n" in o:
            # every ops call, fused or not, stages one copy in and launches one kernel
            o["h2d_per_launch"] = o["HtoD_n"] / max(o["kernel_n"], 1)
            print(f"[profile] {key}: {o['h2d_per_launch']:.3f} host->device copies per "
                  f"recorded kernel launch ({o['kernel_n']})")
    return out


def profile_fused_calls(inputs, device, n: int = 30) -> dict:
    """``n`` fused ops calls (`portfolio_step`, backend cuda) on the
    portfolio's main-path inputs, each problem, under ``torch.profiler``:
    the host->device and device->host copies per recorded K5 launch (the
    staged ops layer makes one each way per call).  A fresh trace drops the
    device events of its first milliseconds, so a warm-up step of ``n``
    calls (the schedule's ``warmup``, recorded nowhere) turns the device
    tracing on before the ``n`` counted calls; the count still starts at
    the first recorded call whose copy in, K5 launch and copy out are all
    there, and from there the device's events, in time order, must be
    exactly (HtoD, K5, DtoH) once a call, for at least half the calls, or
    this raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.binpack_portfolio_step import portfolio_step

    out = {}
    for dev in (None, DEVICE_U50):
        d = inputs[dev]
        kw = {} if dev is None else dict(kinds=d["K2"], old_k=d["req8"][4],
                                         new_k=d["req8"][5], kind_tables=d["prob"].kind_tables)

        def call():
            return portfolio_step(d["W2"], d["H2"], *d["req8"][:4], backend="cuda",
                                  device=device, **kw)

        for _ in range(5):
            call()
        recorded = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: recorded.extend(p.events())) as prof:
            for _ in range(2):
                for _ in range(n):
                    call()
                prof.step()
        seq = []
        for e in sorted((e for e in recorded
                         if "CUDA" in str(getattr(e, "device_type", ""))),
                        key=lambda e: e.time_range.start):
            seq.append("HtoD" if "HtoD" in e.name else "DtoH" if "DtoH" in e.name
                       else "K5" if "portfolio_step_kernel" in e.name else e.name)
        triple = ["HtoD", "K5", "DtoH"]
        start = next((i for i in range(len(seq)) if seq[i:i + 3] == triple), len(seq))
        window = seq[start:]
        n_k5 = len(window) // 3
        key = f"fused ops call {PROBLEM}{'@' + dev if dev else ''}"
        out[key] = o = dict(calls=n, recorded_events=len(seq), dropped_lead=start,
                            k5_n=n_k5, HtoD_n=window.count("HtoD"),
                            DtoH_n=window.count("DtoH"))
        if window != triple * n_k5 or n_k5 < n // 2:
            raise AssertionError(
                f"{key}: the device's events from the first whole call are not one "
                f"(HtoD, K5, DtoH) per call for at least {n // 2} calls: {seq}")
        o.update(h2d_per_k5=o["HtoD_n"] / n_k5, d2h_per_k5=o["DtoH_n"] / n_k5)
        print(f"[profile] {key}, {n} calls: {o['h2d_per_k5']:.3f} host->device and "
              f"{o['d2h_per_k5']:.3f} device->host copies per recorded K5 launch "
              f"({n_k5} whole calls recorded in order, after {start} leading events of "
              f"calls the profiler recorded in part; no other device event)")
    return out


def device_share(prof, wall_us: float, key: str, what: str) -> dict:
    """The device's busy time (the union of its kernel and copy intervals)
    over ``wall_us``, and its time by kind, from one profile; "not
    measured" where the profiler recorded no device event."""
    by_kind = {"kernel": [], "HtoD": [], "DtoH": [], "other": []}
    for e in prof.events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        iv = (e.time_range.start, e.time_range.end)
        kind = ("HtoD" if "HtoD" in e.name else "DtoH" if "DtoH" in e.name
                else "other" if e.name.startswith(("Memcpy", "Memset"))
                else "kernel")
        by_kind[kind].append(iv)
    every = [iv for ivs in by_kind.values() for iv in ivs]
    if not every:
        print(f"[profile] {key}: no device events recorded; device time not measured")
        return dict(wall_us=wall_us, device="not measured")
    busy = _union_us(every)
    o = dict(
        wall_us=wall_us, what=what, busy_us=busy, busy_share=busy / wall_us,
        **{f"{k}_us": sum(b - a for a, b in v) for k, v in by_kind.items()},
        **{f"{k}_n": len(v) for k, v in by_kind.items()},
    )
    print(f"[profile] {key}, {what}: wall {wall_us:.0f} us (profiled), device busy "
          f"{busy:.0f} us = {o['busy_share']:.4f}; kernels {o['kernel_us']:.0f} us / "
          f"{o['kernel_n']}, HtoD {o['HtoD_us']:.0f} us / {o['HtoD_n']}, DtoH "
          f"{o['DtoH_us']:.0f} us / {o['DtoH_n']}, other {o['other_us']:.0f} us / "
          f"{o['other_n']}")
    return o


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

    # tools/fitness_design_probe.cu (K5 as it was before its redesign, timed
    # beside K1 / K2 / K5) is compiled beside the port's sources, one nvcc each
    sys.path.insert(0, str(ROOT / "tools"))
    import fitness_design_probe as probe

    t = time.perf_counter()
    probe_build = probe.start_build()
    reports = build.build()
    probe_lib = probe.finish_build(probe_build)
    print(f"[build] {len(reports)} libraries and the probe in {time.perf_counter() - t:.1f}s "
          f"-> {build.BUILD_DIR}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    inputs = main_path_inputs(device)
    errs = check_kernels(inputs, device)
    launches = main_path_runs(device)
    portfolio = portfolio_runs(device)
    memory = memory_path(device)
    torch.cuda.empty_cache()  # the 6.6 GB tree is gone; later timings start clean
    dse = dse_path(device)
    for name, c in dse["cases"].items():
        errs[name] = max(errs[name], c["err"])
    resumed = resume_path(device, dse, portfolio["keys"][f"portfolio {PROBLEM}"])
    serve = serve_path(device, dse)
    for name, e in serve["errs"].items():
        errs[name] = max(errs[name], e)
    timings = kernel_timings(inputs, device, memory["k1_input"], probe_lib)
    dse_shapes = dse_shape_timings(dse["cases"], device)
    sa_shapes = sa_shape_timings(inputs, device, probe_lib)
    floors = floor_timings(device)
    loops = loop_breakdown(device)
    portfolio_timing(portfolio["runs"], device)
    profiled = profile_loops(device)
    profiled.update(profile_fused_calls(inputs, device))

    record = []
    for name, (source, replaces) in KERNELS.items():
        by_path = {"engines": launches[name], "portfolio": portfolio["launches"][name],
                   "memory": memory["launches"][name], "dse": dse["launches"][name],
                   "resume": resumed["launches"][name], "serve": serve["launches"][name]}
        if name == GATHER:
            # at the largest hymba bank; every shape timed is in `timings`
            tm = memory["timings"]["largest hymba bank"]
            record.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=sum(by_path.values()), max_abs_err=memory["max_abs_err"],
                ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
                bound_by=tm["bound_by"], library_ms=tm["library_ms"], floor_ms=floors[name],
                launches_by_path=by_path, call_ms=tm["call_ms"], ops_ms=tm["ops_ms"],
                warm_ms=tm["warm_ms"], shape=tm["shape"],
                max_err_over_tol=memory["max_err_over_tol"], timings=memory["timings"],
            ))
            continue
        tm = timings[name]
        record.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), max_abs_err=errs[name],
            ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
            bound_by=tm["bound_by"], library_ms=None, floor_ms=floors[name],
            launches_by_path=by_path,
            call_ms=tm["call_ms"], ops_ms=tm["ops_ms"], h2d_ms=tm["h2d_ms"],
            h2d_host_ms=tm["h2d_host_ms"], d2h_host_ms=tm["d2h_host_ms"],
            shape=tm["shape"],
            **{k: tm[k] for k in ("ops_turns_ms", "ops_pageable_ms", "ops_cpu_fetch_ms",
                                  "ops_pinned_fetch_ms", "d2h_cpu_ms", "d2h_pinned_ms",
                                  "old_ms", "tables_uncached_ms", "tables_cached_ms",
                                  "planner")
               if k in tm},
            **{k: tm[k] for k in ("separate_ms", "alone_ms") if k in tm},
            **({"shapes": sa_shapes[name]} if name in sa_shapes else {}),
            **({"dse_shape": dse_shapes[name]} if name in dse_shapes else {}),
        ))
    print(f"[loops] {json.dumps(loops)}")
    print(f"[portfolio] {json.dumps(portfolio['runs'])}")
    print(f"[memory] {json.dumps(dict(memory['summary'], profile=memory['profile']))}")
    print(f"[dse] {json.dumps(dict(dse['sweeps'], profile=dse['profile']))}")
    print(f"[resume] {json.dumps(resumed['runs'])}")
    print(f"[serve] {json.dumps(serve['runs'])}")
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
