"""Production-mesh dry run: trace every (arch x shape x mesh) cell on
DTensors over a fake 256 / 512-device mesh (the port of
``repro.launch.dryrun``).

For each cell this shows (a) the sharding plan is coherent on the
production mesh (every operation of the port's own step has a sharding
rule, or an explicit redistribution, for its placements), (b) it fits
(argument, output and peak temporary bytes per device), and records (c)
the roofline terms (per-device FLOPs, bytes and collective bytes from
`launch.op_analysis`).  Results are cached as JSON under
``experiments/dryrun_torch/``.

How a cell is traced (`trace_step`): the parameters, optimizer state,
batch and cache are the stand-ins of `launch.specs`, distributed as the
tables of `sharding.rules` say, as DTensors whose local shards are fake
tensors (``FakeTensorMode``: shapes and dtypes, no memory).  The port's
own ``make_train_step`` / ``make_prefill_step`` / ``make_decode_step``
runs on them under ``implicit_replication()`` (tensors the model makes
itself — rope tables, masks, positions — count as replicated) and under an
`op_analysis.OpCounter`, which counts each rank's local operations.
Serving cells use bf16 parameters, as the reference's do.
``build_inputs(..., fake=False)`` builds the same arguments with seeded
values, so the step can also run for real on a one-card host mesh: that
is how ``chip_smoke.py`` holds the trace's counts to the card.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod] [--force]
      [--jobs N] [--device cpu]

``--device`` is the device type of the stand-ins (default ``cuda``; on a
host without CUDA pass ``cpu``: nothing runs on it either way).  A
process has one default process group, so ``--all`` with ``--jobs N``
runs the cells in N child processes at a time; ``--jobs 1`` runs them in
this process, rebuilding the group when the mesh changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, get_config, shape_cells
from ..models import model as M
from ..models.config import SHAPES, HybridConfig
from ..optim import AdamWConfig
from ..runtime import TrainState, make_decode_step, make_prefill_step, make_train_step
from ..sharding import (
    batch_partition_specs,
    cache_partition_specs,
    opt_partition_specs,
    param_partition_specs,
    to_placements,
)
from .mesh import make_production_mesh, mesh_axes
from .op_analysis import OpCounter, roofline_terms
from .specs import (
    decode_input_specs,
    opt_specs,
    param_specs,
    prefill_batch_specs,
    train_batch_specs,
)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _local_shape(shape, placements, sizes) -> tuple:
    out = list(shape)
    for size, pl in zip(sizes, placements):
        if pl.is_shard():
            out[pl.dim] //= size
    return tuple(out)


def _stand_in(local_shape, dtype, device, fake: bool, gen):
    """One local shard: a fake tensor, or for a real run seeded values
    (integers in [0, 100) for token / target planes, N(0, 0.02) else)."""
    if fake or not dtype.is_floating_point:
        t = torch.zeros(local_shape, dtype=dtype, device=device)
        if not fake:
            t.random_(0, 100, generator=gen)
        return t
    t = torch.empty(local_shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 0.02, generator=gen)
    return t.to(dtype)


def distribute(meta_tree, spec_tree, mesh, device, fake: bool = True, gen=None):
    """DTensors over ``mesh`` with the shapes and dtypes of ``meta_tree``
    and the placements of ``spec_tree``; each local shard is a fresh
    stand-in (see `_stand_in`; under ``FakeTensorMode`` a fake one)."""
    from torch.distributed.tensor import DTensor

    sizes = tuple(mesh_axes(mesh).values())
    placements = to_placements(mesh, spec_tree)

    def make(meta, pl):
        local = _stand_in(_local_shape(meta.shape, pl, sizes), meta.dtype,
                          device, fake, gen)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=meta.shape, stride=meta.stride())

    return M.tree_map(make, meta_tree, placements)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _flat(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree


def serving_config(cfg, shape):
    """Serving cells run bf16 weights (production practice; halves the
    weight-read term that dominates decode), as the reference's do."""
    if shape.kind != "train":
        return dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


def build_inputs(cfg, shape, mesh, device, fake: bool = True, seed: int = 0):
    """``(step, args)`` of one cell: the step function and its DTensor
    arguments over ``mesh``."""
    gen = None
    if not fake:
        gen = torch.Generator(device=device).manual_seed(seed)
    p_meta = param_specs(cfg)
    params = distribute(p_meta, param_partition_specs(cfg, mesh, p_meta), mesh,
                        device, fake, gen)
    specs = (
        {"batch": train_batch_specs(cfg, shape)} if shape.kind == "train"
        else {"batch": prefill_batch_specs(cfg, shape)} if shape.kind == "prefill"
        else decode_input_specs(cfg, shape)
    )
    if shape.kind == "train":
        o_meta = opt_specs(p_meta)
        opt = distribute(o_meta, opt_partition_specs(cfg, mesh, o_meta), mesh,
                         device, fake, gen)
        if not fake:  # AdamW's state starts at zero
            opt = M.tree_map(lambda t: t.zero_(), opt)
        batch = distribute(specs["batch"],
                           batch_partition_specs(cfg, mesh, specs["batch"]),
                           mesh, device, fake, gen)
        return make_train_step(cfg, AdamWConfig()), (TrainState(params, opt), batch)
    if shape.kind == "prefill":
        batch = distribute(specs["batch"],
                           batch_partition_specs(cfg, mesh, specs["batch"]),
                           mesh, device, fake, gen)
        return make_prefill_step(cfg, shape.seq_len), (params, batch)
    c_meta = specs["cache"]
    cache = distribute(c_meta, cache_partition_specs(cfg, mesh, c_meta), mesh,
                       device, fake, gen)
    token = distribute({"t": specs["token"]},
                       batch_partition_specs(cfg, mesh, {"t": specs["token"]}),
                       mesh, device, fake, gen)["t"]
    if not fake:
        cache = M.tree_map(lambda t: t.zero_(), cache)
    # the port's decode_step takes the position as a Python int: the last
    # slot of the cache
    return make_decode_step(cfg), (params, cache, token, shape.seq_len - 1)


def trace_step(cfg, shape, mesh, device=None):
    """Run one cell's step on fake DTensors over ``mesh`` under an
    `OpCounter`.  Returns ``(counter, memory)``; raises what the step
    raises, with ``counter.last_dtensor_op`` naming the operation it was
    in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ..device import resolve_device

    device = resolve_device(device)
    cfg = serving_config(cfg, shape)
    counter = OpCounter()
    # the mesh's own rank tables are real tensors: let them in
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_inputs(cfg, shape, mesh, device)
        arg_bytes = _local_bytes(args)
        try:
            with implicit_replication(), counter:
                out = step(*args)
        except Exception as e:
            e.counter = counter
            raise
        memory = dict(
            argument_bytes=arg_bytes,
            output_bytes=_local_bytes(out),
            temp_bytes=counter.peak_bytes,
        )
        del out, args
    return counter, memory


def trace_cell(arch: str, shape_name: str, multi_pod: bool, device=None):
    """Trace one cell on the production mesh; returns ``(counter, meta)``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_dev = math.prod(mesh_axes(mesh).values())
    t0 = time.perf_counter()
    counter, memory = trace_step(cfg, shape, mesh, device)
    return counter, dict(
        arch=arch, shape=shape_name, multi_pod=multi_pod, n_devices=n_dev,
        kind=shape.kind, trace_s=time.perf_counter() - t0, memory=memory,
    )


def _model_flops(cfg, shape, n_params_total: int, n_params_active: int) -> float:
    """Analytic useful-FLOPs (the 6ND / 2ND accounting), global."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        # encoder runs B*S tokens, decoder B*T tokens; halve params per stack
        n_half = n_params_active / 2
        t = min(448, cfg.max_target_len)
        fwd = 2 * n_half * b * s + 2 * n_half * b * t
        return 3 * fwd if shape.kind == "train" else (
            fwd if shape.kind == "prefill" else 2 * n_half * b
        )
    tokens = b * s
    if shape.kind == "train":
        return 6 * n_params_active * tokens
    if shape.kind == "prefill":
        return 2 * n_params_active * tokens
    return 2 * n_params_active * b  # decode: one token per sequence


def param_counts(cfg) -> tuple[int, int]:
    """(total, active) parameter counts, as the reference's ``analyze``."""
    n_total = int(sum(math.prod(x.shape) for x in M.tree_leaves(param_specs(cfg))))
    expert = (
        cfg.n_layers * cfg.n_experts * (3 if cfg.mlp_gated else 2)
        * cfg.d_model * cfg.d_ff
        if cfg.n_experts
        else 0
    )
    active_expert = (
        cfg.n_layers * cfg.top_k * (3 if cfg.mlp_gated else 2)
        * cfg.d_model * cfg.d_ff * cfg.capacity_factor
        if cfg.n_experts
        else 0
    )
    return n_total, n_total - expert + active_expert


def analyze(counter: OpCounter, meta: dict, cfg=None, shape=None) -> dict:
    cost = counter.cost
    # memory-term estimate: arguments read once + each materialized tensor
    # written once and read once (perfect fusion); cost.bytes is the
    # zero-fusion upper bound.  Real traffic lies between; both are kept.
    arg_bytes = meta["memory"]["argument_bytes"]
    bytes_est = arg_bytes + 2.0 * cost.wbytes
    terms = roofline_terms(cost.flops, bytes_est, cost.coll_bytes,
                           compute_s=cost.compute_seconds())
    out = dict(meta)
    out.update(
        flops_per_device=cost.flops,
        gemm_flops_by_dtype=dict(cost.dot_flops),
        bytes_per_device=bytes_est,
        bytes_upper_bound=cost.bytes,
        bytes_write_once=cost.wbytes,
        collective_operand_bytes=int(cost.coll_bytes),
        collectives_by_op={k: list(v) for k, v in cost.coll_by_op.items()},
        local_ops=counter.n_ops,
        roofline=terms,
    )
    if cfg is not None and shape is not None:
        n_total, n_active = param_counts(cfg)
        mf = _model_flops(cfg, shape, n_total, n_active)
        flops_global = cost.flops * meta["n_devices"]
        out.update(
            n_params=n_total,
            n_params_active=int(n_active),
            model_flops_global=mf,
            useful_flops_ratio=(mf / flops_global) if flops_global else 0.0,
        )
    return out


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> Path:
    return OUT_DIR / f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}.json"


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             device=None) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = cell_path(arch, shape_name, multi_pod)
    if path.exists() and not force:
        return json.loads(path.read_text())
    t0 = time.perf_counter()
    try:
        counter, meta = trace_cell(arch, shape_name, multi_pod, device)
        result = analyze(counter, meta, cfg=get_config(arch), shape=SHAPES[shape_name])
        result["status"] = "ok"
    except Exception as e:  # record failures: they are bugs to fix
        last = getattr(getattr(e, "counter", None), "last_dtensor_op", None)
        result = dict(
            arch=arch, shape=shape_name, multi_pod=multi_pod,
            status="error", error=f"{type(e).__name__}: {e}"[:2000],
            op=None if last is None else last[0],
            placements=None if last is None else last[1],
            shapes=None if last is None else [list(s) for s in last[2]],
            traceback=traceback.format_exc()[-4000:],
        )
    result["wall_s"] = time.perf_counter() - t0
    path.write_text(json.dumps(result, indent=2))
    return result


def _cells(args) -> list[tuple[str, str, bool]]:
    pods = []
    if args.multi_pod or not args.single_pod:
        pods.append(True)
    if args.single_pod or not args.multi_pod:
        pods.insert(0, False)
    # a HybridConfig is one chip's share of a deployment, not a mesh's model
    mesh_archs = [a for a in ARCHS if not isinstance(get_config(a), HybridConfig)]
    archs = mesh_archs if (args.all or not args.arch) else [args.arch]
    cells = []
    for arch in archs:
        shapes = shape_cells(arch) if (args.all or not args.shape) else [args.shape]
        for shape in shapes:
            for mp in pods:
                cells.append((arch, shape, mp))
    return cells


def _run_children(cells, args) -> None:
    """Each cell in a child process of its own, ``args.jobs`` at a time."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    todo = [c for c in cells if args.force or not cell_path(*c).exists()]
    running: list[subprocess.Popen] = []
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, shape, mp = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape, "--multi-pod" if mp else "--single-pod",
                   "--force", "--jobs", "1", "--quiet"]
            if args.device:
                cmd += ["--device", args.device]
            running.append(subprocess.Popen(cmd, env=env))
        time.sleep(0.2)
        running = [p for p in running if p.poll() is None]


def _report(r: dict, mp: bool, dt: float) -> str:
    arch, shape = r["arch"], r["shape"]
    if r.get("status") == "ok":
        t = r["roofline"]
        return (
            f"[OK ] {arch:22s} {shape:12s} pods={2 if mp else 1} "
            f"trace={r['trace_s']:.1f}s "
            f"compute={t['compute_s']:.3e}s mem={t['memory_s']:.3e}s "
            f"coll={t['collective_s']:.3e}s dom={t['dominant']} ({dt:.0f}s)"
        )
    return (f"[FAIL] {arch:22s} {shape:12s} pods={2 if mp else 1}: "
            f"{r.get('op')} {r.get('placements')} {r.get('error', '?')[:160]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device type of the stand-ins (default cuda)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="child processes at a time (default 1: in process)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    cells = _cells(args)
    t_all = time.perf_counter()
    if args.jobs > 1:
        _run_children(cells, args)
    n_ok = 0
    for arch, shape, mp in cells:
        t0 = time.perf_counter()
        r = run_cell(arch, shape, mp, force=args.force and args.jobs <= 1,
                     device=args.device)
        n_ok += r.get("status") == "ok"
        if not args.quiet:
            print(_report(r, mp, time.perf_counter() - t0), flush=True)
    if not args.quiet:
        print(f"{n_ok}/{len(cells)} cells OK ({time.perf_counter() - t_all:.1f}s)")
    return n_ok, len(cells)


if __name__ == "__main__":
    main()
