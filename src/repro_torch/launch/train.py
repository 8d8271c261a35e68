"""End-to-end training launcher (the port of ``repro.launch.train``), with
the reference's flags and one more, ``--device`` (default ``cuda``; no
fallback to the CPU).

Example (CPU, about a minute):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --d-model 128 --layers 4 --steps 50 --batch 4 --seq 256 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import DataConfig, SyntheticTokenPipeline
from ..device import resolve_device
from ..models import model as M
from ..optim import AdamWConfig, adamw_init
from ..runtime import TrainState, make_train_step
from ..runtime.loop import LoopConfig, TrainLoop


def scaled_config(args):
    """The ``--arch`` config at ``--scale`` (smoke / full), with ``--d-model``,
    ``--layers`` and ``--vocab`` overrides where they are non-zero."""
    cfg = get_smoke_config(args.arch) if args.scale == "smoke" else get_config(args.arch)
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.layers:
        overrides["n_layers"] = args.layers
        if cfg.encoder_decoder:
            overrides["n_encoder_layers"] = args.layers
        if cfg.sliding_window:
            overrides["global_layers"] = tuple(
                g for g in cfg.global_layers if g < args.layers
            ) or (0,)
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    return dataclasses.replace(cfg, **overrides)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="bf16 gradient all-reduce compression")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Train ``--steps`` steps (resuming from ``--ckpt-dir`` with
    ``--resume``); returns the loss history of this run's steps."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = resolve_device(args.device)

    cfg = scaled_config(args)
    opt_cfg = AdamWConfig(
        learning_rate=args.lr,
        total_steps=args.steps,
        warmup_steps=max(10, args.steps // 20),
        grad_allreduce_dtype="bfloat16" if args.grad_compress else "float32",
    )
    params = M.init_params(cfg, args.seed, device)
    state = TrainState(params, adamw_init(params))
    n_params = sum(x.numel() for x in M.tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={device}")

    pipeline = SyntheticTokenPipeline(
        DataConfig(
            seq_len=args.seq, global_batch=args.batch,
            vocab_size=cfg.vocab_size, seed=args.seed,
        ),
        device=device,
    )
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=args.accum)

    def make_batch(np_batch):
        return {
            "tokens": torch.as_tensor(np_batch["tokens"], device=device),
            "targets": torch.as_tensor(np_batch["targets"], device=device),
        }

    ckpt = CheckpointManager(args.ckpt_dir, keep_n=3)
    loop = TrainLoop(
        step_fn, pipeline, ckpt,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, log_every=10),
        make_batch=make_batch,
    )
    start = 0
    if args.resume:
        start, state = loop.resume_or_init(state)
    final_step, state, history = loop.run(state, start)
    print(
        f"done at step {final_step}: loss {history[0] if history else float('nan'):.4f}"
        f" -> {history[-1] if history else float('nan'):.4f}"
    )
    return history


if __name__ == "__main__":
    main()
