"""Batched decode demo: prefill a batch of prompts, decode N tokens.

The port of ``repro.launch.decode_demo``, with the reference's flags and
one more, ``--device`` (default ``cuda``; no fallback to the CPU).

``--packed`` routes the weights through the paper's memory packer
(`PackedParameterStore`): banks are planned with GA-NFD (on the card, its
fitness runs on the hand-written fitness kernel), materialized on the
device, and the model consumes ``store.unpack()`` views — the packed
parameter path end-to-end with identical outputs.

    PYTHONPATH=src python -m repro_torch.launch.decode_demo --packed
    PYTHONPATH=src python -m repro_torch.launch.decode_demo --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..memory import PackedParameterStore, plan_packing
from ..models import model as M
from ..models.config import HybridConfig
from .train import scaled_config


@dataclasses.dataclass
class DecodeRun:
    """What one run served: the greedy tokens (B, gen_len), each step's
    float32 logits over the vocabulary (gen_len, B, vocab_size) on the
    device, the tree served from (``store.unpack()`` under ``--packed``),
    the tree ``init_params`` drew, the store, and host-clock seconds
    (``init``, ``plan``, ``store``, ``prefill``, ``decode``; the device
    synchronised at the end of each)."""

    tokens: np.ndarray
    logits: torch.Tensor
    params: dict
    tree: dict
    store: PackedParameterStore | None
    seconds: dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_batch(cfg, args, device) -> tuple[dict, int]:
    """The reference's prompts (and stub frames / patches) from
    ``np.random.default_rng(args.seed)``, drawn in its order; returns the
    batch and its cache length."""
    b, p_len = args.batch, args.prompt_len
    cache_len = p_len + args.gen_len
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, p_len)), device=device)
    batch = {"tokens": prompts}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.as_tensor(
            (rng.normal(size=(b, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32),
            device=device,
        )
        cache_len += cfg.num_patches
    if cfg.encoder_decoder:
        batch = {
            "frames": torch.as_tensor(
                (rng.normal(size=(b, p_len, cfg.d_model)) * 0.02).astype(np.float32),
                device=device,
            ),
            "tokens": prompts[:, :4],
        }
    return batch, cache_len


def _synced(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(cfg, params: dict, batch: dict, gen_len: int, cache_len: int):
    """Greedy decoding: one prefill, then ``gen_len - 1`` decode steps.
    Returns (tokens (B, gen_len) int64, logits (gen_len, B, vocab_size)
    float32, prefill seconds, decode seconds)."""
    device = batch["tokens"].device
    t0 = _synced(device)
    cache, logits = M.prefill(cfg, params, batch, cache_len)
    steps = [logits[:, -1, : cfg.vocab_size]]
    tok = steps[-1].argmax(-1)
    out_tokens = [tok]
    t1 = _synced(device)
    pos0 = batch["tokens"].shape[1] + (cfg.num_patches if "patches" in batch else 0)
    for i in range(gen_len - 1):
        cache, logits = M.decode_step(cfg, params, cache, tok, pos0 + i)
        steps.append(logits[:, -1, : cfg.vocab_size])
        tok = steps[-1].argmax(-1)
        out_tokens.append(tok)
    t2 = _synced(device)
    return torch.stack(out_tokens, 1), torch.stack(steps), t1 - t0, t2 - t1


def run(args: argparse.Namespace) -> DecodeRun:
    """What ``main`` does, returning the whole run."""
    device = resolve_device(args.device)
    cfg = scaled_config(args)
    if isinstance(cfg, HybridConfig):
        print(f"{cfg.name}: {cfg.n_layers} layers ({len(cfg.layers_of('mamba'))} Mamba-2, "
              f"{len(cfg.layers_of('attention'))} attention), experts "
              f"{cfg.expert_start}-{cfg.expert_start + cfg.held_experts - 1} of "
              f"{cfg.n_experts} held, top-{cfg.top_k}, vocab {cfg.vocab_size}")
    seconds = {}
    t = time.perf_counter()
    tree = params = M.init_params(cfg, args.seed, device=device)
    seconds["init"] = _synced(device) - t

    store = None
    if args.packed:
        t = time.perf_counter()
        plans = plan_packing(params, max_seconds=3.0, split_stacked=True, device=device)
        seconds["plan"] = time.perf_counter() - t
        t = time.perf_counter()
        store = PackedParameterStore(params, plans)
        seconds["store"] = _synced(device) - t
        for isz, s in store.stats().items():
            print(
                f"packed itemsize={isz}: {s['packed_tensors']} tensors in "
                f"{s['banks']} banks, eff {s['efficiency_before']:.3f} -> "
                f"{s['efficiency_after']:.3f} (saved {s['saved_bytes']} bytes)"
            )
        params = store.unpack()

    batch, cache_len = make_batch(cfg, args, device)
    tokens, logits, seconds["prefill"], seconds["decode"] = generate(
        cfg, params, batch, args.gen_len, cache_len
    )
    b, g_len = args.batch, args.gen_len
    dt = seconds["prefill"] + seconds["decode"]
    gen = tokens.cpu().numpy()
    prompt_tokens = b * (batch["tokens"].shape[1] + (cfg.num_patches if "patches" in batch else 0))
    print(f"generated {gen.shape} in {dt:.2f}s ({b * g_len / dt:.1f} tok/s)")
    print(f"prefill {prompt_tokens} tokens in {seconds['prefill']:.4f}s "
          f"({prompt_tokens / seconds['prefill']:.1f} tok/s); decode {b * (g_len - 1)} "
          f"tokens in {seconds['decode']:.4f}s "
          f"({b * (g_len - 1) / max(seconds['decode'], 1e-12):.1f} tok/s) on {device}")
    print("first row:", gen[0][:12], "...")
    return DecodeRun(tokens=gen, logits=logits, params=params, tree=tree, store=store,
                     seconds=seconds)


def main(argv=None):
    return run(parse_args(argv)).tokens


if __name__ == "__main__":
    main()
