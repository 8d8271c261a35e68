"""Input stand-ins for every (arch x shape) cell of the dry run (the port
of ``repro.launch.specs``).

Every tensor here lives on the ``meta`` device: shapes and dtypes, never
memory, so the full configurations cost nothing to describe.  The trees
are the reference's ``eval_shape`` trees leaf for leaf (same paths, shapes
and dtypes); `launch.dryrun` turns them into DTensors over the production
mesh.  A decode cell's ``pos`` is a 0-d int32 as in the reference; the
port's ``decode_step`` takes it as a Python int.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.config import SHAPES, ModelConfig, ShapeConfig

WHISPER_DECODER_TRAIN_LEN = 448  # whisper targets are <=448 tokens
WHISPER_DECODER_PROMPT = 8  # decoder prompt tokens at prefill


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        t = min(WHISPER_DECODER_TRAIN_LEN, cfg.max_target_len)
        return {
            "frames": _meta((b, s, cfg.d_model), torch.float32),
            "tokens": _meta((b, t), torch.int32),
            "targets": _meta((b, t), torch.int32),
        }
    if cfg.frontend == "vision_stub":
        p = cfg.num_patches
        return {
            "patches": _meta((b, p, cfg.d_model), torch.float32),
            "tokens": _meta((b, s - p), torch.int32),
            "targets": _meta((b, s), torch.int32),
        }
    return {
        "tokens": _meta((b, s), torch.int32),
        "targets": _meta((b, s), torch.int32),
    }


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    specs = train_batch_specs(cfg, shape)
    specs.pop("targets")
    if cfg.encoder_decoder:
        specs["tokens"] = _meta((b, WHISPER_DECODER_PROMPT), torch.int32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return M.init_meta_cache(cfg, shape.global_batch, shape.seq_len)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {
        "cache": cache_specs(cfg, shape),
        "token": _meta((b,), torch.int32),
        "pos": _meta((), torch.int32),
    }


def param_specs(cfg: ModelConfig) -> dict:
    return M.init_meta_params(cfg)


def opt_specs(params_shape) -> dict:
    from ..optim import adamw_init

    return adamw_init(params_shape)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """All stand-in inputs for one cell: the entry point used by dryrun.py."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    raise ValueError(shape.kind)
