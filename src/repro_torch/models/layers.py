"""Shared NN building blocks (plain PyTorch, explicit parameter trees).

The port of ``repro.models.layers``: the same functions over nested dicts
of tensors.  Initialisers draw from an explicit ``torch.Generator`` on the
target device (``None`` on the ``meta`` device, where only shapes exist);
parity with the reference never rests on them, it rests on weights carried
across (`repro_torch.convert.params_from_arrays`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .redistribute import matmul_local


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``, ``"bfloat16"``)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def truncated_normal_init(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale / sqrt(fan_in)``
    (fan_in = ``shape[0]`` for 2-D and wider), as the reference draws it."""
    stddev = scale / np.sqrt(max(1, shape[0] if len(shape) >= 2 else 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(float(stddev))
    return t.to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, bias: bool = False) -> dict:
    p = {"kernel": truncated_normal_init(gen, (d_in, d_out), 1.0, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = matmul_local(x.to(compute_dtype), params["kernel"].to(compute_dtype))
    if "bias" in params:
        y = y + params["bias"].to(compute_dtype)
    return y


def norm_init(cfg: ModelConfig, d: int, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm / LayerNorm in fp32 accumulation, output in x.dtype."""
    dt = x.dtype
    x32 = x.float()
    if cfg.norm == "layernorm":
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float()
    return y.to(dt)


def head_rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head qk-norm (Qwen3): RMS over d_head."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(dt)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


# ----------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq).  The frequencies
    are `rope_freqs` computed on x's device (float64, then float32), so no
    host-to-device copy waits on the stream."""
    d_head = x.shape[-1]
    exps = torch.arange(0, d_head, 2, dtype=torch.float64, device=x.device) / d_head
    freqs = (1.0 / theta**exps).float()
    angles = positions[..., :, None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- dense MLP
def mlp_init(cfg: ModelConfig, gen, dtype, device) -> dict:
    p = {
        "up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device, cfg.mlp_bias),
        "down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype, device, cfg.mlp_bias),
    }
    if cfg.mlp_gated:
        p["gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, dtype, device, cfg.mlp_bias)
    return p


def mlp_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    up = dense(params["up"], x, compute_dtype)
    if cfg.mlp_gated:
        gate = activation(cfg.mlp_act, dense(params["gate"], x, compute_dtype))
        h = gate * up
    else:
        h = activation(cfg.mlp_act, up)
    return dense(params["down"], h, compute_dtype)
