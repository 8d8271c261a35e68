"""CUDA wrapper for the packed-bank segment matvec K6.

``packed_gather_cuda`` replaces ``packed_gather_matvec``
(``repro.kernels.packed_gather.kernel``); the source is
``kernels/csrc/packed_gather.cu``.  It takes the reference's block-spec
contract and raises on anything else: a contiguous float32 (R, C) bank with
R % 8 == 0 and C % 128 == 0, (N, C) float32 activations, (R,) int32
segment ids, all on one device.  A CUDA tensor launches the kernel (or
raises); a CPU tensor, and only a CPU tensor, takes the plain version in
``ref.py``.  The wrapper counts its launches
(`build.count_launch`, read with `kernels.launch_counts`).
"""
from __future__ import annotations

import torch

from ..build import count_launch, launch, load
from .ref import packed_gather_ref

ROW_TILE = 8  # rows per block, the reference's fp32 sublane tile
LANE_TILE = 128
_I32_MAX = 2**31 - 1


def _check(bank, x, seg) -> torch.device:
    for name, t in (("bank", bank), ("x", x), ("seg", seg)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"packed_gather: {name} must be a torch tensor, "
                            f"got {type(t).__name__}")
    if bank.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"packed_gather: bank and x must be float32, got "
                        f"{bank.dtype} and {x.dtype}")
    if seg.dtype != torch.int32:
        raise TypeError(f"packed_gather: seg must be int32, got {seg.dtype}")
    if bank.dim() != 2 or x.dim() != 2 or seg.dim() != 1:
        raise ValueError(f"packed_gather: expected bank (R, C), x (N, C), seg (R,), got "
                         f"{tuple(bank.shape)}, {tuple(x.shape)}, {tuple(seg.shape)}")
    r, c = bank.shape
    if x.shape[1] != c or seg.shape[0] != r:
        raise ValueError(f"packed_gather: expected bank (R, C), x (N, C), seg (R,), got "
                         f"{tuple(bank.shape)}, {tuple(x.shape)}, {tuple(seg.shape)}")
    if r % ROW_TILE or c % LANE_TILE:
        raise ValueError(f"packed_gather: bank {tuple(bank.shape)} needs R % {ROW_TILE} "
                         f"== 0 and C % {LANE_TILE} == 0")
    if max(r, c, x.shape[0]) > _I32_MAX:
        raise ValueError("packed_gather: dimension exceeds int32")
    if not (bank.device == x.device == seg.device) or bank.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed_gather: tensors must share one cpu or cuda device, got "
                         f"{bank.device}, {x.device}, {seg.device}")
    for name, t in (("bank", bank), ("x", x), ("seg", seg)):
        if not t.is_contiguous():
            raise ValueError(f"packed_gather: {name} must be contiguous")
    # rows are read as float4: 16-byte aligned bases (C % 128 keeps every row so)
    if bank.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("packed_gather: bank and x must start on a 16-byte boundary")
    return bank.device


def packed_gather_cuda(bank, x, seg) -> torch.Tensor:
    """K6: ``y[r] = sum_c bank[r, c] * x[seg[r], c]`` as (R,) float32, 0
    where ``seg[r]`` is outside ``[0, N)``."""
    device = _check(bank, x, seg)
    if device.type == "cpu":
        return packed_gather_ref(bank, x, seg)
    r, c = bank.shape
    out = torch.empty(r, dtype=torch.float32, device=device)
    if r == 0:
        return out
    lib = load("packed_gather")
    launch(device, lib.packed_gather_launch, bank.data_ptr(), x.data_ptr(),
           seg.data_ptr(), out.data_ptr(), r, c, x.shape[0])
    count_launch(packed_gather_cuda)
    return out
