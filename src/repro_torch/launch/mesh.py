"""The sweep mesh: a 1-D ``("prob",)`` list of devices (the port's
counterpart of the reference's `repro.launch.mesh.make_sweep_mesh`).

The sweep / portfolio fleet is a problem-major array program whose only
shardable axis is the leading problem (chain, population) row axis, so the
mesh is one-dimensional.  A mesh is a tuple of ``torch.device`` of one
type; the ops layers (`kernels/probshard.py`) split each kernel call's
rows into one contiguous block per mesh device, and the sharded sweep and
portfolio pin their sub-fleets to the devices round-robin.

``SweepMesh([dev] * k)`` may repeat a device: k logical shards of one
device.  That is the port's counterpart of the reference's forced
host-platform devices (``XLA_FLAGS=--xla_force_host_platform_device_count``):
the CPU tests build ``SweepMesh([torch.device("cpu")] * k)``, and a
one-card machine builds ``SweepMesh([cuda:0] * k)``, which runs the
padding, the row split and the per-shard pinning on the card but shows
nothing about scaling across cards.

The reference's ``make_production_mesh`` / ``make_host_mesh`` belong to
its LM stack and are not ported yet.
"""
from __future__ import annotations

import torch


class SweepMesh:
    """A 1-D ``("prob",)`` mesh over ``devices`` (one device type; a device
    may repeat).  A CUDA device without an index takes the current one, so
    staging and launch always name the same card."""

    axis_names = ("prob",)

    def __init__(self, devices):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a sweep mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(
                f"a sweep mesh holds devices of one type, got {[str(d) for d in devs]}"
            )
        self.devices: tuple[torch.device, ...] = tuple(devs)

    @property
    def shape(self) -> dict[str, int]:
        return {"prob": len(self.devices)}

    def __repr__(self) -> str:
        return f"SweepMesh([{', '.join(str(d) for d in self.devices)}])"


def make_sweep_mesh(n_devices: int | None = None, device=None) -> SweepMesh:
    """A mesh over the first ``n_devices`` distinct devices of ``device``'s
    type (``None`` means ``"cuda"``, as every entry point of the port;
    ``n_devices=None`` takes every one present).  Raises ``ValueError`` for
    ``n_devices < 1`` and ``RuntimeError`` when fewer are present; to repeat
    a device, build ``SweepMesh([dev] * k)``."""
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda":
        present = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ] if torch.cuda.is_available() else []
    elif kind == "cpu":
        present = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device type {kind!r}; options: cuda, cpu")
    n_devices = max(len(present), 1) if n_devices is None else int(n_devices)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if len(present) < n_devices:
        raise RuntimeError(
            f"sweep mesh needs {n_devices} distinct {kind} devices but only "
            f"{len(present)} present; build SweepMesh([dev] * {n_devices}) to "
            "run logical shards of one device"
        )
    return SweepMesh(present[:n_devices])
