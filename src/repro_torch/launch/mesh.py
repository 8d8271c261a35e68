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

The LM meshes (the reference's ``make_production_mesh`` /
``make_host_mesh``) are ``torch.distributed.DeviceMesh``es with the
reference's shapes and axis names.  The production meshes, ``(16, 16)``
``("data", "model")`` and ``(2, 16, 16)`` ``("pod", "data", "model")``,
stand over the "fake" process-group backend: one process plays rank 0 of
256 or 512, every collective returns at once, and the dry run
(`launch.dryrun`) traces a step on DTensors over it under
``FakeTensorMode``.  A 256-GPU mesh exists on one H100 only so.  The host
mesh is ``(1, 1)`` over a real one-rank group (``nccl`` on the card,
``gloo`` on the CPU), so a step traced on it can also run for real.

A process has one default process group, so each constructor tears the
current one down when it needs another world (another backend or size):
a mesh from an earlier call is dead after that.  ``launch.dryrun --all``
runs its cells in child processes, one world each.
"""
from __future__ import annotations

import math

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


_PROD_SHAPE = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_device_type(device) -> str:
    from ..device import resolve_device

    return resolve_device(device).type


def _ensure_world(backend: str, world_size: int) -> None:
    """The default process group as ``backend`` over ``world_size`` ranks
    with this process as rank 0; an existing group of another kind is
    destroyed first."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() == backend and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world_size)


def make_fake_mesh(shape, axes, device=None):
    """A ``shape`` mesh named ``axes`` over the fake backend (this process
    is rank 0 of ``prod(shape)``; nothing is sent anywhere).  ``device``
    names the tensors' device type (``None`` means ``"cuda"`` and raises
    where CUDA is not available)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = _mesh_device_type(device)
    _ensure_world("fake", math.prod(shape))
    return init_device_mesh(dev_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, device=None):
    """The 256-device ``(16, 16)`` ``("data", "model")`` mesh, or with
    ``multi_pod`` the 512-device ``(2, 16, 16)`` ``("pod", "data",
    "model")`` one, over the fake backend (see `make_fake_mesh`)."""
    shape, axes = _PROD_SHAPE[bool(multi_pod)]
    return make_fake_mesh(shape, axes, device)


def make_host_mesh(device=None):
    """A ``(1, 1)`` ``("data", "model")`` mesh over a real one-rank group
    on ``device`` (``None`` means ``"cuda"``: the one card)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = _mesh_device_type(device)
    _ensure_world("nccl" if dev_type == "cuda" else "gloo", 1)
    return init_device_mesh(dev_type, (1, 1), mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a device mesh, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
