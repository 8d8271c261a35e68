"""Partition-spec rule tables: parameters, optimizer state, inputs, caches
(the port of ``repro.sharding.rules``).

A spec is a per-dimension tuple of mesh-axis entries, as a JAX
``PartitionSpec`` is: ``None`` (replicated), one axis name, or a tuple of
axis names in mesh order (the dimension split over their product).  The
tables are the reference's, entry for entry; `to_placements` turns a spec
tree into DTensor placements (one per mesh dimension), where the reference
builds ``NamedSharding``s.  ``mesh`` is a ``DeviceMesh`` or a mapping of
axis name to size in mesh order.

Conventions:

* ``data`` (+ ``pod`` when present) — batch / token parallelism (DP).
* ``model`` — tensor parallelism: attention heads & d_ff & vocab; expert
  parallelism for MoE (expert dim); SSM inner channels.
* KV caches: batch over DP; heads over ``model`` when divisible, otherwise
  the cache *sequence* dim shards over ``model`` (ring-style decode reads).
* long_500k (batch=1): DP axes are idle for activations; caches/states shard
  over sequence/heads as available.

DTensor shards only evenly, so `param_partition_specs`' ``guard`` drops
any axis whose size does not divide its dimension (the reference's guard,
which XLA needs at the jit boundary too).  The sweep axis ``prob`` is not
here: `kernels.probshard.row_shard` states that rule.
"""
from __future__ import annotations

from collections.abc import Mapping

from ..models.config import ModelConfig

Spec = tuple  # per-dimension entries: None | axis name | tuple of names


def _axes(mesh) -> dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    names = _axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _dp_size(mesh) -> int:
    sizes = _axes(mesh)
    out = 1
    for a in dp_axes(mesh):
        out *= sizes[a]
    return out


def _model_size(mesh) -> int:
    return _axes(mesh).get("model", 1)


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over nested dicts; paths join keys with ``/``."""
    if isinstance(tree, dict):
        return {
            k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
            for k, v in tree.items()
        }
    return fn(path, tree)


def _none(ndim: int) -> Spec:
    return (None,) * ndim


# ------------------------------------------------------------------- params
def _param_spec(cfg: ModelConfig, path: str, ndim: int) -> Spec:
    """Spec for one (unstacked) parameter identified by its tree path."""
    leaf = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    if path == "embed":
        return ("model", None)  # vocab-sharded
    if parent == "lm_head":
        return (None, "model")
    if path in ("dec_pos",):
        return (None, None)
    # attention projections
    if parent in ("q", "k", "v"):
        return (None, "model") if leaf == "kernel" else ("model",)
    if parent == "o":
        return ("model", None) if leaf == "kernel" else (None,)
    # MLP
    if parent in ("up", "gate"):
        return (None, "model") if leaf == "kernel" else ("model",)
    if parent == "down":
        return ("model", None) if leaf == "kernel" else (None,)
    # MoE expert-parallel tables (E, d, f) / router
    if leaf == "router":
        return (None, None)
    if leaf in ("up", "gate", "down") and ndim == 3:
        return ("model", None, None)
    # SSM mixer (per-stream projections: shard-aligned TP)
    if parent in ("in_proj", "z_proj", "x_proj", "b_proj", "c_proj", "dt_proj"):
        return (None, "model") if leaf == "kernel" else ("model",)
    if parent == "out_proj":
        return ("model", None) if leaf == "kernel" else (None,)
    if leaf in ("conv", "conv_x", "conv_b", "conv_c"):
        return (None, "model")
    if leaf in ("conv_bias", "conv_x_bias", "conv_b_bias", "conv_c_bias",
                "a_log", "dt_bias", "d_skip", "norm_scale"):
        return ("model",)
    # norms, qk-norm scales, branch norms, everything small: replicate
    return _none(ndim)


def param_partition_specs(cfg: ModelConfig, mesh, params_shape) -> dict:
    """Spec tree matching a (meta) parameter tree.

    Leaves under stacked layer collections get a leading None for the layer
    dim.  MoE 3-D expert tables keep their own rule (detected by ndim).
    """
    sizes = _axes(mesh)

    def guard(spec: Spec, shape) -> Spec:
        """Drop axis assignments whose mesh size does not divide the dim
        (e.g. hymba's fused SSM in_proj width 6482 is not divisible by 16 —
        replicated)."""
        fixed = []
        for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
            if ax is None:
                fixed.append(None)
                continue
            size = 1
            for a in ax if isinstance(ax, tuple) else (ax,):
                size *= sizes.get(a, 1)
            fixed.append(ax if dim % size == 0 else None)
        return tuple(fixed)

    def spec_for(path, leaf):
        stacked = path.startswith(("layers/", "enc_layers/"))
        rel = path.split("/", 1)[1] if stacked else path
        ndim = leaf.dim() - (1 if stacked else 0)
        spec = _param_spec(cfg, rel, ndim)
        if stacked:
            spec = (None, *spec)
        return guard(spec, tuple(leaf.shape))

    return _map_with_path(spec_for, params_shape)


def opt_partition_specs(cfg: ModelConfig, mesh, opt_shape) -> dict:
    """Optimizer state: m/v mirror params; step is replicated."""
    return {
        "m": param_partition_specs(cfg, mesh, opt_shape["m"]),
        "v": param_partition_specs(cfg, mesh, opt_shape["v"]),
        "step": (),
    }


# ------------------------------------------------------------------- inputs
def batch_partition_specs(cfg: ModelConfig, mesh, batch_shape: dict) -> dict:
    dp = dp_axes(mesh)

    def spec_for(path, leaf):
        b = leaf.shape[0]
        batch_ax = dp if b % _dp_size(mesh) == 0 else ()
        return (batch_ax if batch_ax else None, *_none(leaf.dim() - 1))

    return _map_with_path(spec_for, batch_shape)


# ------------------------------------------------------------------- caches
def cache_partition_specs(cfg: ModelConfig, mesh, cache_shape: dict) -> dict:
    dp = dp_axes(mesh)
    msize = _model_size(mesh)
    names = _axes(mesh)

    def spec_for(path, leaf):
        leafname = path.split("/")[-1]
        if leafname in ("k", "v", "cross_k", "cross_v"):
            layers, b, t, hkv, dh = leaf.shape
            batch_ax = dp if b % _dp_size(mesh) == 0 else None
            if hkv % msize == 0:
                return (None, batch_ax, None, "model", None)
            if batch_ax is None:
                # long-context single sequence: shard seq over everything
                seq = ("data", "model") if "data" in names else "model"
                return (None, None, seq, None, None)
            return (None, batch_ax, "model", None, None)  # ring over seq
        if path.endswith("ssm/state"):
            layers, b, h, p_, n = leaf.shape
            batch_ax = dp if b % _dp_size(mesh) == 0 else None
            head_ax = "model" if h % msize == 0 else None
            return (None, batch_ax, head_ax, None, None)
        if path.endswith("ssm/conv"):
            layers, b, k, c = leaf.shape
            batch_ax = dp if b % _dp_size(mesh) == 0 else None
            ch_ax = "model" if c % msize == 0 else None
            return (None, batch_ax, None, ch_ax)
        return _none(leaf.dim())

    return _map_with_path(spec_for, cache_shape)


# --------------------------------------------------------------- placements
def spec_placements(mesh, spec: Spec) -> list:
    """DTensor placements (one per mesh dimension) of one spec: a mesh axis
    named by tensor dim ``d``'s entry is ``Shard(d)``, every other mesh
    axis ``Replicate()``.  A dim split over several axes is sharded over
    them in mesh order, as a ``PartitionSpec`` tuple is."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_axes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in entry if isinstance(entry, tuple) else (entry,):
            out[names.index(a)] = Shard(d)
    return out


def to_placements(mesh, spec_tree):
    """`spec_placements` over a spec tree (the reference's ``to_named``)."""
    return _map_with_path(lambda _, s: spec_placements(mesh, s), spec_tree)
