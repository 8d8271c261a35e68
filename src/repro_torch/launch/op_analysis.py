"""Per-device cost model of a PyTorch step (the port of
``repro.launch.hlo_analysis``).

The reference parses compiled HLO; the port counts the ATen operations a
step dispatches, with a ``TorchDispatchMode`` (`OpCounter`) that sees them
**at the local shards**: on a DTensor operation it returns
``NotImplemented``, so DTensor lowers the operation to local operations on
each rank's shard (and the collectives a redistribution needs), and those
come back through the mode as plain (or fake) tensors.  The counts are
therefore per device, as the reference's ``flops_per_device`` is.  The
operations DTensor runs on global-shape stand-ins to infer an output's
shape are not work and are not counted (`_no_propagation_counts`).

The accounting is the reference's ``HloCostModel``'s:

* a matrix product costs 2 x |result| x |contracted| FLOPs (``mm``,
  ``bmm``, ``addmm`` / ``baddbmm`` plus one FLOP per output element for
  the add, convolutions over their window), charged at the peak of its
  input dtype;
* any other operation costs one FLOP per output element;
* ``bytes`` is operands plus results of every operation (the zero-fusion
  upper bound), ``wbytes`` results only;
* views and metadata operations (and allocations without data) are free;
* collective bytes are the operand bytes of every functional collective,
  by kind (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``broadcast``).

The mode also keeps the live bytes of the tensors it saw created (a view
or an in-place result adds none) and their peak: a step's temporaries.

Constants are an NVIDIA H100 SXM5 80GB HBM3 at 700 W (NVIDIA H100 Tensor
Core GPU datasheet): dense bf16 / fp16 tensor-core peak 989.4e12 FLOP/s;
float32 without TF32 66.9e12 FLOP/s (the port runs with TF32 off for
parity, so a float32 GEMM is charged there, and so is every elementwise
FLOP); HBM3 3.35e12 B/s.  Collectives: the 16-way ``model`` axis spans two
8-GPU NVLink nodes, so a ring over it is held to the slowest hop, the
inter-node link: one 400 Gb/s NDR InfiniBand NIC per GPU (the DGX H100
layout), 50e9 B/s a direction (NVLink 4 gives 450e9 B/s a direction
inside a node).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_BF16 = 989.4e12  # FLOP/s, dense bf16 / fp16 tensor cores
PEAK_FP32 = 66.9e12  # FLOP/s, float32 without TF32
PEAK_FLOPS = {torch.bfloat16: PEAK_BF16, torch.float16: PEAK_BF16}
HBM_BW = 3.35e12  # B/s
LINK_BW = 50e9  # B/s a direction a GPU, inter-node NDR InfiniBand

_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}
_CONV_OPS = {"convolution", "_convolution", "conv1d", "conv2d"}
_FREE_OPS = {
    "detach", "alias", "lift_fresh", "empty", "empty_strided", "empty_like",
    "new_empty", "new_empty_strided", "_unsafe_view", "_reshape_alias",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_local_scalar_dense", "wait_tensor", "set_",
}
_COLLECTIVES = (
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("broadcast", "broadcast"),
)
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0  # zero-fusion upper bound (operands + results)
    wbytes: float = 0.0  # write-once lower bound (results only)
    coll_bytes: float = 0.0
    coll_by_op: dict = field(default_factory=dict)  # kind -> (count, bytes)
    dot_flops: dict = field(default_factory=dict)  # input dtype -> FLOPs

    def compute_seconds(self) -> float:
        """FLOPs over the card's peak: each GEMM at its input dtype's,
        everything else at float32's."""
        dots = sum(self.dot_flops.values())
        s = (self.flops - dots) / PEAK_FP32
        for dt, f in self.dot_flops.items():
            s += f / PEAK_FLOPS.get(_dtype(dt), PEAK_FP32)
        return s


def _dtype(name: str):
    return getattr(torch, name.replace("torch.", ""), None)


def _numel(t) -> int:
    n = 1
    for d in t.shape:
        n *= int(d)
    return n


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _dot_flops(name: str, args) -> int:
    """2 x |result| x |contracted| of one matrix product (plus one FLOP an
    output element for ``addmm`` / ``baddbmm``'s add)."""
    if name in ("mm", "bmm", "mv", "dot"):
        a, b = args[0], args[1]
    else:  # addmm / baddbmm / addmv: (input, a, b)
        a, b = args[1], args[2]
    k = int(a.shape[-1])
    if name in ("mm", "addmm"):
        out = int(a.shape[0]) * int(b.shape[1])
    elif name in ("bmm", "baddbmm"):
        out = int(a.shape[0]) * int(a.shape[1]) * int(b.shape[2])
    elif name in ("mv", "addmv"):
        out = int(a.shape[0])
    else:
        out = 1
    return 2 * out * k + (out if name.startswith("add") else 0)


def _conv_flops(args, out) -> int:
    w = args[1]
    window = 1
    for d in w.shape[1:]:
        window *= int(d)
    return 2 * _numel(out) * window


class _Propagation:
    """Depth of DTensor's shape inference on global-shape stand-ins."""

    depth = 0


@contextlib.contextmanager
def _no_propagation_counts():
    """While active, operations DTensor runs to infer an output's global
    shape are marked, so `OpCounter` does not count them as work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = next(
        (n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
         if hasattr(ShardingPropagator, n)),
        None,
    )
    if name is None:
        raise RuntimeError(
            "this torch's DTensor has no tensor-meta propagation hook to "
            "exclude; per-device counts would include global-shape stand-ins"
        )
    orig = getattr(ShardingPropagator, name)

    def wrapped(self, *a, **k):
        _Propagation.depth += 1
        try:
            return orig(self, *a, **k)
        finally:
            _Propagation.depth -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class OpCounter(TorchDispatchMode):
    """Counts a region's local operations into ``cost`` and tracks the live
    bytes of the tensors they create (``peak_bytes``).  ``last_dtensor_op``
    is the DTensor operation seen last, with its inputs' placements: after
    a failure, the operation that failed."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.n_ops = 0
        self.last_dtensor_op = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_no_propagation_counts())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.last_dtensor_op = (
                str(func),
                [str(tuple(a.placements)) for a in args if isinstance(a, DTensor)],
                [tuple(a.shape) for a in args if isinstance(a, DTensor)],
            )
            return NotImplemented
        out = func(*args, **kwargs)
        if _Propagation.depth == 0:
            self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "prim" or name in _FREE_OPS:
            return
        rets = func._schema.returns
        aliasing = any(r.alias_info is not None for r in rets)
        writes = any(r.alias_info is not None and r.alias_info.is_write for r in rets)
        if aliasing and not writes:
            return  # a view
        outs = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        res_b = sum(_nbytes(t) for t in outs)
        c = self.cost
        self.n_ops += 1
        if ns in _COLLECTIVE_NS:
            kind = next((k for key, k in _COLLECTIVES if name.startswith(key)), name)
            opb = sum(_nbytes(t) for t in ins) or res_b
            c.coll_bytes += opb
            n0, b0 = c.coll_by_op.get(kind, (0, 0))
            c.coll_by_op[kind] = (n0 + 1, b0 + opb)
            c.bytes += opb + res_b
            c.wbytes += res_b
        else:
            if name in _DOT_OPS:
                f = _dot_flops(name, args)
                key = str(args[0 if name in ("mm", "bmm", "mv", "dot") else 1].dtype)
                c.dot_flops[key] = c.dot_flops.get(key, 0) + f
            elif name in _CONV_OPS:
                f = _conv_flops(args, outs[0])
                key = str(args[0].dtype)
                c.dot_flops[key] = c.dot_flops.get(key, 0) + f
            else:
                f = sum(_numel(t) for t in outs)
            c.flops += f
            c.bytes += sum(_nbytes(t) for t in ins) + res_b
            c.wbytes += res_b
        if not aliasing:
            for t in outs:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)


def count_ops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), counter)``: one call under an `OpCounter`."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    compute_s: float | None = None,
) -> dict:
    """The three roofline terms in seconds and the one that bounds the step.
    ``compute_s`` defaults to the FLOPs at the bf16 peak; the dry run
    passes `Cost.compute_seconds`, which charges each GEMM at its dtype."""
    if compute_s is None:
        compute_s = flops_per_device / PEAK_BF16
    terms = {
        "compute_s": compute_s,
        "memory_s": bytes_per_device / HBM_BW,
        "collective_s": collective_bytes_per_device / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms
