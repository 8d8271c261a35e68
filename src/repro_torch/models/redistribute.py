"""Explicit DTensor redistributions of the model code: the port's
counterparts of the reference's GSPMD sharding constraints, and the other
places where DTensor has no sharding rule for the layout a step reaches.

Every function here redistributes a ``torch.distributed.tensor.DTensor``
(the production-mesh dry run, `launch.dryrun`, runs the model on them) and
returns a plain tensor unchanged, so the serving and training paths, and
their parity with the reference, never see them.  Where each is called:

* `seq_shard` / `replicate_dims` — attention's projections under
  ``cfg.attn_seq_shard`` (the reference's ``_seq_shard`` /
  ``_replicate_dims``): q sharded on sequence, K/V replicated over the
  model axis, before the heads are split;
* `shard_local` — the attention core (full-sequence and decode, unless
  the cache is sharded on its sequence): each rank's batch, sequence and
  head shard run on their own;
* `matmul_local` — `layers.dense`'s product, per rank in the tensor-
  parallel layout its kernel's placements give: column-parallel (the
  input whole on its features, the output sharded on them),
  row-parallel (the input sharded on its features, the output a partial
  sum), or replicated; the batch keeps its shards, the sequence is whole;
* `replicate_partial` — pending partial sums resolved where DTensor
  cannot take them further (after the vocab-sharded lookups below);
* `logits_local` — the logits product, per rank on its batch and vocab
  shards;
* `embed_lookup`, `logsumexp_last`, `gather_last` — the vocab-sharded
  embedding lookup and the loss's log-partition and gold logit, taken
  shard-wise (masked per shard, reduced over the shards) where DTensor's
  own rules would gather the vocab;
* `ssd_local` — Mamba2's SSD scan, per rank on its sequences and heads
  (heads replicated where their count does not divide the model axis:
  hymba's 50); `fit_split` — the SSM decode step's heads and MoE's token
  groups, before they are split off a sharded dim;
* `router_local` / `expert_local` — MoE's router (per token group) and
  expert FFN (expert-parallel: each rank's experts on its token groups);
  `pin_batch` — MoE's input and output, batch-sharded both ways;
* `pad_local` — every ``F.pad`` of the model (the KV blocks, the prefill
  cache, the SSM conv and chunks, MoE's groups), per rank with the padded
  dims whole;
* `write_slot` — the decode step's stacked K/V cache write, by the rank
  that holds the slot.

The shard-local regions (`shard_local`, `matmul_local`, `ssd_local`,
`logits_local`, `router_local`, `expert_local`, `gather_last`,
`pad_local`, `pin_batch`) run the port's own code on each rank's local
tensors.  An input replicated over a mesh axis that splits the region's
work gets its gradient back as a partial sum over that axis
(``to_local(grad_placements=...)``), so the backward's reductions are
DTensor's to insert, as they would be outside the region.
"""
from __future__ import annotations

import torch


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _redistributed(x, placements_of):
    """``x`` redistributed to ``placements_of(mesh names, sizes,
    placements)`` when it is a DTensor and they differ; anything else as it
    is."""
    if not _is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = placements_of(names, tuple(mesh.mesh.shape), list(x.placements))
    if pl == list(x.placements):
        return x
    return x.redistribute(mesh, pl)


def _contiguous(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def _run_local(fn, mesh, args, placements, out_placements):
    """``fn`` on the local shards of ``args`` redistributed to
    ``placements`` (None: a plain argument, passed as it is); each output
    wrapped as a DTensor with its ``out_placements``.  An argument's
    gradient is a partial sum over every mesh axis that shards some other
    argument but replicates it."""
    from torch.distributed.tensor import DTensor, Partial

    work = {i for pl in placements if pl for i, p in enumerate(pl) if p.is_shard()}
    local_args = []
    for x, pl in zip(args, placements):
        if pl is None or not isinstance(x, DTensor):
            local_args.append(x)
            continue
        grad_pl = [Partial() if not p.is_shard() and i in work else p
                   for i, p in enumerate(pl)]
        local_args.append(x.redistribute(mesh, pl).to_local(grad_placements=grad_pl))
    outs = fn(*local_args)
    single = not isinstance(outs, tuple)
    sizes = tuple(mesh.mesh.shape)
    wrapped = []
    for out, pl in zip((outs,) if single else outs, (out_placements,) if single
                       else out_placements):
        shape = list(out.shape)
        for size, p in zip(sizes, pl):
            if p.is_shard():
                shape[p.dim] *= size
        wrapped.append(DTensor.from_local(
            out.contiguous(), mesh, pl, run_check=False,
            shape=torch.Size(shape), stride=_contiguous(shape)))
    return wrapped[0] if single else tuple(wrapped)


# ------------------------------------------------ redistributions in place
def seq_shard(x, axis: int):
    """Sequence-parallel redistribution: shard dim ``axis`` over the
    ``model`` mesh axis, leaving the other mesh axes as they are.  A no-op
    on plain tensors, off a mesh with a ``model`` axis, or when the dim
    does not divide."""
    from torch.distributed.tensor import Shard

    def to(names, sizes, pl):
        if "model" not in names:
            return pl
        i = names.index("model")
        if x.shape[axis] % sizes[i]:
            return pl
        pl[i] = Shard(axis % x.dim())
        return pl

    return _redistributed(x, to)


def replicate_dims(x, axes):
    """Replicate dims ``axes`` over every mesh axis that shards them (a
    no-op on plain tensors)."""
    from torch.distributed.tensor import Replicate

    dims = {a % x.dim() for a in axes}

    def to(names, sizes, pl):
        return [Replicate() if p.is_shard() and p.dim in dims else p for p in pl]

    return _redistributed(x, to)


def replicate_partial(x):
    """Resolve a DTensor's pending partial sums (``Partial`` placements,
    such as a gather over a sharded dim leaves) to ``Replicate``."""
    from torch.distributed.tensor import Replicate

    def to(names, sizes, pl):
        return [Replicate() if p.is_partial() else p for p in pl]

    return _redistributed(x, to)


def fit_split(x, dim: int, parts: int):
    """Replicate dim ``dim`` over every mesh axis that shards it but does
    not divide ``parts``, so splitting it into ``parts`` (heads, token
    groups) stays even."""
    from torch.distributed.tensor import Replicate

    d = dim % x.dim()

    def to(names, sizes, pl):
        return [Replicate() if p.is_shard() and p.dim == d and parts % size else p
                for p, size in zip(pl, sizes)]

    return _redistributed(x, to)


def seq_sharded(x) -> bool:
    """Whether ``x`` is a DTensor sharded on its dim 1 (a sequence)."""
    return _is_dtensor(x) and any(p.is_shard() and p.dim == 1 for p in x.placements)


def pad_local(x, pad, value=0.0):
    """``F.pad(x, pad, value=value)``; on a DTensor the padded dims are
    replicated and each rank pads its shard (DTensor's own pad rule fails
    on some torch versions: 2.11's loses a placement)."""
    from torch.distributed.tensor import Replicate

    f = torch.nn.functional.pad
    if not _is_dtensor(x):
        return f(x, pad, value=value)
    dims = {x.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    pl = [Replicate() if p.is_shard() and p.dim in dims else p for p in x.placements]
    pl = [Replicate() if p.is_partial() else p for p in pl]
    return _run_local(lambda t: f(t, pad, value=value), x.device_mesh, (x,), [pl], pl)


def write_slot(dst, dim: int, at: int, src) -> None:
    """``dst[..., at:at + 1, ...] = src`` on dim ``dim``, in place; on a
    DTensor ``dst`` (a cache sharded on its sequence) only the rank whose
    shard holds slot ``at`` writes, into its local shard, instead of
    DTensor gathering the whole cache for the slice.  (A dry run counts
    rank 0's share: the write where rank 0 holds the slot.)"""
    from torch.distributed.tensor import Replicate

    idx = (slice(None),) * dim + (slice(at, at + 1),)
    if not _is_dtensor(dst):
        dst[idx] = src
        return
    mesh = dst.device_mesh
    s_pl = [Replicate() if p.is_shard() and p.dim == dim else p for p in dst.placements]
    src_l = src.redistribute(mesh, s_pl).to_local() if _is_dtensor(src) else src
    dl = dst.to_local()
    lo, width = 0, dst.shape[dim]
    for i, p in enumerate(dst.placements):
        if p.is_shard() and p.dim == dim:
            width //= mesh.mesh.shape[i]
            lo += mesh.get_coordinate()[i] * width
    if lo <= at < lo + width:
        dl[(slice(None),) * dim + (slice(at - lo, at - lo + 1),)] = src_l


# ------------------------------------------------------ shard-local regions
def shard_local(core, q, kvs, q_pos):
    """``core(q, *kvs, q_pos, q_offset)`` — an attention core — run on
    each rank's shard when ``q`` is a DTensor.

    ``q`` keeps its batch (dim 0), sequence (dim 1) and KV-head (dim 2)
    shards; the K/V-shaped tensors ``kvs`` take the same batch and head
    shards and are replicated wherever ``q`` is sharded on sequence (the
    SP layout of attention's projections).  Each rank runs the port's own
    core on its shard with its slice of the query positions (DTensor's
    batched-matmul rule has no strided shard, which the core's einsums
    make of a sharded sequence or head dim).  A plain ``q`` runs the core
    as it is."""
    from torch.distributed.tensor import Replicate

    if not _is_dtensor(q):
        return core(q, *kvs, q_pos, 0)
    mesh = q.device_mesh
    q_pl = [p if p.is_shard() and p.dim in (0, 1, 2) else Replicate()
            for p in q.placements]
    seq_dims = [i for i, p in enumerate(q_pl) if p.is_shard() and p.dim == 1]
    for i in seq_dims[1:]:  # one mesh axis at most on the sequence
        q_pl[i] = Replicate()
    kv_pl = [p if p.is_shard() and p.dim in (0, 2) else Replicate() for p in q_pl]
    s_local = q.shape[1] // (mesh.mesh.shape[seq_dims[0]] if seq_dims else 1)
    offset = mesh.get_coordinate()[seq_dims[0]] * s_local if seq_dims else 0
    pos = q_pos.full_tensor() if _is_dtensor(q_pos) else q_pos
    if pos.dim():
        pos = pos[offset:offset + s_local]

    def run(ql, *kl):
        return core(ql, *kl, pos, offset)

    return _run_local(run, mesh, (q, *kvs), [q_pl] + [kv_pl] * len(kvs), q_pl)


def ssd_local(core, xs, bmat, cmat, dt, head_vecs):
    """``core(xs, bmat, cmat, dt, *head_vecs)`` — Mamba2's SSD scan over
    (B, S, H*P) inputs, (B, S, N) B / C streams, (B, S, H) steps and (H,)
    per-head vectors, returning y (B, S, H*P) and the final (B, H, P, N)
    state — run on each rank's shard when ``xs`` is a DTensor.

    The scan is independent per sequence and per head, so the batch keeps
    its shards and the heads keep theirs (``xs``'s feature shard, when the
    head count divides it; replicated otherwise); B / C and the sequence
    are replicated.  A plain ``xs`` runs the core as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dtensor(xs):
        return core(xs, bmat, cmat, dt, *head_vecs)
    mesh = xs.device_mesh
    sizes = tuple(mesh.mesh.shape)
    n_heads = dt.shape[-1]
    batch = [p.is_shard() and p.dim == 0 for p in xs.placements]
    heads = [p.is_shard() and p.dim == 2 and n_heads % size == 0
             for p, size in zip(xs.placements, sizes)]

    def pl(head_dim):
        return [Shard(0) if b else Shard(head_dim) if h and head_dim is not None
                else Replicate() for b, h in zip(batch, heads)]

    vec_pl = [Shard(0) if h else Replicate() for h in heads]
    args = (xs, bmat, cmat, dt, *head_vecs)
    in_pl = [pl(2), pl(None), pl(None), pl(2)] + [vec_pl] * len(head_vecs)
    return _run_local(core, mesh, args, in_pl, (pl(2), pl(1)))


def matmul_local(x, w):
    """``torch.matmul(x, w)`` of (..., K) activations and a (K, N) kernel;
    on DTensors, per rank in the layout ``w``'s placements give: on a mesh
    axis that shards ``w``'s rows the input is sharded on K and the output
    is a partial sum, on one that shards its columns the input is whole
    and the output sharded on N; elsewhere the input keeps its batch
    (dim 0) shard.  The sequence dims are whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not (_is_dtensor(x) or _is_dtensor(w)):
        return torch.matmul(x, w)
    mesh = (x if _is_dtensor(x) else w).device_mesh
    n = len(mesh.mesh.shape)
    w_pl = list(w.placements) if _is_dtensor(w) else [Replicate()] * n
    x_in = list(x.placements) if _is_dtensor(x) else [Replicate()] * n
    last = x.dim() - 1
    x_pl, out_pl = [], []
    for xp, wp in zip(x_in, w_pl):
        if wp == Shard(0):
            x_pl.append(Shard(last))
            out_pl.append(Partial())
        elif wp == Shard(1):
            x_pl.append(Replicate())
            out_pl.append(Shard(last))
        elif xp == Shard(0):
            x_pl.append(xp)
            out_pl.append(xp)
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
    w_arg = w if _is_dtensor(w) else None
    return _run_local(torch.matmul, mesh, (x, w),
                      [x_pl, w_pl if w_arg is not None else None], out_pl)


def logits_local(fn, h, w, vocab_dim: int):
    """``fn(h, w)`` — the logits of (B, S, D) hidden states against a
    vocab-by-feature table ``w`` whose vocab is dim ``vocab_dim`` — run per
    rank on its batch and vocab shards when ``h`` is a DTensor; the output
    (B, S, V) is sharded as those are."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dtensor(h):
        return fn(h, w)
    mesh = h.device_mesh
    h_pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in h.placements]
    w_pl = [Replicate()] * len(h_pl)
    if _is_dtensor(w):
        w_pl = [Shard(vocab_dim) if p == Shard(vocab_dim) and hp == Replicate() else Replicate()
                for p, hp in zip(w.placements, h_pl)]
    out_pl = [Shard(2) if wp.is_shard() else hp for hp, wp in zip(h_pl, w_pl)]
    return _run_local(fn, mesh, (h, w), [h_pl, w_pl], out_pl)


def pin_batch(x):
    """``x`` with its batch (dim 0) shards only — whole on every other dim,
    partial sums resolved — and its gradient pinned to the same layout (a
    region of its own), so a reshape that merges the batch with the next
    dim sees a plain shard in both directions."""
    from torch.distributed.tensor import Replicate

    if not _is_dtensor(x):
        return x
    pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in x.placements]
    return _run_local(lambda t: t, x.device_mesh, (x,), [pl], pl)


def router_local(fn, xg, router):
    """``fn(xg, router)`` — MoE router logits over (G, g, d) token groups
    with a replicated (d, e) router — run per rank on its token groups
    when ``xg`` is a DTensor."""
    from torch.distributed.tensor import Replicate

    if not _is_dtensor(xg):
        return fn(xg, router)
    mesh = xg.device_mesh
    x_pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in xg.placements]
    r_pl = [Replicate()] * len(x_pl)
    return _run_local(fn, mesh, (xg, router), [x_pl, r_pl], x_pl)


def expert_local(fn, x, tables):
    """``fn(x, *tables)`` — the experts' FFN over ``x`` (G, e, c, d) with
    expert-major tables (e, ...) — run on each rank's shard when ``x`` is
    a DTensor (expert parallelism).

    ``x`` keeps its group (dim 0) shards and takes an expert (dim 1) shard
    wherever the tables are sharded on their experts (a local slice of the
    dispatched tokens, no communication); the tables take ``x``'s expert
    shards.  Each rank runs its experts on its groups; the output takes
    ``x``'s placements.  A plain ``x`` runs ``fn`` as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not _is_dtensor(x):
        return fn(x, *tables)
    mesh = x.device_mesh
    ref = next((t for t in tables if _is_dtensor(t)), None)
    x_pl = []
    for i, p in enumerate(x.placements):
        if p.is_shard() and p.dim == 0:
            x_pl.append(p)
        elif ref is not None and ref.placements[i] == Shard(0):
            x_pl.append(Shard(1))
        else:
            x_pl.append(Replicate())
    t_pl = [Shard(0) if p == Shard(1) else Replicate() for p in x_pl]
    return _run_local(fn, mesh, (x, *tables), [x_pl] + [t_pl] * len(tables), x_pl)


# ------------------------------------------------------- the vocab, shard-wise
def embed_lookup(table, tokens):
    """``table[tokens]``; on a DTensor table sharded on its rows (the
    vocab), a masked lookup per shard summed over the shards (DTensor's
    embedding rule) instead of gathering the whole table."""
    if not _is_dtensor(table):
        return table[tokens]
    return replicate_partial(torch.nn.functional.embedding(tokens, table))


def _last_sharded(x) -> bool:
    return _is_dtensor(x) and any(
        p.is_shard() and p.dim == x.dim() - 1 for p in x.placements)


def logsumexp_last(x):
    """``torch.logsumexp(x, -1)``; on a DTensor sharded on its last dim
    (the vocab) it is taken shard-wise — the max and the sum of
    exponentials reduced over the shards — instead of gathering the dim."""
    if not _last_sharded(x):
        return torch.logsumexp(x, dim=-1)
    m = replicate_partial(x.detach().amax(-1, keepdim=True))
    return (x - m).exp().sum(-1).log() + m[..., 0]


def gather_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]``; on a DTensor sharded on its
    last dim (the vocab) each rank gathers the indices that fall in its
    shard (zero elsewhere) and the shards are summed, so neither the
    gather nor its backward scatter gathers the dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not _last_sharded(x):
        return replicate_partial(x.gather(-1, idx[..., None]))[..., 0]
    last = x.dim() - 1
    mesh = x.device_mesh
    x_pl = [p if p.is_shard() and p.dim in (0, last) else Replicate()
            for p in x.placements]
    i_pl = [p if p.is_shard() and p.dim == 0 else Replicate() for p in x_pl]
    vocab = [i for i, p in enumerate(x_pl) if p == Shard(last)][0]
    width = x.shape[-1] // mesh.mesh.shape[vocab]
    offset = mesh.get_coordinate()[vocab] * width
    if not _is_dtensor(idx):  # a replicated index plane: this rank's rows
        lo, rows = 0, idx.shape[0]
        for i, p in enumerate(x_pl):
            if p.is_shard() and p.dim == 0:
                rows //= mesh.mesh.shape[i]
                lo += mesh.get_coordinate()[i] * rows
        idx = idx[lo:lo + rows]
        i_pl = None

    def pick(xl, il):
        rel = il - offset
        inside = (rel >= 0) & (rel < width)
        got = xl.gather(-1, rel.clamp(0, width - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype, device=got.device))

    out_pl = [Partial() if p == Shard(last) else p for p in x_pl]
    return replicate_partial(_run_local(pick, mesh, (x, idx), [x_pl, i_pl], out_pl))
