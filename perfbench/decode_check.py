"""The plan cell's decode check: the program's decode through a store's
``unpack()``, held to the plain float32 reference (`plain_granite4h.py`).

Prompts of ``batch`` x ``prompt_len`` ids from the vocabulary slice
(`repro_torch.launch.decode_demo.make_batch` from the seed), then
``decode_demo.generate``: the prefill and ``steps`` greedy decode steps
through the program's cache.  The reference runs its full forward over
the prompts and the program's own tokens (teacher-forced on them), layer
by layer with each layer's weights upcast as it runs, and keeps each
layer's input and router logits.  Compared, each as its largest deviation
over the largest magnitude it is measured against:

* ``prefill_logits`` — the prefill's last-position logits against the
  reference's at the same position, a row's deviation over its largest
  logit, the median over the rows;
* ``step_logits`` — every decode step's logits against the reference's at
  the step's position, the median over rows and steps;
* ``layer_prefill`` — each layer of the program on the reference's input
  to that layer (the prompt positions), against the reference's output,
  over the reference's update of that layer (``max |out - in|``);
* ``layer_decode`` — the same layer then decoding the later positions one
  at a time through its own cache, fed the reference's inputs there.

A (token, layer) whose top-``top_k`` boundary is a near-tie involving a
held expert (the ``top_k``-th and next logits closer than
``ROUTE_MARGIN``) may route either way under float32 rounding: the two
layer checks leave that token out at that layer and count it (``masked``).
The logits checks cannot: a route taken the other way moves that token's
state by a whole expert's share, later routes of the same row flip after
it, and the row's later positions inherit it through the SSM state (one
seed of 12 read 7.9e-2 as the largest step deviation, PERF.md).  So they
take the median over rows (and steps), which a flip in one row leaves
alone while a wrong cache, position, scale or mixer moves every row; the
largest deviations are reported beside them (``*_max``, not judged).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from . import plain_granite4h as ref

# The limits (``[decode]`` on standard error), each from two readings on
# the H100 (PERF.md): the program against the reference over 12
# seeds, float32 compute (the lower), and the same decode computed in
# bfloat16, the precision below the configuration's float32 (the upper);
# the decode ones also below the reading with only each Mamba layer's
# decode state cast to bfloat16.
LIMITS = {
    # median over the rows: float32 rounding over 40 layers (5.2e-5 at
    # most; 0.91 in bfloat16)
    "prefill_logits": 1e-3,
    # median over rows and steps: the same through the cache (2.0e-5 at
    # most; 1.1e-3 with the decode state in bfloat16, 0.55 in bfloat16)
    "step_logits": 2e-4,
    # one layer on the reference's own input, largest over the unmasked
    # tokens: float32 rounding of one layer's sums, the chunked SSD's
    # cumulative decays against the sequential recurrence above all
    # (5.1e-5 at most; 0.28 in bfloat16)
    "layer_prefill": 1e-3,
    # that layer decoding 16 positions on through its own cache: the
    # state's float32 updates step by step (4.7e-6 at most; 1.9e-4 with
    # the decode state in bfloat16, 0.20 in bfloat16)
    "layer_decode": 3e-5,
}
ROUTE_MARGIN = 1e-3


def ambiguous(logits: torch.Tensor, k: int, start: int, held: int, margin: float):
    """(N,) bool: the ``k``-th and ``k+1``-th largest router logits are
    within ``margin`` and either is a held expert's."""
    vals, idx = torch.topk(logits, k + 1, dim=-1)
    near = (vals[:, k - 1] - vals[:, k]) < margin
    is_held = (idx[:, k - 1:] >= start) & (idx[:, k - 1:] < start + held)
    return near & is_held.any(-1)


def _row_rel(got, want) -> torch.Tensor:
    """(..., V) -> (...): each row's largest deviation over its largest
    logit."""
    return (got.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)


def _rel(a, b, scale, keep=None) -> float:
    d = (a.float() - b.float()).abs()
    if keep is not None:
        d = d[keep]
    return float(d.max() / scale) if d.numel() else 0.0


@torch.no_grad()
def run(cfg, plain: dict, params: dict, batch: int, prompt_len: int, steps: int, seed: int,
        device) -> dict:
    """The decode and every comparison: ``dict(values, masked, tokens,
    dropped)``, ``values`` by the names of `LIMITS`; ``dropped`` is what the
    program's counter ``moe.dropped`` gained meanwhile (its expert layer
    computes every assignment to a held expert, so it must be 0)."""
    from repro_torch import obs
    from repro_torch.launch import decode_demo
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of

    dropped = obs.counter("moe.dropped")
    args = SimpleNamespace(batch=batch, prompt_len=prompt_len, gen_len=steps + 1, seed=seed)
    inputs, cache_len = decode_demo.make_batch(cfg, args, device)
    tokens, logits, _, _ = decode_demo.generate(cfg, params, inputs, steps + 1, cache_len)
    p, s, v = prompt_len, prompt_len + steps, cfg.vocab_size
    full = torch.cat([inputs["tokens"], tokens[:, :steps]], 1)
    want, hs, routes = ref.forward(plain, params, full, keep_inputs=True)
    want = want[:, p - 1:s, :v]
    got = logits.permute(1, 0, 2)
    first, later = _row_rel(got[:, 0], want[:, 0]), _row_rel(got[:, 1:], want[:, 1:])
    values = {
        "prefill_logits": float(first.median()),
        "step_logits": float(later.median()),
        "layer_prefill": 0.0,
        "layer_decode": 0.0,
        "prefill_logits_max": float(first.max()),
        "step_logits_max": float(later.max()),
    }
    del want, got, logits
    compute = dtype_of(cfg.dtype)
    positions = torch.arange(p, dtype=torch.int32, device=device)
    masked = 0
    for i, kind, _, lp, mp in M.hybrid_layers(cfg, params):
        h_in, h_out = hs[i], hs[i + 1]
        keep = ~ambiguous(routes[i], cfg.top_k, cfg.expert_start, cfg.held_experts,
                          ROUTE_MARGIN).reshape(full.shape)
        masked += int((~keep).sum())
        scale = (h_out - h_in).abs().max()
        out, cache, _ = blocks.hybrid_block_prefill(cfg, lp, kind, mp, h_in[:, :p].to(compute),
                                                    positions, s)
        values["layer_prefill"] = max(values["layer_prefill"],
                                      _rel(out, h_out[:, :p], scale, keep[:, :p]))
        for t in range(p, s):
            out, new = blocks.hybrid_block_decode(cfg, lp, kind, mp, h_in[:, t:t + 1].to(compute),
                                                  cache, t)
            if kind == "mamba":
                cache = new
            else:
                cache["k"][:, t] = new["k_new"][:, 0].to(cache["k"].dtype)
                cache["v"][:, t] = new["v_new"][:, 0].to(cache["v"].dtype)
            values["layer_decode"] = max(values["layer_decode"],
                                         _rel(out, h_out[:, t:t + 1], scale, keep[:, t:t + 1]))
    return dict(values=values, masked=masked, tokens=int(full.numel()),
                dropped=obs.counter("moe.dropped") - dropped)


def failed(out: dict) -> list[str]:
    """The names of the comparisons over their limits, and ``moe.dropped``
    where it gained."""
    over = [k for k, lim in LIMITS.items() if not out["values"][k] <= lim]
    return over + ["moe.dropped"] * bool(out["dropped"])
