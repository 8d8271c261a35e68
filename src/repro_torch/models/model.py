"""Top-level model: init, full-sequence forward, prefill, and decode.

The port of ``repro.models.model``'s serving half.  The parameter tree is
the reference's: nested dicts of tensors whose layers are *stacked* on a
leading ``n_layers`` dimension, so the memory planner (``split_stacked``),
`PackedParameterStore.unpack()` and `repro_torch.convert.params_from_arrays`
all work on it.  The reference's ``lax.scan`` over each segment of layers
with one static window becomes a loop over the layer index.  ``cfg.remat``
(the reference's ``jax.checkpoint`` of the scan body) wraps each layer of
`forward_hidden` and `_encode` in ``torch.utils.checkpoint.checkpoint``
while autograd records: the layer's activations are recomputed in the
backward pass instead of kept, which changes memory, never values.  The
layers' parameters are indexed out of the stacked leaves inside the
checkpointed function, so gradients flow back into the stacked
``(n_layers, ...)`` leaves.

A `HybridConfig` (Granite-4.0-H) stacks three collections: ``layers``
(each layer's own norms, MoE and shared expert, ``n_layers`` deep),
``mamba_layers`` and ``attn_layers`` (the mixers, one a layer of that
kind, in layer order).  Its tree is drawn layer by layer into stacks
allocated once, so the parameters are never held twice; its cache holds
the SSM conv tails and states of the Mamba layers beside the K/V of the
attention layers.  The spans ``model.prefill`` and ``model.decode_step``
(`repro_torch.obs`) cover `prefill` and `decode_step`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..device import resolve_device
from .attention import attn_init
from .blocks import (
    block_apply_train,
    block_decode,
    block_init,
    block_prefill,
    hybrid_block_decode,
    hybrid_block_prefill,
    hybrid_common_init,
)
from .config import HybridConfig, ModelConfig
from .layers import apply_norm, dense_init, dtype_of, norm_init, truncated_normal_init
from .mamba2 import ssm_init, ssm_init_cache
from .redistribute import (
    embed_lookup,
    gather_last,
    logits_local,
    logsumexp_last,
    write_slot,
)


# ------------------------------------------------------------------ helpers
def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, not copies)."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def layer_segments(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """Contiguous (start, end, window) runs of layers with equal window."""
    if cfg.sliding_window <= 0:
        return [(0, cfg.n_layers, 0)]
    segs: list[tuple[int, int, int]] = []
    start = 0
    cur_win = 0 if cfg.is_global_layer(0) else cfg.sliding_window
    for i in range(1, cfg.n_layers):
        win = 0 if cfg.is_global_layer(i) else cfg.sliding_window
        if win != cur_win:
            segs.append((start, i, cur_win))
            start, cur_win = i, win
    segs.append((start, cfg.n_layers, cur_win))
    return segs


def _layers(cfg: ModelConfig, stacked: dict):
    """(layer index, layer params, window) in layer order."""
    for start, end, window in layer_segments(cfg):
        for i in range(start, end):
            yield i, tree_index(stacked, i), window


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    pos = np.arange(seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    angle = pos / np.power(10_000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# ------------------------------------------------------------------- hybrid
MIXER_COLLECTIONS = {"mamba": "mamba_layers", "attention": "attn_layers"}


class _Stacked:
    """Layers' trees stacked on a new leading dim, each written into
    tensors allocated at the first layer as it is drawn."""

    def __init__(self, n: int):
        self.n, self.i, self.tree = n, 0, None

    def add(self, one: dict) -> None:
        if self.tree is None:
            self.tree = tree_map(lambda x: x.new_empty((self.n,) + tuple(x.shape)), one)
        tree_map(lambda dst, src: dst[self.i].copy_(src), self.tree, one)
        self.i += 1


def _init_hybrid(cfg: HybridConfig, gen, device: torch.device) -> dict:
    dtype = dtype_of(cfg.param_dtype)
    params: dict = {
        "embed": truncated_normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype, device
        ),
        "final_norm": norm_init(cfg, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device)
    common = _Stacked(cfg.n_layers)
    mixers = {k: _Stacked(len(cfg.layers_of(k))) for k in MIXER_COLLECTIONS if cfg.layers_of(k)}
    for kind in cfg.layer_types:
        common.add(hybrid_common_init(cfg, gen, dtype, device))
        init = ssm_init if kind == "mamba" else attn_init
        mixers[kind].add(init(cfg, gen, dtype, device))
    params["layers"] = common.tree
    for kind, st in mixers.items():
        params[MIXER_COLLECTIONS[kind]] = st.tree
    return params


def hybrid_layers(cfg: HybridConfig, params: dict):
    """(layer, kind, index among its kind's layers, the layer's own
    parameters, its mixer's) in layer order."""
    seen = dict.fromkeys(MIXER_COLLECTIONS, 0)
    for i, kind in enumerate(cfg.layer_types):
        j = seen[kind]
        seen[kind] += 1
        yield (i, kind, j, tree_index(params["layers"], i),
               tree_index(params[MIXER_COLLECTIONS[kind]], j))


def _forward_hybrid(cfg: HybridConfig, params: dict, h, positions):
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, kind, _, p, mp in hybrid_layers(cfg, params):
        h, _, aux = hybrid_block_prefill(cfg, p, kind, mp, h, positions, None)
        aux_total = aux_total + aux
    return h, aux_total


def _prefill_hybrid(cfg: HybridConfig, params: dict, batch: dict, cache_len: int):
    h, positions = _embed_inputs(cfg, params, batch)
    caches = {k: [] for k in MIXER_COLLECTIONS}
    for _, kind, _, p, mp in hybrid_layers(cfg, params):
        h, c, _ = hybrid_block_prefill(cfg, p, kind, mp, h, positions, cache_len)
        caches[kind].append(c)
    cache: dict = {}
    if caches["attention"]:
        cache.update(_stack(caches["attention"]))
    if caches["mamba"]:
        cache["ssm"] = _stack([c["ssm"] for c in caches["mamba"]])
    h = apply_norm(cfg, params["final_norm"], h)
    return cache, _logits(cfg, params, h[:, -1:, :])


def _decode_hybrid(cfg: HybridConfig, params: dict, cache: dict, token, pos: int):
    h = _embed(cfg, params, token[:, None])
    news = {k: [] for k in MIXER_COLLECTIONS}
    for _, kind, j, p, mp in hybrid_layers(cfg, params):
        if kind == "mamba":
            c = {"ssm": tree_index(cache["ssm"], j)}
        else:
            c = {"k": cache["k"][j], "v": cache["v"][j]}
        h, nc = hybrid_block_decode(cfg, p, kind, mp, h, c, pos)
        news[kind].append(nc)
    new_cache = dict(cache)
    if news["attention"]:
        ys = _stack(news["attention"])
        at = min(max(pos, 0), cache["k"].shape[2] - 1)
        write_slot(cache["k"], 2, at, ys["k_new"].to(cache["k"].dtype))
        write_slot(cache["v"], 2, at, ys["v_new"].to(cache["v"].dtype))
    if news["mamba"]:
        new_cache["ssm"] = _stack([c["ssm"] for c in news["mamba"]])
    h = apply_norm(cfg, params["final_norm"], h)
    return new_cache, _logits(cfg, params, h)


# --------------------------------------------------------------------- init
def _init(cfg: ModelConfig, gen, device: torch.device) -> dict:
    if isinstance(cfg, HybridConfig):
        return _init_hybrid(cfg, gen, device)
    dtype = dtype_of(cfg.param_dtype)
    params: dict = {
        "embed": truncated_normal_init(
            gen, (cfg.padded_vocab, cfg.d_model), 1.0, dtype, device
        ),
        "final_norm": norm_init(cfg, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype, device)
    params["layers"] = _stack([
        block_init(cfg, gen, dtype, device, use_cross=cfg.encoder_decoder)
        for _ in range(cfg.n_layers)
    ])
    if cfg.encoder_decoder:
        params["enc_layers"] = _stack([
            block_init(cfg, gen, dtype, device) for _ in range(cfg.n_encoder_layers)
        ])
        params["enc_norm"] = norm_init(cfg, cfg.d_model, dtype, device)
        params["dec_pos"] = truncated_normal_init(
            gen, (cfg.max_target_len, cfg.d_model), 1.0, dtype, device
        )
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """The parameter tree, drawn from one ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``None`` means ``"cuda"``; raises without CUDA).
    Its values are the port's own; the reference's weights come across
    through `repro_torch.convert.params_from_arrays`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init(cfg, gen, device)


def init_meta_params(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes and dtypes on the ``meta`` device."""
    return _init(cfg, None, torch.device("meta"))


# ------------------------------------------------------------------ forward
def forward_hidden(
    cfg: ModelConfig,
    params: dict,
    h: torch.Tensor,
    positions: torch.Tensor,
    cross_kv=None,
    cross_pos=None,
    causal: bool = True,
    rope: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decoder (or encoder when causal=False) stack over a full sequence.
    Returns (h, summed MoE aux loss)."""
    if isinstance(cfg, HybridConfig):
        return _forward_hybrid(cfg, params, h, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start, end, window in layer_segments(cfg):
        for i in range(start, end):
            h, a = _run_layer(
                cfg, params["layers"], i, h, positions, window,
                cross_kv=cross_kv, cross_pos=cross_pos, causal=causal, rope=rope,
            )
            aux_total = aux_total + a
    return h, aux_total


def _run_layer(cfg: ModelConfig, stacked: dict, i: int, h, positions, window: int, **kw):
    """`block_apply_train` on layer ``i`` of ``stacked``; under ``cfg.remat``
    and while autograd records, as one checkpointed region."""

    def body(hh):
        return block_apply_train(cfg, tree_index(stacked, i), hh, positions, window, **kw)

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, h, use_reentrant=False)
    return body(h)


def _encode(cfg: ModelConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings."""
    s = frames.shape[1]
    pos_emb = torch.as_tensor(sinusoidal_positions(s, cfg.d_model), device=frames.device)
    h = frames + pos_emb.to(frames.dtype)[None]
    positions = torch.arange(s, dtype=torch.int32, device=frames.device)
    for i in range(cfg.n_encoder_layers):
        h, _ = _run_layer(cfg, params["enc_layers"], i, h, positions, 0, causal=False)
    return apply_norm(cfg, params["enc_norm"], h)


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings in the compute dtype (a hybrid's times its
    embedding multiplier)."""
    h = embed_lookup(params["embed"], tokens).to(dtype_of(cfg.dtype))
    if isinstance(cfg, HybridConfig):
        h = h * cfg.embedding_multiplier
    return h


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """Token (+ stub modality) embedding. Returns (h, positions)."""
    compute_dtype = dtype_of(cfg.dtype)
    h = _embed(cfg, params, batch["tokens"])
    if cfg.frontend == "vision_stub" and "patches" in batch:
        patches = batch["patches"].to(compute_dtype)  # (B, P, D) precomputed
        h = torch.cat([patches, h], dim=1)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    return h, positions


def _logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """(B, S, padded_vocab) float32: the compute-dtype operands' products
    accumulated in float32 (a hybrid's divided by its logits scaling)."""
    compute_dtype = dtype_of(cfg.dtype)
    if cfg.tie_embeddings:
        out = logits_local(
            lambda h, w: torch.einsum("bsd,vd->bsv", h.float(), w.to(compute_dtype).float()),
            h, params["embed"], 0)
    else:
        out = logits_local(
            lambda h, w: torch.einsum("bsd,dv->bsv", h.float(), w.to(compute_dtype).float()),
            h, params["lm_head"]["kernel"], 1)
    if isinstance(cfg, HybridConfig):
        out = out / cfg.logits_scaling
    return out


def _decoder_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """(h, positions, cross_kv, cross_pos, rope) of the decoder stack."""
    if not cfg.encoder_decoder:
        h, positions = _embed_inputs(cfg, params, batch)
        return h, positions, None, None, True
    compute_dtype = dtype_of(cfg.dtype)
    enc_out = _encode(cfg, params, batch["frames"].to(compute_dtype))
    tokens = batch["tokens"]
    t = tokens.shape[1]
    h = embed_lookup(params["embed"], tokens).to(compute_dtype)
    h = h + params["dec_pos"][:t].to(h.dtype)[None]
    positions = torch.arange(t, dtype=torch.int32, device=h.device)
    cross_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=h.device)
    return h, positions, enc_out, cross_pos, False


def train_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Cross-entropy (+ MoE aux) over the batch. Returns (loss, metrics).

    batch: tokens (B,S) integer, targets (B,S) integer with -1 = masked;
    whisper additionally frames (B,T,D); vlm additionally patches.  The
    log-partition runs over all ``padded_vocab`` columns, as the
    reference's does; the gold logit is a gather, which equals the
    reference's one-hot sum for finite logits without a second (B, S, V)
    float32 tensor."""
    h, positions, cross_kv, cross_pos, rope = _decoder_inputs(cfg, params, batch)
    h, aux = forward_hidden(
        cfg, params, h, positions, cross_kv=cross_kv, cross_pos=cross_pos, rope=rope
    )
    h = apply_norm(cfg, params["final_norm"], h)
    logits = _logits(cfg, params, h)  # (B, S, V) fp32

    targets = batch["targets"]
    if logits.shape[1] != targets.shape[1]:  # vlm: strip patch positions
        logits = logits[:, logits.shape[1] - targets.shape[1]:]
    mask = (targets >= 0).float()
    safe_targets = targets.clamp_min(0).long()
    logz = logsumexp_last(logits)
    gold = gather_last(logits, safe_targets)
    ce = (logz - gold) * mask
    tokens = mask.sum()
    loss = ce.sum() / tokens.clamp_min(1.0)
    total = loss + aux
    metrics = {"loss": loss, "aux_loss": aux, "tokens": tokens}
    return total, metrics


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """All-layer stacked decode cache (compute-dtype KV, fp32 SSM state) on
    ``device`` (``None`` means ``"cuda"``)."""
    return _init_cache(cfg, batch, cache_len, resolve_device(device))


def init_meta_cache(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """The decode cache's shapes and dtypes on the ``meta`` device."""
    return _init_cache(cfg, batch, cache_len, torch.device("meta"))


def _init_cache(cfg: ModelConfig, batch: int, cache_len: int, device) -> dict:
    compute_dtype = dtype_of(cfg.dtype)
    layers = cfg.n_layers
    cache: dict = {}
    if isinstance(cfg, HybridConfig):
        n_attn, n_ssm = len(cfg.layers_of("attention")), len(cfg.layers_of("mamba"))
        if n_attn:
            kv_shape = (n_attn, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
            cache["k"] = torch.zeros(kv_shape, dtype=compute_dtype, device=device)
            cache["v"] = torch.zeros(kv_shape, dtype=compute_dtype, device=device)
        if n_ssm:
            one = ssm_init_cache(cfg, batch, compute_dtype, device)
            cache["ssm"] = tree_map(lambda x: x[None].repeat((n_ssm,) + (1,) * x.dim()), one)
        return cache
    if cfg.has_attention():
        # enc-dec: the self-attention cache is bounded by the target length;
        # cache_len sizes the cross-attention (encoder output) cache instead
        self_len = min(cache_len, cfg.max_target_len) if cfg.encoder_decoder else cache_len
        kv_shape = (layers, batch, self_len, cfg.n_kv_heads, cfg.d_head)
        cache["k"] = torch.zeros(kv_shape, dtype=compute_dtype, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=compute_dtype, device=device)
    if cfg.has_ssm():
        one = ssm_init_cache(cfg, batch, compute_dtype, device)
        cache["ssm"] = tree_map(lambda x: x[None].repeat((layers,) + (1,) * x.dim()), one)
    if cfg.encoder_decoder:
        shape = (layers, batch, cache_len, cfg.n_kv_heads, cfg.d_head)
        cache["cross_k"] = torch.zeros(shape, dtype=compute_dtype, device=device)
        cache["cross_v"] = torch.zeros_like(cache["cross_k"])
    return cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    """Process the prompt; returns (cache, last_token_logits (B, 1, V))."""
    with obs.span("model.prefill"):
        if isinstance(cfg, HybridConfig):
            return _prefill_hybrid(cfg, params, batch, cache_len)
        return _prefill(cfg, params, batch, cache_len)


def _prefill(cfg: ModelConfig, params: dict, batch: dict, cache_len: int):
    h, positions, cross_kv, cross_pos, rope = _decoder_inputs(cfg, params, batch)
    caches = []
    for _, lp, window in _layers(cfg, params["layers"]):
        h, c = block_prefill(
            cfg, lp, h, positions, window, cache_len,
            cross_kv=cross_kv, cross_pos=cross_pos, rope=rope,
        )
        caches.append(c)
    cache = _stack(caches)
    h = apply_norm(cfg, params["final_norm"], h)
    logits_last = _logits(cfg, params, h[:, -1:, :])
    return cache, logits_last


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token: torch.Tensor, pos):
    """One token decode. token: (B,) integer; pos: the token's position.

    Returns (new_cache, logits (B, 1, V)).  The new token's K/V are written
    into ``cache``'s K/V tensors in place, one stacked write per tensor at
    ``pos`` (the reference donates them to the same write); the returned
    dict holds them and the new SSM states."""
    with obs.span("model.decode_step"):
        if isinstance(cfg, HybridConfig):
            return _decode_hybrid(cfg, params, cache, token, int(pos))
        return _decode_step(cfg, params, cache, token, int(pos))


def _decode_step(cfg: ModelConfig, params: dict, cache: dict, token: torch.Tensor, pos: int):
    compute_dtype = dtype_of(cfg.dtype)
    h = _embed(cfg, params, token[:, None])
    rope = True
    if cfg.encoder_decoder:
        # dynamic_slice clamps the start into the table
        at = min(max(pos, 0), params["dec_pos"].shape[0] - 1)
        h = h + params["dec_pos"][at:at + 1].to(compute_dtype)[None]
        rope = False

    news = []
    for i, lp, window in _layers(cfg, params["layers"]):
        h, nc = block_decode(
            cfg, lp, h, tree_index(cache, i), pos, window, rope=rope,
            defer_cache_write=True,
        )
        news.append(nc)
    ys = _stack(news)
    new_cache = dict(cache)
    if "k_new" in ys:
        at = min(max(pos, 0), cache["k"].shape[2] - 1)
        write_slot(cache["k"], 2, at, ys["k_new"].to(cache["k"].dtype))
        write_slot(cache["v"], 2, at, ys["v_new"].to(cache["v"].dtype))
    if "ssm" in ys:
        new_cache["ssm"] = ys["ssm"]
    h = apply_norm(cfg, params["final_norm"], h)
    logits = _logits(cfg, params, h)
    return new_cache, logits
