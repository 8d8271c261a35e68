"""granite-4.0-h-small on the port (`HybridConfig`): the port's hybrid stack
against the plain float32 reference (`repro_torch.models.plain_granite4h`)
on the smoke config (every feature kept: both mixer kinds, the routed MoE
beside the shared expert, the four multipliers, NoPE, a share of the
experts), on seeded random weights; the expert shares against the uncut
layer; ``moe.dropped``; the packed decode; the planner's settings
pass-through and its per-layer split of the new tree; and the spans.

Tolerance ``F32_REL`` is the largest deviation over the largest magnitude
of what is compared: float32 rounding of four layers of sums taken in
another order (the chunked SSD against the sequential recurrence, the
sorted expert dispatch against per-expert masks), measured at about 1e-6,
with room.  The seeds used give no near-tie at any top-k boundary (a route
taken the other way would change a token's update by a whole expert's
share); `test_a_bf16_decode_state_fails_the_tolerance` shows the tolerance
catches the SSM decode state kept in bfloat16 instead of float32.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import api
from repro_torch.launch import decode_demo
from repro_torch.memory import PackedParameterStore, plan_packing, planner, tiles
from repro_torch.models import blocks, moe
from repro_torch.models import model as M
from repro_torch.models import plain_granite4h as P
from repro_torch.models.layers import apply_norm
from repro_torch.models.mamba2 import ssm_apply

ARCH = "granite-4.0-h-small"
F32_REL = 1e-5
SEEDS = [3, 11]


def randomized(tree, seed):
    """Every leaf moved off its init by seeded noise (norm scales, biases,
    ``a_log`` and ``d_skip`` included), kept in its dtype."""
    g = torch.Generator().manual_seed(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        return (t.float() + 0.1 * torch.randn(t.shape, generator=g)).to(t.dtype)
    return go(tree)


def smoke_params(seed, cfg=None):
    cfg = cfg or get_smoke_config(ARCH)
    return randomized(M.init_params(cfg, seed, device="cpu"), seed)


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def port_and_plain(cfg, params, seed, b=2, s=40, steps=6):
    """(port logits of the prefill's last position and of each decode step,
    the plain reference's at the same positions), teacher-forced on the
    port's greedy tokens."""
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(2, cfg.vocab_size, (b, s), generator=g)
    cache, lg = M.prefill(cfg, params, {"tokens": tok}, s + steps)
    out = [lg[:, -1, :cfg.vocab_size]]
    fed = []
    for i in range(steps):
        fed.append(out[-1].argmax(-1))
        cache, lg = M.decode_step(cfg, params, cache, fed[-1], s + i)
        out.append(lg[:, -1, :cfg.vocab_size])
    full = torch.cat([tok, torch.stack(fed, 1)], 1)
    want = P.forward(cfg.plain_keys(), params, full)[:, s - 1:, :cfg.vocab_size]
    return torch.stack(out, 1), want


# ------------------------------------------------------------- the config
def test_config_holds_the_published_widths_and_the_cut():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head) == (
        40, 4096, 32, 8, 128)
    assert cfg.layers_of("attention") == [5, 15, 25, 35] and len(cfg.layers_of("mamba")) == 36
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv_width,
            cfg.ssm_chunk, cfg.d_inner) == (128, 64, 128, 4, 256, 8192)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.shared_d_ff) == (72, 10, 768, 1536)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier, cfg.attention_multiplier,
            cfg.logits_scaling, cfg.norm_eps, cfg.rope) == (12, 0.22, 0.0078125, 16, 1e-5, False)
    # the EP-8 share: 9 experts of 72, an eighth of the 100352-row vocabulary
    assert (cfg.held_experts, cfg.expert_start, cfg.vocab_size, cfg.padded_vocab) == (
        9, 0, 12544, 12544)
    assert cfg.param_dtype == "bfloat16" and cfg.tie_embeddings
    assert abs(cfg.param_count() - 8.066e9) < 0.01e9
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, layer_types=cfg.layer_types[:-1])
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, expert_start=64)


def test_tree_stacks_each_collection_once():
    """Three stacked collections at their depths; drawing layer by layer
    into one allocation gives the same tree from the same seed."""
    cfg = get_smoke_config(ARCH)
    meta = M.init_meta_params(cfg)
    assert set(meta) == {"embed", "final_norm", "layers", "mamba_layers", "attn_layers"}
    assert meta["layers"]["moe"]["gate"].shape == (4, 4, 64, 32)
    assert meta["layers"]["moe"]["router"].shape == (4, 64, 8)
    assert meta["layers"]["shared"]["down"]["kernel"].shape == (4, 48, 64)
    assert meta["mamba_layers"]["a_log"].shape[0] == 3 and meta["attn_layers"]["q"]["kernel"].shape[0] == 1
    a, b = M.init_params(cfg, 5, device="cpu"), M.init_params(cfg, 5, device="cpu")
    for (pa, x), (pb, y) in zip(planner.leaves_with_paths(a), planner.leaves_with_paths(b)):
        assert pa == pb and torch.equal(x, y) and x.dtype == torch.bfloat16
    assert [(p, tuple(x.shape)) for p, x in planner.leaves_with_paths(a)] == [
        (p, tuple(x.shape)) for p, x in planner.leaves_with_paths(meta)]


# ----------------------------------------------- the port against the plain
@pytest.mark.parametrize("seed", SEEDS)
def test_prefill_and_decode_match_the_plain_reference(seed):
    cfg = get_smoke_config(ARCH)
    got, want = port_and_plain(cfg, smoke_params(seed), seed)
    assert rel(got[:, 0], want[:, 0]) < F32_REL  # the prefill
    for i in range(1, got.shape[1]):  # each decode step through the cache
        assert rel(got[:, i], want[:, i]) < F32_REL, i


@pytest.mark.parametrize("seed", SEEDS)
def test_full_forward_matches_the_plain_reference(seed):
    cfg = get_smoke_config(ARCH)
    params = smoke_params(seed)
    tok = torch.randint(2, cfg.vocab_size, (2, 37), generator=torch.Generator().manual_seed(seed))
    h, pos = M._embed_inputs(cfg, params, {"tokens": tok})
    h, aux = M.forward_hidden(cfg, params, h, pos)
    got = M._logits(cfg, params, apply_norm(cfg, params["final_norm"], h))
    assert rel(got, P.forward(cfg.plain_keys(), params, tok)) < F32_REL
    assert 0.0 <= float(aux) < 1.0
    loss, metrics = M.train_loss(cfg, params, {"tokens": tok, "targets": tok})
    assert torch.isfinite(loss) and float(metrics["tokens"]) == tok.numel()


def test_a_bf16_decode_state_fails_the_tolerance(monkeypatch):
    """The control: each Mamba layer's decode state rounded to bfloat16
    (the precision below the configuration's float32 state) moves the
    decode steps' logits past ``F32_REL`` while the prefill stays within."""
    orig = blocks.ssm_decode

    def bf16_state(cfg, params, x_in, cache, compute_dtype):
        c = dict(cache, state=cache["state"].to(torch.bfloat16).float())
        out, new = orig(cfg, params, x_in, c, compute_dtype)
        return out, dict(new, state=new["state"].to(torch.bfloat16).float())

    monkeypatch.setattr(blocks, "ssm_decode", bf16_state)
    cfg = get_smoke_config(ARCH)
    got, want = port_and_plain(cfg, smoke_params(SEEDS[0]), SEEDS[0])
    assert rel(got[:, 0], want[:, 0]) < F32_REL
    assert max(rel(got[:, i], want[:, i]) for i in range(1, got.shape[1])) > 10 * F32_REL


@pytest.mark.parametrize("layer", [0, 1])
def test_expert_shares_add_up_to_the_uncut_layer(layer):
    """Four chips' shares of 2 experts each (the same weights sliced),
    with what every chip computes alike (the residual, the mixer, the
    shared expert) counted once, give the uncut reference's layer."""
    full_cfg = dataclasses.replace(get_smoke_config(ARCH), experts_held=0)
    params = smoke_params(7, full_cfg)
    h = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(1))
    kind = full_cfg.layer_types[layer]
    _, _, j, p, mp = next(x for x in M.hybrid_layers(full_cfg, params) if x[0] == layer)
    cd = torch.float32
    r = full_cfg.residual_multiplier
    hn = apply_norm(full_cfg, p["norm1"], h)
    mix = (ssm_apply(full_cfg, mp, hn, cd) if kind == "mamba" else
           blocks.attn_apply(full_cfg, mp, hn, torch.arange(24), 0, rope=False,
                             scale=full_cfg.attention_multiplier))
    x = apply_norm(full_cfg, p["norm2"], h + mix * r)
    common = h + mix * r + moe.shared_apply(full_cfg, p["shared"], x, cd) * r
    total = common.clone()
    pos = torch.arange(24, dtype=torch.int32)
    for start in (0, 2, 4, 6):
        cfg = dataclasses.replace(full_cfg, experts_held=2, expert_start=start)
        share = dict(p, moe={k: (v if k == "router" else v[start:start + 2])
                             for k, v in p["moe"].items()})
        out, _, _ = blocks.hybrid_block_prefill(cfg, share, kind, mp, h, pos, None)
        total += out - common
    want = P.layer(full_cfg.plain_keys(), params, layer, h)
    assert rel(total, want) < F32_REL


def test_moe_dropped_reads_zero_and_counts_real_drops():
    """The expert-parallel layer computes every assignment to a held
    expert; the capacity-bounded GShard layer counts what it drops."""
    cfg = get_smoke_config(ARCH)
    before = obs.counter("moe.dropped")
    port_and_plain(cfg, smoke_params(SEEDS[0]), SEEDS[0], steps=2)
    assert obs.counter("moe.dropped") == before
    g = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"), dtype="float32",
                            capacity_factor=0.3)
    mp = moe.moe_init(g, torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = torch.randn(2, 16, g.d_model, generator=torch.Generator().manual_seed(2))
    out_off = moe.moe_apply(g, mp, x, torch.float32)[0]
    assert obs.counter("moe.dropped") == before  # nothing read while off
    with obs.recording() as rec:
        out_on = moe.moe_apply(g, mp, x, torch.float32)[0]
    assert torch.equal(out_on, out_off)
    cap = max(1, int(32 * g.top_k * g.capacity_factor / g.n_experts))
    assert 0 < rec.counters["moe.dropped"] == 32 * g.top_k - sum(
        min(cap, n) for n in _route_counts(g, mp, x))


def _route_counts(cfg, mp, x):
    logits = x.reshape(-1, cfg.d_model) @ mp["router"]
    idx = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True)[1]
    return torch.bincount(idx[:, :cfg.top_k].reshape(-1), minlength=cfg.n_experts).tolist()


# ------------------------------------------------------ the serving path
def test_decode_demo_packed_gives_the_unpacked_tokens():
    base = ["--arch", ARCH, "--batch", "2", "--prompt-len", "20", "--gen-len", "5",
            "--device", "cpu"]
    plain = decode_demo.run(decode_demo.parse_args(base))
    packed = decode_demo.run(decode_demo.parse_args(base + ["--packed"]))
    assert packed.store is not None and packed.store.banks
    assert np.array_equal(plain.tokens, packed.tokens)
    assert torch.equal(plain.logits, packed.logits)
    for path, leaf in planner.leaves_with_paths(packed.params):
        assert torch.equal(leaf, dict(planner.leaves_with_paths(packed.tree))[path]), path


def test_spans_leave_the_serving_path_bit_identical():
    cfg = get_smoke_config(ARCH)
    params = smoke_params(SEEDS[1])
    off = port_and_plain(cfg, params, SEEDS[1], steps=3)[0]
    with obs.recording() as rec:
        on = port_and_plain(cfg, params, SEEDS[1], steps=3)[0]
    assert torch.equal(on, off)
    assert rec.count("model.prefill") == 1 and rec.count("model.decode_step") == 3


# ------------------------------------------------------------ the planner
SA = dict(n_chains=4, max_iterations=60, max_seconds=1e9, patience=10**9, sa_t0=40,
          sa_rc=0.004, p_adm_w=0.0, p_adm_h=0.1)
GA = dict(max_generations=6, max_seconds=1e9, patience=10**9)


@pytest.mark.parametrize("algorithm,settings,seed", [
    ("sa-s", SA, 0), ("sa-s", SA, 2**31 + 5), ("ga-nfd", GA, 4)])
def test_plan_settings_reach_the_packer(algorithm, settings, seed):
    """``plan_packing(..., **settings)`` is ``api.pack`` on the tree's
    tile-grid problem with those settings, seed for seed."""
    tree = M.init_params(get_smoke_config(ARCH), 1, device="cpu")
    (plan,) = plan_packing(tree, algorithm, seed=seed, split_stacked=True, device="cpu",
                           **settings).values()
    entries = planner._flatten_params(tree, split_stacked=True)
    cands = [e for e in entries if planner.tile_efficiency(e[1], e[2]) < 0.9]
    prob, paths = tiles.tile_grid_problem(cands)
    want = api.pack(prob, algorithm, seed=seed, device="cpu", **settings)
    got = plan.packer_result
    assert [list(b) for b in got.solution.bins] == [list(b) for b in want.solution.bins]
    assert (got.cost, got.iterations) == (want.cost, want.iterations)
    assert [c for _, c in got.trace] == [c for _, c in want.trace]
    assert [[e.path for e in bank] for bank in plan.banks] == [
        [paths[i] for i in b] for b in want.solution.bins]


def test_every_stacked_collection_is_split_per_layer():
    cfg = get_config(ARCH)
    entries = planner._flatten_params(M.init_meta_params(cfg), split_stacked=True)
    depth = {"layers": 40, "mamba_layers": 36, "attn_layers": 4}
    ks = {}
    for path, shape, itemsize in entries:
        root = path.split("/", 1)[0]
        assert itemsize == 2
        if root in depth:
            leaf, k = path.rsplit("#", 1)
            ks.setdefault(leaf, []).append(int(k))
        else:
            assert "#" not in path
    assert ks and all(v == list(range(depth[p.split("/", 1)[0]])) for p, v in ks.items())
    assert ("layers/moe/gate#0", (9, 4096, 768), 2) in entries
    cands = [e for e in entries if planner.tile_efficiency(e[1], 2) < 0.9]
    assert len(cands) == 36 * 13 + 4 * 3 + 1


def test_plan_spans_and_counters_leave_the_plan_bit_identical():
    tree = M.init_params(get_smoke_config(ARCH), 2, device="cpu")
    kw = dict(seed=9, split_stacked=True, device="cpu", **SA)
    off = plan_packing(tree, "sa-s", **kw)
    with obs.recording() as rec:
        on = plan_packing(tree, "sa-s", **kw)
        store = PackedParameterStore(tree, on)
    assert on[2].banks == off[2].banks
    for name in ("memory.plan", "memory.plan.flatten", "memory.plan.problem",
                 "memory.plan.banks", "memory.store.build"):
        assert rec.count(name) == 1, name
    assert rec.counters["memory.plan.candidates"] == 84
    assert rec.counters["memory.plan.banks"] == len(on[2].banks)
    assert rec.counters["memory.store.bytes"] == sum(
        b.numel() * b.element_size() for b in store.banks.values())


def test_an_invalid_packing_raises_with_the_answer(monkeypatch):
    tree = M.init_params(get_smoke_config(ARCH), 2, device="cpu")
    orig = api.pack

    def broken(*a, **k):
        res = orig(*a, **k)
        res.solution.bins[0] = list(res.solution.bins[0]) + list(res.solution.bins[1])
        return res
    monkeypatch.setattr(api, "pack", broken)
    with pytest.raises(planner.InvalidPlan) as e:
        plan_packing(tree, "sa-s", split_stacked=True, device="cpu", **SA)
    assert e.value.result.solution.bins[0]


def test_make_batch_draws_ids_from_the_vocabulary_slice():
    cfg = get_config(ARCH)
    args = SimpleNamespace(batch=4, prompt_len=512, gen_len=17, seed=2**40 + 3)
    batch, cache_len = decode_demo.make_batch(cfg, args, torch.device("cpu"))
    assert batch["tokens"].shape == (4, 512) and cache_len == 529
    assert 2 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < 12544
