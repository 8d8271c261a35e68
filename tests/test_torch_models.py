"""The port's LM stack (`repro_torch.models`, `repro_torch.configs`) against
the reference's (`repro.models`, `repro.configs`): configs and layer
segments equal, parameter counts equal, the modules and the whole model's
prefill / decode on the reference's own weights (carried across with
`params_from_arrays`) within a stated tolerance, and the reference's model
invariants (`tests/test_models.py`) holding on the port.

Tolerances, as ``max|port - reference| / max|reference|``:

* float32 (``dtype="float32"``): ``F32_REL = 1e-4``.  Both packages do the
  same float32 arithmetic in another order (XLA's fused CPU loops against
  PyTorch's kernels), a few ulps (2^-24) per operation; the two-layer
  smoke models land near 1e-6.
* bfloat16 (the configs' default compute dtype, float32 parameters):
  ``BF16_REL = 16 * 2**-8``, sixteen bf16 roundings (2^-8 each).  XLA keeps
  some bf16 intermediates of a fused loop in float32 where PyTorch rounds
  each operation's output to bf16, so single values differ by a bf16
  rounding here and there, and those differences pass through two layers
  of attention, MLP and norms, and for the SSM through its chunk
  recurrence.  Over seeds 0-11 of `test_prefill_and_decode_match_reference`
  every arch lands at 0.8-2.4e-2, hymba's SSM state at up to 4.0e-2.

Float32 matmuls on the CPU use no reduced-precision path, so no setting
changes these numbers here; on a card TF32 must be off (``chip_smoke.py``
asserts it).

MoE routes.  A flipped route (a near-tie in ``top_k``) moves a whole
expert's output, so it shows as an error far above either bound, never
under it.  In float32 no seed of 0-11 flips one (both MoE archs), and
`test_moe_apply_matches_reference` asserts that its seeded inputs hold no
near-tie.  In bfloat16 the two packages round the router's input at
different points, and granite-moe's 8-expert top-2 smoke router flips a
route on seeds 3, 6, 10 and 11 of 0-11 (relative error 0.53-1.31); this
file's seed 0 is not one of them, phi3.5-moe flips on none.  No bound is
widened for a flip: the float32 variant is the one that holds the routing.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs
import repro.models.attention as RA
import repro_torch.configs as tconfigs
import repro_torch.models.attention as TA
from repro.models import layers as RL
from repro.models import mamba2 as RS
from repro.models import model as M
from repro.models import moe as RMOE
from repro_torch.convert import params_from_arrays
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TS
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig

F32_REL = 1e-4
BF16_REL = 16 * 2**-8
SEED = 0  # every test draws its inputs from its own generator
DECODE_ARCHS = ["qwen3-0.6b", "hymba-1.5b", "mamba2-1.3b", "starcoder2-7b"]


def rel_err(port, ref) -> float:
    a = port.float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    b = np.asarray(ref).astype(np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def batch_for(cfg, B, S, rng):
    """numpy inputs as `tests/test_models.py` builds them (no targets)."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.encoder_decoder:
        frames = (rng.normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)
        return {"frames": frames, "tokens": toks[:, :16]}
    if cfg.frontend == "vision_stub":
        P = cfg.num_patches
        patches = (rng.normal(size=(B, P, cfg.d_model)) * 0.1).astype(np.float32)
        return {"patches": patches, "tokens": toks[:, : S - P]}
    return {"tokens": toks}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def configs_of(arch, dtype):
    """(reference, port) smoke configs at compute ``dtype``."""
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def ref_weights(arch, seed=0):
    """The reference's smoke weights as numpy (``jax.device_get``)."""
    return jax.device_get(M.init_params(configs.get_smoke_config(arch), jax.random.PRNGKey(seed)))


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_configs_and_segments_equal_reference(arch):
    # the reference's archs first, in its order; the port's own after them
    assert tconfigs.ARCHS[:len(configs.ARCHS)] == configs.ARCHS
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(configs, get)(arch)
        port = getattr(tconfigs, get)(arch)
        assert isinstance(port, ModelConfig)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert TM.layer_segments(port) == M.layer_segments(ref)
        assert port.padded_vocab == ref.padded_vocab
    assert tconfigs.shape_cells(arch) == configs.shape_cells(arch)
    down = tconfigs.scale_down(tconfigs.get_config(arch), n_layers=3)
    assert dataclasses.asdict(down) == dataclasses.asdict(
        configs.scale_down(configs.get_config(arch), n_layers=3))
    mod = tconfigs._MODULES[arch]
    assert mod.__doc__ == configs._MODULES[arch].__doc__
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}


def test_unknown_arch_raises_like_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-5")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_counts_equal_reference(arch):
    """Full published widths: the port's count comes from a tree on the
    ``meta`` device, the reference's from ``jax.eval_shape``."""
    ref, port = configs.get_config(arch), tconfigs.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_init_tree_matches_reference_structure(arch):
    """The port's own init: the reference's paths, shapes and dtypes, every
    value finite, the same values again from the same seed."""
    cfg = tconfigs.get_smoke_config(arch)
    ref = dict(leaves(ref_weights(arch)))
    a = dict(leaves(TM.init_params(cfg, 3, device="cpu")))
    b = dict(leaves(TM.init_params(cfg, 3, device="cpu")))
    assert sorted(a) == sorted(ref)
    for path, x in a.items():
        assert tuple(x.shape) == ref[path].shape, path
        assert str(x.dtype).split(".")[-1] == str(ref[path].dtype), path
        assert torch.isfinite(x).all() and torch.equal(x, b[path]), path
    meta = dict(leaves(TM.init_meta_params(cfg)))
    assert {p: tuple(x.shape) for p, x in meta.items()} == {
        p: tuple(x.shape) for p, x in a.items()}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_params_from_arrays_carries_every_smoke_tree(arch, param_dtype):
    """The reference's smoke tree (float32, and bfloat16 parameters) comes
    across with its paths, shapes and dtypes, every value bit-equal."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), param_dtype=param_dtype)
    ref = jax.device_get(M.init_params(cfg, jax.random.PRNGKey(1)))
    got = dict(leaves(params_from_arrays(ref, device="cpu")))
    want = dict(leaves(ref))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        w = want[path]
        assert tuple(x.shape) == w.shape and str(x.dtype).split(".")[-1] == str(w.dtype), path
        bits = np.int16 if w.dtype.itemsize == 2 else np.int32
        np.testing.assert_array_equal(
            x.view(torch.int16 if bits is np.int16 else torch.int32).numpy(),
            np.asarray(w).view(bits), err_msg=path)


def test_init_params_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_params(tconfigs.get_smoke_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TM.init_cache(tconfigs.get_smoke_config("qwen3-0.6b"), 1, 4)


# ------------------------------------------------------------- modules
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_layers_match_reference(norm):
    rng = np.random.default_rng(SEED)
    cfg = dataclasses.replace(configs.get_smoke_config("whisper-medium"), norm=norm,
                              mlp_gated=True, dtype="float32")
    x = (rng.normal(size=(2, 5, cfg.d_model)) * 2).astype(np.float32)
    p = jax.device_get(RL.norm_init(cfg, cfg.d_model, jnp.float32))
    p = {k: v + rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    assert rel_err(TL.apply_norm(cfg, params_from_arrays(p, device="cpu"), torch.from_numpy(x)),
                   RL.apply_norm(cfg, p, jnp.asarray(x))) < F32_REL
    np.testing.assert_array_equal(TL.rope_freqs(16, 1e6), RL.rope_freqs(16, 1e6))
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    xh = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    assert rel_err(TL.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e6),
                   RL.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6)) < F32_REL
    scale = rng.normal(size=16).astype(np.float32)
    assert rel_err(TL.head_rms_norm(torch.from_numpy(scale), torch.from_numpy(xh), 1e-6),
                   RL.head_rms_norm(jnp.asarray(scale), jnp.asarray(xh), 1e-6)) < F32_REL
    for act in ("silu", "gelu"):
        c = dataclasses.replace(cfg, mlp_act=act)
        mp = jax.device_get(RL.mlp_init(c, jax.random.PRNGKey(1), jnp.float32))
        assert rel_err(
            TL.mlp_apply(c, params_from_arrays(mp, device="cpu"), torch.from_numpy(x),
                         torch.float32),
            RL.mlp_apply(c, mp, jnp.asarray(x), jnp.float32)) < F32_REL
    with pytest.raises(ValueError):
        TL.activation("relu", torch.zeros(1))


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("scores", ["float32", "bfloat16"])
def test_sdpa_paths_match_reference(window, scores, monkeypatch):
    rng = np.random.default_rng(SEED)
    """`_sdpa`, the blockwise path (KV block 16) and the windowed blocks,
    each against the reference's on the same inputs."""
    monkeypatch.setattr(RA, "_BLOCK_KV", 16)
    monkeypatch.setattr(TA, "_BLOCK_KV", 16)
    tol = F32_REL if scores == "float32" else BF16_REL
    sd_j, sd_t = jnp.dtype(scores), getattr(torch, scores)
    q = rng.normal(size=(2, 40, 2, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 40, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 40, 2, 8)).astype(np.float32)
    qj, kj, vj = (jnp.asarray(a).astype(sd_j) for a in (q, k, v))
    qt, kt, vt = (torch.from_numpy(a).to(sd_t) for a in (q, k, v))
    qp = np.arange(40)
    bias_r = RA._mask_bias(jnp.asarray(qp), jnp.asarray(qp), window, True)
    bias_t = TA._mask_bias(torch.from_numpy(qp), torch.from_numpy(qp), window, True)
    assert np.array_equal(bias_t.numpy(), np.asarray(bias_r))
    assert rel_err(TA._sdpa(qt, kt, vt, bias_t, sd_t), RA._sdpa(qj, kj, vj, bias_r, sd_j)) < tol
    assert rel_err(
        TA._sdpa_blockwise(qt, kt, vt, torch.from_numpy(qp), torch.from_numpy(qp), window,
                           True, sd_t),
        RA._sdpa_blockwise(qj, kj, vj, jnp.asarray(qp), jnp.asarray(qp), window, True,
                           sd_j)) < tol
    if window:
        assert rel_err(TA._sdpa_windowed_blocks(qt, kt, vt, window, 16, sd_t),
                       RA._sdpa_windowed_blocks(qj, kj, vj, window, 16, sd_j)) < tol


@pytest.mark.parametrize("update_cache", [True, False])
@pytest.mark.parametrize("window", [0, 6])
def test_attn_decode_matches_reference(update_cache, window):
    rng = np.random.default_rng(SEED)
    """Both cache disciplines, full and sliding window, on a qk-norm GQA
    config with biases."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-0.6b"), dtype="float32",
                              qkv_bias=True, attn_out_bias=True)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    p = jax.device_get(RA.attn_init(cfg, jax.random.PRNGKey(2), jnp.float32))
    tp = params_from_arrays(p, device="cpu")
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(2, 12, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    kc0 = kc.copy()
    for pos in (0, 5, 11):
        ref = RA.attn_decode(cfg, p, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(pos, jnp.int32), window, update_cache=update_cache)
        got = TA.attn_decode(tcfg, tp, torch.from_numpy(x), torch.from_numpy(kc),
                             torch.from_numpy(vc), pos, window, update_cache=update_cache)
        for a, b in zip(got, ref):
            assert rel_err(a, b) < F32_REL
    # neither discipline writes the caller's cache
    assert np.array_equal(kc, kc0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_apply_matches_reference(arch, capacity_factor):
    rng = np.random.default_rng(SEED)
    """Capacity dispatch (tokens dropped at 1.25) and dropless routing, 600
    tokens (a full 512-token group and a padded one).  The seeded inputs
    hold no near-tie: the gap between the top_k-th and the next routing
    probability is far above float32 rounding, so `torch.topk` and
    `jax.lax.top_k` choose the same experts in the same order."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32",
                              capacity_factor=capacity_factor)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    p = jax.device_get(RMOE.moe_init(cfg, jax.random.PRNGKey(3), jnp.float32))
    x = (rng.normal(size=(3, 200, cfg.d_model)) * 0.3).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model)) @ p["router"], -1)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    assert float(np.min(top[:, cfg.top_k - 1] - top[:, cfg.top_k])) > 1e-5
    out_r, aux_r = RMOE.moe_apply(cfg, p, jnp.asarray(x), jnp.float32)
    out_t, aux_t = TMOE.moe_apply(tcfg, params_from_arrays(p, device="cpu"),
                                  torch.from_numpy(x), torch.float32)
    assert rel_err(out_t, out_r) < F32_REL
    assert abs(float(aux_t) - float(aux_r)) <= F32_REL * abs(float(aux_r))


@pytest.mark.parametrize("seq", [5, 31])
def test_ssm_matches_reference(seq):
    rng = np.random.default_rng(SEED)
    """Chunked SSD (chunk 8: one partial chunk, or three and a padded one)
    with its decode cache, then three decode steps."""
    cfg = dataclasses.replace(configs.get_smoke_config("mamba2-1.3b"), dtype="float32",
                              ssm_chunk=8)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    p = jax.device_get(RS.ssm_init(cfg, jax.random.PRNGKey(1), jnp.float32))
    tp = params_from_arrays(p, device="cpu")
    x = (rng.normal(size=(2, seq, cfg.d_model)) * 0.3).astype(np.float32)
    y_r, c_r = RS.ssm_apply(cfg, p, jnp.asarray(x), jnp.float32, return_state=True)
    y_t, c_t = TS.ssm_apply(tcfg, tp, torch.from_numpy(x), torch.float32, return_state=True)
    assert rel_err(y_t, y_r) < F32_REL
    for key in ("conv", "state"):
        assert rel_err(c_t[key], c_r[key]) < F32_REL
    for _ in range(3):
        xt = (rng.normal(size=(2, 1, cfg.d_model)) * 0.3).astype(np.float32)
        y_r, c_r = RS.ssm_decode(cfg, p, jnp.asarray(xt), c_r, jnp.float32)
        y_t, c_t = TS.ssm_decode(tcfg, tp, torch.from_numpy(xt), c_t, torch.float32)
        assert rel_err(y_t, y_r) < F32_REL
        assert rel_err(c_t["state"], c_r["state"]) < F32_REL


# --------------------------------------------------------- whole model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    rng = np.random.default_rng(SEED)
    """The reference's weights carried across: prefill's last logits and its
    whole cache, then one decode step's logits and cache."""
    cfg, tcfg = configs_of(arch, dtype)
    tol = F32_REL if dtype == "float32" else BF16_REL
    rp = ref_weights(arch)
    tp = params_from_arrays(rp, device="cpu")
    B, S = 2, 24
    nb = batch_for(cfg, B, S, rng)
    cache_len = cfg.max_target_len if cfg.encoder_decoder else S + 8 + (
        cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    rc, rl = M.prefill(cfg, rp, to_jax(nb), cache_len)
    tc, tl = TM.prefill(tcfg, tp, to_torch(nb), cache_len)
    assert tl.shape == (B, 1, cfg.padded_vocab) and tl.dtype == torch.float32
    assert rel_err(tl, rl) < tol
    ref_cache, port_cache = dict(leaves(jax.device_get(rc))), dict(leaves(tc))
    assert sorted(port_cache) == sorted(ref_cache)
    for path, x in port_cache.items():
        assert str(x.dtype).split(".")[-1] == str(ref_cache[path].dtype), path
        assert rel_err(x, ref_cache[path]) < tol, path
    pos = nb["tokens"].shape[1] + (cfg.num_patches if "patches" in nb else 0)
    tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    rc2, rl2 = M.decode_step(cfg, rp, rc, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
    tc2, tl2 = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tok), pos)
    assert rel_err(tl2, rl2) < tol
    ref_cache, port_cache = dict(leaves(jax.device_get(rc2))), dict(leaves(tc2))
    assert sorted(port_cache) == sorted(ref_cache)
    for path, x in port_cache.items():
        assert rel_err(x, ref_cache[path]) < tol, path


@pytest.mark.parametrize("defer", [True, False])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-medium"])
def test_block_decode_matches_reference(arch, defer):
    """One block's decode step in both cache disciplines (hymba: sliding
    window, attention and SSM; whisper: cross-attention), on a prefill
    cache of the reference's."""
    from repro.models import blocks as RB
    from repro_torch.models import blocks as TB

    cfg, tcfg = configs_of(arch, "float32")
    rp = ref_weights(arch)
    lp = jax.tree.map(lambda x: x[1], rp["layers"])
    rng = np.random.default_rng(SEED)
    nb = batch_for(cfg, 2, 12, rng)
    rcache, _ = M.prefill(cfg, rp, to_jax(nb), 20)
    rc = jax.device_get(jax.tree.map(lambda x: x[1], rcache))
    h = (rng.normal(size=(2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    window = 0 if cfg.is_global_layer(1) else cfg.sliding_window  # hymba: 8 of a 20-long cache
    pos = nb["tokens"].shape[1]
    want = RB.block_decode(cfg, lp, jnp.asarray(h), rc, jnp.asarray(pos, jnp.int32), window,
                           rope=not cfg.encoder_decoder, defer_cache_write=defer)
    got = TB.block_decode(tcfg, params_from_arrays(lp, device="cpu"), torch.from_numpy(h),
                          params_from_arrays(rc, device="cpu"), pos, window,
                          rope=not cfg.encoder_decoder, defer_cache_write=defer)
    assert rel_err(got[0], want[0]) < F32_REL
    want_c, got_c = dict(leaves(jax.device_get(want[1]))), dict(leaves(got[1]))
    assert sorted(got_c) == sorted(want_c)
    for path, x in got_c.items():
        assert rel_err(x, want_c[path]) < F32_REL, path


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium", "hymba-1.5b"])
def test_forward_hidden_matches_reference(arch):
    rng = np.random.default_rng(SEED)
    """The full-sequence stack (encoder too, for whisper) and its logits."""
    cfg, tcfg = configs_of(arch, "float32")
    rp = ref_weights(arch)
    tp = params_from_arrays(rp, device="cpu")
    nb = batch_for(cfg, 2, 20, rng)
    if cfg.encoder_decoder:
        enc_r = M._encode(cfg, rp, jnp.asarray(nb["frames"]))
        enc_t = TM._encode(tcfg, tp, torch.from_numpy(nb["frames"]))
        assert rel_err(enc_t, enc_r) < F32_REL
        return
    h, pos = M._embed_inputs(cfg, rp, to_jax(nb))
    h, aux = M.forward_hidden(cfg, rp, h, pos)
    th, tpos = TM._embed_inputs(tcfg, tp, to_torch(nb))
    th, taux = TM.forward_hidden(tcfg, tp, th, tpos)
    assert rel_err(th, h) < F32_REL and float(taux) == float(aux) == 0.0
    assert rel_err(TM._logits(tcfg, tp, th), M._logits(cfg, rp, h)) < F32_REL


def test_init_cache_matches_reference():
    for arch in configs.ARCHS:
        cfg, tcfg = configs_of(arch, "bfloat16")
        ref = dict(leaves(jax.device_get(M.init_cache(cfg, 3, 20))))
        got = dict(leaves(TM.init_cache(tcfg, 3, 20, device="cpu")))
        assert sorted(got) == sorted(ref), arch
        for path, x in got.items():
            assert tuple(x.shape) == ref[path].shape, (arch, path)
            assert str(x.dtype).split(".")[-1] == str(ref[path].dtype), (arch, path)
            assert not x.any(), (arch, path)


def test_sinusoidal_positions_equal_reference():
    assert np.array_equal(TM.sinusoidal_positions(37, 64), M.sinusoidal_positions(37, 64))


# ------------------------------------------- the reference's invariants
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_full_forward(arch):
    rng = np.random.default_rng(SEED)
    """Teacher-forced decode at position S-1 == full forward logits there
    (the port's own init, float32)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32",
                              param_dtype="float32", remat=False)
    params = TM.init_params(cfg, 7, device="cpu")
    B, S = 2, 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    cache, _ = TM.prefill(cfg, params, {"tokens": toks[:, : S - 1]}, S + 4)
    _, logits_dec = TM.decode_step(cfg, params, cache, toks[:, S - 1], S - 1)
    h, pos = TM._embed_inputs(cfg, params, {"tokens": toks})
    h, _ = TM.forward_hidden(cfg, params, h, pos)
    h = TL.apply_norm(cfg, params["final_norm"], h)
    logits_full = TM._logits(cfg, params, h)
    err = float((logits_full[:, -1] - logits_dec[:, 0]).abs().max())
    scale = float(logits_full[:, -1].abs().max()) + 1e-9
    assert err / scale < 2e-3, f"{arch}: {err / scale}"


def test_ssd_chunked_equals_sequential():
    rng = np.random.default_rng(SEED)
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("mamba2-1.3b"), dtype="float32",
        param_dtype="float32", ssm_chunk=8,
    )
    p = TS.ssm_init(cfg, torch.Generator().manual_seed(1), torch.float32, "cpu")
    B, S = 2, 31  # deliberately not a chunk multiple
    x = torch.from_numpy((rng.normal(size=(B, S, cfg.d_model)) * 0.3).astype(np.float32))
    y_full = TS.ssm_apply(cfg, p, x, torch.float32)
    cache = TS.ssm_init_cache(cfg, B, torch.float32, "cpu")
    ys = []
    for t in range(S):
        yt, cache = TS.ssm_decode(cfg, p, x[:, t : t + 1], cache, torch.float32)
        ys.append(yt)
    y_seq = torch.cat(ys, dim=1)
    rel = float((y_full - y_seq).abs().max() / (y_seq.abs().max() + 1e-9))
    assert rel < 1e-4


@pytest.mark.parametrize("window", [0, 7])
def test_blockwise_attention_matches_naive(window, monkeypatch):
    rng = np.random.default_rng(SEED)
    monkeypatch.setattr(TA, "_BLOCK_KV", 16)
    q = torch.from_numpy(rng.normal(size=(2, 40, 2, 3, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 8)).astype(np.float32))
    qp = torch.arange(40)
    bias = TA._mask_bias(qp, qp, window, True)
    naive = TA._sdpa(q, k, v, bias)
    blk = TA._sdpa_blockwise(q, k, v, qp, qp, window, True)
    assert float((naive - blk).abs().max()) < 1e-4


def test_moe_dropless_matches_dense_mix():
    rng = np.random.default_rng(SEED)
    """With capacity >= every token, grouped dispatch == explicit per-token
    top-k mixture computed densely (the port's own init)."""
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"),
        capacity_factor=8.0, dtype="float32", param_dtype="float32",
    )
    p = TMOE.moe_init(cfg, torch.Generator().manual_seed(3), torch.float32, "cpu")
    x = torch.from_numpy((rng.normal(size=(2, 16, cfg.d_model)) * 0.3).astype(np.float32))
    out, aux = TMOE.moe_apply(cfg, p, x, torch.float32)
    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(xt @ p["gate"][e]) * (xt @ p["up"][e])
        w = torch.where(idx == e, gate, 0.0).sum(-1)
        y = y + (h @ p["down"][e]) * w[:, None]
    ref = y.reshape(x.shape)
    rel = float((out - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 1e-4
    assert 0.0 <= float(aux) < 1.0


def test_segments_cover_all_layers():
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.get_config(arch)
        covered = []
        for s, e, _ in TM.layer_segments(cfg):
            covered.extend(range(s, e))
        assert covered == list(range(cfg.n_layers))
