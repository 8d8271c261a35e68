"""The port's step factories (`repro_torch.runtime.steps`) against the
reference's (`repro.runtime.steps`) on the reference's weights and the
same numpy batches: `make_train_step` over three consecutive steps, with
and without gradient accumulation and bf16 gradient compression, and
`make_prefill_step` / `make_decode_step` against the model functions they
wrap.

Tolerance: `tests/test_torch_models.py`'s, as ``max|port - reference| /
max|reference|``: ``F32_REL = 1e-4`` (float32 compute) on every metric and
on every leaf of the parameters, and of ``m`` and ``v`` after each step.
Under bf16 compression ``m`` and ``v`` are moments of bf16-rounded
gradients: a gradient element that the two packages compute a few float32
ulps apart can round to neighbouring bf16 values, one bf16 rounding
(2^-8) apart, so those two trees are held to ``BF16_REL``; they land at
1e-3 to 5.4e-3.

The optimizer runs at the training launcher's settings (``--lr 3e-4``,
warmup ``max(10, steps // 20)``).  Adam divides each moment by its root
mean square, so where a gradient element is near ``eps`` (1e-8) the
update turns on float32 noise: at a learning rate of 1e-2 with one warmup
step the parameters of the two packages part by up to 2.0e-4 relative
within three steps (up to 1.5e-3 under bf16 compression), at 3e-4 with
ten by under 4e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as configs
import repro_torch.configs as tconfigs
from repro.models import model as M
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import TrainState as RefTrainState
from repro.runtime import make_decode_step as ref_make_decode_step
from repro.runtime import make_prefill_step as ref_make_prefill_step
from repro.runtime import make_train_step as ref_make_train_step
from repro_torch.convert import params_from_arrays
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (
    TrainState,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from test_torch_models import (
    BF16_REL,
    F32_REL,
    batch_for,
    configs_of,
    leaves,
    ref_weights,
    rel_err,
    to_jax,
    to_torch,
)

B, S = 4, 32
STEPS = 3
OPT = dict(learning_rate=3e-4, warmup_steps=10, total_steps=50)


def batches(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tgts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        tgts[:, -2:] = -1
        out.append({"tokens": toks, "targets": tgts})
    return out


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_train_step_matches_reference(arch, accum, grad_dtype):
    cfg, tcfg = configs_of(arch, "float32")
    rp = ref_weights(arch)
    ref_step = jax.jit(ref_make_train_step(
        cfg, RefAdamW(grad_allreduce_dtype=grad_dtype, **OPT), accum_steps=accum))
    step = make_train_step(tcfg, AdamWConfig(grad_allreduce_dtype=grad_dtype, **OPT),
                           accum_steps=accum)
    rstate = RefTrainState(rp, ref_adamw_init(rp))
    tp = params_from_arrays(rp, device="cpu")
    state = TrainState(tp, adamw_init(tp))
    for nb in batches(cfg, seed=accum):
        rstate, rmetrics = ref_step(rstate, to_jax(nb))
        state, metrics = step(state, to_torch(nb))
        assert isinstance(state, TrainState)
        assert sorted(metrics) == sorted(rmetrics)
        for k in rmetrics:
            assert rel_err(metrics[k], rmetrics[k]) < F32_REL, k
        assert int(state.opt["step"]) == int(rstate.opt["step"])
        moment_tol = BF16_REL if grad_dtype == "bfloat16" else F32_REL
        for tree, ref, tol in ((state.params, rstate.params, F32_REL),
                               (state.opt["m"], rstate.opt["m"], moment_tol),
                               (state.opt["v"], rstate.opt["v"], moment_tol)):
            want = dict(leaves(jax.device_get(ref)))
            for path, x in leaves(tree):
                assert x.dtype == torch.float32 and not x.requires_grad, path
                assert rel_err(x, want[path]) < tol, path
    if accum > 1:
        assert sorted(metrics) == ["grad_norm", "learning_rate", "loss", "total_loss"]


def test_accumulation_averages_the_micro_slices():
    """Two micro-slices of two rows give the mean of the two slices'
    gradients (the same update as a by-hand average), and the loss is the
    mean of the slices' losses."""
    _, tcfg = configs_of("qwen3-0.6b", "float32")
    tp = params_from_arrays(ref_weights("qwen3-0.6b"), device="cpu")
    nb = to_torch(batches(tcfg, seed=5)[0])
    opt = AdamWConfig(**OPT)
    _, m2 = make_train_step(tcfg, opt, accum_steps=2)(TrainState(tp, adamw_init(tp)), nb)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in nb.items()} for i in range(2)]
    losses = [TM.train_loss(tcfg, tp, h)[0] for h in halves]
    assert rel_err(m2["loss"], ((losses[0] + losses[1]) / 2).numpy()) < F32_REL
    assert torch.equal(m2["loss"], m2["total_loss"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hymba-1.5b", "whisper-medium"])
def test_prefill_and_decode_steps_wrap_the_model(arch):
    """The factories' steps return what `prefill` / `decode_step` return,
    bit for bit, and match the reference's steps at ``F32_REL``."""
    cfg, tcfg = configs_of(arch, "float32")
    rp = ref_weights(arch)
    tp = params_from_arrays(rp, device="cpu")
    rng = np.random.default_rng(3)
    nb = batch_for(cfg, 2, 24, rng)
    cache_len = cfg.max_target_len if cfg.encoder_decoder else 40
    cache, logits = make_prefill_step(tcfg, cache_len)(tp, to_torch(nb))
    want_cache, want_logits = TM.prefill(tcfg, tp, to_torch(nb), cache_len)
    assert torch.equal(logits, want_logits)
    for (p, x), (_, y) in zip(leaves(cache), leaves(want_cache)):
        assert torch.equal(x, y), p
    rcache, rlogits = ref_make_prefill_step(cfg, cache_len)(rp, to_jax(nb))
    assert rel_err(logits, rlogits) < F32_REL
    pos = nb["tokens"].shape[1]
    tok = rng.integers(0, cfg.vocab_size, (2,)).astype(np.int32)
    new_cache, dlogits = make_decode_step(tcfg)(
        tp, {k: TM.tree_map(torch.clone, v) if isinstance(v, dict) else v.clone()
             for k, v in cache.items()}, torch.from_numpy(tok), pos)
    _, want = TM.decode_step(tcfg, tp, want_cache, torch.from_numpy(tok), pos)
    assert torch.equal(dlogits, want)
    _, rdl = ref_make_decode_step(cfg)(rp, rcache, jax.numpy.asarray(tok),
                                      jax.numpy.asarray(pos, jax.numpy.int32))
    assert rel_err(dlogits, rdl) < F32_REL
    assert not dlogits.requires_grad


def test_train_step_leaves_the_callers_state():
    """A step returns a new state and leaves the one it was given (the
    loop's rollback and the tests' comparisons rely on it)."""
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen3-0.6b"), dtype="float32")
    tp = TM.init_params(tcfg, 1, device="cpu")
    state = TrainState(tp, adamw_init(tp))
    before = [x.clone() for _, x in leaves(tp)]
    nb = to_torch(batches(configs.get_smoke_config("qwen3-0.6b"), seed=9)[0])
    new, metrics = make_train_step(tcfg, AdamWConfig(**OPT))(state, nb)
    assert all(torch.equal(x, y) for (_, x), y in zip(leaves(tp), before))
    assert int(state.opt["step"]) == 0 and int(new.opt["step"]) == 1
    assert np.isfinite(float(metrics["total_loss"])) and float(metrics["grad_norm"]) > 0
