"""The port's training loss and its gradient (`repro_torch.models.model.
train_loss` under ``torch.autograd``) against the reference's
(``jax.value_and_grad(repro.models.model.train_loss)``) on the reference's
own weights, carried across with `params_from_arrays`.

Tolerances are `tests/test_torch_models.py`'s, as
``max|port - reference| / max|reference|`` per value or gradient leaf:
``F32_REL = 1e-4`` in float32 and ``BF16_REL = 16 * 2**-8`` in bfloat16.
Every arch is held in float32 on the loss, ``aux_loss``, ``tokens`` and
each gradient leaf; the MoE archs only in float32 (a bf16 route flip moves
a whole expert, see that file's docstring), the others also in bf16 on the
loss and the gradient's global norm.

One kind of leaf has no relative measure: the key projection's bias of an
attention without RoPE (whisper's encoder, decoder and cross attention).
Adding ``q . b`` to every score of a query leaves its softmax unchanged, so
that gradient is zero in exact arithmetic, and both packages return
rounding noise near 1e-8 of the tree's largest gradient.  Those leaves are
held to ``F32_REL`` times the largest reference gradient of the tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as configs
import repro_torch.configs as tconfigs
from repro.models import model as M
from repro_torch.convert import params_from_arrays
from repro_torch.models import model as TM
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

MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
SEED = 0
B, S = 2, 32


def train_batch(cfg, rng, mask_some=True):
    """`batch_for`'s inputs plus targets: the text positions only (a VLM's
    logits then lose their patch positions), a few set to -1."""
    nb = batch_for(cfg, B, S, rng)
    nb["targets"] = rng.integers(0, cfg.vocab_size, nb["tokens"].shape).astype(np.int32)
    if mask_some:
        nb["targets"][0, :3] = -1
        nb["targets"][1, -1] = -1
    return nb


def zero_grad_leaf(cfg, path) -> bool:
    """A key bias of an attention without RoPE (see the module docstring)."""
    return cfg.encoder_decoder and path.endswith("k/bias")


def ref_loss_and_grads(cfg, params, nb):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: M.train_loss(cfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(params, to_jax(nb))
    return loss, jax.device_get(metrics), dict(leaves(jax.device_get(grads)))


def port_loss_and_grads(cfg, params, nb):
    tracked = []

    def track(x):
        x = x.detach().requires_grad_(True)
        tracked.append(x)
        return x

    tree = TM.tree_map(track, params)
    loss, metrics = TM.train_loss(cfg, tree, to_torch(nb))
    grads = torch.autograd.grad(loss, tracked, allow_unused=True)
    paths = [p for p, _ in leaves(tree)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {p: (torch.zeros_like(x) if g is None else g)
             for (p, x), g in zip(leaves(tree), grads)}, paths)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_loss_and_every_gradient_leaf_match_reference_f32(arch):
    cfg, tcfg = configs_of(arch, "float32")
    rng = np.random.default_rng(SEED)
    nb = train_batch(cfg, rng)
    rp = ref_weights(arch)
    loss, metrics, grads = ref_loss_and_grads(cfg, rp, nb)
    tloss, tmetrics, tgrads, paths = port_loss_and_grads(
        tcfg, params_from_arrays(rp, device="cpu"), nb)
    assert rel_err(tloss, loss) < F32_REL
    assert rel_err(tmetrics["loss"], metrics["loss"]) < F32_REL
    assert float(tmetrics["tokens"]) == float(metrics["tokens"]) == nb["targets"].size - 4
    if arch in MOE_ARCHS:
        assert float(metrics["aux_loss"]) > 0
        assert rel_err(tmetrics["aux_loss"], metrics["aux_loss"]) < F32_REL
    else:
        assert float(tmetrics["aux_loss"]) == float(metrics["aux_loss"]) == 0.0
    assert sorted(paths) == sorted(grads)
    scale = max(float(np.max(np.abs(g))) for g in grads.values())
    for path in paths:
        got, want = tgrads[path], grads[path]
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32, path
        if zero_grad_leaf(cfg, path):
            assert float(np.max(np.abs(want))) < F32_REL * scale, path
            assert float(got.abs().max()) < F32_REL * scale, path
        else:
            assert rel_err(got, want) < F32_REL, path


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS if a not in MOE_ARCHS])
def test_loss_and_grad_norm_match_reference_bf16(arch):
    """bf16 compute, float32 parameters: the loss and the gradient's global
    norm."""
    cfg, tcfg = configs_of(arch, "bfloat16")
    rng = np.random.default_rng(SEED)
    nb = train_batch(cfg, rng)
    rp = ref_weights(arch)
    loss, _, grads = ref_loss_and_grads(cfg, rp, nb)
    tloss, _, tgrads, _ = port_loss_and_grads(tcfg, params_from_arrays(rp, device="cpu"), nb)
    norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float32))) for g in grads.values()))
    tnorm = torch.sqrt(sum(g.float().square().sum() for g in tgrads.values()))
    assert rel_err(tloss, loss) < BF16_REL
    assert rel_err(tnorm, norm) < BF16_REL


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi-3-vision-4.2b", "whisper-medium"])
def test_masked_targets_patch_strip_and_frames(arch):
    """Fully masked rows add nothing (the loss averages over the unmasked
    tokens only); a VLM's targets cover the text positions after its
    patches; whisper's frames reach the loss through the encoder."""
    cfg, tcfg = configs_of(arch, "float32")
    rng = np.random.default_rng(SEED + 1)
    nb = train_batch(cfg, rng, mask_some=False)
    tp = params_from_arrays(ref_weights(arch), device="cpu")
    masked = dict(nb, targets=nb["targets"].copy())
    masked["targets"][1] = -1
    one_row = {k: v[:1] for k, v in nb.items()}
    full, fm = TM.train_loss(tcfg, tp, to_torch(masked))
    row, rm = TM.train_loss(tcfg, tp, to_torch(one_row))
    assert float(fm["tokens"]) == float(rm["tokens"]) == nb["targets"].shape[1]
    assert rel_err(full, row.numpy()) < F32_REL
    rl, rmetrics = M.train_loss(cfg, ref_weights(arch), to_jax(masked))
    assert rel_err(full, rl) < F32_REL
    none = dict(nb, targets=np.full_like(nb["targets"], -1))
    loss, metrics = TM.train_loss(tcfg, tp, to_torch(none))
    assert float(loss) == 0.0 and float(metrics["tokens"]) == 0.0
    if cfg.frontend == "vision_stub":
        assert nb["targets"].shape[1] == nb["tokens"].shape[1] < (
            nb["tokens"].shape[1] + cfg.num_patches)
    if cfg.encoder_decoder:
        moved = dict(nb, frames=np.ascontiguousarray(nb["frames"][:, ::-1]))
        assert float(TM.train_loss(tcfg, tp, to_torch(moved))[0]) != float(
            TM.train_loss(tcfg, tp, to_torch(nb))[0])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m",
                                  "hymba-1.5b", "whisper-medium"])
def test_remat_changes_no_value(arch):
    """``remat=True`` (per-layer checkpointing, the default) and
    ``remat=False`` give bit-equal losses and gradients."""
    rng = np.random.default_rng(SEED)
    cfg = configs.get_smoke_config(arch)
    nb = train_batch(cfg, rng)
    tp = params_from_arrays(ref_weights(arch), device="cpu")
    out = {}
    for remat in (True, False):
        tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
        out[remat] = port_loss_and_grads(tcfg, tp, nb)
    assert torch.equal(out[True][0], out[False][0])
    for path in out[True][3]:
        assert torch.equal(out[True][2][path], out[False][2][path]), path


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_smoke_train_step(arch, rng):
    """The reference's `tests/test_models.py` invariant on the port's own
    init: one loss and gradient on the smoke config (bf16 compute), finite,
    with tokens counted and a non-zero gradient."""
    cfg = tconfigs.get_smoke_config(arch)
    params = TM.init_params(cfg, 0, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    if cfg.encoder_decoder:
        nb = {"frames": (rng.normal(size=(2, 32, cfg.d_model)) * 0.1).astype(np.float32),
              "tokens": toks[:, :16], "targets": toks[:, :16]}
    elif cfg.frontend == "vision_stub":
        P = cfg.num_patches
        nb = {"patches": (rng.normal(size=(2, P, cfg.d_model)) * 0.1).astype(np.float32),
              "tokens": toks[:, : 32 - P], "targets": toks}
    else:
        nb = {"tokens": toks, "targets": toks}
    loss, metrics, grads, _ = port_loss_and_grads(cfg, params, nb)
    assert np.isfinite(float(loss))
    assert float(metrics["tokens"]) > 0
    gnorm = sum(float(g.abs().sum()) for g in grads.values())
    assert np.isfinite(gnorm) and gnorm > 0
