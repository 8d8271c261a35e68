"""The port's AdamW and cosine schedule (`repro_torch.optim`) against the
reference's (`repro.optim`) on the same numpy gradients, and the
reference's optimizer tests (`tests/test_runtime.py`) ported.

Bound: both packages do the same float32 tensor arithmetic on the step
(schedule, bias corrections, clip scale), so the only differences come
from ``cos`` and ``pow``, whose implementations (XLA's, PyTorch's) may
round differently by a few float32 ulps.  The learning rate is held to
``MAX_ULPS`` float32 ulps, and parameters and moments after the updates
to ``F32_REL = 1e-4`` relative (they land within a few ulps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

MAX_ULPS = 4
F32_REL = 1e-4
SCHEDULES = [
    dict(warmup_steps=10, total_steps=100),
    dict(learning_rate=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(warmup_steps=0, total_steps=10),
    dict(),
]


def ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(a - b)))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def numpy_tree(rng, scale=1.0):
    return {"embed": (rng.normal(size=(6, 4)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(2, 4, 3)) * scale).astype(np.float32),
                       "b": (rng.normal(size=(2, 3)) * scale).astype(np.float32)},
            "norm": (rng.normal(size=(4,)) * scale).astype(np.float32)}


def tmap(fn, tree):
    return {k: tmap(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("kw", SCHEDULES)
def test_cosine_schedule_matches_reference(kw):
    ref_cfg, cfg = RA.AdamWConfig(**kw), AdamWConfig(**kw)
    want = [np.float32(RA.cosine_schedule(ref_cfg, jnp.asarray(s, jnp.int32)))
            for s in range(102)]
    got = [cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)) for s in range(102)]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    assert ulps([g.item() for g in got], want) <= MAX_ULPS


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(warmup_steps=3, total_steps=12),
                                dict(clip_norm=1e-3, warmup_steps=0, total_steps=5),
                                dict(weight_decay=0.0, clip_norm=100.0)])
def test_adamw_update_matches_reference(kw, grad_dtype):
    """Twelve updates on the same numpy gradients (large ones, so the clip
    engages in the first two configs): params, ``m``, ``v``, ``step``,
    ``grad_norm`` and ``learning_rate`` after each."""
    rng = np.random.default_rng(0)
    ref_cfg, cfg = RA.AdamWConfig(**kw), AdamWConfig(**kw)
    p0 = numpy_tree(rng)
    rp, tp = tmap(jnp.asarray, p0), tmap(torch.from_numpy, p0)
    ro, to = RA.adamw_init(rp), adamw_init(tp)
    assert to["step"].dtype == torch.int32 and to["step"].dim() == 0
    assert all(v.dtype == np.float32 for _, v in flat(to["m"]))
    for _ in range(12):
        g = numpy_tree(rng, scale=5.0)
        rg = tmap(lambda x: jnp.asarray(x).astype(grad_dtype), g)
        tg = tmap(lambda x: torch.from_numpy(x).to(getattr(torch, grad_dtype)), g)
        rp, ro, rm = RA.adamw_update(ref_cfg, rp, rg, ro)
        tp, to, tm = adamw_update(cfg, tp, tg, to)
        assert int(to["step"]) == int(ro["step"]) and to["step"].dtype == torch.int32
        assert rel(tm["grad_norm"], rm["grad_norm"]) < F32_REL
        assert ulps(tm["learning_rate"].item(), rm["learning_rate"]) <= MAX_ULPS
        for tree, ref in ((tp, rp), (to["m"], ro["m"]), (to["v"], ro["v"])):
            ref = dict(flat(jax.device_get(ref)))
            for path, x in flat(tree):
                assert x.dtype == ref[path].dtype, path
                assert rel(x, ref[path]) < F32_REL, path


def test_bf16_cast_of_gradients_is_bit_equal():
    """The compression cast (`grad_allreduce_dtype="bfloat16"`) rounds the
    same numpy gradients to the same bf16 bits in both packages."""
    rng = np.random.default_rng(1)
    g = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
                        [0.0, -0.0, 1e-40, 3.0e38, np.inf, -np.inf]]).astype(np.float32)
    want = np.asarray(jnp.asarray(g).astype(jnp.bfloat16)).view(np.uint16)
    got = torch.from_numpy(g).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    tree = numpy_tree(rng, scale=3.0)
    want = RA.global_norm(tmap(jnp.asarray, tree))
    got = global_norm(tmap(torch.from_numpy, tree))
    assert rel(got, want) < F32_REL


# --------------------------------- the reference's tests/test_runtime.py
def test_adamw_converges_quadratic():
    cfg = AdamWConfig(learning_rate=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        params, opt, metrics = adamw_update(cfg, params, {"w": g}, opt)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)
    assert int(opt["step"]) == 200


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(learning_rate=1.0, clip_norm=1e-3, weight_decay=0.0,
                      warmup_steps=0, total_steps=10)
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    g = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(cfg, params, g, opt)
    assert float(metrics["grad_norm"]) > 1e5  # raw norm reported


def test_cosine_schedule_shape():
    cfg = AdamWConfig(learning_rate=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] < lrs[9] <= 1.0
    assert abs(lrs[10] - 1.0) < 0.1
    assert lrs[-1] == pytest.approx(0.1, abs=0.02)


def test_update_leaves_its_inputs_and_keeps_dtypes():
    """The update is functional (the loop's rollback keeps the old state)
    and a bf16 parameter stays bf16, updated through float32."""
    params = {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    before = tmap(torch.clone, params)
    new, new_opt, _ = adamw_update(AdamWConfig(warmup_steps=0), params,
                                   tmap(torch.ones_like, params), opt)
    assert all(torch.equal(params[k], before[k]) for k in params)
    assert int(opt["step"]) == 0 and int(new_opt["step"]) == 1
    assert new["b"].dtype == torch.bfloat16 and new_opt["m"]["b"].dtype == torch.float32
    assert not torch.equal(new["a"], params["a"])
