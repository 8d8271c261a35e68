"""The port's serving path (`repro_torch.launch.decode_demo`) against the
reference's (`repro.launch.decode_demo`'s prefill / decode loop and
`repro.memory.plan_packing`), on the reference's own weights carried
across with `params_from_arrays`:

* a greedy generation, teacher-forced on the reference's tokens, within
  float32 tolerance of the reference's logits at every step, and the
  port's own greedy tokens equal to the reference's;
* ``--packed``: the port's plan of the carried tree equal to the
  reference's (a budget the GA never reaches, so both stop on patience,
  as in `tests/test_torch_memory.py`), ``unpack()`` bit-equal to the tree,
  and packed and unpacked generations bit-equal;
* ``decode_demo.main([... "--device", "cpu"])`` at smoke scale.

Float32 configs (``dtype="float32"``), tolerance ``F32_REL`` as in
`tests/test_torch_models.py`: the relative max error of each step's
logits.  The seeds used give no near-tie in any greedy argmax or MoE
route: a flip would change a token, and the tokens are compared exactly.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs
from repro.memory import PackedParameterStore as RefStore
from repro.memory import plan_packing as ref_plan_packing
from repro.models import model as M
from repro_torch.convert import params_from_arrays
from repro_torch.launch import decode_demo
from repro_torch.memory import PackedParameterStore, plan_packing
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
F32_REL = 1e-4
MAX_SECONDS = 600.0
ARCHS = ["qwen3-0.6b", "granite-moe-1b-a400m", "whisper-medium", "phi-3-vision-4.2b",
         "hymba-1.5b", "mamba2-1.3b"]


def rel_err(port, ref) -> float:
    a = port.float().numpy()
    b = np.asarray(ref).astype(np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def demo_args(arch, *extra):
    return decode_demo.parse_args(["--arch", arch, "--batch", "2", "--prompt-len", "12",
                                   "--gen-len", "6", "--device", "cpu", *extra])


@functools.lru_cache(maxsize=None)
def ref_run(arch):
    """The reference decode_demo's loop (jitted prefill / decode, greedy over
    ``[: vocab_size]``) on its own seed-0 weights at float32; returns
    (numpy weights, numpy batch, cache_len, tokens (B, G), logits (G, B, V))."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    args = demo_args(arch)
    batch, cache_len = decode_demo.make_batch(cfg, args, torch.device("cpu"))
    nb = {k: v.numpy() for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    prefill = jax.jit(lambda p, bt: M.prefill(cfg, p, bt, cache_len))
    decode = jax.jit(lambda p, c, t, pos: M.decode_step(cfg, p, c, t, pos))
    cache, logits = prefill(params, jb)
    steps = [logits[:, -1, : cfg.vocab_size]]
    tok = jnp.argmax(steps[-1], axis=-1).astype(jnp.int32)
    toks = [tok]
    pos0 = jb["tokens"].shape[1] + (cfg.num_patches if "patches" in jb else 0)
    for i in range(args.gen_len - 1):
        cache, logits = decode(params, cache, tok, jnp.asarray(pos0 + i, jnp.int32))
        steps.append(logits[:, -1, : cfg.vocab_size])
        tok = jnp.argmax(steps[-1], axis=-1).astype(jnp.int32)
        toks.append(tok)
    return (jax.device_get(params), nb, cache_len, np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(s) for s in steps]))


def test_make_batch_draws_the_reference_prompts():
    """The port's prompts, patches and frames are the reference demo's:
    ``default_rng(seed)`` drawn in the same order."""
    for arch in ("qwen3-0.6b", "phi-3-vision-4.2b", "whisper-medium"):
        cfg = configs.get_smoke_config(arch)
        args = demo_args(arch, "--seed", "5")
        batch, cache_len = decode_demo.make_batch(cfg, args, torch.device("cpu"))
        rng = np.random.default_rng(5)
        prompts = rng.integers(2, cfg.vocab_size, (2, 12))
        want = {"tokens": prompts}
        want_len = 12 + 6
        if cfg.frontend == "vision_stub":
            want["patches"] = rng.normal(size=(2, cfg.num_patches, cfg.d_model)) * 0.02
            want_len += cfg.num_patches
        if cfg.encoder_decoder:
            want = {"frames": rng.normal(size=(2, 12, cfg.d_model)) * 0.02,
                    "tokens": prompts[:, :4]}
        assert cache_len == want_len and sorted(batch) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v).astype(batch[k].numpy().dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_generation_matches_reference_loop(arch):
    params, nb, cache_len, ref_tokens, ref_logits = ref_run(arch)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    tp = params_from_arrays(params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    # teacher-forced on the reference's tokens: every step's logits
    cache, logits = TM.prefill(cfg, tp, batch, cache_len)
    assert rel_err(logits[:, -1, : cfg.vocab_size], ref_logits[0]) < F32_REL
    pos0 = nb["tokens"].shape[1] + (cfg.num_patches if "patches" in nb else 0)
    for i in range(ref_tokens.shape[1] - 1):
        tok = torch.from_numpy(ref_tokens[:, i].astype(np.int64))
        cache, logits = TM.decode_step(cfg, tp, cache, tok, pos0 + i)
        assert rel_err(logits[:, -1, : cfg.vocab_size], ref_logits[i + 1]) < F32_REL, i
    # the port's own greedy loop chooses the reference's tokens
    tokens, steps, _, _ = decode_demo.generate(cfg, tp, batch, ref_tokens.shape[1], cache_len)
    np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
    assert steps.shape == ref_logits.shape and rel_err(steps, ref_logits) < F32_REL


def plan_key(plans):
    return {
        isz: dict(
            banks=[[(e.path, e.row_offset, e.rows, e.cols, tuple(e.shape)) for e in b]
                   for b in p.banks],
            unpacked=list(p.unpacked), before=p.padded_bytes_before,
            after=p.padded_bytes_after, logical=p.logical_bytes,
            packer=None if p.packer_result is None else (
                p.packer_result.cost, p.packer_result.iterations),
        )
        for isz, p in plans.items()
    }


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m", "whisper-medium"])
def test_packed_path_matches_reference_plan_and_serves_bit_equal(arch):
    params, nb, cache_len, ref_tokens, _ = ref_run(arch)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype="float32")
    tp = params_from_arrays(params, device="cpu")
    plans = plan_packing(tp, max_seconds=MAX_SECONDS, split_stacked=True, device="cpu")
    want = ref_plan_packing(params, max_seconds=MAX_SECONDS, split_stacked=True)
    assert plan_key(plans) == plan_key(want)
    for p in plans.values():
        r = p.packer_result
        assert r is None or r.wall_time_s < MAX_SECONDS  # stopped on patience
    store = PackedParameterStore(tp, plans)
    ref_store = RefStore(params, want)
    assert store.stats() == ref_store.stats()
    served = store.unpack()
    flat = dict(leaves(tp))
    assert sorted(flat) == sorted(dict(leaves(served)))
    for path, x in leaves(served):
        assert x.dtype == flat[path].dtype and torch.equal(x, flat[path]), path
    assert plans[4].banks, "the smoke tree packs something"
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    g = ref_tokens.shape[1]
    t_plain, l_plain, _, _ = decode_demo.generate(cfg, tp, batch, g, cache_len)
    t_packed, l_packed, _, _ = decode_demo.generate(cfg, served, batch, g, cache_len)
    assert torch.equal(t_packed, t_plain) and torch.equal(l_packed, l_plain)
    np.testing.assert_array_equal(t_packed.numpy(), ref_tokens)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m", "whisper-medium",
                                  "phi-3-vision-4.2b", "mamba2-1.3b", "hymba-1.5b"])
def test_main_runs_at_smoke_scale_on_the_cpu(arch, capsys):
    gen = decode_demo.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                            "--gen-len", "4", "--device", "cpu"])
    cfg = configs.get_smoke_config(arch)
    assert gen.shape == (2, 4) and ((0 <= gen) & (gen < cfg.vocab_size)).all()
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "tok/s" in out


def test_main_packed_reports_the_store_and_serves_what_it_plans(capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--batch", "2", "--prompt-len", "16",
            "--gen-len", "8", "--device", "cpu"]
    run = decode_demo.run(decode_demo.parse_args(argv + ["--packed"]))
    out = capsys.readouterr().out
    assert "packed itemsize=4:" in out and "banks, eff" in out
    assert run.store is not None and run.store.banks
    for path, x in leaves(run.tree):
        assert torch.equal(x, dict(leaves(run.params))[path]), path
    plain = decode_demo.run(decode_demo.parse_args(argv))
    np.testing.assert_array_equal(run.tokens, plain.tokens)
    assert torch.equal(run.logits, plain.logits)
    assert run.logits.shape == (8, 2, configs.get_smoke_config("granite-moe-1b-a400m").vocab_size)
    assert {"init", "plan", "store", "prefill", "decode"} <= set(run.seconds)


def test_main_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_demo.main(["--arch", "qwen3-0.6b", "--gen-len", "2"])


def test_serve_packed_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_packed_torch.py"),
         "--arch", "granite-moe-1b-a400m", "--batch", "2", "--prompt-len", "16",
         "--gen-len", "8", "--packed", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "packed itemsize=4" in out.stdout and "generated (2, 8)" in out.stdout
