"""The port's fault-tolerant training loop (`repro_torch.runtime.loop`) and
training launcher (`repro_torch.launch.train`): the reference's loop test
(`tests/test_runtime.py`) ported, the SIGTERM emergency checkpoint, the
rollback budget, checkpoints that cross between the two packages' loops
both ways, and ``main`` on the CPU with ``--resume``.

Losses after a resume are held to `tests/test_torch_models.py`'s
``F32_REL = 1e-4`` (float32 compute); a restored state is held bit for bit
to the state that was saved.
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as configs
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.models import model as M
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import TrainState as RefTrainState
from repro.runtime import make_train_step as ref_make_train_step
from repro.runtime.loop import LoopConfig as RefLoopConfig
from repro.runtime.loop import TrainLoop as RefTrainLoop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_arrays
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.launch import train
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import TrainState, make_train_step
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from test_torch_models import F32_REL, configs_of, leaves, rel_err

DATA = dict(seq_len=32, global_batch=2, vocab_size=64, seed=0)
OPT = dict(learning_rate=3e-4, warmup_steps=10, total_steps=50)


def _pipeline():
    return SyntheticTokenPipeline(DataConfig(**DATA), device="cpu")


def _bit_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


# ------------------------------------------------ the reference's loop test
def test_train_loop_resume_and_nan_rollback(tmp_path):
    pipeline = _pipeline()
    calls = {"n": 0}

    def fake_step(state, batch):
        calls["n"] += 1
        w = state.params["w"] + 1.0
        # transient fault: exactly the 5th *invocation* produces a NaN
        # (e.g. a poisoned batch); after rollback+skip the retry is clean
        loss = torch.tensor(np.nan if calls["n"] == 5 else 1.0 / float(w[0]))
        return TrainState({"w": w}, state.opt), {"loss": loss}

    mgr = CheckpointManager(tmp_path, async_save=False)
    loop = TrainLoop(
        fake_step, pipeline, mgr,
        LoopConfig(total_steps=8, ckpt_every=2, rollback_on_nan=True),
    )
    state = TrainState({"w": torch.zeros(1)}, {})
    final_step, state, hist = loop.run(state, 0)
    assert final_step == 8
    assert calls["n"] > 8  # rollback caused re-execution
    # the rollback restored step 4's w (4.0) and went on: 4 more steps
    assert isinstance(state, TrainState) and float(state.params["w"][0]) == 8.0
    assert len(hist) == 8 and all(np.isfinite(hist))
    # resume path
    pipeline2 = _pipeline()
    loop2 = TrainLoop(fake_step, pipeline2, mgr, LoopConfig(total_steps=8))
    start, state2 = loop2.resume_or_init(TrainState({"w": torch.zeros(1)}, {}))
    assert start == 8
    assert isinstance(state2, TrainState) and float(state2.params["w"][0]) == 8.0
    assert pipeline2.state() == pipeline.state()


def test_rollback_skips_the_poisoned_batch(tmp_path):
    """After a rollback the pipeline stands one batch past the restored
    checkpoint's position, as the reference's does."""
    pipeline = _pipeline()
    seen = []

    def step(state, batch):
        seen.append(batch["tokens"].copy())
        bad = len(seen) == 4
        return state, {"loss": torch.tensor(np.nan if bad else 1.0)}

    mgr = CheckpointManager(tmp_path, async_save=False)
    TrainLoop(step, pipeline, mgr, LoopConfig(total_steps=5, ckpt_every=2)).run(
        TrainState({"w": torch.zeros(1)}, {}))
    ref = _pipeline()
    want = [ref.next_batch()["tokens"] for _ in range(6)]
    # batches 0-3, then rollback to step 2 (pipeline after batch 1), batch 2
    # skipped, batches 3.. retried from there
    for got, i in zip(seen, [0, 1, 2, 3, 3, 4, 5]):
        np.testing.assert_array_equal(got, want[i])


def test_nan_rollbacks_exhausted_raise(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        return state, {"loss": torch.tensor(np.inf if calls["n"] > 2 else 1.0)}

    loop = TrainLoop(step, _pipeline(), mgr,
                     LoopConfig(total_steps=10, ckpt_every=1, max_nan_rollbacks=2))
    with pytest.raises(FloatingPointError, match="non-finite loss at step 2"):
        loop.run(TrainState({"w": torch.zeros(1)}, {}))
    assert calls["n"] == 5  # two clean steps, two rollbacks, then the raise
    with pytest.raises(FloatingPointError, match="before first checkpoint"):
        TrainLoop(step, _pipeline(), CheckpointManager(tmp_path / "empty"),
                  LoopConfig(total_steps=3)).run(TrainState({"w": torch.zeros(1)}, {}))


def test_sigterm_writes_an_emergency_checkpoint_and_resumes(tmp_path):
    """A SIGTERM raised from inside step 3 lets that step finish, then the
    loop writes an emergency checkpoint and breaks, restoring the previous
    handlers.  A second loop resumes from it with the pipeline's state."""
    before = signal.getsignal(signal.SIGTERM)
    pipeline = _pipeline()
    calls = {"n": 0}

    def step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        w = state.params["w"] + 1.0
        return TrainState({"w": w}, {"step": state.opt["step"] + 1}), {
            "loss": torch.tensor(1.0)}

    mgr = CheckpointManager(tmp_path, async_save=False)
    init = TrainState({"w": torch.zeros(3, dtype=torch.bfloat16)},
                      {"step": torch.zeros((), dtype=torch.int32)})
    final, state, hist = TrainLoop(
        step, pipeline, mgr, LoopConfig(total_steps=10, ckpt_every=100)).run(init)
    assert final == 3 and len(hist) == 3 and mgr.all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is before
    pipeline2 = _pipeline()
    loop2 = TrainLoop(step, pipeline2, mgr, LoopConfig(total_steps=5))
    start, restored = loop2.resume_or_init(init)
    assert start == 3 and pipeline2.state() == pipeline.state()
    assert isinstance(restored, TrainState)
    assert _bit_equal(restored.params["w"], state.params["w"])
    assert _bit_equal(restored.opt["step"], state.opt["step"])
    final2, state2, _ = loop2.run(restored, start)
    assert final2 == 5 and float(state2.params["w"][0]) == 5.0


# ------------------------------------------- checkpoints across the packages
def _ref_loop(tmp, total, cfg, rp):
    pipe = RefPipeline(RefDataConfig(**DATA))
    step = jax.jit(ref_make_train_step(cfg, RefAdamW(**OPT)))
    loop = RefTrainLoop(
        step, pipe, RefCheckpointManager(tmp, async_save=False),
        RefLoopConfig(total_steps=total, ckpt_every=2),
        make_batch=lambda b: {"tokens": jnp.asarray(b["tokens"]),
                              "targets": jnp.asarray(b["targets"])})
    return loop, pipe, RefTrainState(rp, ref_adamw_init(rp))


def _port_loop(tmp, total, tcfg, rp):
    pipe = _pipeline()
    loop = TrainLoop(
        make_train_step(tcfg, AdamWConfig(**OPT)), pipe,
        CheckpointManager(tmp, async_save=False),
        LoopConfig(total_steps=total, ckpt_every=2),
        make_batch=lambda b: {"tokens": torch.from_numpy(b["tokens"]),
                              "targets": torch.from_numpy(b["targets"])})
    tp = params_from_arrays(rp, device="cpu")
    return loop, pipe, TrainState(tp, adamw_init(tp))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_loop_checkpoint_crosses_packages(tmp_path, writer):
    """One package's loop trains 4 steps (checkpoints at 2 and 4); the other
    package's ``resume_or_init`` restores step 4 bit for bit with the
    pipeline's state, and both then train to step 6 with equal losses."""
    arch = "qwen3-0.6b"
    cfg, tcfg = configs_of(arch, "float32")
    rp = jax.device_get(M.init_params(configs.get_smoke_config(arch), jax.random.PRNGKey(2)))
    make_first, make_second = ((_ref_loop, cfg), (_port_loop, tcfg))
    if writer == "port":
        make_first, make_second = make_second, make_first
    loop, pipe, state = make_first[0](tmp_path, 4, make_first[1], rp)
    final, saved, _ = loop.run(state, 0)
    assert final == 4
    loop2, pipe2, init2 = make_second[0](tmp_path, 6, make_second[1], rp)
    start, restored = loop2.resume_or_init(init2)
    assert start == 4 and pipe2.state() == pipe.state()
    assert type(restored).__name__ == "TrainState"
    for tree, want in ((restored.params, saved.params), (restored.opt, saved.opt)):
        got_leaves = dict(leaves(tree if writer == "reference" else jax.device_get(tree)))
        want_leaves = dict(leaves(want if writer == "port" else jax.device_get(want)))
        assert sorted(got_leaves) == sorted(want_leaves)
        for path in want_leaves:
            np.testing.assert_array_equal(_numpy(got_leaves[path]),
                                          _numpy(want_leaves[path]), err_msg=path)
    _, _, resumed = loop2.run(restored, start)
    # the first package's own run from step 4 to 6
    loop3, _, _ = make_first[0](tmp_path / "again", 6, make_first[1], rp)
    loop3.pipeline.restore(pipe.state())
    _, _, own = loop3.run(saved, 4)
    assert len(resumed) == len(own) == 2
    assert rel_err(torch.tensor(resumed), np.asarray(own, np.float32)) < F32_REL


# ------------------------------------------------------------ the launcher
def test_main_trains_on_the_cpu_and_resumes(tmp_path):
    args = ["--arch", "qwen3-0.6b", "--batch", "2", "--seq", "64", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = train.main(args + ["--steps", "4"])
    assert len(first) == 4 and all(np.isfinite(first))
    mgr = CheckpointManager(tmp_path)
    assert mgr.all_steps() == [2, 4]
    manifest = mgr.load(4)[1]
    assert manifest["extra"]["data"]["step"] == 4
    assert any(k.startswith(".params/") for k in manifest["keys"])
    assert ".opt/step" in manifest["keys"]
    resumed = train.main(args + ["--steps", "6", "--resume"])
    assert len(resumed) == 2 and all(np.isfinite(resumed))
    assert mgr.all_steps() == [2, 4, 6]
    # --accum and --grad-compress take the same path
    other = train.main(args[:-4] + ["--ckpt-dir", str(tmp_path / "b"), "--device", "cpu",
                                    "--steps", "2", "--accum", "2", "--grad-compress"])
    assert len(other) == 2 and all(np.isfinite(other))


def test_main_without_device_raises_where_cuda_is_absent(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_parse_args_keeps_the_reference_flags():
    args = train.parse_args([])
    assert (args.arch, args.scale, args.steps, args.batch, args.seq, args.accum,
            args.lr, args.ckpt_every, args.resume, args.grad_compress, args.seed,
            args.device) == ("qwen3-0.6b", "smoke", 50, 4, 256, 1, 3e-4, 100,
                             False, False, 0, "cuda")
    cfg = train.scaled_config(train.parse_args(["--layers", "1", "--d-model", "64"]))
    assert dataclasses.asdict(cfg)["n_layers"] == 1 and cfg.d_model == 64
