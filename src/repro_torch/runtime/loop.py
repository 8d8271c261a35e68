"""Fault-tolerant training loop (the port of ``repro.runtime.loop``).

Production behaviors on top of the bare train_step:
* checkpoint/restart (resume from latest; data-iterator state rides along);
* NaN/Inf loss detection with rollback-and-skip (reload last good
  checkpoint, fast-forward the data pipeline past the poison window);
* SIGTERM/SIGINT emergency checkpoint (preemption-safe);
* step-time EWMA heartbeat — the per-host hook where a multi-host deploy
  reports to the straggler detector (slowest-worker logging here);
* periodic + final checkpointing, async writes.

Checkpoints are the reference's layout and keys (``.params/...``,
``.opt/...``), so a run checkpointed by either package resumes in the
other.  A restore places every leaf on the device of the state it
replaces and comes back as a `TrainState`.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import signal
import time

import torch

from ..checkpoint import CheckpointManager
from ..models.model import tree_leaves
from .steps import TrainState

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    rollback_on_nan: bool = True
    max_nan_rollbacks: int = 3
    straggler_factor: float = 2.0  # heartbeat: warn when step > factor * EWMA


class TrainLoop:
    def __init__(
        self,
        train_step,  # (state, batch) -> (state, metrics)
        pipeline,  # SyntheticTokenPipeline-like (next_batch/state/restore)
        ckpt: CheckpointManager,
        cfg: LoopConfig,
        make_batch=lambda np_batch: np_batch,
    ):
        self.train_step = train_step
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.cfg = cfg
        self.make_batch = make_batch
        self._interrupted = False
        self._ewma = None

    # ---------------------------------------------------------------- run
    def run(self, state: TrainState, start_step: int = 0):
        cfg = self.cfg
        step = start_step
        nan_rollbacks = 0
        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, self._on_signal)
        history = []
        try:
            while step < cfg.total_steps:
                if self._interrupted:
                    log.warning("interrupt: emergency checkpoint at step %d", step)
                    self.ckpt.save(step, state, extra={"data": self.pipeline.state()})
                    self.ckpt.wait()
                    break
                t0 = time.perf_counter()
                np_batch = self.pipeline.next_batch()
                batch = self.make_batch(np_batch)
                state, metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self._heartbeat(step, dt)
                if not math.isfinite(loss):
                    if cfg.rollback_on_nan and nan_rollbacks < cfg.max_nan_rollbacks:
                        nan_rollbacks += 1
                        log.error(
                            "non-finite loss at step %d; rollback #%d", step,
                            nan_rollbacks,
                        )
                        step, state = self._rollback(state)
                        continue
                    raise FloatingPointError(f"non-finite loss at step {step}")
                history.append(loss)
                step += 1
                if step % cfg.log_every == 0:
                    log.info("step %d loss %.4f (%.2fs/step)", step, loss, dt)
                if step % cfg.ckpt_every == 0:
                    self.ckpt.save(step, state, extra={"data": self.pipeline.state()})
            self.ckpt.save(step, state, extra={"data": self.pipeline.state()})
            self.ckpt.wait()
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        return step, state, history

    # ------------------------------------------------------------- helpers
    def _on_signal(self, signum, frame):
        self._interrupted = True

    def _heartbeat(self, step: int, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
        if dt > self.cfg.straggler_factor * self._ewma and step > 3:
            # multi-host: this is where the controller would be notified /
            # the slow host replaced; single-host: log it
            log.warning(
                "straggler heartbeat: step %d took %.2fs (EWMA %.2fs)",
                step, dt, self._ewma,
            )
        self._ewma = 0.9 * self._ewma + 0.1 * dt

    def _restore(self, like: TrainState):
        leaf = next(tree_leaves(like.params), None)
        device = leaf.device if isinstance(leaf, torch.Tensor) else None
        step, restored, extra = self.ckpt.restore(like, device=device)
        self.pipeline.restore(extra["data"])
        return step, restored

    def _rollback(self, state: TrainState):
        if self.ckpt.latest_step() is None:
            raise FloatingPointError("non-finite loss before first checkpoint")
        step, restored = self._restore(state)
        # skip past the poisoned window deterministically
        self.pipeline.next_batch()
        return step, restored

    def resume_or_init(self, init_state: TrainState):
        if self.ckpt.latest_step() is None:
            return 0, init_state
        step, restored = self._restore(init_state)
        log.info("resumed from checkpoint step %d", step)
        return step, restored
