"""Deterministic, checkpointable synthetic token pipeline.

Generates documents with a reproducible counter-based PRNG (stateless in
(seed, index), so any batch can be regenerated from the iterator state),
packs them into fixed-length sequences with the paper's bin packer, and
yields sharded-ready numpy batches.  The iterator state is two integers —
it snapshots into every checkpoint and restores exactly.

The port of ``repro.data.pipeline``: documents still come from numpy's
counter-based generator, so its batches are bit-equal to the reference's
and its state crosses the two packages; the one addition is ``device``,
passed on to `pack_documents` (``None`` means ``"cuda"``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab_size: int = 32_000
    mean_doc_len: int = 384
    max_docs_per_seq: int = 8
    seed: int = 0
    pack: bool = True  # NFD sequence packing vs one doc per row


class SyntheticTokenPipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.doc_index = 0  # persistent iterator state
        self.step = 0

    # ------------------------------------------------------------- state
    def state(self) -> dict:
        return {"doc_index": self.doc_index, "step": self.step}

    def restore(self, state: dict) -> None:
        self.doc_index = int(state["doc_index"])
        self.step = int(state["step"])

    # ----------------------------------------------------------- internals
    def _doc(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed << 32) ^ idx)
        length = int(
            np.clip(rng.lognormal(np.log(self.cfg.mean_doc_len), 0.6), 8,
                    self.cfg.seq_len)
        )
        return rng.integers(2, self.cfg.vocab_size, size=length, dtype=np.int32)

    # ------------------------------------------------------------- batches
    def next_batch(self) -> dict:
        cfg = self.cfg
        rows_needed = cfg.global_batch
        tokens = np.zeros((rows_needed, cfg.seq_len), np.int32)
        targets = np.full((rows_needed, cfg.seq_len), -1, np.int32)
        segments = np.zeros((rows_needed, cfg.seq_len), np.int32)

        if cfg.pack:
            # draw a pool of docs ~1.2x the token budget, pack, take rows
            docs: list[np.ndarray] = []
            budget = int(rows_needed * cfg.seq_len * 1.2)
            got = 0
            while got < budget:
                d = self._doc(self.doc_index)
                self.doc_index += 1
                docs.append(d)
                got += len(d)
            from .packing import pack_documents

            seqs = pack_documents(
                [len(d) for d in docs], cfg.seq_len, cfg.max_docs_per_seq,
                seed=cfg.seed + self.step, device=self.device,
            )
            for row in range(rows_needed):
                seq = seqs[row % len(seqs)]
                off = 0
                for si, di in enumerate(seq):
                    d = docs[di]
                    n = min(len(d), cfg.seq_len - off)
                    if n <= 1:
                        break
                    tokens[row, off : off + n] = d[:n]
                    targets[row, off : off + n - 1] = d[1:n]
                    segments[row, off : off + n] = si + 1
                    off += n
        else:
            for row in range(rows_needed):
                d = self._doc(self.doc_index)
                self.doc_index += 1
                n = min(len(d), cfg.seq_len)
                tokens[row, :n] = d[:n]
                targets[row, : n - 1] = d[1:n]
                segments[row, :n] = 1
        self.step += 1
        return {"tokens": tokens, "targets": targets, "segments": segments}
