"""Persistent fingerprint-keyed result store for the packing service (the
port's `repro.serve.store`, in the reference's on-disk layout).

One entry per task key (:func:`repro_torch.core.dse.task_key` — problem
fingerprint + algorithm + seed + settings), laid out with the durable-
artifact convention of ``repro_torch.checkpoint`` (shared helpers
``write_atomic_dir``/``read_atomic_dir``):

    <dir>/entry_<digest>/
        arrays.npz     — the packing itself: flattened bins + kind lane
        manifest.json  — format, task digest, sha256 of arrays.npz, and the
                         JSON remainder of the PackingResult (cost,
                         efficiency, trace, iterations, params, ...)

The digest, the arrays and the manifest are the reference's, so an entry
written by either package is served by the other (for the task keys the
two packages share: backend ``"auto"`` or ``"python"``;
``tests/test_torch_serve_store.py`` holds both directions).

Guarantees:

* **atomic**: entries are written to a unique scratch dir and published
  with one ``os.rename`` — a crash mid-write never leaves a half-written
  entry, and a *concurrent second writer* that loses the publish race
  discards its scratch copy instead of touching the winner (safe because
  entries are immutable: equal task keys mean bit-identical results);
* **digest-verified reads**: ``get`` sha256-checks ``arrays.npz`` against
  the manifest and validates the task digest; a torn, corrupted, or
  half-deleted entry is *skipped with a logged warning and never served* —
  the caller simply recomputes (and the recompute's ``put`` replaces the
  damaged entry);
* **warm restarts**: a service restarted over the same store dir serves
  every previously-completed task from disk, bit-identically.

Results round-trip through the ``repro_torch.core.resume`` result codec,
the same serializer the crash-safe sweep checkpoints use, so "stored
result" and "checkpointed result" can never drift apart.
"""
from __future__ import annotations

import logging
import shutil
from pathlib import Path

import numpy as np

from ..checkpoint import read_atomic_dir, write_atomic_dir
from ..core.problem import PackingProblem, PackingResult, Solution
from ..core.resume import result_from_state, result_state, task_digest

logger = logging.getLogger(__name__)

FORMAT = 1

_PREFIX = "entry_"


def _solution_arrays(sol: Solution) -> dict[str, np.ndarray]:
    """Flatten a ragged packing into dense int64 arrays for ``arrays.npz``."""
    return {
        "bins_flat": np.asarray(
            [i for b in sol.bins for i in b], dtype=np.int64
        ),
        "bin_sizes": np.asarray([len(b) for b in sol.bins], dtype=np.int64),
        "kinds": np.asarray(sol.kinds, dtype=np.int64),
    }


def _solution_state(flat: dict[str, np.ndarray]) -> dict:
    """Rebuild the ``Solution.state_dict`` payload from the dense arrays."""
    sizes = flat["bin_sizes"]
    if len(flat["kinds"]) != len(sizes):
        raise IOError("kind lane misaligned with bins")
    if int(sizes.sum()) != len(flat["bins_flat"]):
        raise IOError("bin sizes do not cover the flattened items")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    bins = [
        [int(i) for i in flat["bins_flat"][offsets[b]:offsets[b + 1]]]
        for b in range(len(sizes))
    ]
    return {"bins": bins, "kinds": [int(k) for k in flat["kinds"]]}


class ResultStore:
    """Persistent, digest-verified map ``task key -> PackingResult``.

    Every ``get`` reads from disk: the in-process cache of warm traffic is
    the service's own (``PackingService``'s memory tier), so the store has
    none.  (The reference's ``memory_cache`` option, which its service
    turns off, is not kept.)
    """

    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        # observability counters (served by PackingService.stats())
        self.hits = 0
        self.misses = 0
        self.corrupt_skipped = 0
        self.lost_races = 0

    # ------------------------------------------------------------- layout
    def path_for(self, key: tuple) -> Path:
        return self.dir / f"{_PREFIX}{task_digest(key)}"

    def digests(self) -> list[str]:
        """Digests of the complete-looking entries on disk (unverified)."""
        out = []
        for p in self.dir.glob(f"{_PREFIX}*"):
            if ".tmp" in p.name or not (p / "manifest.json").is_file():
                continue
            out.append(p.name[len(_PREFIX):])
        return sorted(out)

    def __len__(self) -> int:
        return len(self.digests())

    def __contains__(self, key: tuple) -> bool:
        return (self.path_for(key) / "manifest.json").is_file()

    # ---------------------------------------------------------------- get
    def get(self, key: tuple, prob: PackingProblem) -> PackingResult | None:
        """The stored result for ``key``, or None (miss / damaged entry).

        A damaged entry — torn npz, scribbled manifest, missing file, task
        digest mismatch, sha256 mismatch — is **never served**: it logs a
        warning, counts in ``corrupt_skipped``, and reads as a miss so the
        caller recomputes (whose ``put`` then replaces the damage).
        """
        digest = task_digest(key)
        path = self.dir / f"{_PREFIX}{digest}"
        if not path.exists():
            self.misses += 1
            return None
        try:
            flat, manifest = read_atomic_dir(path)
            if manifest.get("format") != FORMAT:
                raise IOError(f"entry format {manifest.get('format')!r}")
            if manifest.get("digest") != digest:
                raise IOError("entry digest does not match its key")
            state = dict(manifest["result"])
            state["solution"] = _solution_state(flat)
            res = result_from_state(prob, state)
        except Exception as e:
            self.corrupt_skipped += 1
            self.misses += 1
            logger.warning(
                "skipping corrupt result-store entry %s: %s", path, e
            )
            return None
        self.hits += 1
        return res

    # ---------------------------------------------------------------- put
    def put(self, key: tuple, res: PackingResult) -> bool:
        """Persist ``res`` under ``key``; returns False on a lost race.

        An existing *intact* entry is left untouched (immutable-content
        contract); an existing *damaged* entry is swapped out for the fresh
        result.  Either way the publish is a single atomic rename.
        """
        digest = task_digest(key)
        state = result_state(res)
        solution = state.pop("solution")
        path = self.dir / f"{_PREFIX}{digest}"
        manifest = {"format": FORMAT, "digest": digest, "result": state}
        arrays = _solution_arrays(res.solution)
        del solution  # bins/kinds travel in arrays.npz, not the manifest
        if write_atomic_dir(path, arrays, manifest, replace=False):
            return True
        # final exists: keep it if intact, replace it if damaged
        try:
            _, existing = read_atomic_dir(path)
            if existing.get("digest") == digest and existing.get("format") == FORMAT:
                self.lost_races += 1
                return False
        except Exception:
            pass
        shutil.rmtree(path, ignore_errors=True)
        ok = write_atomic_dir(path, arrays, manifest, replace=False)
        if not ok:
            self.lost_races += 1
        return ok

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {
            "dir": str(self.dir),
            "entries": len(self),
            "hits": self.hits,
            "misses": self.misses,
            "corrupt_skipped": self.corrupt_skipped,
            "lost_races": self.lost_races,
        }
