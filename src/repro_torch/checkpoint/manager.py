"""Fault-tolerant checkpointing: atomic, hashed, async (the port's
`repro.checkpoint.manager`, with the same on-disk layout).

Layout per step:  <dir>/step_000123/
    arrays.npz     — every leaf, keyed by its flattened tree path
    manifest.json  — step, keys, wall time, caller's ``extra``, and the
                     sha256 of arrays.npz

The layout, the key paths and the manifest are the reference's, so a step
written by either package reads in the other (``tests/test_torch_checkpoint
.py`` holds both directions).

Guarantees:
* atomic: written to step_x.tmp then os.rename'd — a crash mid-save never
  corrupts the latest checkpoint;
* integrity: sha256 verified on restore; ``restore()`` (and
  ``restore_latest_valid()``) fall back to the newest step that passes the
  sha256/shape checks, logging what was skipped — a torn or corrupted
  latest step degrades gracefully instead of bricking the run;
* device-agnostic restore: leaves are saved as host arrays and placed on
  the caller's ``device`` at load;
* async: save() can run on a background thread (wait() joins before the
  next save and re-raises anything the previous write died on); an atexit
  hook drains the in-flight write so interpreter shutdown can't tear it;
* keep_n garbage collection of old steps.

Trees are nested dicts, lists and plain tuples whose leaves are numpy
arrays, torch tensors or scalars; ``None`` is an empty subtree.  Keys are the
path components joined with ``/`` (dict keys sorted, sequences indexed),
as JAX's tree flattening gives them for the reference.  bfloat16 tensors
are stored as their ``uint16`` bits under a ``::bf16`` key suffix and read
back as ``torch.bfloat16``.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

_BF16_SUFFIX = "::bf16"


def write_atomic_dir(
    final: str | Path,
    flat: dict[str, np.ndarray],
    manifest: dict,
    *,
    tmp: str | Path | None = None,
    replace: bool = True,
) -> bool:
    """Publish ``{arrays.npz, manifest.json}`` atomically under ``final``.

    The integrity convention of every durable artifact of the port
    (checkpoint steps, ``repro_torch.serve`` result-store entries): arrays
    go to ``arrays.npz``, the manifest is stamped with its sha256, both
    land in a scratch dir that is ``os.rename``d into place — a crash
    mid-write can leave a stray ``*.tmp*`` dir but never a half-written
    ``final``.

    ``replace=False`` is the concurrent-writer contract: when ``final``
    already exists (another writer won the publish race) the scratch dir is
    discarded and ``False`` is returned — an existing entry is never
    touched.  With ``replace=True`` (the checkpoint-step behavior) an
    existing ``final`` is swapped out and ``True`` returned.  ``tmp``
    overrides the scratch path; the default carries pid + random bytes so
    concurrent writers cannot collide on it.
    """
    final = Path(final)
    if tmp is None:
        tmp = final.with_name(
            f"{final.name}.tmp-{os.getpid()}-{os.urandom(4).hex()}"
        )
    tmp = Path(tmp)
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz", **flat)
    digest = hashlib.sha256((tmp / "arrays.npz").read_bytes()).hexdigest()
    (tmp / "manifest.json").write_text(
        json.dumps({**manifest, "sha256": digest}, indent=2)
    )
    if final.exists():
        if not replace:
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        shutil.rmtree(final)
    try:
        os.rename(tmp, final)
    except OSError:
        if not replace and final.exists():
            # lost the publish race between the exists() check and the
            # rename: the other writer's entry stands, ours is discarded
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        raise
    return True


def read_atomic_dir(path: str | Path) -> tuple[dict, dict]:
    """Integrity-checked read of a :func:`write_atomic_dir` layout.

    Returns ``(flat, manifest)``: numpy arrays, except bf16 leaves, which
    come back as ``torch.bfloat16`` tensors.  Raises ``IOError`` on a
    sha256 mismatch (and lets json/npz parse errors of a torn or scribbled
    entry propagate) — callers wanting graceful degradation catch and skip,
    as ``CheckpointManager.restore_latest_valid`` does.
    """
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    blob = (path / "arrays.npz").read_bytes()
    if hashlib.sha256(blob).hexdigest() != manifest.get("sha256"):
        raise IOError(f"checkpoint {path} failed integrity check")
    flat: dict = {}
    with np.load(path / "arrays.npz") as arrays:
        for key in arrays.files:
            if key.endswith(_BF16_SUFFIX):
                bits = np.ascontiguousarray(arrays[key]).view(np.int16)
                flat[key[: -len(_BF16_SUFFIX)]] = torch.from_numpy(bits).view(
                    torch.bfloat16
                )
            else:
                flat[key] = arrays[key]
    return flat, manifest


def _leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in JAX's flattening order: dict keys sorted,
    sequences by index, ``None`` an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host_leaf(leaf) -> np.ndarray | torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in _leaves(tree):
        key = _key(path)
        arr = _host_leaf(leaf)
        if isinstance(arr, torch.Tensor):
            if arr.dtype == torch.bfloat16:
                out[key + _BF16_SUFFIX] = (
                    arr.contiguous().view(torch.int16).numpy().view(np.uint16)
                )
                continue
            arr = arr.numpy()
        out[key] = arr
    return out


def _rebuild(like, fn, prefix=()):
    """``like``'s structure with every leaf replaced by ``fn(path, leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, fn, prefix + (i,)) for i, v in enumerate(like)]
        return items if isinstance(like, list) else tuple(items)
    return fn(prefix, like)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_n: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # a daemon writer thread dies mid-_write on normal interpreter exit,
        # which is exactly the torn-file failure the atomic rename protocol
        # exists to prevent — drain it before teardown
        atexit.register(self._drain)

    # ---------------------------------------------------------------- save
    def save(self, step: int, state, extra: dict | None = None) -> None:
        """Snapshot ``state`` (a tree, see the module docstring) + a
        JSON-serializable ``extra``.

        With ``async_save`` the write happens on a background thread; a
        failure there is re-raised by the *next* ``save()``/``wait()`` call
        rather than swallowed (a sweep must not run for hours believing it
        is checkpointed).
        """
        host_flat = _flatten(state)  # device->host copy happens here, sync
        self.wait()  # join the previous write; re-raise if it failed
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(step, host_flat, extra or {}),
                daemon=True,
            )
            self._thread.start()
        else:
            self._write(step, host_flat, extra or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _drain(self) -> None:
        """atexit hook: finish the in-flight background write, never raise."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        if self._error is not None:
            logger.error(
                "checkpoint background write under %s failed at exit: %r",
                self.dir, self._error,
            )

    def _write_guarded(self, step: int, flat: dict, extra: dict) -> None:
        try:
            self._write(step, flat, extra)
        except BaseException as e:  # surfaced by the next save()/wait()
            self._error = e

    def _write(self, step: int, flat: dict, extra: dict) -> None:
        write_atomic_dir(
            self.dir / f"step_{step:08d}",
            flat,
            {
                "step": step,
                "keys": sorted(flat.keys()),
                "time": time.time(),
                "extra": extra,
            },
            tmp=self.dir / f"step_{step:08d}.tmp",
        )
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        """Steps with a complete on-disk snapshot.

        Half-written ``.tmp`` dirs, half-deleted dirs (missing
        ``manifest.json`` or ``arrays.npz`` — e.g. a crash mid-``_gc``),
        and stray non-step paths are all ignored.
        """
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp":
                continue
            if not (p / "manifest.json").is_file() or not (p / "arrays.npz").is_file():
                continue
            try:
                out.append(int(p.name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: int) -> tuple[dict, dict]:
        """Integrity-checked raw read of one step.

        Returns ``(flat, manifest)`` where ``flat`` maps flattened tree-path
        keys to host arrays (bf16 leaves as ``torch.bfloat16``).  Raises
        ``IOError`` on a sha256 mismatch — callers wanting graceful
        degradation go through :meth:`restore_latest_valid`.
        """
        return read_atomic_dir(self.dir / f"step_{step:08d}")

    def restore(
        self, like, step: int | None = None, device=None
    ) -> tuple[int, object, dict]:
        """Restore into the structure of ``like`` (a tree of arrays,
        tensors or anything with a ``.shape``).

        Returns (step, state, extra).  Leaves come back as host numpy
        arrays (bf16 ones as ``torch.bfloat16``); with ``device`` every leaf
        is a torch tensor placed there.  Without an explicit ``step`` this
        is :meth:`restore_latest_valid`: a corrupt latest step falls back to
        the newest step that passes the integrity/shape checks.
        """
        if step is None:
            return self.restore_latest_valid(like, device=device)
        flat, manifest = self.load(step)

        def leaf(path, like_leaf):
            key = _key(path)
            arr = flat[key]
            if tuple(arr.shape) != tuple(np.shape(like_leaf)):
                raise ValueError(
                    f"shape mismatch restoring {key}: ckpt {tuple(arr.shape)} "
                    f"vs {tuple(np.shape(like_leaf))}"
                )
            if device is not None:
                return torch.as_tensor(arr).to(device)
            return arr

        state = _rebuild(like, leaf)
        return step, state, manifest.get("extra", {})

    def restore_latest_valid(
        self, like=None, device=None
    ) -> tuple[int, object, dict]:
        """Restore the newest step passing the sha256/shape checks.

        Corrupt or torn steps (bad hash, unreadable manifest/npz, shape
        mismatch against ``like``) are skipped with a warning — the crash-
        recovery contract is "degrade to the newest intact checkpoint",
        never "refuse to resume".  With ``like=None`` the raw flat
        ``{tree-path: array}`` dict is returned instead of a tree (the
        engine-state resume path, which knows its own layout).
        Raises ``FileNotFoundError`` when the directory has no steps at
        all, ``IOError`` when every step is damaged.
        """
        steps = self.all_steps()
        last_err: Exception | None = None
        for step in reversed(steps):
            try:
                if like is None:
                    flat, manifest = self.load(step)
                    return step, flat, manifest.get("extra", {})
                return self.restore(like, step=step, device=device)
            except Exception as e:
                last_err = e
                logger.warning(
                    "skipping corrupt checkpoint step %d under %s: %s",
                    step, self.dir, e,
                )
        if last_err is not None:
            raise IOError(
                f"no valid checkpoint under {self.dir} "
                f"({len(steps)} step(s) damaged; newest error: {last_err})"
            )
        raise FileNotFoundError(f"no checkpoints under {self.dir}")
