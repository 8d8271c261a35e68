"""Host-clock spans around calls into the program's layers.

The benchmark times each layer from its own files: while a `Spans` is
active, each target function or method is swapped for a wrapper that logs
every call's start and duration under a label (the program looks its
layers up at call time, through the module or the class, so the swap
reaches every caller).  A per-layer metric's reader names the spans it
needs in its ``SPANS`` mapping, ``label -> "module:Attr.path"``, and may
name in ``NOTES`` a function ``(args, kwargs) -> dict`` kept beside each
call of a label (the kernel's inputs, for its bytes and operations).
Spans are only installed in a traced run.
"""
from __future__ import annotations

import importlib
import threading
import time


def resolve(target: str):
    """``"pkg.mod:Cls.meth"`` -> ``(owner, attribute)``."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Spans:
    """``spans[label]`` holds ``(start, seconds, thread id)`` a call, in
    the order calls ended; ``notes[label]`` what ``NOTES`` kept for them."""

    def __init__(self, targets: dict, notes: dict | None = None):
        self.targets = dict(targets)
        self.note_fns = dict(notes or {})

    def __enter__(self):
        self.spans = {label: [] for label in self.targets}
        self.notes = {label: [] for label in self.note_fns}
        self._saved = []
        for label, target in self.targets.items():
            owner, attr = resolve(target)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(label, fn))
        return self

    def _wrap(self, label, fn):
        log = self.spans[label]
        note = self.note_fns.get(label)
        notes = self.notes.get(label)

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                log.append((t, time.perf_counter() - t, threading.get_ident()))
                if note is not None:
                    notes.append(note(args, kwargs))
        return timed

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
