"""Spans and counters inside the port: where a pack's host time goes.

A **span** names one piece of work on one thread: ``tok = begin(name)``
where it starts and ``end(tok)`` where it stops.  Spans are explicit
pairs, not only ``with`` blocks, because some work is cut by a ``yield``
(the SA fleet's step generator closes its spans before each one).  While
recording is off, ``begin`` reads one module global, branches and returns
``None``, and ``end(None)`` returns at once: nothing is allocated.

While on, a finished span is kept as one record (`Span`): its name, start
and end on ``time.perf_counter_ns()``, the span open on the same thread
when it began (its parent), the thread, and the id of its outermost entry
call (``begin(name, entry=True)``: one id a `core.api.pack` or
`core.dse.pack_sweep`, inherited by everything under it on that thread).
Records stay in memory, in a bounded buffer: when it is full the oldest
go, and the counter ``obs.dropped`` counts them.  Nothing is written out.

A **counter** is a named integer, always on, under a lock (the island
portfolio launches kernels from two threads).  The kernels' launch counts
live here as ``launch.<wrapper>`` (`kernels.launch_counts`).

Clocks: `enable` takes an anchor, a ``(perf_counter_ns, time_ns)`` pair
read together, and `unix_ns` maps a record's time onto the Unix clock on
which ``torch.profiler`` stamps its events (``kineto_results.
trace_start_ns()`` plus an event's offset), so spans and device activity
line up without a marker kernel.

Operator use::

    from repro_torch import obs
    with obs.recording() as rec:
        pack(prob, "sa-s", n_chains=64, max_iterations=2000, max_seconds=1e9)
    for name, s in sorted(rec.self_s.items(), key=lambda x: -x[1]):
        print(name, rec.count(name), s)

This module imports only the standard library, so every layer of the
port may import it.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

CAPACITY = 1 << 20  # records kept before the oldest are dropped

_perf_ns = time.perf_counter_ns
_ident = threading.get_ident

_on = False
_anchor: tuple[int, int] | None = None
_buf: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()  # .st: [this thread's open span tokens, its id]
_sids = itertools.count(1)
_entries = itertools.count(1)
_lock = threading.Lock()
_counters: dict[str, int] = {}


class Span(NamedTuple):
    """One finished span.  ``parent`` and ``entry`` are 0 where there is
    none; times are ``time.perf_counter_ns()``."""

    sid: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    thread: int
    entry: int


# ----------------------------------------------------------------- spans
def begin(name: str, entry: bool = False):
    """Open a span on this thread; returns the token for `end` (``None``
    while recording is off).  ``entry=True`` marks an entry call: it takes
    a new entry id unless a span of an entry call is already open here."""
    if not _on:
        return None
    try:
        st = _local.st
    except AttributeError:
        st = _local.st = [[], _ident()]
    stack = st[0]
    if stack:
        top = stack[-1]
        parent, ent = top[0], top[3]
    else:
        parent = ent = 0
    if entry and not ent:
        ent = next(_entries)
    # (sid, name, parent, entry, depth, thread state, start): the clock last
    tok = (next(_sids), name, parent, ent, len(stack), st, _perf_ns())
    stack.append(tok)
    return tok


def end(tok) -> None:
    """Close the span ``tok`` opened.  Spans opened after it on this thread
    and never closed (an exception passed through them) are discarded."""
    if tok is None:
        return
    t1 = _perf_ns()
    st = tok[5]
    del st[0][tok[4]:]
    if len(_buf) == CAPACITY:
        count("obs.dropped")
    _buf.append((tok[0], tok[1], tok[6], t1, tok[2], st[1], tok[3]))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "entry", "tok")

    def __init__(self, name, entry):
        self.name, self.entry = name, entry

    def __enter__(self):
        self.tok = begin(self.name, self.entry)
        return self.tok

    def __exit__(self, *exc):
        end(self.tok)
        return False


def span(name: str, entry: bool = False):
    """``with span(name):`` — `begin` / `end` around a block (closed on an
    exception too); a shared no-op object while recording is off."""
    return _OpenSpan(name, entry) if _on else _NO_SPAN


# ------------------------------------------------------------- switching
def anchor_now() -> tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair read together: the Unix read
    between two reads of the performance counter, paired with their mean."""
    p0 = _perf_ns()
    u = time.time_ns()
    p1 = _perf_ns()
    return (p0 + p1) // 2, u


def enable(anchor: tuple[int, int] | None = None) -> None:
    """Start recording spans; ``anchor`` (default: read now) ties the
    performance counter to the Unix clock (`unix_ns`)."""
    global _on, _anchor
    _anchor = tuple(anchor) if anchor is not None else anchor_now()
    _on = True


def disable() -> None:
    """Stop recording; records already kept stay until `reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def anchor() -> tuple[int, int] | None:
    return _anchor


def reset() -> None:
    """Drop every kept record and this thread's open spans (counters are
    kept: see `reset_counters`)."""
    _buf.clear()
    _local.st = [[], _ident()]


def unix_ns(t_ns: int, anchor: tuple[int, int] | None = None) -> int:
    """A ``perf_counter_ns`` time on the Unix clock, through ``anchor``
    (default: the one `enable` took)."""
    a = anchor if anchor is not None else _anchor
    if a is None:
        raise RuntimeError("no clock anchor: call enable() first")
    return a[1] + (t_ns - a[0])


def perf_ns(t_unix_ns: int, anchor: tuple[int, int] | None = None) -> int:
    """The inverse of `unix_ns`."""
    a = anchor if anchor is not None else _anchor
    if a is None:
        raise RuntimeError("no clock anchor: call enable() first")
    return a[0] + (t_unix_ns - a[1])


# --------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on; under a lock, so no
    increment from another thread is lost)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def reset_counters(names=None) -> None:
    """Set the named counters (default: all) to zero."""
    with _lock:
        if names is None:
            _counters.clear()
        else:
            for n in names:
                _counters.pop(n, None)


# ---------------------------------------------------------------- reading
class Snapshot:
    """Kept records and what they add up to.

    * ``records`` — every `Span`, in the order they ended;
    * ``spans`` — by name, ``(start_s, seconds, thread)`` a span, with
      ``start_s`` on ``time.perf_counter()``'s clock;
    * ``self_s`` — by name, the spans' seconds less what their child
      spans cover;
    * ``counters``, ``anchor`` and ``dropped`` (records lost to the
      buffer's bound)."""

    def __init__(self, records=(), counters=None, anchor=None):
        self._load(records, counters or {}, anchor)

    def _load(self, records, counters, anchor):
        self.records = [Span(*r) for r in records]
        self.counters = dict(counters)
        self.anchor = anchor
        self.dropped = self.counters.get("obs.dropped", 0)
        self.spans: dict[str, list[tuple[float, float, int]]] = {}
        covered: dict[int, int] = {}
        for r in self.records:
            self.spans.setdefault(r.name, []).append(
                (r.start_ns / 1e9, (r.end_ns - r.start_ns) / 1e9, r.thread))
            if r.parent:
                covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
        self.self_s: dict[str, float] = {}
        for r in self.records:
            own = r.end_ns - r.start_ns - covered.get(r.sid, 0)
            self.self_s[r.name] = self.self_s.get(r.name, 0.0) + own / 1e9

    def seconds(self, name: str) -> float:
        return sum(d for _, d, _ in self.spans.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))


def snapshot() -> Snapshot:
    """Every kept record, the counters and the anchor, as a `Snapshot`."""
    return Snapshot(list(_buf), counters(), _anchor)


@contextlib.contextmanager
def recording():
    """``with recording() as rec:`` — record the block; ``rec`` (a
    `Snapshot`) is filled when it ends with the spans that began and
    ended inside it and the counters' increase over it.  Recording is left
    as it was found (on or off, with its anchor), and nothing recorded
    before is dropped."""
    was_on = _on
    before = counters()
    enable(_anchor if was_on else None)
    t0 = _perf_ns()
    rec = Snapshot(anchor=_anchor)
    try:
        yield rec
    finally:
        t1 = _perf_ns()
        if not was_on:
            disable()
        after = counters()
        rec._load([r for r in list(_buf) if r[2] >= t0 and r[3] <= t1],
                  {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)},
                  rec.anchor)
