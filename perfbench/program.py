"""The program's own spans (`repro_torch.obs`), as the per-layer readers
read them.

Each reader turns the program's recorder on when the harness loads it
(`arm`; importing this module alone does not).  The harness loads the
per-layer readers only in a traced run, before the cell's set-up: so a
``--trace 0`` run records nothing, and a traced run records its set-up and
both halves.  Records are picked by time, on
the performance counter that the harness's spans share:

* the **first half**: records that start inside one of the harness's
  entry spans there (``api.pack`` or ``sweep.pack_sweep`` in
  ``run.spans``; every reader names both in ``SPANS``, under the labels
  and targets the device readers use, so nothing is wrapped twice);
* the **traced half**: records that start inside ``[run.trace.t0,
  run.trace.t1]``;
* the **set-up**: entry calls (``api.pack``, ``dse.sweep``) that ended
  before the first half began, and what ran inside them (the cell's
  warm-up: kernel load or build, the card's first use, the first pinned
  buffers).

The device's operations are put on the program's clock through the
profiler's own Unix stamp (``kineto_results.trace_start_ns()``) and the
recorder's anchor, each at the host time of the runtime call that issued
it (`device_timeline`: a CUDA-only trace's device stamps drift from its
host stamps); without that stamp, through the harness's spin-mark offset
(said on standard error).  Each idle interval of the device is then split
*by overlap* among the innermost program spans open on the host's thread.
Each selection is an ``obs.Snapshot`` of the records picked.  A program
without the recorder (before it had one) gives no records, and every
reader returns ``None``.
"""
from __future__ import annotations

import bisect
import sys

try:
    from repro_torch import obs
except ImportError:  # a program without the recorder
    obs = None


def arm() -> None:
    """Turn the recorder on, from nothing: a run's records start here.
    Called by each reader when the harness loads it, so every traced run
    in one process records afresh."""
    if obs is not None:
        obs.reset()
        obs.enable()


SPANS = {
    "api.pack": "repro_torch.core.api:pack",
    "sweep.pack_sweep": "repro_torch.core.dse:pack_sweep",
}
ENTRY = ("api.pack", "dse.sweep")
# K1-K4's kernel names in the trace (K1 / K2 and K3 / K4 are one template each)
KERNELS = ("fitness_rows_kernel", "sa_step_lanes_kernel")
MARK_KERNEL = "spin_kernel"  # the harness's clock mark (perfbench/trace.py)

_cache: dict = {}


def log(msg: str) -> None:
    print(f"[program] {msg}", file=sys.stderr, flush=True)


def _records() -> list:
    return obs.snapshot().records if obs is not None else []


def _view(recs):
    """The picked records as an ``obs.Snapshot`` (``None`` without a
    recorder or without records)."""
    return obs.Snapshot(recs) if recs else None


def _state(run) -> dict:
    """What was worked out for ``run`` so far (its records first)."""
    got = _cache.get(id(run))
    if got is None or got[0] is not run:
        if len(_cache) >= 4:  # a process's runs one after another
            _cache.clear()
        got = _cache[id(run)] = (run, {"records": _records()})
    return got[1]


def _memo(run, key, fn):
    memo = _state(run)
    if key not in memo:
        memo[key] = fn(memo["records"])
    return memo[key]


def _entry_intervals(run) -> list[tuple[float, float]]:
    return sorted((t, t + d) for label in SPANS for t, d, _ in run.spans.get(label, ()))


def _inside(t: float, iv, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= iv[i][1]


def first_half(run):
    """Records that start inside a harness entry span of ``run.spans``."""
    def pick(recs):
        iv = _entry_intervals(run)
        starts = [a for a, _ in iv]
        return _view([r for r in recs if _inside(r.start_ns / 1e9, iv, starts)])
    return _memo(run, "first", pick)


def traced_half(run):
    """Records that start inside the device trace's window."""
    def pick(recs):
        tr = run.trace
        if tr is None:
            return None
        return _view([r for r in recs if tr.t0 <= r.start_ns / 1e9 <= tr.t1])
    return _memo(run, "traced", pick)


def setup(run):
    """The set-up's entry calls and what ran inside them: records that
    ended before the first half began (and began after the run did)."""
    def pick(recs):
        iv = _entry_intervals(run)
        if not iv:
            return None
        hi = iv[0][0]
        lo = hi - run.setup_s if run.setup_s is not None else float("-inf")
        return _view([r for r in recs if r.end_ns / 1e9 <= hi and r.start_ns / 1e9 >= lo])
    return _memo(run, "setup", pick)


def per(run, names, per_name: str, scale: float):
    """``scale`` times the first half's seconds in ``names`` spans over its
    count of ``per_name`` spans; ``None`` where either is missing."""
    v = first_half(run)
    n = v.count(per_name) if v is not None else 0
    if not n or not any(v.count(x) for x in names):
        return None
    return sum(v.seconds(x) for x in names) / n * scale


# ------------------------------------------------------------ device clock
def device_offset(run):
    """``(seconds to add to a device time for the recorder's clock, how)``:
    through the profiler's Unix stamp and the recorder's anchor, else the
    harness's spin-mark offset; ``(None, None)`` without either."""
    tr = run.trace
    if tr is None:
        return None, None
    anchor = obs.anchor() if obs is not None else None
    try:
        start_ns = int(tr.prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:
        start_ns = None
    if start_ns is not None and anchor is not None:
        return obs.perf_ns(start_ns, anchor) / 1e9, "kineto"
    if tr.offset is not None:
        log("no kineto trace_start_ns() or no recorder anchor: device times put on "
            "the host clock by the spin-mark offset")
        return tr.offset, "spin"
    return None, None


def _innermost(recs):
    """One thread's spans (properly nested) as ``(start, end, name)``
    segments, each named by the innermost span open over it."""
    segs, stack, t = [], [], None
    for s, e, n in sorted(recs, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            segs.append((t, top[1], top[2]))
            t = top[1]
        if stack and s > t:
            segs.append((t, s, stack[-1][2]))
        t = s
        stack.append((s, e, n))
    while stack:
        top = stack.pop()
        segs.append((t, top[1], top[2]))
        t = top[1]
    return [x for x in segs if x[1] > x[0]]


def _gaps(ops, lo, hi):
    gaps, end = [], lo
    for a, b in sorted(ops):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def split_by_overlap(gaps, segs) -> dict[str | None, float]:
    """Seconds of ``gaps`` under each segment's name (``None`` where no
    segment is), both lists sorted and each free of overlaps."""
    out: dict[str | None, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, n = segs[k]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[n] = out.get(n, 0.0) + ov
                covered += ov
            k += 1
        out[None] = out.get(None, 0.0) + (b - a - covered)
    return out


def device_timeline(run):
    """The traced window's device operations on the recorder's clock,
    ``dict(ops=[(name, start, end, raw_start, call)], how, rebased, ...)``
    or ``None``.

    With the profiler's Unix stamp, each operation is put at the host time
    of the runtime call that issued it (kineto's host stamps, which keep to
    the recorder's clock), or at the end of the operation before it on the
    stream if that is later, and keeps its device duration: a CUDA-only
    trace's device stamps drift from the host's (about -720 ppm in one
    H100 measurement), and the runtime calls carry the same correlation id
    as the operations they issue.  ``raw_start`` is the device stamp as the
    trace has it; ``call`` the issuing call's time (``None`` unmatched)."""
    def build(recs):
        tr = run.trace
        off, how = device_offset(run)
        if off is None:
            return None
        if how != "kineto":
            ops = [(n, s + off, e + off, s + off, None) for n, s, e in tr.ops]
            return dict(ops=_clip(ops, tr), how=how, rebased=0, spin=None)
        calls, dev = {}, []
        for e in tr.prof.events():
            start, stop = e.time_range.start / 1e6 + off, e.time_range.end / 1e6 + off
            if "CUDA" in str(getattr(e, "device_type", "")):
                dev.append((start, stop, e.name, e.id))
            elif e.name.startswith("cu"):  # the CUDA API call that issued it
                calls.setdefault(e.id, start)
        dev.sort()
        ops, end, spin = [], float("-inf"), None
        for start, stop, name, cid in dev:
            call = calls.get(cid)
            if MARK_KERNEL in name:
                spin = (start, call)
                continue
            t = start if call is None else max(call, end)
            end = t + (stop - start)
            ops.append((name, t, end, start, call))
        rebased = sum(o[4] is not None for o in ops)
        if ops and rebased < 0.9 * len(ops):  # no correlation: the device's stamps
            ops = [(n, r, r + (e - s), r, c) for n, s, e, r, c in ops]
            how, rebased = "kineto, device stamps", 0
        else:
            how = "kineto, re-based on launch calls"
        return dict(ops=_clip(ops, tr), how=how, rebased=rebased, spin=spin)
    return _memo(run, "timeline", build)


def _clip(ops, tr):
    return [(n, max(s, tr.t0), min(e, tr.t1), r, c) for n, s, e, r, c in ops
            if e > tr.t0 and s < tr.t1]


def idle_split(run):
    """``{innermost span name or None: idle seconds}`` over the traced
    half, or ``None`` without a trace or records."""
    def split(recs):
        tr = run.trace
        tl = device_timeline(run)
        if tl is None:
            return None
        threads = {}
        for r in recs:
            if r.name in ENTRY and tr.t0 <= r.start_ns / 1e9 <= tr.t1:
                threads[r.thread] = threads.get(r.thread, 0) + r.end_ns - r.start_ns
        if not threads:
            return None
        host = max(threads, key=threads.get)
        segs = _innermost([(r.start_ns / 1e9, r.end_ns / 1e9, r.name)
                           for r in recs if r.thread == host])
        ops = [(o[1], o[2]) for o in tl["ops"]]
        by = split_by_overlap(_gaps(ops, tr.t0, tr.t1), segs)
        return dict(by=by, how=tl["how"], total=sum(by.values()))
    return _memo(run, "idle", split)


def unnamed_share(split) -> float | None:
    """Percent of the idle time whose innermost span is an entry span or
    none."""
    if not split or split["total"] <= 0:
        return None
    unnamed = sum(v for k, v in split["by"].items() if k is None or k in ENTRY)
    return 100.0 * unnamed / split["total"]


def log_idle(split) -> None:
    if not split:
        log("idle: no device trace or no program spans")
        return
    total = split["total"]
    top = sorted(split["by"].items(), key=lambda kv: -kv[1])[:10]
    log(f"idle {total:.4f} s by innermost span ({split['how']}): "
        + ", ".join(f"{k or 'none'} {v:.4f} s ({100 * v / total:.2f} %)" for k, v in top))


def clock_check(run):
    """How the device's stamps sit on the recorder's clock: the profiler's
    Unix stamp against the harness's spin-mark offset, the spin kernel's
    start after its launch call (the offset's error: the mark is read
    before the call) and what is left, the drift of the device's stamps
    from the host's (K1-K4), and each K1-K4 launch call and device start
    against the ``ops.launch`` span that issued it (paired in order):
    ``dict`` or ``None``."""
    tr = run.trace
    off, how = device_offset(run)
    tl = device_timeline(run)
    if tl is None or obs is None:
        return None
    out = dict(how=tl["how"], kineto_minus_spin_us=None, spin_start_after_call_us=None,
               spin_call_after_mark_us=None, drift_ppm=None)
    if how == "kineto" and tr.offset is not None:
        out["kineto_minus_spin_us"] = (off - tr.offset) * 1e6
    if tl["spin"] and tl["spin"][1] is not None:
        out["spin_start_after_call_us"] = (tl["spin"][0] - tl["spin"][1]) * 1e6
        if out["kineto_minus_spin_us"] is not None:
            # the spin kernel's launch call on kineto's host clock, after the
            # harness read its mark: what is left of the difference once the
            # kernel's own start lag is taken out
            out["spin_call_after_mark_us"] = (out["kineto_minus_spin_us"]
                                              - out["spin_start_after_call_us"])
    kern = sorted((o[4], o[3], o[1]) for o in tl["ops"]
                  if any(k in o[0] for k in KERNELS) and o[4] is not None)
    if len(kern) >= 2:
        xs = [c - kern[0][0] for c, _, _ in kern]
        ys = [r - c for c, r, _ in kern]
        mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
        var = sum((x - mx) ** 2 for x in xs)
        if var > 0:
            out["drift_ppm"] = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var * 1e6
    half = traced_half(run)
    spans = sorted((t, t + d) for t, d, _ in half.spans.get("ops.launch", ())) if half else []
    n = min(len(kern), len(spans))
    pairs = list(zip(kern[:n], spans[:n]))
    out.update(
        kernels=len(kern), launch_spans=len(spans),
        calls_outside_span=sum(not b <= c <= e for (c, _, _), (b, e) in pairs),
        min_call_lead_us=min((c - b for (c, _, _), (b, _) in pairs), default=0) * 1e6,
        raw_before_span=sum(r < b for (_, r, _), (b, _) in pairs),
        min_raw_lead_us=min((r - b for (_, r, _), (b, _) in pairs), default=0) * 1e6,
        before_span=sum(t < b for (_, _, t), (b, _) in pairs),
        min_lead_us=min((t - b for (_, _, t), (b, _) in pairs), default=0) * 1e6)
    return out


def log_clock(check) -> None:
    if not check:
        log("clock: no device trace or no recorder")
        return
    f = {k: ("n/a" if v is None else f"{v:.1f}") if isinstance(v, float) or v is None else v
         for k, v in check.items()}
    log(f"clock ({f['how']}): kineto minus spin-mark offset {f['kineto_minus_spin_us']} us, "
        f"spin kernel start after its call {f['spin_start_after_call_us']} us, so its call "
        f"{f['spin_call_after_mark_us']} us after the mark; device stamps' "
        f"drift {f['drift_ppm']} ppm; K1-K4 launches {f['kernels']}, ops.launch spans "
        f"{f['launch_spans']}: launch calls outside their span {f['calls_outside_span']} "
        f"(earliest {f['min_call_lead_us']} us after its begin); device starts before their "
        f"span {f['before_span']} (earliest {f['min_lead_us']} us after), on raw device "
        f"stamps {f['raw_before_span']} (earliest {f['min_raw_lead_us']} us)")


def entry_seconds(view) -> float:
    """Seconds of the view's outermost entry calls (0 without a view)."""
    if view is None:
        return 0.0
    return sum(r.end_ns - r.start_ns for r in view.records
               if r.name in ENTRY and not r.parent) / 1e9


def log_setup(run, view) -> None:
    warm = entry_seconds(view)
    names = sorted(set(view.spans) - set(ENTRY), key=lambda n: -view.seconds(n)) if view else []
    rest = "" if run.setup_s is None else f" of setup_s {run.setup_s:.3f} s"
    log(f"setup: warm-up calls {warm:.3f} s{rest}; inside: "
        + ", ".join(f"{n} {view.seconds(n):.4f} s x{view.count(n)}" for n in names[:12]))


OPS_PARTS = ("ops.alloc", "ops.fill", "ops.copy", "ops.launch", "ops.wait")


def report(run) -> None:
    """Once a run (each half of a traced run is one): every span's count,
    seconds and self seconds, the ops call's split, and where the run has
    a device trace, the idle split and the clock check; the set-up's split
    with the half without the profiler."""
    memo = _state(run)
    if memo.get("reported"):
        return
    memo["reported"] = True
    tr = run.trace
    iv = _entry_intervals(run)
    part = ("under the profiler" if tr is not None and iv and iv[0][0] >= tr.t0
            else "without the profiler")
    v = first_half(run)
    if v is None:
        log(f"{part}: no program spans")
        return
    names = sorted(v.spans, key=lambda n: -v.self_s[n])
    dropped = obs.counter("obs.dropped") if obs is not None else 0
    if dropped:
        log(f"{dropped} records were dropped by the recorder's bound: the spans are incomplete")
    log(f"{part}: span count, seconds, self seconds: "
        + ", ".join(f"{n} {v.count(n)} {v.seconds(n):.4f} {v.self_s[n]:.4f}" for n in names))
    calls = v.count("ops.call")
    if calls:
        cover = sum(v.seconds(n) for n in OPS_PARTS) / v.seconds("ops.call") * 100
        log(f"{part}: ops.call {v.seconds('ops.call') / calls * 1e6:.1f} us a call x{calls}, "
            f"its parts cover {cover:.2f} %: "
            + ", ".join(f"{n} {v.seconds(n) / calls * 1e6:.1f} us" for n in OPS_PARTS))
    if tr is not None and part == "under the profiler":
        split = idle_split(run)
        log_idle(split)
        share = unnamed_share(split)
        log(f"idle under an entry span or none: {'n/a' if share is None else f'{share:.3f} %'}")
        log_clock(clock_check(run))
    if part == "without the profiler":
        log_setup(run, setup(run))
