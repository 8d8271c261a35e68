"""The device's side of a traced window, from ``torch.profiler``.

The profiler records the card's kernels and copies (CUDA activity only:
recording every host operator too would slow the host that decides these
cells).  From it: the seconds in which an operation ran (the union of the
device intervals), each kernel's device seconds by name, the operations
that took most time, and the device's idle gaps, each put down to the
benchmark's innermost host span that was open at the gap's middle.  A
short spin kernel, launched at a known host time right after the trace
starts, ties the profiler's clock to the host clock of the spans.
"""
from __future__ import annotations

import time

import numpy as np

MARK_KERNEL = "spin_kernel"


class DeviceTrace:
    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        self._read()

    def _read(self):
        events = []
        for e in self.prof.events():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            events.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
        mark = [s for n, s, _ in events if MARK_KERNEL in n]
        # device seconds -> host clock; without the mark, not aligned
        self.offset = self.mark_host - min(mark) if mark else None
        self.ops = [(n, s, e) for n, s, e in events if MARK_KERNEL not in n]
        self.window_s = self.t1 - self.t0
        if self.offset is not None:
            lo, hi = self.t0 - self.offset, self.t1 - self.offset
            self.ops = [(n, max(s, lo), min(e, hi)) for n, s, e in self.ops if e > lo and s < hi]

    def intervals(self):
        return sorted((s, e) for _, s, e in self.ops)

    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for a, b in self.intervals():
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def kernel_seconds(self, name_part: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``name_part``."""
        d = [e - s for n, s, e in self.ops if name_part in n]
        return float(sum(d)), len(d)

    def top_ops(self, k=10):
        by = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, spans, k=10):
        """Idle seconds of the device in the traced window, by the host
        span open at each gap's middle (the shortest, so the innermost);
        ``"host: none"`` where none was."""
        if self.offset is None:
            return []
        iv = self.intervals()
        gaps, end = [], self.t0 - self.offset
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 - self.offset > end:
            gaps.append((end, self.t1 - self.offset))
        if not gaps:
            return []
        g = np.asarray(gaps)
        mid = g.mean(axis=1) + self.offset
        labels = ["host: none"]
        # per gap: the length of the shortest span covering its middle, and
        # which label it has (spans of one label do not overlap on a thread;
        # a label's calls from several threads are taken thread by thread)
        best_len = np.full(len(mid), np.inf)
        best = np.zeros(len(mid), dtype=np.int64)
        for label, calls in spans.items():
            by_thread = {}
            for t, d, tid in calls:
                by_thread.setdefault(tid, []).append((t, t + d))
            labels.append(label)
            for iv in by_thread.values():
                iv = np.asarray(sorted(iv))
                i = np.searchsorted(iv[:, 0], mid, side="right") - 1
                ok = i >= 0
                ln = np.where(ok, iv[np.maximum(i, 0), 1] - iv[np.maximum(i, 0), 0], np.inf)
                ok &= iv[np.maximum(i, 0), 1] >= mid
                take = ok & (ln < best_len)
                best_len[take] = ln[take]
                best[take] = len(labels) - 1
        secs = np.bincount(best, weights=g[:, 1] - g[:, 0], minlength=len(labels))
        out = [[labels[i], float(secs[i])] for i in np.flatnonzero(secs)]
        return sorted(out, key=lambda x: -x[1])[:k]


def idle_pct(trace) -> float | None:
    """Percent of the traced window with nothing running on the device."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
