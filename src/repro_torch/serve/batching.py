"""Micro-batching policy (the port's `repro.serve.batching`): pure,
clock-injected, event-loop-agnostic.

The :class:`MicroBatcher` holds pending requests bucketed by their
``batch_group_key`` (problems sharing a cost-model signature can ride one
batched fleet — see ``repro_torch.core.problem.batch_group_key``) and decides
*when* each bucket flushes:

* **size**: a bucket reaching ``max_batch`` flushes immediately;
* **age**: a bucket whose oldest request has waited ``max_wait_ms``
  flushes with whatever it has — bounded queueing delay;
* **deadline**: a request whose ``deadline_ms`` budget is too tight to
  ride out the batching window flushes its bucket *now*, alone if nobody
  compatible is waiting — the single-candidate fallback.  Trading batch
  occupancy for tail latency is exactly the knob the deadline requests;
  the result is still bit-identical (batch shape never changes answers).

All time handling goes through explicit ``now`` arguments so tests drive
the policy with a fake clock; the service supplies ``time.monotonic``.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ..core.problem import PackingProblem


@dataclass
class Request:
    """One in-flight ``pack`` request inside the service."""

    prob: PackingProblem
    seed: int
    key: tuple  # full task identity (repro_torch.core.dse.task_key)
    group: tuple  # batch_group_key(prob) — batching compatibility class
    future: asyncio.Future
    arrival: float  # service clock at admission
    flush_at: float  # batching window closes (age or deadline pressure)
    deadline_at: float | None = None  # absolute deadline, service clock
    deadline_rushed: bool = field(default=False)  # flushed early for deadline


class MicroBatcher:
    def __init__(self, max_batch: int = 8, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._buckets: dict[tuple, list[Request]] = {}

    def pending(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def admit(self, req: Request, now: float) -> None:
        """Place ``req`` in its bucket and stamp its flush window.

        ``req.deadline_at`` (stamped by the service at *arrival*, so queue
        time counts against the budget) tighter than the batching window
        collapses the window to "now" — the next ``pop_ready`` emits the
        bucket even if it only holds this one request (single-candidate
        fallback).
        """
        req.flush_at = now + self.max_wait_s
        if req.deadline_at is not None and req.deadline_at < req.flush_at:
            req.flush_at = now
            req.deadline_rushed = True
        self._buckets.setdefault(req.group, []).append(req)

    def next_flush_at(self) -> float | None:
        """Earliest moment any bucket's window closes (None: nothing pending).

        The service sleeps at most until this point before re-polling
        ``pop_ready`` — full buckets never wait on it because ``admit`` is
        always followed by a ``pop_ready`` pass.
        """
        times = [r.flush_at for b in self._buckets.values() for r in b]
        return min(times) if times else None

    def pop_ready(self, now: float) -> list[list[Request]]:
        """Remove and return every batch due at ``now``.

        Full buckets emit ``max_batch``-sized slices oldest-first; a bucket
        whose window has closed emits whatever it holds.  Requests never
        linger past their ``flush_at``.
        """
        out: list[list[Request]] = []
        for group in list(self._buckets):
            bucket = self._buckets[group]
            while len(bucket) >= self.max_batch:
                out.append(bucket[: self.max_batch])
                del bucket[: self.max_batch]
            if bucket and min(r.flush_at for r in bucket) <= now:
                out.append(bucket)
                bucket = []
            if bucket:
                self._buckets[group] = bucket
            else:
                del self._buckets[group]
        return out

    def drain(self) -> list[list[Request]]:
        """Flush everything regardless of windows (shutdown path)."""
        out = []
        for bucket in self._buckets.values():
            for i in range(0, len(bucket), self.max_batch):
                out.append(bucket[i : i + self.max_batch])
        self._buckets.clear()
        return out
