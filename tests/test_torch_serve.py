"""`repro_torch.serve.PackingService` on the CPU against `repro.core.pack`:
the counterpart of every test in ``tests/test_serve.py``.

The contract: every response — micro-batched, coalesced, memory-cached or
store-served — is bit-identical (``result_signature``) to the reference's
standalone ``repro.core.pack(problem, seed=s)`` with the service's solver
settings.  The reference's own tests hold its service to itself; these
hold the port's to the reference.  Plus the operational semantics:
in-flight coalescing, warm restarts over a store dir, the deadline
single-candidate fallback, bounded-queue backpressure, drain-on-shutdown
and the ``stats()`` surface; and, beyond the reference, ``device=None``
raising at construction where CUDA is not available and a GA-NFD service.

The port runs on ``device="cpu"`` through its kernel wrappers
(``backend="cuda"``, which take the plain versions for CPU tensors) unless
a test says otherwise; the reference runs its host lane
(``backend="python"``).  Budgets are iteration counts, never wall clock.
"""
import asyncio

import pytest
import torch

import repro.core as ref
import repro.serve as ref_serve
from repro_torch.serve import (
    MicroBatcher,
    PackingService,
    Request,
    make_problems,
    result_signature,
)
from repro_torch.serve.stats import LatencyStats

_HYPER = dict(max_seconds=1e9, patience=10**9, max_iterations=80, n_chains=3)
_KW = dict(_HYPER, backend="cuda", device="cpu")

PROBS = make_problems(4, seed=3, hetero=True, max_buffers=14)
REF_PROBS = ref_serve.make_problems(4, seed=3, hetero=True, max_buffers=14)

_REFS: dict = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run on tiny tensors; one intra-op thread keeps
    parallel test workers from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(i, seed, algorithm="sa-s", **hyper):
    """The reference's standalone ``pack`` signature for ``PROBS[i]``."""
    hyper = hyper or _HYPER
    key = (i, seed, algorithm, tuple(sorted(hyper.items())))
    if key not in _REFS:
        _REFS[key] = ref_serve.result_signature(
            ref.pack(REF_PROBS[i], algorithm, seed=seed, backend="python", **hyper)
        )
    return _REFS[key]


def _service(**kw):
    return PackingService("sa-s", **{**_KW, **kw})


def test_corpus_is_the_references():
    assert [p.fingerprint() for p in PROBS] == [p.fingerprint() for p in REF_PROBS]


# ------------------------------------------------------------ bit parity
@pytest.mark.parametrize("backend", ["auto", "python", "torch", "cuda"])
def test_single_request_bit_identical_to_pack(backend):
    async def go():
        async with _service(backend=backend) as svc:
            return await svc.pack(PROBS[0], seed=7)

    res = asyncio.run(go())
    assert res.params["backend"] == ("torch" if backend == "auto" else backend)
    assert result_signature(res) == _ref(0, 7)


def test_microbatched_mixed_fleet_bit_parity():
    """Concurrent mixed requests ride shared micro-batches, yet every
    response equals the reference's standalone run."""
    reqs = [(i, s) for i in range(len(PROBS)) for s in (0, 1)]

    async def go():
        async with _service(max_batch=4, max_wait_ms=20.0) as svc:
            out = await asyncio.gather(
                *(svc.pack(PROBS[i], seed=s) for i, s in reqs)
            )
            return out, svc.stats()

    out, stats = asyncio.run(go())
    for (i, s), res in zip(reqs, out):
        assert result_signature(res) == _ref(i, s)
    assert stats["solved"] == len(reqs)
    assert stats["batches"] < len(reqs)  # real batching happened
    assert stats["batch_occupancy"]["mean"] > 1.0


# ------------------------------------------------- dedup: coalesce + caches
def test_inflight_duplicates_coalesce_to_one_solve():
    async def go():
        async with _service() as svc:
            out = await asyncio.gather(
                *(svc.pack(PROBS[1], seed=5) for _ in range(6))
            )
            return out, svc.stats()

    out, stats = asyncio.run(go())
    assert stats["solved"] == 1
    assert stats["coalesced"] == 5
    assert all(result_signature(r) == _ref(1, 5) for r in out)


def test_sequential_repeat_hits_memory_cache():
    async def go():
        async with _service() as svc:
            a = await svc.pack(PROBS[2], seed=1)
            b = await svc.pack(PROBS[2], seed=1)
            return a, b, svc.stats()

    a, b, stats = asyncio.run(go())
    assert stats["solved"] == 1 and stats["cache_hits_mem"] == 1
    assert result_signature(a) == result_signature(b) == _ref(2, 1)
    assert stats["hit_rate"] == 0.5


def test_store_warm_restart_bit_identical(tmp_path):
    """A restarted service over the same store dir serves prior results
    from disk — zero solver work, answers equal to the reference's."""
    store = tmp_path / "store"

    async def run():
        async with _service(store_dir=store) as svc:
            out = await asyncio.gather(*(svc.pack(p, seed=2) for p in PROBS))
            return out, svc.stats()

    cold, _ = asyncio.run(run())
    warm, stats = asyncio.run(run())
    assert stats["solved"] == 0
    assert stats["cache_hits_store"] == len(PROBS)
    for i, (a, b) in enumerate(zip(cold, warm)):
        assert result_signature(a) == result_signature(b) == _ref(i, 2)


# ------------------------------------------------- degradation + lifecycle
def test_deadline_skips_batching_window():
    """With a 10 s batching window, a 1 ms deadline request cannot wait for
    co-batchers: it flushes immediately, alone (single-candidate fallback)."""
    async def go():
        async with _service(max_wait_ms=10_000.0) as svc:
            res = await asyncio.wait_for(
                svc.pack(PROBS[0], seed=0, deadline_ms=1.0), timeout=30.0
            )
            return res, svc.stats()

    res, stats = asyncio.run(go())
    assert result_signature(res) == _ref(0, 0)
    assert stats["deadline_fallbacks"] == 1
    assert stats["batch_occupancy"]["counts"] == {"1": 1}


def test_backpressure_bounded_queue_still_answers_everything():
    reqs = [(i, s) for i in range(len(PROBS)) for s in range(3)]

    async def go():
        async with _service(max_queue=2, max_batch=2) as svc:
            out = await asyncio.gather(
                *(svc.pack(PROBS[i], seed=s) for i, s in reqs)
            )
            assert svc._queue.maxsize == 2
            return out

    out = asyncio.run(go())
    for (i, s), res in zip(reqs, out):
        assert result_signature(res) == _ref(i, s)


def test_stop_drains_accepted_work():
    async def go():
        svc = _service()
        tasks = [
            asyncio.create_task(svc.pack(PROBS[i], seed=9))
            for i in range(len(PROBS))
        ]
        await asyncio.sleep(0.01)  # let requests reach the queue
        await svc.stop()
        assert all(t.done() for t in tasks)
        out = [t.result() for t in tasks]
        with pytest.raises(RuntimeError):
            await svc.pack(PROBS[0], seed=0)  # stopped: no new admissions
        return out

    out = asyncio.run(go())
    for i, res in enumerate(out):
        assert result_signature(res) == _ref(i, 9)


def test_solver_error_propagates_to_clients():
    async def go():
        async with PackingService("no-such-algo", backend="python",
                                  device="cpu") as svc:
            with pytest.raises(ValueError, match="unknown algorithm"):
                await svc.pack(PROBS[0], seed=0)
            return svc.stats()

    stats = asyncio.run(go())
    assert stats["inflight"] == 0  # failed request cleaned up
    assert stats["solved"] == 0 and stats["batches"] == 1


def test_stats_surface_shape():
    async def go():
        async with _service() as svc:
            await svc.pack(PROBS[0], seed=0)
            return svc.stats()

    stats = asyncio.run(go())
    for key in ("requests", "coalesced", "cache_hits_mem",
                "cache_hits_store", "hit_rate", "solved", "batches",
                "deadline_fallbacks", "queue_depth", "pending", "inflight",
                "batch_occupancy", "latency_cached", "latency_solved"):
        assert key in stats, key
    assert stats["latency_solved"]["count"] == 1
    assert stats["latency_solved"]["p99_s"] >= stats["latency_solved"]["p50_s"] >= 0
    assert sum(
        int(v) for v in stats["batch_occupancy"]["counts"].values()
    ) == stats["batches"]


# --------------------------------------------------- micro-batcher policy
def _req(group, deadline_at=None):
    return Request(prob=None, seed=0, key=(), group=group, future=None,
                   arrival=0.0, flush_at=0.0, deadline_at=deadline_at)


def _ref_req(group, deadline_at=None):
    return ref_serve.Request(prob=None, seed=0, key=(), group=group, future=None,
                             arrival=0.0, flush_at=0.0, deadline_at=deadline_at)


def test_batcher_size_flush_is_immediate():
    b = MicroBatcher(max_batch=2, max_wait_ms=1e6)
    b.admit(_req("g"), now=0.0)
    assert b.pop_ready(0.0) == []
    b.admit(_req("g"), now=0.0)
    (batch,) = b.pop_ready(0.0)
    assert len(batch) == 2 and b.pending() == 0


def test_batcher_age_flush_and_group_separation():
    b = MicroBatcher(max_batch=8, max_wait_ms=1000.0)
    b.admit(_req("g1"), now=0.0)
    b.admit(_req("g2"), now=0.5)
    assert b.pop_ready(0.9) == []  # neither window closed
    assert b.next_flush_at() == pytest.approx(1.0)
    batches = b.pop_ready(1.0)  # g1's window closes; g2 keeps waiting
    assert [r.group for bt in batches for r in bt] == ["g1"]
    assert b.pending() == 1


def test_batcher_deadline_rush():
    b = MicroBatcher(max_batch=8, max_wait_ms=1000.0)
    b.admit(_req("g", deadline_at=0.01), now=0.0)
    (batch,) = b.pop_ready(0.0)  # due immediately, alone
    assert len(batch) == 1 and batch[0].deadline_rushed


def test_batcher_decisions_equal_the_references():
    """One admission script through both batchers: the same batches, in
    the same order, at the same moments."""
    script = [("a", 0.0, None), ("b", 0.001, None), ("a", 0.002, 0.003),
              ("a", 0.003, None), ("b", 0.004, None), ("a", 0.0045, None),
              ("c", 0.005, 0.5), ("a", 0.006, None), ("b", 0.007, None)]
    out = []
    for batcher, make in ((MicroBatcher(3, 4.0), _req),
                          (ref_serve.MicroBatcher(3, 4.0), _ref_req)):
        log = []
        for i, (group, now, deadline) in enumerate(script):
            r = make(group, deadline)
            r.seed = i
            batcher.admit(r, now)
            for t in (now, now + 0.002):
                log.append((t, batcher.next_flush_at(),
                            [[(q.seed, q.deadline_rushed) for q in bt]
                             for bt in batcher.pop_ready(t)]))
        log.append([[q.seed for q in bt] for bt in batcher.drain()])
        out.append(log)
    assert out[0] == out[1]


def test_latency_stats_percentiles():
    ls = LatencyStats()
    for v in range(1, 101):
        ls.record(float(v))
    assert ls.count == 100
    assert ls.percentile(0.50) == pytest.approx(50.0, abs=1.0)
    assert ls.percentile(0.99) == pytest.approx(99.0, abs=1.0)
    assert ls.mean == pytest.approx(50.5)


# ------------------------------------------------------ beyond the reference
def test_default_device_is_cuda_and_raises_at_construction_without_it():
    """``device=None`` means cuda; without CUDA the constructor raises —
    never a per-request failure later, inside the worker thread."""
    if torch.cuda.is_available():
        svc = PackingService()
        assert svc.device.type == "cuda"
        svc._pool.shutdown()
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackingService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PackingService("ga-nfd", backend="python", device="cuda")
    assert PackingService(device="cpu").device == torch.device("cpu")


def test_ga_nfd_service_bit_identical_to_reference_pack():
    """A GA-NFD service (the lockstep lane through the fitness wrappers)
    answers a mixed batch of homogeneous and heterogeneous problems equal
    to the reference's standalone ``pack``."""
    hyper = dict(max_seconds=1e9, patience=10**9, n_pop=8, max_generations=6)
    reqs = [(i, s) for i in (0, 1, 3) for s in (0, 1)]
    homog = make_problems(1, seed=5, max_buffers=14)
    ref_homog = ref_serve.make_problems(1, seed=5, max_buffers=14)

    async def go():
        async with PackingService("ga-nfd", device="cpu", backend="cuda",
                                  max_batch=4, max_wait_ms=20.0, **hyper) as svc:
            out = await asyncio.gather(
                *(svc.pack(PROBS[i], seed=s) for i, s in reqs),
                svc.pack(homog[0], seed=4),
            )
            return out, svc.stats()

    out, stats = asyncio.run(go())
    for (i, s), res in zip(reqs, out):
        assert result_signature(res) == _ref(i, s, "ga-nfd", **hyper)
    want = ref.pack(ref_homog[0], "ga-nfd", seed=4, backend="python", **hyper)
    assert result_signature(out[-1]) == ref_serve.result_signature(want)
    assert stats["solved"] == len(reqs) + 1 and stats["batches"] < len(reqs) + 1
