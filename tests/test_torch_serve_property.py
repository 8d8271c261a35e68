"""Hypothesis property tests for the port's packing service: the
counterpart of ``tests/test_serve_property.py``.

For *arbitrary interleavings* of request arrivals — mixed problems
(hetero and homogeneous devices), duplicate fingerprints, varying seeds,
varying micro-batch limits and flush windows, staggered vs simultaneous
admission — the port's service (``device="cpu"``, through the kernel
wrappers' plain versions) must satisfy two properties:

1. **bit-parity**: every response equals the reference's standalone
   ``repro.core.pack(problem, seed)`` with the service's solver settings;
2. **coalescing**: duplicate requests collapse — the solver runs exactly
   once per *unique* task, no matter how many times or in what order the
   task is requested.

The reference's answers are memoized across examples (they are pure
functions of (problem, seed)), so hypothesis explores interleavings
without re-paying the solver each time.
"""
import asyncio

import pytest

pytest.importorskip("hypothesis", reason="optional dependency: hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core as ref
import repro.serve as ref_serve
from repro_torch.serve import PackingService, make_problems, result_signature

_HYPER = dict(max_seconds=1e9, patience=10**9, max_iterations=40, n_chains=2)
_KW = dict(_HYPER, backend="cuda", device="cpu")

# small mixed corpus: index 0-2 heterogeneous (OCM inventories, kind
# lanes), 3-4 homogeneous — duplicate group keys across both families
PROBS = make_problems(3, seed=21, hetero=True, max_buffers=10) + \
    make_problems(2, seed=22, hetero=False, max_buffers=10)
REF_PROBS = ref_serve.make_problems(3, seed=21, hetero=True, max_buffers=10) + \
    ref_serve.make_problems(2, seed=22, hetero=False, max_buffers=10)

_REFS: dict[tuple[int, int], tuple] = {}


def _ref_signature(idx: int, seed: int) -> tuple:
    if (idx, seed) not in _REFS:
        _REFS[(idx, seed)] = ref_serve.result_signature(
            ref.pack(REF_PROBS[idx], "sa-s", seed=seed, backend="python", **_HYPER)
        )
    return _REFS[(idx, seed)]


arrivals = st.lists(
    st.tuples(
        st.integers(0, len(PROBS) - 1),  # problem (duplicates likely)
        st.integers(0, 1),               # seed pool
        st.floats(0.0, 0.004),           # admission stagger (seconds)
    ),
    min_size=1,
    max_size=10,
)


@settings(max_examples=10, deadline=None)
@given(
    arrivals,
    st.integers(1, 4),                    # max_batch
    st.sampled_from([0.0, 1.0, 8.0]),     # max_wait_ms
)
def test_any_interleaving_bit_parity_and_coalescing(reqs, max_batch, wait_ms):
    async def go():
        async with PackingService(
            "sa-s", max_batch=max_batch, max_wait_ms=wait_ms, **_KW
        ) as svc:
            async def one(idx, seed, delay):
                await asyncio.sleep(delay)
                return await svc.pack(PROBS[idx], seed=seed)

            out = await asyncio.gather(
                *(one(i, s, d) for i, s, d in reqs)
            )
            return out, svc.stats()

    out, stats = asyncio.run(go())

    for (idx, seed, _), res in zip(reqs, out):
        assert result_signature(res) == _ref_signature(idx, seed)

    unique = {(i, s) for i, s, _ in reqs}
    # exactly one solve per unique task: in-flight duplicates coalesced,
    # later duplicates memory-cached — never a repeat solve
    assert stats["solved"] == len(unique)
    assert stats["requests"] == len(reqs)
    dupes = len(reqs) - len(unique)
    assert stats["coalesced"] + stats["cache_hits_mem"] == dupes
    assert stats["inflight"] == 0 and stats["pending"] == 0


@settings(max_examples=6, deadline=None)
@given(st.integers(2, 8), st.integers(0, 1))
def test_n_way_duplicate_burst_is_one_solve(n, seed):
    """The sharpest coalescing case: N simultaneous identical requests."""
    async def go():
        async with PackingService("sa-s", max_batch=4, **_KW) as svc:
            out = await asyncio.gather(
                *(svc.pack(PROBS[0], seed=seed) for _ in range(n))
            )
            return out, svc.stats()

    out, stats = asyncio.run(go())
    assert stats["solved"] == 1
    assert stats["coalesced"] + stats["cache_hits_mem"] == n - 1
    sig = _ref_signature(0, seed)
    assert all(result_signature(r) == sig for r in out)
