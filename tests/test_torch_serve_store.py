"""Fault-injection and cross-package tests for the port's ``ResultStore``:
the counterpart of every test in ``tests/test_serve_store.py``, with the
``tests/faultinject.py`` corruptors, plus the store shared with the
reference in both directions and ``write_atomic_dir(replace=False)`` held
to the reference's on the same races.

The contract under damage mirrors ``restore_latest_valid``: a damaged
entry is **skipped with a logged warning and never served**; the caller
recomputes and the recompute's ``put`` repairs the entry on disk.  The
concurrent-writer contract is the atomic-rename one: a losing writer
never touches the winning entry.  Entries are the reference's layout under
the reference's directory names, so a store written by either package is
served warm by the other (for the task keys both packages share: backend
``"python"`` or ``"auto"``).
"""
import asyncio
import json
import os

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.serve as ref_serve
import repro_torch.core as port
from faultinject import (
    corrupt_arrays,
    corrupt_manifest,
    half_delete,
    tear_arrays,
)
from repro.checkpoint import write_atomic_dir as ref_write_atomic_dir
from repro.core.dse import task_key as ref_task_key
from repro_torch.checkpoint import read_atomic_dir, write_atomic_dir
from repro_torch.core.dse import task_key
from repro_torch.serve import (
    PackingService,
    ResultStore,
    make_problems,
    result_signature,
)

_HYPER = dict(patience=10**9, max_iterations=60, n_chains=2)
_KW = dict(max_seconds=1e9, **_HYPER)

PROB = make_problems(1, seed=11, hetero=True, max_buffers=12)[0]
REF_PROB = ref_serve.make_problems(1, seed=11, hetero=True, max_buffers=12)[0]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solve(seed=0, backend="python"):
    return port.pack(PROB, "sa-s", seed=seed, backend=backend, device="cpu", **_KW)


def _ref_solve(seed=0, backend="python"):
    return ref.pack(REF_PROB, "sa-s", seed=seed, backend=backend, **_KW)


def _key(seed=0, backend="python"):
    return task_key(PROB, "sa-s", seed, backend=backend, max_seconds=1e9,
                    hyper=dict(_HYPER))


def _ref_key(seed=0, backend="python"):
    return ref_task_key(REF_PROB, "sa-s", seed, backend=backend, max_seconds=1e9,
                        hyper=dict(_HYPER))


def _files(entry):
    return {f.name: f.read_bytes() for f in entry.iterdir() if f.is_file()}


def test_round_trip_bit_identical(tmp_path):
    store = ResultStore(tmp_path)
    res = _solve()
    assert result_signature(res) == ref_serve.result_signature(_ref_solve())
    assert store.put(_key(), res)
    assert _key() in store and len(store) == 1
    got = store.get(_key(), PROB)
    assert result_signature(got) == result_signature(res)
    # full metadata survives too, not just the packing
    assert got.algorithm == res.algorithm
    assert got.iterations == res.iterations
    assert got.params == res.params


def test_fresh_store_over_same_dir_serves_warm(tmp_path):
    """The killed-server model: writer process gone, a brand-new store over
    the same dir serves its results from disk."""
    ResultStore(tmp_path).put(_key(), _solve())
    reborn = ResultStore(tmp_path)
    got = reborn.get(_key(), PROB)
    assert result_signature(got) == result_signature(_solve())
    assert reborn.hits == 1 and reborn.corrupt_skipped == 0


@pytest.mark.parametrize(
    "corruptor", [tear_arrays, corrupt_arrays, corrupt_manifest, half_delete]
)
def test_damaged_entry_skipped_then_repaired(tmp_path, corruptor, caplog):
    store = ResultStore(tmp_path)
    res = _solve()
    store.put(_key(), res)
    corruptor(store.path_for(_key()))

    with caplog.at_level("WARNING", logger="repro_torch.serve.store"):
        assert store.get(_key(), PROB) is None  # never served damaged
    assert store.corrupt_skipped == 1
    assert any("corrupt" in r.message and r.name == "repro_torch.serve.store"
               for r in caplog.records)

    # the recompute path: put() swaps the damaged entry for a fresh one
    assert store.put(_key(), res)
    store2 = ResultStore(tmp_path)
    assert result_signature(store2.get(_key(), PROB)) == result_signature(res)


def test_wrong_key_digest_never_served(tmp_path):
    """An entry renamed over another task's slot fails the digest check."""
    store = ResultStore(tmp_path)
    store.put(_key(0), _solve(0))
    path0 = store.path_for(_key(0))
    path1 = store.path_for(_key(1))
    path0.rename(path1)  # files intact, identity wrong
    assert store.get(_key(1), PROB) is None
    assert store.corrupt_skipped == 1


def test_concurrent_second_writer_never_corrupts(tmp_path):
    """Atomic-rename contract: a losing writer leaves the winner untouched
    (same bytes before and after) and reports the lost race."""
    store_a = ResultStore(tmp_path)
    store_b = ResultStore(tmp_path)
    res = _solve()
    assert store_a.put(_key(), res)
    entry = store_a.path_for(_key())
    before = _files(entry)

    assert store_b.put(_key(), res) is False  # lost the race
    assert store_b.lost_races == 1
    assert _files(entry) == before  # bit-for-bit untouched
    assert not list(tmp_path.glob("*.tmp*"))  # scratch dirs cleaned up

    got = store_b.get(_key(), PROB)
    assert result_signature(got) == result_signature(res)


def test_torn_tmp_dir_is_invisible(tmp_path):
    """A crash mid-write leaves only a scratch dir: not an entry, not
    counted, not served."""
    store = ResultStore(tmp_path)
    junk = tmp_path / "entry_deadbeef.tmp-999-aa"
    junk.mkdir()
    (junk / "arrays.npz").write_bytes(b"partial")
    assert len(store) == 0
    assert store.digests() == []


def test_manifest_is_valid_json_with_sha(tmp_path):
    """Entry layout contract: manifest carries format, task digest, and the
    sha256 the corruptors/readers verify against."""
    store = ResultStore(tmp_path)
    store.put(_key(), _solve())
    manifest = json.loads(
        (store.path_for(_key()) / "manifest.json").read_text()
    )
    assert manifest["format"] == 1
    assert manifest["digest"] in store.path_for(_key()).name
    assert len(manifest["sha256"]) == 64
    assert "wall_time_s" in manifest["result"]


# --------------------------------------------------- across the two packages
@pytest.mark.parametrize("backend", ["python", "auto"])
def test_entry_written_by_reference_is_served_by_port(tmp_path, backend):
    assert _key(backend=backend) == _ref_key(backend=backend)
    ref_store = ref_serve.ResultStore(tmp_path, memory_cache=False)
    want = _ref_solve(3, backend)
    assert ref_store.put(_ref_key(3, backend), want)
    store = ResultStore(tmp_path)
    assert store.path_for(_key(3, backend)) == ref_store.path_for(_ref_key(3, backend))
    got = store.get(_key(3, backend), PROB)
    assert store.hits == 1 and store.corrupt_skipped == 0
    assert result_signature(got) == ref_serve.result_signature(want)
    assert result_signature(got) == result_signature(_solve(3, backend))
    # an intact entry of the other package is never overwritten
    entry = store.path_for(_key(3, backend))
    before = _files(entry)
    assert store.put(_key(3, backend), got) is False
    assert _files(entry) == before


@pytest.mark.parametrize("backend", ["python", "auto"])
def test_entry_written_by_port_is_served_by_reference(tmp_path, backend):
    store = ResultStore(tmp_path)
    res = _solve(4, backend)
    assert store.put(_key(4, backend), res)
    ref_store = ref_serve.ResultStore(tmp_path, memory_cache=False)
    got = ref_store.get(_ref_key(4, backend), REF_PROB)
    assert ref_store.hits == 1 and ref_store.corrupt_skipped == 0
    assert ref_serve.result_signature(got) == result_signature(res)
    assert ref_serve.result_signature(got) == ref_serve.result_signature(
        _ref_solve(4, backend))
    assert ref_store.put(_ref_key(4, backend), got) is False


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_service_store_is_served_warm_by_the_other_package(tmp_path, writer):
    """A service of one package fills a store dir; a service of the other
    over the same dir answers every request from it, with no solve, equal
    to the writer's answers."""
    seeds = (0, 1)
    ref_svc = dict(store_dir=tmp_path, backend="auto", **_KW)
    port_svc = dict(ref_svc, device="cpu")

    async def run(make, probs):
        async with make() as svc:
            out = await asyncio.gather(*(svc.pack(p, seed=s) for p in probs
                                         for s in seeds))
            return [ref_serve.result_signature(r) for r in out], svc.stats()

    ref_probs = [REF_PROB] + ref_serve.make_problems(2, seed=12, max_buffers=12)
    port_probs = [PROB] + make_problems(2, seed=12, max_buffers=12)
    ref_run = (lambda: ref_serve.PackingService("sa-s", **ref_svc), ref_probs)
    port_run = (lambda: PackingService("sa-s", **port_svc), port_probs)
    first, second = (ref_run, port_run) if writer == "reference" else (port_run, ref_run)
    cold, cold_stats = asyncio.run(run(*first))
    warm, warm_stats = asyncio.run(run(*second))
    n = len(ref_probs) * len(seeds)
    assert cold_stats["solved"] == n
    assert warm_stats["solved"] == 0 and warm_stats["cache_hits_store"] == n
    assert warm == cold


# ------------------------------------------ write_atomic_dir(replace=False)
def _entry(tag):
    return {"a": np.arange(4) + tag}, {"tag": int(tag)}


def _lose_at(race, final, monkeypatch, rival):
    """Stage the race: the rival's entry is at ``final`` before the
    writer's exists() check ("exists") or lands between that check and
    the writer's rename ("rename")."""
    if race == "exists":
        rival(final, *_entry(1))
        return
    real = os.rename
    staged = []

    def rename_after_rival(src, dst):
        if os.fspath(dst) == os.fspath(final) and not staged:
            staged.append(True)
            rival(final, *_entry(1), tmp=final.with_name("rival.tmp"))
        return real(src, dst)

    monkeypatch.setattr(os, "rename", rename_after_rival)


@pytest.mark.parametrize("race", ["exists", "rename"])
def test_write_atomic_dir_no_replace_loses_like_the_reference(
        tmp_path, monkeypatch, race):
    """The same race against both packages' writers, the rival being the
    other package's: each returns False, leaves the rival's entry bit for
    bit, and no scratch dir behind."""
    out = {}
    for name, fn, rival in (("port", write_atomic_dir, ref_write_atomic_dir),
                            ("reference", ref_write_atomic_dir, write_atomic_dir)):
        final = tmp_path / name / "entry_x"
        final.parent.mkdir()
        with monkeypatch.context() as m:
            _lose_at(race, final, m, rival)
            before = _files(final) if final.exists() else None
            ok = fn(final, *_entry(2), replace=False)
        flat, manifest = read_atomic_dir(final)
        out[name] = (ok, manifest["tag"], flat["a"].tolist(),
                     sorted(p.name for p in final.parent.iterdir()))
        if before is not None:
            assert _files(final) == before
    assert out["port"] == out["reference"] == (
        False, 1, [1, 2, 3, 4], ["entry_x"])


def test_write_atomic_dir_returns_true_when_it_publishes(tmp_path):
    for fn in (write_atomic_dir, ref_write_atomic_dir):
        final = tmp_path / fn.__module__ / "e"
        final.parent.mkdir()
        assert fn(final, *_entry(0), replace=False) is True
        assert fn(final, *_entry(5)) is True  # replace=True swaps it out
        assert read_atomic_dir(final)[1]["tag"] == 5
        assert fn(final, *_entry(6), replace=False) is False
        assert read_atomic_dir(final)[1]["tag"] == 5
