"""The traffic generator: the same seed gives the same work, another seed
the same amount of work in another order (CPU only)."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import schedule
from perfbench.stats import nearest_rank

ROOT = Path(__file__).resolve().parents[1]
SERVE = json.loads((ROOT / "perfbench" / "traffic" / "serve-sa.json").read_text())
ACCS = ["CNV-W1A1", "CNV-W2A2", "Tincy-YOLO", "DoReFaNet", "ReBNet", "RN50-W1A2",
        "RN101-W1A2", "RN152-W1A2"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**64 + 1])
def test_open_loop_repeats_per_seed(seed):
    a = schedule.open_loop(SERVE, ACCS, seed, 30.0)
    b = schedule.open_loop(SERVE, ACCS, seed, 30.0)
    assert a == b and len(a) == round(SERVE["rate_hz"] * 30)
    assert all(0 <= x.due_s < 30.0 for x in a)
    assert all(x.due_s <= y.due_s for x, y in zip(a, a[1:]))


def test_open_loop_seeds_reorder_the_same_work():
    a = schedule.open_loop(SERVE, ACCS, 11, 30.0)
    b = schedule.open_loop(SERVE, ACCS, 12, 30.0)
    assert [x.accelerator for x in a] != [x.accelerator for x in b]
    assert sorted(x.accelerator for x in a) == sorted(x.accelerator for x in b)
    assert len({x.seed for x in a + b}) == len(a) + len(b)  # every request solved afresh


def test_zipf_counts_follow_the_ranks():
    counts = schedule.zipf_counts(150, 8, 1.2)
    assert sum(counts) == 150 and counts == sorted(counts, reverse=True)
    p = np.arange(1, 9, dtype=float) ** -1.2
    assert np.all(np.abs(np.asarray(counts) - 150 * p / p.sum()) < 1)


def test_seed_stream_repeats_and_takes_large_seeds():
    for seed in (1, 2**31 + 17, 2**70):
        a = [schedule.SeedStream(seed).next() for _ in range(1)]
        s = schedule.SeedStream(seed)
        assert a[0] == s.next() and s.next() != a[0]
    assert schedule.SeedStream(5).next() != schedule.SeedStream(6).next()


def test_nearest_rank_matches_the_program_rule():
    from repro_torch.serve.stats import LatencyStats

    rng = np.random.default_rng(3)
    xs = list(rng.exponential(size=57))
    ls = LatencyStats()
    for x in xs:
        ls.record(x)
    for q in (0.5, 0.95, 0.99):
        assert nearest_rank(xs, q) == ls.percentile(q)
    assert nearest_rank([1.0, 2.0], 0.5) == 1.0
