"""The port's data pipeline (`repro_torch.data`) against the reference's
(`repro.data`): `pack_documents` gives the reference's sequences, pipeline
batches are bit-equal step for step (packed and one document per row),
the two-integer iterator state crosses the packages both ways, and the
pipeline cases of `tests/test_runtime.py` hold on the port.

Documents come from numpy's counter-based generator in both packages and
the deterministic heuristics (``ffd``, the default, and ``nfd`` at a seed)
pack them, so every comparison is exact."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.data import pack_documents as ref_pack_documents
from repro.data.packing import packing_efficiency as ref_packing_efficiency
from repro_torch.data import DataConfig, SyntheticTokenPipeline, pack_documents
from repro_torch.data.packing import packing_efficiency

CPU = "cpu"
CONFIGS = [
    dict(),  # the defaults: seq 512, batch 8, vocab 32000
    dict(seq_len=128, global_batch=2, vocab_size=1000, seed=3),
    dict(seq_len=256, global_batch=3, vocab_size=500, seed=1, max_docs_per_seq=3),
    dict(seq_len=64, global_batch=5, vocab_size=64, seed=7, mean_doc_len=40),
]


def doc_lengths(seed, n, seq_len):
    rng = np.random.default_rng(seed)
    return [int(x) for x in np.clip(rng.lognormal(np.log(seq_len * 0.6), 0.7, n), 1, seq_len)]


@pytest.mark.parametrize("algorithm", ["ffd", "nfd"])
@pytest.mark.parametrize("seed,n,seq_len,max_docs", [
    (0, 40, 512, 8), (1, 120, 128, 4), (2, 17, 64, 2), (3, 300, 2048, 8), (4, 1, 32, 8),
])
def test_pack_documents_equals_reference(algorithm, seed, n, seq_len, max_docs):
    lengths = doc_lengths(seed, n, seq_len)
    want = ref_pack_documents(lengths, seq_len, max_docs, algorithm=algorithm, seed=seed)
    got = pack_documents(lengths, seq_len, max_docs, algorithm=algorithm, seed=seed,
                         device=CPU)
    assert got == want
    assert sorted(i for seq in got for i in seq) == list(range(n))
    assert all(sum(lengths[i] for i in seq) <= seq_len for seq in got)
    assert packing_efficiency(got, lengths, seq_len) == ref_packing_efficiency(
        want, lengths, seq_len)


def test_pack_documents_rejects_long_documents():
    with pytest.raises(ValueError, match="split documents"):
        pack_documents([10, 65], 64, device=CPU)


def test_pack_documents_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_documents([10, 20], 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticTokenPipeline(DataConfig(seq_len=64, global_batch=1)).next_batch()


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want) == ["segments", "targets", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_batches_bit_equal_reference(kw, pack):
    ref = RefPipeline(RefDataConfig(pack=pack, **kw))
    port = SyntheticTokenPipeline(DataConfig(pack=pack, **kw), device=CPU)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    for _ in range(3):
        assert_batches_equal(port.next_batch(), ref.next_batch())
        assert port.state() == ref.state()


@pytest.mark.parametrize("pack", [True, False])
def test_state_crosses_packages_both_ways(pack):
    kw = dict(seq_len=128, global_batch=2, vocab_size=1000, seed=3, pack=pack)
    ref = RefPipeline(RefDataConfig(**kw))
    port = SyntheticTokenPipeline(DataConfig(**kw), device=CPU)
    for _ in range(2):
        ref.next_batch()
    # reference -> port
    port.restore(ref.state())
    assert port.state() == ref.state() == {"doc_index": ref.doc_index, "step": 2}
    assert_batches_equal(port.next_batch(), ref.next_batch())
    # port -> reference (a fresh reference pipeline picks up where the port is)
    port.next_batch()
    ref2 = RefPipeline(RefDataConfig(**kw))
    ref2.restore(port.state())
    assert_batches_equal(ref2.next_batch(), port.next_batch())
    # the state is two plain integers
    assert {type(v) for v in port.state().values()} == {int}


# ------------------------------------------- tests/test_runtime.py's cases
def test_pipeline_deterministic_and_restorable():
    cfg = DataConfig(seq_len=128, global_batch=2, vocab_size=1000, seed=3)
    p1 = SyntheticTokenPipeline(cfg, device=CPU)
    b1 = [p1.next_batch() for _ in range(3)]
    # restore mid-stream
    p2 = SyntheticTokenPipeline(cfg, device=CPU)
    p2.next_batch()
    state = p2.state()
    p3 = SyntheticTokenPipeline(cfg, device=CPU)
    p3.restore(state)
    b2a, b3a = p2.next_batch(), p3.next_batch()
    np.testing.assert_array_equal(b2a["tokens"], b3a["tokens"])
    # full determinism
    p4 = SyntheticTokenPipeline(cfg, device=CPU)
    b4 = [p4.next_batch() for _ in range(3)]
    for x, y in zip(b1, b4):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_pipeline_targets_are_next_tokens():
    cfg = DataConfig(seq_len=256, global_batch=2, vocab_size=500, seed=1)
    b = SyntheticTokenPipeline(cfg, device=CPU).next_batch()
    toks, tgts, segs = b["tokens"], b["targets"], b["segments"]
    for row in range(toks.shape[0]):
        for t in range(toks.shape[1] - 1):
            if tgts[row, t] >= 0 and segs[row, t] == segs[row, t + 1] != 0:
                assert tgts[row, t] == toks[row, t + 1]


def test_packing_beats_unpacked_efficiency():
    packed = DataConfig(seq_len=512, global_batch=4, seed=5, pack=True)
    unpacked = dataclasses.replace(packed, pack=False)
    bp = SyntheticTokenPipeline(packed, device=CPU).next_batch()
    bu = SyntheticTokenPipeline(unpacked, device=CPU).next_batch()
    fill_p = float((bp["segments"] > 0).mean())
    fill_u = float((bu["segments"] > 0).mean())
    assert fill_p > fill_u
