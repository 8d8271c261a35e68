"""K6 (packed-bank segment matvec): the port's plain version and the CUDA
wrapper's CPU path against the reference's Pallas kernel (interpret mode)
and its jnp oracle, within float32 rounding (``rtol = atol = 1e-5``, the
reference test's tolerance: the sums run in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.packed_gather import bank_matvec as ref_bank_matvec
from repro.kernels.packed_gather import packed_gather_matvec
from repro.kernels.packed_gather import packed_gather_ref as jnp_packed_gather_ref
from repro.kernels.packed_gather import split_outputs as ref_split_outputs
from repro_torch import kernels
from repro_torch.kernels.packed_gather import (
    bank_matvec,
    packed_gather_cuda,
    packed_gather_ref,
    split_outputs,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def case(seed):
    """The reference test's seeded shapes (tests/test_kernels.py,
    test_packed_gather_property)."""
    rng = np.random.default_rng(seed)
    r = 8 * int(rng.integers(1, 7))
    c = 128 * int(rng.integers(1, 5))
    n = int(rng.integers(1, 7))
    bank = rng.normal(size=(r, c)).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    seg = rng.integers(0, n, r).astype(np.int32)
    return bank, x, seg


def port_calls(bank, x, seg):
    t = [torch.from_numpy(a) for a in (bank, x, seg)]
    return {
        "ref": packed_gather_ref(*t),
        "cuda wrapper": packed_gather_cuda(*t),
        "auto": bank_matvec(*t),
        "torch": bank_matvec(*t, backend="torch"),
        "cuda": bank_matvec(*t, backend="cuda"),
    }


@pytest.mark.parametrize("seed", range(20))
def test_matches_pallas_kernel_and_jnp_oracle(seed):
    bank, x, seg = case(seed)
    pallas = np.asarray(packed_gather_matvec(
        jnp.asarray(bank), jnp.asarray(x), jnp.asarray(seg), interpret=True))
    oracle = np.asarray(jnp_packed_gather_ref(jnp.asarray(bank), jnp.asarray(x),
                                              jnp.asarray(seg)))
    for name, y in port_calls(bank, x, seg).items():
        assert y.dtype == torch.float32 and y.shape == (bank.shape[0],), name
        np.testing.assert_allclose(y.numpy(), pallas, **TOL, err_msg=name)
        np.testing.assert_allclose(y.numpy(), oracle, **TOL, err_msg=name)


def test_out_of_range_segment_gives_zero_like_the_pallas_kernel():
    """seg outside [0, N) gives 0 in the Pallas kernel and in the port; the
    reference's jnp oracle wraps / clamps its gather there instead."""
    rng = np.random.default_rng(11)
    n, c = 3, 128
    bank = rng.normal(size=(8, c)).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    seg = np.array([3, -1, 5, 0, 1, 2, -7, 2**31 - 1], np.int32)
    pallas = np.asarray(packed_gather_matvec(
        jnp.asarray(bank), jnp.asarray(x), jnp.asarray(seg), interpret=True))
    out = np.isin(np.arange(8), [0, 1, 2, 6, 7])
    assert np.all(pallas[out] == 0)
    for name, y in port_calls(bank, x, seg).items():
        assert np.all(y.numpy()[out] == 0), name
        np.testing.assert_allclose(y.numpy(), pallas, **TOL, err_msg=name)
    oracle = np.asarray(jnp_packed_gather_ref(jnp.asarray(bank), jnp.asarray(x),
                                              jnp.asarray(seg)))
    np.testing.assert_allclose(oracle[1], bank[1] @ x[2], **TOL)  # -1 wraps to x[2]
    # no activations at all: every row is out of range
    empty = packed_gather_cuda(torch.from_numpy(bank), torch.zeros(0, c),
                               torch.from_numpy(seg))
    assert torch.equal(empty, torch.zeros(8))


def test_split_outputs_matches_reference():
    rng = np.random.default_rng(0)
    r, c, n = 24, 128, 3
    bank = rng.normal(size=(r, c)).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    seg = np.repeat(np.arange(n), r // n).astype(np.int32)
    rng.shuffle(seg)
    y_ref = ref_bank_matvec(jnp.asarray(bank), jnp.asarray(x), jnp.asarray(seg),
                            backend="ref")
    want = ref_split_outputs(y_ref, seg, n)
    y = bank_matvec(torch.from_numpy(bank), torch.from_numpy(x), torch.from_numpy(seg))
    for s in (torch.from_numpy(seg), seg):
        got = split_outputs(y, s, n)
        assert [g.shape[0] for g in got] == [w.shape[0] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert sum(g.shape[0] for g in got) == r


def test_wrapper_checks_raise_and_do_not_count():
    kernels.reset_launch_counts()
    bank = torch.zeros(16, 256)
    x = torch.zeros(2, 256)
    seg = torch.zeros(16, dtype=torch.int32)
    packed_gather_cuda(bank, x, seg)
    bad = [
        (TypeError, (bank.double(), x, seg)),
        (TypeError, (bank, x.half(), seg)),
        (TypeError, (bank, x, seg.long())),
        (TypeError, (bank.numpy(), x, seg)),
        (ValueError, (bank[:12], x, seg[:12])),  # R % 8
        (ValueError, (torch.zeros(16, 200), torch.zeros(2, 200), seg)),  # C % 128
        (ValueError, (bank, torch.zeros(2, 128), seg)),  # x width
        (ValueError, (bank, x, seg[:8])),  # seg length
        (ValueError, (bank.reshape(16, 2, 128), x, seg)),
        (ValueError, (bank, x, seg.reshape(16, 1))),
        (ValueError, (torch.zeros(256, 16).t(), x, seg)),  # not contiguous
        (ValueError, (torch.zeros(16 * 256 + 1)[1:].view(16, 256), x, seg)),  # misaligned
        (ValueError, (bank, x.to("meta"), seg)),  # two devices
        (ValueError, (bank.to("meta"), x.to("meta"), seg.to("meta"))),
    ]
    for err, args in bad:
        with pytest.raises(err, match="packed_gather"):
            packed_gather_cuda(*args)
    with pytest.raises(ValueError, match="unknown backend"):
        bank_matvec(bank, x, seg, backend="pallas")
    assert kernels.launch_counts()["packed_gather_cuda"] == 0
