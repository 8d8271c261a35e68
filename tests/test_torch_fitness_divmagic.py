"""K1 / K2's division by multiplication (``csrc/binpack_fitness.cu``) on the
CPU: the kernel's formula, emulated in numpy uint64 with the constants that
``build.ceil_div_magic`` makes (the function that fills the kernel's
``FitnessTables``), equals ``ceil(x / d) = -(-x // d)`` for every mode of
the four RAM kinds, a few hundred random divisors and the powers of two and
their neighbours, at the numerators where such a formula breaks first (0,
1, d - 1, d, d + 1, k d +- 1, 2**31 - 1).  The kernel's whole slot cost
(32-bit fast path and 64-bit path) is emulated the same way and held
against the plain version; the struct builder refuses what the kernel
cannot take.  K3 / K4 and K5's SA role cost each touched slot with the
same arithmetic (``fitness_slot_cost`` in ``csrc/fitness_rows.cuh``): its
emulated deltas equal K3 / K4's plain version on SA step inputs with empty
slots, zero heights and kinds past the table.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.problem import BRAM18, BRAM36, LUTRAM64, URAM288
from repro_torch.kernels import build
from repro_torch.kernels.binpack_fitness import binpack_fitness_kinds_ref
from repro_torch.kernels.binpack_sa_step import sa_step_deltas_kinds_ref, sa_step_deltas_ref

I32_MAX = 2**31 - 1
U32 = np.uint64(0xFFFFFFFF)


def device_ceil_div(x, magic, shift):
    """The kernel's ``(__umulhi(magic, 2 (x - 1)) >> shift) + 1``, in uint32
    arithmetic (uint64 numpy, masked), for int32 ``x >= 0``; ``x == 0`` is a
    slot the kernel skips (cost 0), as ceil(0 / d) = 0 gives."""
    x = np.asarray(x, dtype=np.uint64)
    n2 = ((x - np.uint64(1)) << np.uint64(1)) & U32
    hi = (np.uint64(magic) * n2) >> np.uint64(32)
    return np.where(x == 0, np.uint64(0), (hi >> np.uint64(shift)) + np.uint64(1))


def numerators(d):
    """Where a magic-number division is likeliest to be off by one."""
    base = [0, 1, d - 1, d, d + 1, I32_MAX, I32_MAX - 1, I32_MAX - d, I32_MAX - d + 1]
    for k in (2, 3, 7, 1000, 65537, I32_MAX // d, I32_MAX // d - 1):
        base += [k * d - 1, k * d, k * d + 1]
    return np.array(sorted({x for x in base if 0 <= x <= I32_MAX}), dtype=np.int64)


def check_divisor(d):
    magic, shift = build.ceil_div_magic(d)
    # the proof's premises (csrc/binpack_fitness.cu): magic < 2**32 and
    # e = magic * d - 2**(31 + shift) in [0, 2**shift)
    assert 0 < magic < 2**32
    assert 0 <= magic * d - 2 ** (31 + shift) < 2**shift
    x = numerators(d)
    got = device_ceil_div(x, magic, shift)
    want = -(-x // d)
    np.testing.assert_array_equal(got.astype(np.int64), want, err_msg=f"d = {d}")


@pytest.mark.parametrize("kind", [BRAM18, BRAM36, URAM288, LUTRAM64], ids=lambda k: k.name)
def test_every_mode_of_every_ram_kind(kind):
    for mw, md in kind.modes:
        check_divisor(mw)
        check_divisor(md)


@pytest.mark.parametrize("seed", range(3))
def test_random_divisors(seed):
    rng = np.random.default_rng(seed)
    for d in rng.integers(1, I32_MAX, 100, endpoint=True):
        check_divisor(int(d))


def test_powers_of_two_and_their_neighbours():
    ds = {1, 2, 3, I32_MAX, I32_MAX - 1}
    for k in range(31):
        ds |= {2**k - 1, 2**k, 2**k + 1}
    for d in sorted(x for x in ds if 1 <= x <= I32_MAX):
        check_divisor(d)


def emulated_fitness(w, h, k, kind_tables):
    """The kernel's per-slot cost, step by step, from the struct the wrapper
    passes it: the 32-bit fast path where w * h < 2**32 (products and the
    minimum wrapped to uint32), the 64-bit path elsewhere, the modes past a
    kind's count as the struct holds them, weight 0 past the table."""
    t = build.fitness_tables_struct(kind_tables)
    w, h, k = (np.asarray(a, dtype=np.int64) for a in (w, h, k))
    out = np.zeros(w.shape, dtype=np.int64)
    for idx in np.ndindex(w.shape):
        wi, hi, ki = int(w[idx]), int(h[idx]), int(k[idx])
        if wi <= 0 or hi <= 0 or not 0 <= ki < build.MAX_KINDS:
            continue
        fast = wi * hi < 2**32
        best = None
        for m in range(build.MAX_MODES):
            md = t.mode[ki][m]
            cw = int(device_ceil_div(wi, md.magic_w, md.shift_w))
            ch = int(device_ceil_div(hi, md.magic_d, md.shift_d))
            c = (cw * (ch - 1) + cw) & 0xFFFFFFFF if fast else cw * ch
            best = c if best is None else min(best, c)
        out[idx] = best * t.weight[ki]
    return out


@pytest.mark.parametrize("case", ["u50", "extremes", "random"])
def test_emulated_slot_cost_equals_plain_version(case):
    """Both arithmetic paths of the kernel's slot cost, emulated, equal the
    plain version: ordinary geometry (fast path), int32 extremes (the
    64-bit path, and w * h just under and over 2**32), random tables."""
    rng = np.random.default_rng({"u50": 0, "extremes": 1, "random": 2}[case])
    if case == "u50":
        kt = ((1, BRAM18.modes), (16, URAM288.modes))
        w = rng.integers(0, 200, (6, 40))
        h = np.where(w > 0, rng.integers(1, 70_000, w.shape), 0)
        k = rng.integers(-1, 4, w.shape)
    elif case == "extremes":
        kt = ((1, ((1, 1), (I32_MAX, 7), (3, I32_MAX))), (5, ((I32_MAX, I32_MAX),)))
        w = rng.integers(2**31 - 1000, 2**31, (6, 40))
        h = rng.integers(0, 2**31, w.shape)
        w[:, :4] = [[65536, 65535, 65537, 1]] * 6  # w * h around 2**32
        h[:, :4] = [[65536, 65537, 65535, I32_MAX]] * 6
        k = rng.integers(0, 2, w.shape)
    else:
        kt = tuple((int(rng.integers(1, 32)),
                    tuple((int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
                          for _ in range(int(rng.integers(1, 9)))))
                   for _ in range(int(rng.integers(1, 5))))
        w = rng.integers(0, 100, (6, 40))
        h = np.where(w > 0, rng.integers(1, 70_000, w.shape), 0)
        k = rng.integers(0, len(kt) + 1, w.shape)
    w, h, k = (np.asarray(a, dtype=np.int32) for a in (w, h, k))
    plain = binpack_fitness_kinds_ref(*(torch.from_numpy(a) for a in (w, h, k)), kt).numpy()
    np.testing.assert_array_equal(emulated_fitness(w, h, k, kt), plain)


@pytest.mark.parametrize("case", ["u50", "random", "one-kind", "extremes"])
def test_emulated_sa_role_equals_plain_deltas(case):
    """K3 / K4 and K5's SA role, emulated: sum(cost(new)) - sum(cost(old)) over each
    chain row's touched slots, each slot costed as the GA role costs it,
    equals K3 / K4's plain version on the domain w, h >= 0 -- empty slots
    (w == 0), live widths at height 0, kinds past the table's count and
    past the struct (k < 0, k >= 4), and int32 extremes."""
    rng = np.random.default_rng({"u50": 10, "random": 11, "one-kind": 12, "extremes": 13}[case])
    shape = (40, 6)
    if case == "extremes":
        kt = ((1, ((1, 1), (I32_MAX, 7), (3, I32_MAX))), (5, ((I32_MAX, I32_MAX),)))
        planes = [rng.integers(2**31 - 1000, 2**31, shape) if i % 2 == 0
                  else rng.integers(0, 2**31, shape) for i in range(4)]
    else:
        kt = (((1, BRAM18.modes), (16, URAM288.modes)) if case == "u50" else
              ((1, ((int(rng.integers(1, 96)), int(rng.integers(1, 40_000))),) * 3),)
              if case == "one-kind" else
              tuple((int(rng.integers(1, 32)),
                     tuple((int(rng.integers(1, 96)), int(rng.integers(1, 40_000)))
                           for _ in range(int(rng.integers(1, 9)))))
                    for _ in range(int(rng.integers(1, 5)))))
        planes = []
        for _ in range(2):
            w = rng.integers(0, 100, shape)
            w[rng.random(shape) < 0.25] = 0
            h = rng.integers(1, 70_000, shape)
            h[rng.random(shape) < 0.15] = 0  # zero heights, live widths among them
            planes += [w, h]
    ow, oh, nw, nh = (np.asarray(a, dtype=np.int32) for a in planes)
    ok, nk = (rng.integers(-1, 6, shape).astype(np.int32) for _ in range(2))
    emulated = (emulated_fitness(nw, nh, nk, kt).sum(-1)
                - emulated_fitness(ow, oh, ok, kt).sum(-1))
    t = [torch.from_numpy(a) for a in (ow, oh, ok, nw, nh, nk)]
    np.testing.assert_array_equal(emulated, sa_step_deltas_kinds_ref(*t, kt).numpy())
    # without kind lanes: kind 0 of a one-kind table at weight 1
    modes = kt[0][1]
    zero = np.zeros(shape, dtype=np.int32)
    emulated = (emulated_fitness(nw, nh, zero, ((1, modes),)).sum(-1)
                - emulated_fitness(ow, oh, zero, ((1, modes),)).sum(-1))
    np.testing.assert_array_equal(emulated, sa_step_deltas_ref(t[0], t[1], t[3], t[4],
                                                               modes).numpy())


def test_struct_holds_the_constants():
    """The struct the kernel takes: every (kind, mode) as its two magic
    numbers and shifts, modes past a kind's count repeating its mode 0,
    weights as given and 0 past the table."""
    kt = ((1, BRAM18.modes), (16, URAM288.modes))
    t = build.fitness_tables_struct(kt)
    for ki, (weight, modes) in enumerate(kt):
        assert t.weight[ki] == weight
        for m in range(build.MAX_MODES + 1):
            mw, md = modes[m] if m < len(modes) else modes[0]
            got = t.mode[ki][m]
            assert (got.magic_w, got.shift_w) == build.ceil_div_magic(mw)
            assert (got.magic_d, got.shift_d) == build.ceil_div_magic(md)
    assert list(t.weight)[len(kt):] == [0] * (build.MAX_KINDS - len(kt))


def test_struct_is_built_once_per_table():
    """One struct per distinct table, shared by every call (lists are taken
    as the tuples they spell); K1's single mode set is kind 0, weight 1."""
    kt = ((1, BRAM18.modes), (16, URAM288.modes))
    listed = [[1, [list(m) for m in BRAM18.modes]], [16, [list(m) for m in URAM288.modes]]]
    assert build.fitness_tables_struct(kt) is build.fitness_tables_struct(listed)
    assert build.fitness_modes_struct(BRAM18.modes) is build.fitness_tables_struct(
        ((1, BRAM18.modes),))


@pytest.mark.parametrize("tables", [
    (),                                                    # no kind
    ((1, BRAM18.modes),) * (build.MAX_KINDS + 1),          # too many kinds
    ((1, ()),),                                            # no mode
    ((1, ((1, 1),) * (build.MAX_MODES + 1)),),             # too many modes
    ((1, ((0, 512),)),),                                   # a zero divisor
    ((1, ((4, -512),)),),                                  # a negative one
    ((1, ((2**31, 512),)),),                               # beyond int32
    ((0, BRAM18.modes),),                                  # weight 0
    ((2**31, BRAM18.modes),),                              # weight beyond int32
], ids=["no-kind", "kinds", "no-mode", "modes", "zero", "negative", "int32", "weight0",
        "weight-int32"])
def test_struct_builder_rejects_what_the_kernel_cannot_take(tables):
    with pytest.raises(ValueError):
        build.fitness_tables_struct(tables)


@pytest.mark.parametrize("d", [0, -1, 2**31, 2**32])
def test_magic_rejects_divisors_outside_int32(d):
    with pytest.raises(ValueError):
        build.ceil_div_magic(d)
