"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared`` into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds) by the port's one
loader (`repro_torch.native`, family `KERNELS`).  Libraries land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of every source in ``csrc/`` plus the compiler flags, so a
changed source is rebuilt and a stale library is never loaded.  Nothing here
runs at import time: the CPU tests import every module on a host without
``nvcc``.

Spans (`repro_torch.obs`): ``kernels.load`` (a library's first use) and
``kernels.build`` (the nvcc run inside it).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .. import obs
from ..native import BUILD_ROOT, Libraries

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = BUILD_ROOT / "kernels"
SOURCES = ("binpack_fitness", "binpack_sa_step", "binpack_portfolio_step", "packed_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNELS = Libraries("kernels", ("nvcc", "/usr/local/cuda/bin/nvcc"), NVCC_FLAGS, BUILD_DIR,
                    include=CSRC)

# the tables' capacity: RT_MAX_KINDS / RT_MAX_MODES in csrc/fitness_rows.cuh
MAX_KINDS = 4
MAX_MODES = 8
_I32_MAX = 2**31 - 1


def check_kind_tables(kind_tables) -> None:
    """Raise unless ``((weight, ((mode_w, mode_d), ...)), ...)`` fits the
    kernels' table capacity and holds only values they can take (a zero mode
    divides by zero)."""
    if not 1 <= len(kind_tables) <= MAX_KINDS:
        raise ValueError(
            f"{len(kind_tables)} RAM kinds; the CUDA kernels take 1..{MAX_KINDS}"
        )
    for k, (weight, modes) in enumerate(kind_tables):
        if not 1 <= len(modes) <= MAX_MODES:
            raise ValueError(
                f"kind {k} has {len(modes)} modes; the CUDA kernels take "
                f"1..{MAX_MODES}"
            )
        if not 1 <= weight <= _I32_MAX:
            raise ValueError(f"kind {k} weight {weight} outside 1..2**31-1")
        for m, (mw, md) in enumerate(modes):
            if not (1 <= mw <= _I32_MAX and 1 <= md <= _I32_MAX):
                raise ValueError(f"kind {k} mode {m} = ({mw}, {md}) not positive int32")


# Every kernel's by-value table (csrc/fitness_rows.cuh): every (kind, mode)
# divisor as a magic number and a shift, so the kernels divide by
# multiplying.  Must match `FitnessMode` / `FitnessTables` there.
class FitnessMode(ctypes.Structure):
    _fields_ = [
        ("magic_w", ctypes.c_uint32),
        ("magic_d", ctypes.c_uint32),
        ("shift_w", ctypes.c_uint32),
        ("shift_d", ctypes.c_uint32),
    ]


class FitnessTables(ctypes.Structure):
    _fields_ = [
        # one spare mode per kind: the kernel's shared-memory copy is
        # bank-padded by it
        ("mode", (FitnessMode * (MAX_MODES + 1)) * MAX_KINDS),
        ("weight", ctypes.c_int32 * MAX_KINDS),
    ]


assert ctypes.sizeof(FitnessTables) == 592, ctypes.sizeof(FitnessTables)
# K1 / K2's launch geometry, as csrc/fitness_rows.cuh fixes it: one block
# of 1024 threads per row, taking the row in passes of 4096 slots
FITNESS_THREADS = 1024
FITNESS_CHUNK = 4096
# K5's (csrc/binpack_portfolio_step.cu): every block has 1024 threads, GA
# rows first (a block each), then the chain rows, each on a group of
# `2 ** sa_lanes_log2(T)` lanes (csrc/sa_lanes.cuh), so a block holds
# `portfolio_chain_rows(T)` of them
PORTFOLIO_THREADS = 1024
SA_MAX_LANES = 32


def sa_lanes_log2(t: int) -> int:
    """log2 of the lanes per chain row: ``min(32, next power of two >=
    2T)``, 1 lane for ``T = 0`` (``sa_lanes_log2`` in csrc/sa_lanes.cuh)."""
    lg = 0
    while (1 << lg) < SA_MAX_LANES and (1 << lg) < 2 * t:
        lg += 1
    return lg


def portfolio_chain_rows(t: int) -> int:
    """Chain rows of T slots in one of K5's SA blocks."""
    return PORTFOLIO_THREADS >> sa_lanes_log2(t)


def ceil_div_magic(d: int) -> tuple[int, int]:
    """``(magic, shift)`` with, for every ``1 <= x <= 2**31 - 1``,

        ceil(x / d) == ((magic * 2 * (x - 1)) >> 32 >> shift) + 1

    (the kernel's ``(__umulhi(magic, 2 (x - 1)) >> shift) + 1``):
    ``shift = ceil(log2 d)``, ``magic = ceil(2**(31 + shift) / d) < 2**32``.
    The proof is in csrc/fitness_rows.cuh.  Raises for a divisor outside
    ``1 .. 2**31 - 1``."""
    d = int(d)
    if not 1 <= d <= _I32_MAX:
        raise ValueError(f"divisor {d} outside 1..2**31-1")
    shift = (d - 1).bit_length()
    magic = -(-(1 << (31 + shift)) // d)
    assert magic < 2**32, (d, magic)
    return magic, shift


def _frozen_tables(kind_tables) -> tuple:
    """``kind_tables`` as nested tuples of ints (hashable; lists accepted)."""
    return tuple(
        (int(weight), tuple((int(mw), int(md)) for mw, md in modes))
        for weight, modes in kind_tables
    )


@functools.lru_cache(maxsize=64)
def _fitness_tables(kind_tables) -> FitnessTables:
    frozen = _frozen_tables(kind_tables)
    check_kind_tables(frozen)
    t = FitnessTables()
    for k, (weight, modes) in enumerate(frozen):
        t.weight[k] = weight
        for m in range(MAX_MODES + 1):
            # modes past the kind's count repeat its mode 0, so the
            # kernel's unrolled minimum needs no select
            mw, md = modes[m] if m < len(modes) else modes[0]
            slot = t.mode[k][m]
            slot.magic_w, slot.shift_w = ceil_div_magic(mw)
            slot.magic_d, slot.shift_d = ceil_div_magic(md)
    # a kind past the table keeps weight 0 (and zero modes), so costs 0
    return t


def fitness_tables_struct(kind_tables) -> FitnessTables:
    """``((weight, ((mode_w, mode_d), ...)), ...)`` -> the kernels'
    by-value table argument, built once per distinct table and shared (it is
    never written after it is built, so the portfolio's lane threads may
    pass it at once).  Raises as `check_kind_tables` does."""
    try:
        return _fitness_tables(kind_tables)  # a table of tuples hashes as it is
    except TypeError:  # lists: cached under their tuple form
        return _fitness_tables(_frozen_tables(kind_tables))


def fitness_modes_struct(modes) -> FitnessTables:
    """A single mode table (K1, K3, K5a) as kind 0, weight 1."""
    return fitness_tables_struct(((1, modes),))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.POINTER(FitnessTables)
_SIGNATURES = {
    "binpack_fitness": {
        "binpack_fitness_launch": [_P, _P, _P, _I, _I, _F, _P],
        "binpack_fitness_kinds_launch": [_P, _P, _P, _P, _I, _I, _F, _P],
    },
    "binpack_sa_step": {
        "sa_step_deltas_launch": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
        "sa_step_deltas_kinds_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    },
    "binpack_portfolio_step": {
        "portfolio_step_launch": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P],
        "portfolio_step_kinds_launch": [
            _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P,
        ],
    },
    "packed_gather": {
        "packed_gather_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
}
# Values a library reports through plain-C functions, checked at load
# against this module's before the first launch: the by-value table's
# size and K1 / K2's and K5's launch geometry.
LIBRARY_CONSTANTS = {
    "fitness_tables_bytes": ctypes.sizeof(FitnessTables),
    "fitness_threads": FITNESS_THREADS,
    "fitness_chunk_slots": FITNESS_CHUNK,
    "portfolio_threads": PORTFOLIO_THREADS,
    "portfolio_max_lanes": SA_MAX_LANES,
}
_CHECKED = {
    "binpack_fitness": ("fitness_tables_bytes", "fitness_threads", "fitness_chunk_slots"),
    "binpack_sa_step": ("fitness_tables_bytes",),
    "binpack_portfolio_step": ("fitness_tables_bytes", "portfolio_threads",
                               "portfolio_max_lanes"),
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    for fn in _CHECKED.get(name, ()):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
        if getattr(lib, fn)() != LIBRARY_CONSTANTS[fn]:
            raise RuntimeError(
                f"{name}: {fn}() is {getattr(lib, fn)()} in C but "
                f"{LIBRARY_CONSTANTS[fn]} in build.py"
            )
    return lib


# each library's source and binding, built once (`load` runs every launch)
_LIBRARIES = {name: (CSRC / f"{name}.cu", functools.partial(_bind, name)) for name in SOURCES}


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns each
    compiled source's ``ptxas -v`` report (register and spill counts);
    raises with the compiler's output if any build fails.  Safe to call
    from several threads: a library being built is built once."""
    return KERNELS.build([_LIBRARIES[name][0] for name in names])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; every entry point gets explicit ``argtypes`` (``c_void_p`` for
    pointers and the stream, so no pointer is cut to 32 bits) and each
    checked constant is compared with this module's.  Safe to call from
    several threads: each library is built and loaded once."""
    return KERNELS.load(*_LIBRARIES[name])


def check_planes(what: str, planes):
    """Validate a kernel's int32 inputs: 2-D tensors of one shape, on
    one CPU or CUDA device, C-contiguous.  Raises on anything else (the
    kernels take exactly this layout and nothing is converted silently)."""
    import torch

    first = planes[0]
    for x in planes:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what}: expected torch tensors, got {type(x).__name__}")
        if x.dtype != torch.int32:
            raise TypeError(f"{what}: expected int32 tensors, got {x.dtype}")
        if x.dim() != 2 or x.shape != first.shape:
            raise ValueError(
                f"{what}: expected 2-D tensors of one shape, got "
                f"{[tuple(p.shape) for p in planes]}"
            )
        if x.device != first.device or x.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"{what}: tensors must share one cpu or cuda device, got "
                f"{[str(p.device) for p in planes]}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if any(s > _I32_MAX for s in first.shape):
        raise ValueError(f"{what}: dimension exceeds int32")
    return first.device


def count_launch(wrapper) -> None:
    """Add one to the counter ``launch.<wrapper's name>`` (`obs.count`;
    read with `kernels.launch_counts`).  The island portfolio launches from
    two host threads at once, so the increment holds a lock: no launch is
    lost from the count."""
    obs.count("launch." + wrapper.__name__)


def launch(device, fn, *args) -> None:
    """Call one C entry point on ``device``'s current stream (appended as
    the last argument) and raise if the launch was refused."""
    import torch

    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error {rc}")
