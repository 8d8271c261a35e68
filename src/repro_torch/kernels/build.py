"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared`` into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of every source in ``csrc/`` plus the compiler flags, so a
changed source is rebuilt and a stale library is never loaded.  Nothing here
runs at import time: the CPU tests import every module on a host without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("binpack_fitness", "binpack_sa_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# must match `struct KindTables` in csrc/kind_tables.cuh
MAX_KINDS = 4
MAX_MODES = 8
_I32_MAX = 2**31 - 1


class KindTables(ctypes.Structure):
    _fields_ = [
        ("n_kinds", ctypes.c_int32),
        ("n_modes", ctypes.c_int32 * MAX_KINDS),
        ("weight", ctypes.c_int32 * MAX_KINDS),
        ("mode_w", (ctypes.c_int32 * MAX_MODES) * MAX_KINDS),
        ("mode_d", (ctypes.c_int32 * MAX_MODES) * MAX_KINDS),
    ]


# 4 + 2 * 4 * MAX_KINDS + 2 * 4 * MAX_KINDS * MAX_MODES bytes, as the
# header's static_assert; `load` also asks each library for its sizeof
assert ctypes.sizeof(KindTables) == 292, ctypes.sizeof(KindTables)


def kind_tables_struct(kind_tables) -> KindTables:
    """``((weight, ((mode_w, mode_d), ...)), ...)`` -> the by-value kernel
    argument.  Raises if a table exceeds the struct's capacity or holds a
    value the kernels cannot take (a zero mode divides by zero)."""
    kind_tables = tuple(kind_tables)
    if not 1 <= len(kind_tables) <= MAX_KINDS:
        raise ValueError(
            f"{len(kind_tables)} RAM kinds; the CUDA kernels take 1..{MAX_KINDS}"
        )
    t = KindTables()
    t.n_kinds = len(kind_tables)
    for k, (weight, modes) in enumerate(kind_tables):
        modes = tuple(modes)
        if not 1 <= len(modes) <= MAX_MODES:
            raise ValueError(
                f"kind {k} has {len(modes)} modes; the CUDA kernels take "
                f"1..{MAX_MODES}"
            )
        if not 1 <= int(weight) <= _I32_MAX:
            raise ValueError(f"kind {k} weight {weight} outside 1..2**31-1")
        t.n_modes[k] = len(modes)
        t.weight[k] = int(weight)
        for m, (mw, md) in enumerate(modes):
            if not (1 <= int(mw) <= _I32_MAX and 1 <= int(md) <= _I32_MAX):
                raise ValueError(f"kind {k} mode {m} = ({mw}, {md}) not positive int32")
            t.mode_w[k][m] = int(mw)
            t.mode_d[k][m] = int(md)
    return t


def modes_struct(modes) -> KindTables:
    """A single mode table (the homogeneous kernels) as kind 0, weight 1."""
    return kind_tables_struct(((1, modes),))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns each
    compiled source's ``ptxas -v`` report (register and spill counts);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: never a half-written .so
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


_P = ctypes.c_void_p
_I = ctypes.c_int
_T = ctypes.POINTER(KindTables)
_SIGNATURES = {
    "binpack_fitness": {
        "binpack_fitness_launch": [_P, _P, _P, _I, _I, _T, _P],
        "binpack_fitness_kinds_launch": [_P, _P, _P, _P, _I, _I, _T, _P],
    },
    "binpack_sa_step": {
        "sa_step_deltas_launch": [_P, _P, _P, _P, _P, _I, _I, _T, _P],
        "sa_step_deltas_kinds_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _T, _P],
    },
}
_LIBS: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed; every entry point gets explicit ``argtypes`` (``c_void_p`` for
    pointers and the stream, so no pointer is cut to 32 bits)."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kind_tables_bytes.argtypes = []
        lib.kind_tables_bytes.restype = ctypes.c_int
        if lib.kind_tables_bytes() != ctypes.sizeof(KindTables):
            raise RuntimeError(
                f"{name}: struct KindTables is {lib.kind_tables_bytes()} bytes "
                f"in C but {ctypes.sizeof(KindTables)} in ctypes"
            )
        _LIBS[name] = lib
    return lib


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


def launch(device, fn, *args) -> None:
    """Call one C entry point on ``device``'s current stream (appended as
    the last argument) and raise if the launch was refused."""
    import torch

    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed with error {rc}")
