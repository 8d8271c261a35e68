"""Plain-C host helpers: built by the host's C compiler at first use, loaded
with ``ctypes``.

A helper is a module that names its library: ``SOURCE`` (the C file),
``CC_FLAGS``, ``BUILD_DIR``, ``COMPILERS``, ``SPAN`` (the spans' prefix),
``_bind(cdll)`` (declares the functions' ``argtypes`` / ``restype`` and
returns what callers use), and the load state ``_lib`` (``UNSET`` until the
first use) under ``_lock``.  `library(mod)` builds and loads it once,
whichever threads ask at once; a test or a tool that sets ``mod._lib`` or
``mod.BUILD_DIR`` steers it.

The library lands in ``build/host/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, written to a
temporary file and moved into place, so concurrent builds (threads, or test
processes sharing the checkout) never load a half-written library.  Where
no compiler is found, `library` returns ``None`` and the caller runs its
Python path, which gives the same answer.  ``ctypes.CDLL`` releases the
interpreter lock for the length of each call.

Spans (`repro_torch.obs`): ``<SPAN>.load`` (the first use: find, build and
load) and ``<SPAN>.build`` (the compiler run inside it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .. import obs

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
CC_FLAGS = ("-std=c99", "-O2", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "clang")
UNSET = object()


def library_path(mod) -> Path:
    h = hashlib.sha256(" ".join(mod.CC_FLAGS).encode())
    h.update(mod.SOURCE.read_bytes())
    return mod.BUILD_DIR / f"{mod.SOURCE.stem}-{h.hexdigest()[:16]}.so"


def _compiler(names) -> str | None:
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    return None


def _compile(cc: str, source: Path, flags, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    out = subprocess.run(
        [cc, *flags, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cc} failed for {source.name} (exit {out.returncode}):\n"
                           f"{out.stdout}")
    os.replace(tmp, path)  # atomic: never a half-written library


def _load(mod):
    path = library_path(mod)
    if not path.exists():
        cc = _compiler(mod.COMPILERS)
        if cc is None:
            return None
        with obs.span(f"{mod.SPAN}.build"):
            _compile(cc, mod.SOURCE, mod.CC_FLAGS, path)
    return mod._bind(ctypes.CDLL(str(path)))


def library(mod):
    """``mod``'s bound library, built and loaded at the first call (once,
    whichever threads ask at once), or ``None`` where no C compiler is
    found.  Raises if the compiler fails."""
    lib = mod._lib
    if lib is not UNSET:
        return lib
    with mod._lock:
        if mod._lib is UNSET:
            with obs.span(f"{mod.SPAN}.load"):
                mod._lib = _load(mod)
        return mod._lib
