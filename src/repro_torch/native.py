"""Native libraries of the port: compiled at first use from sources in the
checkout, loaded with ``ctypes``.

A `Libraries` object is one family of libraries built alike: a list of
compilers to search, the compiler flags, a build directory, an optional
include directory, a lock and a span prefix.  The port holds three: the CUDA
kernels (``kernels/build.py``, nvcc) and the two host helpers
(``core/nfd_native.py`` and ``core/sa_native.py``, the host's C compiler).
`Libraries.load` builds and loads a source's library once, whichever
threads ask at once; `Libraries.build` compiles several sources at once,
one compiler process each.  A test or a tool steers a family through its
``build_dir``, ``compilers`` and ``loaded`` attributes.

A library is named by its source's stem and a hash of the flags and the
source (with an include directory: of every file in it, by name and
bytes), so a changed source is rebuilt and a stale library is never loaded.
It is written to a temporary file and moved into place, so concurrent
builds (threads, or processes sharing the checkout) never load a
half-written library.  Where no library is built and no compiler on the
list is found, the first use raises ``RuntimeError`` naming them.  Nothing
here runs at import: the CPU tests import every module on a host without
nvcc.  ``ctypes.CDLL`` releases the interpreter lock for each call.

Spans (`repro_torch.obs`): ``<span>.load`` (a library's first use: build
and load) and ``<span>.build`` (the compiler run inside it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from . import obs

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
CC = ("cc", "gcc", "clang")  # the host's C compiler, the first found


class Libraries:
    """Libraries built from sources with one compiler search and one set of
    flags into ``build_dir`` (``-I include`` where given), under one lock,
    with spans ``<span>.load`` / ``<span>.build``."""

    def __init__(self, span: str, compilers, flags, build_dir: Path,
                 include: Path | None = None):
        self.span = span
        self.compilers = tuple(compilers)
        self.flags = tuple(flags)
        self.build_dir = Path(build_dir)
        self.include = include
        self.loaded: dict[Path, object] = {}  # source -> what `bind` returned
        # reentrant: `load` builds under it, and `build` takes it too
        self.lock = threading.RLock()

    def path(self, source: Path) -> Path:
        h = hashlib.sha256(" ".join(self.flags).encode())
        if self.include is None:
            h.update(source.read_bytes())
        else:
            for dep in sorted(self.include.iterdir()):
                h.update(dep.name.encode())
                h.update(dep.read_bytes())
        return self.build_dir / f"{source.stem}-{h.hexdigest()[:16]}.so"

    def compiler(self) -> str:
        """The first of ``compilers`` found; raises naming them all."""
        for name in self.compilers:
            found = shutil.which(name)
            if found:
                return found
        raise RuntimeError(f"no compiler for the {self.span} libraries: searched "
                           f"{', '.join(self.compilers)}")

    def build(self, sources) -> dict[str, str]:
        """Compile every source that has no up-to-date library, one compiler
        process each, all started together.  Returns each compiled source's
        compiler output by its stem (nvcc's ``ptxas -v`` report: registers
        and spills); raises with the output if any build fails."""
        with self.lock:
            todo = [s for s in sources if not self.path(s).exists()]
            if not todo:
                return {}
            with obs.span(f"{self.span}.build"):
                return self._compile(todo)

    def _compile(self, todo) -> dict[str, str]:
        cc = self.compiler()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        include = () if self.include is None else (f"-I{self.include}",)
        procs = {}
        for source in todo:
            path = self.path(source)
            tmp = path.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            procs[source] = (path, tmp, subprocess.Popen(
                [cc, *self.flags, *include, "-o", str(tmp), str(source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        reports, failed = {}, []
        for source, (path, tmp, proc) in procs.items():
            out, _ = proc.communicate()
            reports[source.stem] = out
            if proc.returncode != 0:
                failed.append(f"{source.name} (exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, path)  # atomic: never a half-written library
        if failed:
            raise RuntimeError(f"{Path(cc).name} failed for " + "\n".join(failed))
        return reports

    def load(self, source: Path, bind):
        """``bind(cdll)`` for ``source``'s library (``bind`` declares the
        functions' ``argtypes`` / ``restype`` and returns what callers use),
        built and loaded at the first call, once, whichever threads ask at
        once."""
        lib = self.loaded.get(source)
        if lib is not None:
            return lib
        with self.lock:
            if source not in self.loaded:
                with obs.span(f"{self.span}.load"):
                    self.build((source,))
                    self.loaded[source] = bind(ctypes.CDLL(str(self.path(source))))
            return self.loaded[source]
