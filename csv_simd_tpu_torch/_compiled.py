"""Build the port's compiled code at first use and bind it with ctypes.

This module owns how a shared library is named, built, cached and loaded;
`_kernels` (the product's CUDA kernels), `tools._lab_kernels` (the
measurement probes' kernels) and `native` (the g++ host engine) each
describe one `Library` and build nothing themselves.

- Name: `_build/<stem>-<hash>.so`, the hash taken over the sources, every
  local header they include (`#include "..."`, followed through headers),
  and the flags, so an edited source or header names another library.
- Build: the compiler runs once a source, all started together, each
  writing an object into a private temporary directory under `_build/`;
  the objects are linked there and the library `os.replace`d into place,
  so a concurrent loader never sees a half-written file. A compiler that
  cannot be run, or refuses a source, raises `BuildError` with its log.
- Load: under the library's lock, built unless its file exists, then
  opened once with ctypes.

Each entry point is declared where its wrapper lives, by `Library.fn`
with its C signature; the library is built and loaded at the entry's
first call, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
# a compile or a link that takes longer than this is treated as failed
COMPILE_TIMEOUT_S = 600

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


class BuildError(RuntimeError):
    """A compiler could not be found or run, or refused a source; the
    message holds the command and its output."""


def find_compiler(name: str) -> str:
    """The executable `name`: under $CUDA_HOME/bin (or $CUDA_PATH/bin),
    on PATH, or under /usr/local/cuda/bin, the first that exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(pathlib.Path(home) / "bin" / name)] if home else []
    candidates += [shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise BuildError(f"{name} not found (set CUDA_HOME or put {name} on "
                     "PATH)")


def _headers(sources, include_dirs) -> set:
    """The local headers the sources include, directly or through other
    headers: each name looked up beside the including file, then in
    include_dirs; a name found nowhere is a system header."""
    seen, todo = set(), list(sources)
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_bytes()):
            name = name.decode()
            for d in (path.parent, *include_dirs):
                hit = pathlib.Path(d) / name
                if hit.is_file():
                    if hit.resolve() not in seen:
                        seen.add(hit.resolve())
                        todo.append(hit)
                    break
    return seen


class Library:
    """One shared library built from the files matching `pattern` in
    `source_dir` by the compiler `compiler` (found by `find_compiler`)
    with `flags`; `include_dirs` are passed as -I and searched for the
    headers the hash covers; `verbose_flags` are added by
    `build(verbose=True)` and are not part of the hash."""

    def __init__(self, stem: str, source_dir: pathlib.Path, pattern: str,
                 compiler: str, flags: tuple, include_dirs: tuple = (),
                 verbose_flags: tuple = ()):
        self.stem = stem
        self.source_dir = pathlib.Path(source_dir)
        self.pattern = pattern
        self.compiler = compiler
        self.flags = tuple(flags)
        self.include_dirs = tuple(include_dirs)
        self.verbose_flags = tuple(verbose_flags)
        self._lock = threading.Lock()
        self._cdll = None

    def sources(self) -> list:
        return sorted(self.source_dir.glob(self.pattern))

    def path(self) -> pathlib.Path:
        """Where this source set is built: `_build/<stem>-<hash>.so`."""
        sources = self.sources()
        files = set(p.resolve() for p in sources)
        files |= _headers(sources, self.include_dirs)
        h = hashlib.sha256()
        for p in sorted(files, key=lambda p: (p.name, str(p))):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.stem}-{h.hexdigest()[:16]}.so"

    def build(self, verbose: bool = False) -> dict:
        """Compile and link unless this source set is already built (or
        `verbose`, which adds `verbose_flags` and builds again). Returns
        {"path", "seconds", "log"}; raises BuildError."""
        out = self.path()
        if out.exists() and not verbose:
            return {"path": str(out), "seconds": 0.0, "log": ""}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        exe = find_compiler(self.compiler)
        flags = [*self.flags, *(self.verbose_flags if verbose else ())]
        incs = [f"-I{d}" for d in self.include_dirs]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs, runs = [], []
            for src in self.sources():
                obj = os.path.join(tmp, src.stem + ".o")
                objs.append(obj)
                runs.append(_start([exe, *flags, *incs, "-c", "-o", obj,
                                    str(src)]))
            log, failed = [], []
            for cmd, proc in runs:
                try:
                    log.append(_finish(cmd, proc))
                except BuildError as e:
                    failed.append(str(e))
            if failed:
                raise BuildError("\n".join(failed))
            lib = os.path.join(tmp, "lib.so")
            log.append(_finish(*_start([exe, *self.flags, "-shared", "-o",
                                        lib, *objs])))
            os.replace(lib, out)
        return {"path": str(out), "seconds": time.perf_counter() - t0,
                "log": "".join(log)}

    def handle(self) -> ctypes.CDLL:
        """The loaded library, built first unless its file exists."""
        with self._lock:
            if self._cdll is None:
                path = self.path()
                if not path.exists():
                    self.build()
                self._cdll = ctypes.CDLL(str(path))
            return self._cdll

    def fn(self, name: str, argtypes: list, restype=ctypes.c_int):
        """The C entry point `name` with its signature: a callable that
        loads the library at its first call and binds `name` then."""
        return _Function(self, name, argtypes, restype)


class _Function:
    __slots__ = ("_lib", "_name", "_argtypes", "_restype", "_f")

    def __init__(self, lib: Library, name: str, argtypes, restype):
        self._lib, self._name = lib, name
        self._argtypes, self._restype = list(argtypes), restype
        self._f = None

    def __call__(self, *args):
        f = self._f
        if f is None:
            f = getattr(self._lib.handle(), self._name)
            f.argtypes, f.restype = self._argtypes, self._restype
            self._f = f
        return f(*args)


def _start(cmd: list) -> tuple:
    try:
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise BuildError(f"{cmd[0]} invocation failed: {e}") from e


def _finish(cmd: list, proc) -> str:
    """Wait for one compiler run; its output, or BuildError."""
    try:
        text = proc.communicate(timeout=COMPILE_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        raise BuildError(f"{cmd[0]} timed out after {COMPILE_TIMEOUT_S} s:\n"
                         f"{' '.join(cmd)}") from e
    if proc.returncode != 0:
        raise BuildError(f"{os.path.basename(cmd[0])} failed "
                         f"({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    return text
