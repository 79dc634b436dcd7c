"""The pure-host modules, shared with the JAX package by source.

config (Dialect), errors, utils (as_u8), serve, tape (Header, NewLine,
Tape), artifact (save_tape, load_tape), golden (the NumPy oracle) and
native (the C++ host engine with the fold-layout extractor, built by g++
at first use) import nothing but numpy, ctypes and each other. Importing them through `csv_simd_tpu` would run
that package's `__init__`, which imports jax. Loading the same files
under this package's name binds their relative imports to this package,
so neither jax nor `csv_simd_tpu` is ever imported: the machine that
runs the port may have no JAX at all.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csv_simd_tpu"

# dependency order: each file's relative imports name earlier entries
_MODULES = (
    ("errors", "errors.py"),
    ("utils", "utils/__init__.py"),
    ("config", "config.py"),
    ("serve", "serve.py"),
    ("tape", "tape.py"),
    ("artifact", "artifact.py"),
    ("golden", "golden.py"),
    ("native", "native/__init__.py"),
)


def _load(name: str, rel: str):
    full = f"{__package__}.{name}"
    mod = sys.modules.get(full)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(full, _SRC / rel)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {full} from {_SRC / rel}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    setattr(sys.modules[__package__], name, mod)
    return mod


for _name, _rel in _MODULES:
    _load(_name, _rel)
