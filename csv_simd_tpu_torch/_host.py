"""The pure-host modules, shared with the JAX package by source.

config (Dialect), errors, utils (as_u8, and the submodules metrics and
debug), serve, tape (Header, NewLine, Tape), artifact (save_tape,
load_tape), golden (the NumPy oracle) and native (the C++ host engine
with the fold-layout extractor, built by g++ at first use) import
nothing but numpy, ctypes and each other. Importing them through
`csv_simd_tpu` would run that package's `__init__`, which imports jax.
Loading the same files under this package's name binds their relative
imports to this package, so neither jax nor `csv_simd_tpu` is ever
imported: the machine that runs the port may have no JAX at all.

`utils.profiling` is the one name under utils that the port does not
share: the JAX file wraps jax.profiler, so the port's own torch module
(profiling.py) is registered under that name here, before anything can
import the JAX file by it.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

_PORT = pathlib.Path(__file__).resolve().parent
_SRC = _PORT.parent / "csv_simd_tpu"

# dependency order: each file's relative imports name earlier entries
_MODULES = (
    ("errors", _SRC / "errors.py"),
    ("utils", _SRC / "utils/__init__.py"),
    ("utils.profiling", _PORT / "profiling.py"),
    ("config", _SRC / "config.py"),
    ("serve", _SRC / "serve.py"),
    ("tape", _SRC / "tape.py"),
    ("artifact", _SRC / "artifact.py"),
    ("golden", _SRC / "golden.py"),
    ("native", _SRC / "native/__init__.py"),
)


def _load(name: str, path: pathlib.Path):
    """Load `path` as module `name` of this package (dotted names are
    submodules of an already loaded one) and bind it as an attribute of
    its parent."""
    full = f"{__package__}.{name}"
    mod = sys.modules.get(full)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(full, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {full} from {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    parent, _, leaf = full.rpartition(".")
    setattr(sys.modules[parent], leaf, mod)
    return mod


for _name, _path in _MODULES:
    _load(_name, _path)
