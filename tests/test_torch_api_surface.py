"""The port's public names against the JAX package's: every name the JAX
package exports is exported by the port, and the sharding modules
(parallel.sharded, parallel.serving) and streaming define the JAX
modules' public names. The names of OWN_OBJECTS, which
the port defines in its own copies of the host, relational and SQL
modules, are its own objects, and its constants have the JAX package's
values."""

import importlib
import inspect
import re

import numpy as np
import pytest

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt

UNPORTED = set()
OWN_OBJECTS = ("StructureError", "MissingValue", "InvalidState", "NewLine",
               "Boundary", "Chunk", "boundaries", "build_nibble_luts",
               "DecodedView", "decode_field", "decode_str",
               "Col", "Frame", "Stats", "CsvCorpus", "CorpusTape",
               "sql", "explain_sql", "SqlResult", "SqlError")
CONSTANTS = ("CODE_NEWLINE", "CODE_DELIM", "CODE_SPACE", "CODE_ESCAPE",
             "CODE_QUOTE", "CODE_STRUCTURAL")


def test_missing_names_are_exactly_the_unported_modules():
    assert UNPORTED == set()
    assert set(jx.__all__) - set(pt.__all__) == UNPORTED


def test_every_listed_name_is_defined():
    for name in pt.__all__:
        assert hasattr(pt, name), name
    assert len(pt.__all__) == len(set(pt.__all__))


@pytest.mark.parametrize("name", OWN_OBJECTS)
def test_exported_name_is_the_ports_own(name):
    obj = getattr(pt, name)
    assert obj.__module__.startswith("csv_simd_tpu_torch."), obj.__module__
    assert obj is not getattr(jx, name)


@pytest.mark.parametrize("name", CONSTANTS)
def test_exported_constant_has_the_jax_value(name):
    assert getattr(pt, name) == getattr(jx, name)


def test_exported_names_behave_as_the_jax_ones():
    from csv_simd_tpu_torch import (  # noqa: F401 - the import is the test
        CODE_QUOTE,
        Chunk,
        StructureError,
        build_nibble_luts,
    )

    assert issubclass(pt.InvalidCsvFormat, pt.StructureError)
    assert issubclass(pt.MissingValue, pt.StructureError)
    assert issubclass(pt.InvalidState, pt.StructureError)
    for d in ({}, dict(delimiter=0x3B, quote=0x27)):
        for got, want in zip(pt.build_nibble_luts(pt.Dialect(**d)),
                             jx.build_nibble_luts(jx.Dialect(**d))):
            np.testing.assert_array_equal(got, want)
    for args in ((100, 1), (1000, 7), (10, 20), (0, 3)):
        got = pt.boundaries(*args)
        want = jx.boundaries(*args)
        assert (got is None) == (want is None)
        if got is not None:
            assert [(b.start, b.len) for b in got] == \
                [(b.start, b.len) for b in want]
    assert [m.name for m in pt.NewLine] == [m.name for m in jx.NewLine]


# the port's names beyond the JAX module's: Mesh is the port's mesh (the
# JAX module imports jax.sharding.Mesh)
MODULE_EXTRA = {"parallel.sharded": {"Mesh"}, "parallel.serving": set(),
                "streaming": set()}


def _defined(mod) -> set:
    """The public functions and classes a module defines itself (not the
    names it imports; a jitted function counts), and the upper-case
    constants its source assigns at the top level."""
    out = {name for name, obj in vars(mod).items()
           if not name.startswith("_") and callable(obj)
           and getattr(obj, "__module__", None) == mod.__name__}
    src = inspect.getsource(mod)
    out |= set(re.findall(r"^([A-Z][A-Z0-9_]*)\s*=", src, re.M))
    return out


@pytest.mark.parametrize("name", sorted(MODULE_EXTRA))
def test_module_names_match_the_jax_module(name):
    jmod = importlib.import_module(f"csv_simd_tpu.{name}")
    pmod = importlib.import_module(f"csv_simd_tpu_torch.{name}")
    want = _defined(jmod)
    assert _defined(pmod) - want == MODULE_EXTRA[name]
    assert want <= _defined(pmod), want - _defined(pmod)
    for n in want:
        obj = getattr(pmod, n)
        if callable(obj):
            assert obj.__module__ == pmod.__name__, n
        else:
            assert obj == getattr(jmod, n), n
