"""Differential harness for the port's SQL (csv_simd_tpu_torch/sql.py).

The JAX package's SQL test modules (tests/test_sql*.py,
tests/test_window_device_keys.py) are run as they are, with their module
name `sql` bound to `diff_sql` and `explain` to `diff_explain`. Each
statement a test runs then goes through csv_simd_tpu.sql.sql and
csv_simd_tpu_torch.sql(device="cpu") on the same sources, on both
engines ("offsets" and "packed"), with the device thresholds
(DEVICE_WINDOW_MIN_ROWS, DEVICE_SETOP_MIN_ROWS, and _MAX_EXACT_PARTITION)
as the test set them in the JAX package, and again forced to 1 in both
packages. The JAX result of the test's own call (its engine, its
thresholds) goes back to the test, whose assertions then run as before.

Equality, per call:
- a Frame: names, column specs, length, record ids, every column's
  dtype and values (floats bit for bit, NaN equal, the sign of zero
  too) and every ok mask;
- a SqlResult: names, types, length and columns; float columns exact,
  or within FLOAT_RTOL = 1e-5 (float32 group and statistics sums: the
  port adds its float32 partial sums in another order than XLA);
- a string (EXPLAIN): equal text; EXPLAIN ANALYZE: the plan and the
  result shape equal, and the same stage spans with the same call
  counts (their times are the run's own);
- an error: the same class name and message;
- the window and set-operation executors return a device result (not
  None) in the port exactly as often as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
import sys

import numpy as np
import pytest

import csv_simd_tpu as jx
import csv_simd_tpu.setops as jsetops
import csv_simd_tpu.window as jwindow
import csv_simd_tpu_torch as pt
import csv_simd_tpu_torch.setops as psetops
import csv_simd_tpu_torch.window as pwindow
from csv_simd_tpu.sql import SqlResult as _JxSqlResult
from csv_simd_tpu.sql import explain as _jx_explain
from csv_simd_tpu.sql import sql as _jx_sql

ENGINES = ("offsets", "packed")
FLOAT_RTOL = 1e-5

# (JAX module, port module, name): thresholds mirrored into the port
_KNOBS = ((jwindow, pwindow, "DEVICE_WINDOW_MIN_ROWS"),
          (jwindow, pwindow, "_MAX_EXACT_PARTITION"),
          (jsetops, psetops, "DEVICE_SETOP_MIN_ROWS"))
_FORCED = {"DEVICE_WINDOW_MIN_ROWS": 1, "DEVICE_SETOP_MIN_ROWS": 1}
# device executors whose non-None results are counted in both packages
_EXECUTORS = ((jwindow, pwindow, "window_column"),
              (jsetops, psetops, "dedupe_keep"),
              (jsetops, psetops, "setop_keep_concat"))


# ------------------------------------------------------------ comparison

def _same_scalar(g, w) -> bool:
    if w is None or g is None:
        return g is None and w is None
    if isinstance(w, float) and w != w:
        return isinstance(g, float) and g != g
    return type(g) is type(w) and g == w


def same_array(got, want, path: str, float_rtol=None):
    g = np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (
        path, g.dtype, w.dtype, g.shape, w.shape)
    if w.dtype == object:
        bad = [i for i, (a, b) in enumerate(zip(g.tolist(), w.tolist()))
               if not _same_scalar(a, b)]
        assert not bad, (path, bad[:5], [g[i] for i in bad[:5]],
                         [w[i] for i in bad[:5]])
    elif w.dtype.kind == "f":
        if float_rtol is not None and not np.array_equal(
                g, w, equal_nan=True):
            np.testing.assert_allclose(g, w, rtol=float_rtol, err_msg=path)
            return
        np.testing.assert_array_equal(g, w, err_msg=path)
        np.testing.assert_array_equal(np.signbit(g), np.signbit(w),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(g, w, err_msg=path)


def _ok_mask(m):
    return None if m is None else np.asarray(m, bool)


# spans and counters that only the port records (its per-layer tracing
# inside parse, group keys, typed parses, the pad and the index build)
_PORT_ONLY = ("sql.parse", "query.", "offsetfree.", "index.",
              "device_tape.")


def _analyze_parts(text: str):
    """EXPLAIN ANALYZE text -> (plan, result shape, [(span, calls)]), the
    port's own spans and counters left out."""
    plan, _sep, rest = text.partition("\n\n-- ANALYZE --\n")
    lines = rest.splitlines()
    shape = lines[0].split("->", 1)[1].strip() if lines else ""
    spans = [re.match(r"\s*(\S+)\s+(\d+) (?:calls|counted)", ln)
             .groups() for ln in lines[1:]]
    return plan, shape, sorted(s for s in spans
                               if not s[0].startswith(_PORT_ONLY))


def same_result(got, want, path: str = "result"):
    if isinstance(want, str):
        assert isinstance(got, str), (path, type(got))
        if "-- ANALYZE --" in want:
            assert _analyze_parts(got) == _analyze_parts(want), (
                path, got, want)
        else:
            assert got == want, (path, got, want)
        return
    if isinstance(want, _JxSqlResult):
        assert type(got).__name__ == "SqlResult", (path, type(got))
        assert got.names == want.names, (path, got.names, want.names)
        assert len(got) == len(want), path
        assert ({n: s.type for n, s in got.schema.items()}
                == {n: s.type for n, s in want.schema.items()}), path
        for n in want.names:
            same_array(got[n], want[n], f"{path}[{n!r}]", FLOAT_RTOL)
        return
    if isinstance(want, jx.Frame):
        assert type(got).__name__ == "Frame", (path, type(got))
        assert got.names == want.names, (path, got.names, want.names)
        assert len(got) == len(want), path
        assert ({n: repr(c) for n, c in got.schema.items()}
                == {n: repr(c) for n, c in want.schema.items()}), path
        assert (got.records is None) == (want.records is None), path
        if want.records is not None:
            same_array(got.records, want.records, f"{path}.records")
        for n in want.names:
            same_array(got[n], want[n], f"{path}[{n!r}]")
            gm, wm = _ok_mask(got.ok(n)), _ok_mask(want.ok(n))
            assert (gm is None) == (wm is None), (path, n, "ok")
            if wm is not None:
                np.testing.assert_array_equal(gm, wm,
                                              err_msg=f"{path}.ok({n!r})")
        return
    raise AssertionError(f"{path}: unexpected result type {type(want)}")


def same_error(gerr, werr, path: str):
    assert (gerr is None) == (werr is None), (
        path, "port raised" if gerr else "JAX raised", gerr or werr)
    if werr is not None:
        assert type(gerr).__name__ == type(werr).__name__, (
            path, gerr, werr)
        assert str(gerr) == str(werr), (path, str(gerr), str(werr))


# ------------------------------------------------------ source transfer

def _port_value(v):
    """A JAX-package argument as the port takes it."""
    if isinstance(v, jx.CsvCorpus):
        return pt.CsvCorpus(list(v._paths), device="cpu")
    if isinstance(v, jx.Col):
        return pt.Col(**dataclasses.asdict(v))
    if isinstance(v, jx.Dialect):
        return pt.Dialect(**dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _port_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_port_value(x) for x in v]
    return v


# ------------------------------------------------------------- wrappers

def _call(fn, *a, **k):
    try:
        return fn(*a, **k), None
    except Exception as e:  # compared with the other package's outcome
        return None, e


class _Counted:
    """Counts the calls and the non-None results of a device executor."""

    def __init__(self, real):
        self.real = real
        self.calls = 0
        self.n = 0

    def __call__(self, *a, **k):
        self.calls += 1
        r = self.real(*a, **k)
        if r is not None:
            self.n += 1
        return r


_JX_MODULES = (sys.modules["csv_simd_tpu.sql"], jwindow, jsetops)
# the JAX modules' functions as imported: a test may replace one with a
# spy, which then sees only the test's own call
_PRISTINE = {m: {k: v for k, v in vars(m).items() if callable(v)}
             for m in _JX_MODULES}
# statements whose EXPLAIN text or execution reads the thresholds
_SETWISE = re.compile(r"\b(OVER|UNION|EXCEPT|INTERSECT)\b", re.I)


def _replaced():
    return [(m, k, vars(m).get(k)) for m, fns in _PRISTINE.items()
            for k, v in fns.items() if vars(m).get(k) is not v]


def _variant(query, source, kw, eng: str, knobs: dict):
    """One JAX call and one port call with `knobs` set in both packages;
    asserts they agree. Returns (JAX outcome, whether an executor was
    called)."""
    for jm, pm, name in _KNOBS:
        setattr(jm, name, knobs[name])
        setattr(pm, name, knobs[name])
    real = {(m, name): getattr(m, name)
            for jm, pm, name in _EXECUTORS for m in (jm, pm)}
    for (m, name), f in real.items():
        setattr(m, name, _Counted(f))
    try:
        want, werr = _call(_jx_sql, query, source, engine=eng, **kw)
        got, gerr = _call(pt.sql, query, _port_value(source), engine=eng,
                          device="cpu", **_port_value(kw))
        counted = {(m, name): getattr(m, name) for m, name in real}
    finally:
        for (m, name), f in real.items():
            setattr(m, name, f)
    path = f"{query!r} engine={eng} knobs={knobs}"
    same_error(gerr, werr, path)
    if werr is None:
        same_result(got, want, path)
    counts = [(name, counted[(pm, name)].n, counted[(jm, name)].n)
              for jm, pm, name in _EXECUTORS]
    assert all(p == j for _n, p, j in counts), (path, counts)
    return (want, werr), any(c.calls for c in counted.values())


def diff_sql(query, source=None, **kw):
    """csv_simd_tpu's sql(query, source, **kw), after holding the
    port to it on every variant (module docstring); returns the JAX
    result of the call as given, or raises its error. Functions of the
    JAX sql, window and setops modules that the test replaced serve
    only that call; the comparisons run the JAX package's own."""
    engine = kw.pop("engine", "offsets")
    knobs = {name: getattr(jm, name) for jm, _pm, name in _KNOBS}
    saved = {(m, name): getattr(m, name)
             for jm, pm, name in _KNOBS for m in (jm, pm)}
    replaced = _replaced()
    primary = (_call(_jx_sql, query, source, engine=engine, **kw)
               if replaced else None)
    engines = (engine,) + tuple(e for e in ENGINES if e != engine)
    try:
        for m, k, _f in replaced:
            setattr(m, k, _PRISTINE[m][k])
        ran = False
        for eng in engines:
            outcome, called = _variant(query, source, kw, eng, knobs)
            ran |= called
            if primary is None:
                primary = outcome
        forced = dict(knobs, **_FORCED)
        # the thresholds are read only by the executors and by the
        # EXPLAIN text of windows and set operations
        if forced != knobs and (ran or _SETWISE.search(query)):
            for eng in engines:
                _variant(query, source, kw, eng, forced)
    finally:
        for m, k, f in replaced:
            setattr(m, k, f)
        for (m, name), v in saved.items():
            setattr(m, name, v)
    want, werr = primary
    if werr is not None:
        raise werr
    return want


def diff_explain(query):
    want, werr = _call(_jx_explain, query)
    got, gerr = _call(pt.explain_sql, query)
    same_error(gerr, werr, repr(query))
    if werr is not None:
        raise werr
    assert got == want, (query, got, want)
    return want


# --------------------------------------------------------------- cases

# the CLI's tests: the port has no CLI yet, and they call none of sql
CLI_TESTS = ("test_cli_where_or_value_fallback",
             "test_cli_sql_self_join_rejected", "test_cli_sql",
             "test_cli_explain")


def cases(*modules, part=(0, 1)):
    """One pytest.param a test function and parametrize combination of
    each module, but the CLI's; `part=(i, k)` keeps every k-th case from
    the i-th, so that a large module splits across test files."""
    out = []
    for mod in modules:
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not callable(fn) \
                    or name in CLI_TESTS:
                continue
            combos = [{}]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name != "parametrize":
                    continue
                argnames, values = mark.args[:2]
                names = ([a.strip() for a in argnames.split(",")]
                         if isinstance(argnames, str) else list(argnames))
                values = [getattr(v, "values", v) for v in values]
                combos = [dict(c, **dict(zip(
                    names, v if len(names) > 1 else (v,))))
                    for c in combos for v in values]
            short = mod.__name__.removeprefix("test_")
            for i, c in enumerate(combos):
                tag = f"[{i}]" if len(combos) > 1 else ""
                out.append(pytest.param(mod.__name__, name, c,
                                        id=f"{short}::{name}{tag}"))
    return out[part[0]::part[1]]


def run_case(modname: str, name: str, params: dict, monkeypatch,
             tmp_path, capsys):
    mod = sys.modules[modname]
    if hasattr(mod, "sql"):
        monkeypatch.setattr(mod, "sql", diff_sql)
    if hasattr(mod, "explain"):
        monkeypatch.setattr(mod, "explain", diff_explain)
    fixtures = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
                "capsys": capsys}
    fn = getattr(mod, name)
    args = {p: params[p] if p in params else fixtures[p]
            for p in inspect.signature(fn).parameters}
    fn(**args)
