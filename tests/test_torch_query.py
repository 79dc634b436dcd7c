"""The port's relational query layer (csv_simd_tpu_torch/query.py)
against the JAX package's, on the CPU.

The same seeded CSVs (numpy, under 64 KB each) go through the JAX
function and the port's (device="cpu"), on both engines ("offsets": the
offsets route and DeviceTape; "packed": PackedDeviceTape). The tables
hold int, float, exponent-float, decimal, date, datetime and text
columns, with quoted, escaped, empty and unparsable fields.

Tolerance: record ids, permutations, counts, integer sums, min/max,
quantiles and group keys are exact. The float32 sums and square sums
(chunk sums of column_stats, float group sums) are within rtol=1e-5:
the port adds in another order than XLA. Everything else is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt
from csv_simd_tpu import query as jq
from csv_simd_tpu_torch import query as pq
from csv_simd_tpu_torch import setops as psetops
from csv_simd_tpu_torch import window as pwindow

from test_torch_gpu import relational_csv

ENGINES = ("offsets", "packed")
FLOAT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SCHEMA = {"id": "int32", "k": "int32", "v": "int32", "f": "float32",
          "x": "float", "d": "decimal:2", "day": "date",
          "ts": "datetime:ms", "s": "str", "t": "str"}
DATA = relational_csv(11)
_TAPES = {}


def tapes(engine: str):
    """(JAX tape, port tape) over DATA, built once a module."""
    if engine not in _TAPES:
        jt, _ = jx.frame._resolve_tape(DATA, None, "auto", engine, False)
        ptt, _ = pt.frame._resolve_tape(DATA, None, "auto", engine, False,
                                        "cpu")
        _TAPES[engine] = (jt, ptt)
    return _TAPES[engine]


def same(got, want, float_rtol=None, path="result"):
    """got (port) == want (JAX): dicts, lists and tuples elementwise,
    arrays with equal dtype and shape, floats bit for bit unless
    float_rtol is given (then within it), NaNs equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same(got[k], want[k], float_rtol, f"{path}[{k!r}]")
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, float_rtol, f"{path}[{i}]")
        return
    if isinstance(want, jq.Stats):
        assert type(got).__name__ == "Stats", path
        for f in ("count", "ok_count", "min", "max"):
            assert getattr(got, f) == getattr(want, f), (path, f)
        for f in ("sum", "sum_sq"):
            g, w = getattr(got, f), getattr(want, f)
            if isinstance(w, float) and float_rtol is not None:
                assert g == pytest.approx(w, rel=float_rtol), (path, f)
            else:
                assert g == w and type(g) is type(w), (path, f)
        return
    if isinstance(want, (np.ndarray, np.generic)):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, (
            path, g.dtype, want.dtype, g.shape, want.shape)
        if want.dtype.kind == "f" and float_rtol is not None:
            np.testing.assert_allclose(g, want, rtol=float_rtol,
                                       err_msg=path)
        elif want.dtype == object:
            assert g.tolist() == want.tolist(), path
        else:
            np.testing.assert_array_equal(g, want, err_msg=path)
        return
    assert got == want or (got != got and want != want), (path, got, want)


# ------------------------------------------------------------------ stats

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("column,spec", [
    ("v", "int32"), ("k", None), ("f", "float32"), ("x", "float"),
    ("d", "decimal:2"), ("day", "date"), ("ts", "datetime:ms"),
    ("s", "str"), ("id", None)])
def test_column_stats_matches_jax(engine, column, spec):
    """Counts, integer sums and min/max exact; float32 sums and square
    sums within rtol=1e-5."""
    jt, ptt = tapes(engine)
    want = jx.column_stats(jt, column, spec)
    got = pt.column_stats(ptt, column, spec)
    same(got, want, FLOAT_RTOL)
    where = [("k", ">=", 1), ("s", "!=", "AAPL")]
    want = jx.column_stats(DATA, column, spec, engine=engine, where=where,
                           schema=SCHEMA)
    got = pt.column_stats(DATA, column, spec, engine=engine, device="cpu",
                          where=where, schema=SCHEMA)
    same(got, want, FLOAT_RTOL)


def test_column_stats_of_expressions_matches_jax():
    """Aggregates of arithmetic expressions: int exact, float within
    rtol=1e-5."""
    jt, ptt = tapes("offsets")
    for tree in (("+", ("col", "v"), ("col", "k")),
                 ("*", ("col", "k"), ("lit", 3)),
                 ("/", ("col", "f"), ("col", "k")),
                 ("%", ("col", "v"), ("col", "k"))):
        want = jx.column_stats(jt, jq.VExpr(tree), SCHEMA)
        got = pt.column_stats(ptt, pq.VExpr(tree), SCHEMA)
        same(got, want, FLOAT_RTOL)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_stats_direct_on_extremes(kind):
    """stats_int / stats_float on tensors across several 8192-row chunks,
    int32 extremes included: int exact, float within rtol=1e-5."""
    rng = np.random.default_rng(3)
    n = 3 * 8192 + 17
    if kind == "int":
        v = rng.integers(-2**31, 2**31, n).astype(np.int32)
        v[:50] = 2**31 - 1
        v[50:90] = -2**31
    else:
        v = rng.uniform(-1e4, 1e4, n).astype(np.float32)
    ok = rng.random(n) > 0.1
    jf = jq.stats_int if kind == "int" else jq.stats_float
    pf = pq.stats_int if kind == "int" else pq.stats_float
    same(pf(torch.from_numpy(v), torch.from_numpy(ok)),
         jf(jnp.asarray(v), jnp.asarray(ok)), FLOAT_RTOL)


# -------------------------------------------------------------- quantiles

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("column,spec", [
    ("v", "int32"), ("f", "float32"), ("x", "float"), ("d", "decimal:2"),
    ("day", "date"), ("ts", "datetime:ms")])
def test_column_quantiles_matches_jax(engine, column, spec):
    """Exact: the same ranks of the same values, interpolated alike."""
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 1.0)
    want = jx.column_quantiles(DATA, column, qs, spec, engine=engine)
    got = pt.column_quantiles(DATA, column, qs, spec, engine=engine,
                              device="cpu")
    same(got, want)
    want = jx.column_quantiles(DATA, column, qs, spec, engine=engine,
                               where=("k", "<", 3), schema=SCHEMA)
    got = pt.column_quantiles(DATA, column, qs, spec, engine=engine,
                              device="cpu", where=("k", "<", 3),
                              schema=SCHEMA)
    same(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_describe_matches_jax(engine):
    """Counts, integer sums, min/max, quantiles and distinct counts exact;
    float sums within rtol=1e-5."""
    cols = ["v", "f", "x", "d", "s", "t"]
    want = jx.describe(DATA, cols, schema=SCHEMA, engine=engine,
                       where=("k", "!=", 2))
    got = pt.describe(DATA, cols, schema=SCHEMA, engine=engine,
                      device="cpu", where=("k", "!=", 2))
    same(got, want, FLOAT_RTOL)
    same(pt.describe(DATA, engine=engine, device="cpu"),
         jx.describe(DATA, engine=engine), FLOAT_RTOL)


def test_select_ranks_device_matches_jax():
    """The rank bisection over several buffers: exact."""
    rng = np.random.default_rng(8)
    parts_j, parts_p = [], []
    for n in (1, 100, 1000):
        v = rng.integers(-2**31, 2**31, n).astype(np.int32)
        ok = rng.random(n) > 0.2
        parts_j.append((jnp.asarray(v), jnp.asarray(ok)))
        parts_p.append((torch.from_numpy(v), torch.from_numpy(ok)))
    ranks = np.array([0, 1, 5, 300, 800])
    same(pq._select_ranks_device(parts_p, ranks),
         jq._select_ranks_device(parts_j, ranks))
    f = rng.standard_normal(500).astype(np.float32)
    f[:3] = (-0.0, 0.0, np.inf)
    same(pq._quantiles_multi_device([(torch.from_numpy(f),
                                      torch.ones(500, dtype=torch.bool))],
                                    (0.0, 0.3, 0.99, 1.0), True),
         jq._quantiles_multi_device([(jnp.asarray(f), jnp.ones(500, bool))],
                                    (0.0, 0.3, 0.99, 1.0), True))


# ------------------------------------------------------------ predicates

WHERES = [
    ("v", "<", 0), ("v", ">=", 2**31 - 1), ("v", "==", -2**31),
    ("k", "!=", 3), ("k", "between", (-1, 2)), ("k", "in", [0, 4, 5]),
    ("k", "isnull", None), ("v", "notnull", None),
    ("f", "<=", -0.0), ("f", ">", 12.5), ("x", "between", (1e-3, 5e2)),
    ("d", ">", "12.5"), ("d", "in", ["1.00", "-0.5"]),
    ("day", "<", "2021-06-01"), ("ts", ">=", "2030-01-01 00:00:00"),
    ("s", "==", "AA,PL"), ("s", "==", 'say "hi"'), ("s", "!=", ""),
    ("s", "in", ["AAPL", "", "pad"]), ("s", "startswith", "A"),
    ("s", "endswith", "ft"), ("s", "contains", "a"),
    ("s", "contains", ""), ("s", "like", "A%"), ("s", "like", "%L"),
    ("s", "like", "%a%b%"), ("s", "like", "_a%"), ("s", "like", "a_b%c"),
    ("s", "like", ("a!_b!%c", "!")), ("s", "like", ("50!%%", "!")),
    ("s", "like", "%"), ("s", "like", ""), ("s", "like", "a\\b"),
    ("s", "like", "%\"%"), ("s", "like", "g%o_"),
    ("t", "like", "%"), ("t", "==", "b"),
    [("k", ">", 0), ("s", "like", "%A%")],
    ("or", [("k", "==", 1), ("t", "==", "c")]),
    ("not", ("and", [("v", ">", 0), ("s", "contains", "P")])),
    ("not", ("f", "isnull", None)),
]


def _vexpr_wheres(mod):
    V = mod.VExpr
    return [
        (V(("+", ("col", "v"), ("col", "k"))), ">", 0),
        (V(("*", ("col", "k"), ("lit", 1000))), "<=", V(("col", "v"))),
        (V(("/", ("col", "v"), ("col", "k"))), "<", 10.5),
        (V(("%", ("col", "v"), ("col", "k"))), "==", 0),
        (V(("%", ("col", "f"), ("lit", 7.5))), ">", 1.0),
        (V(("len", "s")), ">=", 4),
        (V(("round", ("col", "f"), ("lit", -1))), "==", 100.0),
        (V(("abs", ("col", "v"))), ">", 5000),
        (V(("floor", ("col", "x"))), "==", V(("ceil", ("col", "x")))),
        (V(("cast", ("col", "f"), "int")), "==", V(("col", "k"))),
        (mod.TextFold("upper", "s"), "==", "AAPL"),
        (mod.TextFold("lower", "s"), "like", "%a%"),
        (mod.TextFold("upper", "t"), "in", ["A", "C"]),
        (("k", "t"), "in_rows", [(1, "a"), (2, "b"), (0, "")]),
        (("s",), "in_rows", [("AAPL",), ("MSFT",)]),
    ]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("i", range(len(WHERES) + 15))
def test_select_records_matches_jax(engine, i):
    """Record ids of every predicate shape: exact."""
    jt, ptt = tapes(engine)
    if i < len(WHERES):
        jw = pw = WHERES[i]
    else:
        jw = _vexpr_wheres(jq)[i - len(WHERES)]
        pw = _vexpr_wheres(pq)[i - len(WHERES)]
    want = jx.select_records(jt, jw, schema=SCHEMA)
    got = pt.select_records(ptt, pw, schema=SCHEMA)
    same(got, want)


def test_vexpr_division_and_remainder_by_zero():
    """x / 0 and x % 0 make the row not-ok in both packages; the int32
    values and the float32 bits of every ok row are equal."""
    jt, ptt = tapes("offsets")
    specs = {k: jx.frame.parse_spec(v) for k, v in SCHEMA.items()}
    pspecs = {k: pt.frame.parse_spec(v) for k, v in SCHEMA.items()}
    names = list(SCHEMA)
    for tree in (("/", ("col", "v"), ("col", "k")),
                 ("%", ("col", "v"), ("col", "k")),
                 ("%", ("col", "f"), ("col", "k")),
                 ("%", ("lit", -2**31), ("lit", -1)),
                 ("/", ("col", "f"), ("lit", 0)),
                 ("-", ("lit", -2**31), ("lit", 1)),
                 ("*", ("col", "f"), ("lit", 1e-30))):
        jv, jok, jf = jq._eval_vexpr(jt, names, tree, dict(specs), None, 64)
        pv, pok, pf = pq._eval_vexpr(ptt, names, tree, dict(pspecs), None, 64)
        assert jf == pf
        jok = np.asarray(jok)
        np.testing.assert_array_equal(pok.numpy(), jok)
        jv = np.where(jok, np.asarray(jv), 0)
        pv = np.where(jok, pv.numpy(), 0)
        assert jv.dtype == pv.dtype
        if jf:
            jv, pv = jv.view(np.int32), pv.view(np.int32)
        np.testing.assert_array_equal(pv, jv)


def test_cast_to_int32_saturates_as_xla():
    """CAST(x AS INTEGER) of 3e9, -3e9, NaN, +inf and -inf: the port's
    int32 equals the JAX _eval_vexpr's (XLA's convert saturates, NaN
    gives 0), exactly."""
    vals = [3e9, -3e9, float("nan"), float("inf"), float("-inf"), 2.7,
            -2.7, 2147483520.0, -2147483648.0]
    data = ("a\n" + "\n".join(
        "nan" if v != v else "inf" if v == float("inf")
        else "-inf" if v == float("-inf") else repr(v) for v in vals)
        + "\n").encode()
    jt, _ = jx.frame._resolve_tape(data, None, "golden", "offsets", False)
    ptt, _ = pt.frame._resolve_tape(data, None, "golden", "offsets", False,
                                    "cpu")
    # the fields parse as float32 where they can; the cast then runs on
    # the parsed values, so give it the values themselves as literals too
    for v in vals:
        tree = ("cast", ("lit", v), "int")
        jv, _, jf = jq._eval_vexpr(jt, ["a"], tree, {}, None, 8)
        pv, _, pf = pq._eval_vexpr(ptt, ["a"], tree, {}, None, 8)
        assert jf is pf is False
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    want = np.array([2**31 - 1, -2**31, 0, 2**31 - 1, -2**31, 2, -2,
                     2147483520, -2**31], np.int32)
    got = pq._cast_int32(torch.tensor(vals, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    tree = ("cast", ("col", "a"), "int")
    spec = {"a": jx.frame.parse_spec("float")}
    jv, jok, _ = jq._eval_vexpr(jt, ["a"], tree, dict(spec), None, 8)
    pv, pok, _ = pq._eval_vexpr(ptt, ["a"], tree,
                                {"a": pt.frame.parse_spec("float")}, None, 8)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_ragged_input_is_refused_by_both():
    bad = b"a,b\n1,2\n3\n4,5\n"
    with pytest.raises(jx.InvalidCsvFormat):
        jx.column_stats(bad, "a")
    with pytest.raises(pt.InvalidCsvFormat):
        pt.column_stats(bad, "a", device="cpu")
    with pytest.raises(jx.InvalidCsvFormat):
        jx.column_stats(bad, "a", engine="packed")
    with pytest.raises(pt.InvalidCsvFormat):
        pt.column_stats(bad, "a", engine="packed", device="cpu")


# -------------------------------------------------------------- ordering

ORDERS = [("v", False), ("v", True), ("f", False), ("f", True),
          ("x", True), ("d", False), ("d", True), ("day", True),
          ("ts", False), ("s", False), ("s", True), ("k", True),
          (["t", "k", "v"], [False, True, False]), (["s", "f"], True)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("by,desc", ORDERS)
def test_order_records_matches_jax(engine, by, desc):
    """The permutation, ties in record order, parse failures last (or
    first under NULLS FIRST): exact."""
    jt, ptt = tapes(engine)
    for jd, pd in ((desc, desc),
                   (jq.SortDir(True, nulls_first=True),
                    pq.SortDir(True, nulls_first=True)),
                   (jq.SortDir(False, nulls_first=True),
                    pq.SortDir(False, nulls_first=True))):
        if isinstance(desc, list) and jd is not desc:
            jd = [jd] * len(by)
            pd = [pd] * len(by)
        same(pt.order_records(ptt, by, schema=SCHEMA, descending=pd),
             jx.order_records(jt, by, schema=SCHEMA, descending=jd))
    same(pt.order_records(ptt, by, schema=SCHEMA, descending=desc,
                          where=("k", ">", 0), limit=17),
         jx.order_records(jt, by, schema=SCHEMA, descending=desc,
                          where=("k", ">", 0), limit=17))


def test_order_device_signed_zero_nan_and_extremes():
    """The device sort itself on float32 with -0.0, 0.0, inf and NaN
    (ok rows), and int32 extremes, both directions: exact."""
    f = np.array([0.0, -0.0, np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf,
                  np.nan, 2.0], np.float32)
    i = np.array([0, -2**31, 2**31 - 1, 5, -2**31, 2**31 - 1, 0, 1, 1, 3],
                 np.int32)
    ok = np.array([1, 1, 1, 0, 1, 1, 1, 1, 1, 0], bool)
    for v in (f, i):
        for desc in (False, True):
            for nf in (False, True):
                got = pq._order_device(torch.from_numpy(v),
                                       torch.from_numpy(ok), desc, nf)
                want = jq._order_device(jnp.asarray(v), jnp.asarray(ok),
                                        desc, nf)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------- group-by

GROUPS = [
    ("k", "v", None, None), ("t", "v", None, None), ("s", "k", None, None),
    ("k", "f", None, None), ("day", "v", None, None),
    ("d", "v", None, None), ("k", "d", None, None),
    (["t", "k"], "v", None, None), (["s", "day"], "f", None, None),
    ("k", ["v", "f", "d"], None, None), (["t", "k"], ["v", "x"], None, None),
    ("k", "v", ("k", ">", 0), ("count", ">=", 3)),
    ("t", "v", None, ("or", [("sum", ">", 0), ("min", "<", -100)])),
    ("k", ["v", "f"], None, [("v.mean", ">", 0), ("f.count", ">", 1)]),
    ("f", "v", None, None), ("x", "k", None, None),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("key,value,where,having", GROUPS)
def test_groupby_typed_matches_jax(engine, key, value, where, having):
    """Group keys, counts, integer sums and min/max exact; float32 group
    sums within rtol=1e-5."""
    jt, ptt = tapes(engine)

    def specs(names):
        return ([SCHEMA[n] for n in names] if isinstance(names, list)
                else SCHEMA[names])

    kw = dict(key_spec=specs(key), value_spec=specs(value), where=where,
              having=having, schema=SCHEMA)
    same(pt.groupby_typed(ptt, key, value, **kw),
         jx.groupby_typed(jt, key, value, **kw), FLOAT_RTOL)


def test_groupby_of_expression_values_matches_jax():
    """A VExpr value column: int sums exact, float sums within
    rtol=1e-5."""
    jt, ptt = tapes("packed")
    for tree in (("*", ("col", "v"), ("lit", 2)),
                 ("/", ("col", "v"), ("lit", 4))):
        same(pt.groupby_typed(ptt, "t", pq.VExpr(tree), value_spec=SCHEMA),
             jx.groupby_typed(jt, "t", jq.VExpr(tree), value_spec=SCHEMA),
             FLOAT_RTOL)


@pytest.mark.parametrize("kind", ["int", "float", "host"])
def test_group_aggregate_matches_jax(kind):
    """group_aggregate on tensors (and on host int64/float64 arrays,
    which become int32/float32 as in JAX): keys, counts, int sums and
    min/max exact, float sums within rtol=1e-5."""
    rng = np.random.default_rng(21)
    n = 5000
    keys = rng.integers(-50, 50, n).astype(np.int32)
    keys[:10] = 2**31 - 1
    ok = rng.random(n) > 0.2
    if kind == "float":
        vals = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    else:
        vals = rng.integers(-2**31, 2**31, n).astype(np.int32)
    if kind == "host":
        same(pt.group_aggregate(torch.from_numpy(keys.astype(np.int64)),
                                vals.astype(np.int64), ok),
             jx.group_aggregate(keys.astype(np.int64),
                                vals.astype(np.int64), ok))
        f = rng.uniform(-5, 5, n)
        same(pt.group_aggregate(torch.from_numpy(keys), f),
             jx.group_aggregate(jnp.asarray(keys), f), FLOAT_RTOL)
        return
    same(pt.group_aggregate(torch.from_numpy(keys), torch.from_numpy(vals),
                            key_ok=torch.from_numpy(ok)),
         jx.group_aggregate(jnp.asarray(keys), jnp.asarray(vals),
                            key_ok=jnp.asarray(ok)), FLOAT_RTOL)
    same(pt.group_aggregate(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32)),
         jx.group_aggregate(jnp.zeros(0, jnp.int32), jnp.zeros(0, jnp.int32)))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("column,spec", [
    ("k", None), ("v", "int32"), ("f", "float32"), ("d", "decimal:2"),
    ("day", "date"), ("s", "str"), ("s", "bytes"), ("t", None)])
def test_value_counts_and_distinct_match_jax(engine, column, spec):
    """Keys and counts: exact."""
    same(pt.value_counts(DATA, column, spec, engine=engine, device="cpu"),
         jx.value_counts(DATA, column, spec, engine=engine))
    same(pt.distinct(DATA, column, spec, engine=engine, device="cpu",
                     where=("k", ">=", 0), schema=SCHEMA),
         jx.distinct(DATA, column, spec, engine=engine,
                     where=("k", ">=", 0), schema=SCHEMA))


# --------------------------------------------------------- the host guard

def test_public_functions_read_the_device_through_one_helper(monkeypatch,
                                                             tmp_path):
    """With torch.Tensor.__array__ made to raise, each of the 19 public
    relational names and sql() run on CPU tapes of both engines: an
    implicit np.asarray(tensor), which would raise on a CUDA tensor,
    fails here too. sql's window and set-operation statements run with
    the device thresholds at 1, and take the device path."""
    paths = []
    for i in range(3):
        p = tmp_path / f"part{i}.csv"
        p.write_bytes(relational_csv(40 + i, 60))
        paths.append(str(p))

    def refuse(self, *a, **k):
        raise TypeError("implicit tensor -> numpy conversion")

    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    with pytest.raises(TypeError):
        np.asarray(torch.zeros(2))
    corpus = pt.CsvCorpus(paths, device="cpu")
    assert isinstance(corpus.serving_tape(), pt.CorpusTape)
    col = pt.Col("decimal", scale=2)
    for source, eng in ((DATA, "offsets"), (DATA, "packed"),
                        (corpus, "offsets")):
        kw = dict(engine=eng, device="cpu") if source is DATA else {}
        st = pt.column_stats(source, "v", "int32", **kw)
        assert isinstance(st, pt.Stats) and st.count > 0
        pt.column_stats(source, "f", "float32", where=("s", "like", "%a%"),
                        **kw)
        pt.column_quantiles(source, "x", spec="float", **kw)
        pt.describe(source, ["v", "d", "s"], schema={"d": col}, **kw)
        pt.value_counts(source, "t", **kw)
        pt.distinct(source, "k", **kw)
        pt.groupby_typed(source, "t", ["v", "f"], having=("count", ">", 0),
                         value_spec=["int32", "float32"], **kw)
        fr = pt.read_typed(source, SCHEMA, where=("k", ">", 0),
                           order_by="v", limit=20, **kw)
        assert isinstance(fr, pt.Frame) and pt.write_csv(fr)
        tape = source.serving_tape() if source is corpus else \
            pt.frame._resolve_tape(DATA, None, "auto", eng, False, "cpu")[0]
        pt.infer_schema(tape, list(SCHEMA))
        pt.select_records(source if source is corpus else tape,
                          [("v", ">", 0), ("s", "like", "A%")], schema=SCHEMA)
        pt.order_records(tape, ["t", "v"], schema=SCHEMA)
        pt.join_records(tape, tape, "k", how="left")
        pt.join_records(tape, tape, ["t", "k"])
        pt.join_typed(source, source, "id", columns=["id", "v"],
                      right_columns=["s"], **kw)
    pt.group_aggregate(torch.arange(10, dtype=torch.int32) % 3,
                       torch.arange(10, dtype=torch.float32))

    device_results = []
    for mod, name in ((pwindow, "window_column"), (psetops, "dedupe_keep"),
                      (psetops, "setop_keep_concat")):
        real = getattr(mod, name)

        def spy(*a, _real=real, **k):
            r = _real(*a, **k)
            device_results.append(r is not None)
            return r

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(pwindow, "DEVICE_WINDOW_MIN_ROWS", 1)
    monkeypatch.setattr(psetops, "DEVICE_SETOP_MIN_ROWS", 1)
    statements = [
        "SELECT id, SUM(f) OVER (PARTITION BY k ORDER BY v) AS s,"
        " RANK() OVER (ORDER BY v DESC NULLS FIRST) AS r,"
        " LAG(s) OVER (PARTITION BY t ORDER BY id) AS p,"
        " MIN(v) OVER (ORDER BY id ROWS BETWEEN 2 PRECEDING"
        " AND 2 FOLLOWING) AS m FROM t",
        "SELECT k, v FROM t WHERE v > 0 UNION SELECT k, v FROM t"
        " EXCEPT SELECT k, v FROM t WHERE k = 1",
        "SELECT k, f FROM t INTERSECT SELECT k, f FROM t WHERE f > 0",
        "SELECT t, COUNT(*), SUM(v), AVG(f) FROM t WHERE k >= 0"
        " GROUP BY t HAVING COUNT(*) > 1 ORDER BY t",
        "SELECT a.id, b.v FROM a JOIN b ON a.id = b.id WHERE a.k > 0",
        "SELECT id FROM t WHERE k IN (SELECT k FROM t WHERE v > 0)",
        "EXPLAIN ANALYZE SELECT id, ROW_NUMBER() OVER (ORDER BY v) AS r"
        " FROM t",
    ]
    for source, eng in ((DATA, "offsets"), (DATA, "packed"),
                        (corpus, "offsets")):
        for q in statements:
            tables = {"a": source, "b": DATA} if " JOIN " in q else None
            pt.sql(q, None if tables else source, tables=tables,
                   schema=SCHEMA, engine=eng, device="cpu")
    assert device_results.count(True) >= 3 * 5, device_results
