"""The port's CLI (`python -m csv_simd_tpu_torch`) against the JAX
package's (`python -m csv_simd_tpu`), on the CPU.

Each of the 14 subcommands runs on the small fixtures of the JAX CLI
tests (tests/test_components.py, test_query.py, test_join.py,
test_sql.py) through `csv_simd_tpu.__main__.main(args)` (with
`--platform cpu`) and through the port's `main(["--device", "cpu",
*args])`, the JAX backend names mapped to the port's (jnp -> torch).
Stdout and the exit code must be identical, error paths included (a
float32 column's sum and mean are the one exception: the two packages
add float32 in another order, so those two numbers agree within rtol
1e-5, as the relational layer's tests hold them): a
ragged CSV returns 1 from both, and what raises (`SystemExit` from
`_parse_where` and the sql checks, ValueError from join) raises the same
exception with the same message. Artifacts written by either CLI's
`index` (both formats) are served by the other's `serve`. A subprocess
`python -m csv_simd_tpu_torch --device cpu info` imports no JAX, and the
default `--device cuda` fails without a card, with no fall back.
Tolerance: exact (text)."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from csv_simd_tpu.__main__ import main as jax_main
from csv_simd_tpu_torch.__main__ import _parse_where
from csv_simd_tpu_torch.__main__ import main as port_main

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _make_csv(n=1000, bad_rows=(), quoted=()):
    """tests/test_query.py's synthetic table."""
    out = [b"sym,qty,price,day,ratio"]
    for i in range(n):
        sym = ("AAPL", "MSFT", "GOOG")[i % 3]
        if i in quoted:
            sym = '"AA,PL"'
        qty = "x!" if i in bad_rows else str((-1) ** i * ((i * 7) % 2000))
        price = f"{i % 100}.{i % 97:02d}"
        day = f"2024-{(i % 12) + 1:02d}-{(i % 28) + 1:02d}"
        ratio = f"{(i % 13) * 0.5}"
        out.append(f"{sym},{qty},{price},{day},{ratio}".encode())
    return b"\n".join(out) + b"\n"


def _halves(data: bytes) -> tuple:
    rows = data.decode().strip().split("\n")
    head, body = rows[0], rows[1:]
    half = len(body) // 2
    return (("\n".join([head] + body[:half]) + "\n").encode(),
            ("\n".join([head] + body[half:]) + "\n").encode())


_P1, _P2 = _halves(_make_csv(n=200))

FILES = {
    "t.csv": b'a,b,c\n1,"x,y",3\n4,5,6\n',
    "prices.csv": b"sku,price,n\nA,12.34,3\nB,-0.05,4\nC,1.00,5\n",
    "typed.csv": b"sku,price,n\nA,12.34,3\nB,-0.05,4\nC,oops,x\n",
    "s.csv": b"sym,qty,price\nAA,5,1.25\nBB,50,2.50\nAA,500,0.75\n",
    "q.csv": _make_csv(n=600, bad_rows={5, 77}, quoted={9, 12}),
    "o.csv": b"sym,qty\nAA,5\nBB,50\nAA,500\nCC,2\nBB,7\n",
    "h.csv": b"sym,qty\nAA,5\nBB,50\nAA,500\nCC,2\nBB,7\nBB,1\n",
    "p1.csv": _P1,
    "p2.csv": _P2,
    "l.csv": (b"sym,qty\nAAPL,10\nMSFT,20\nZZZZ,30\nAAPL,40\nGOOG,bad!\n"
              b'"AA,PL",50\n'),
    "r.csv": (b'sym,price\nMSFT,2.50\n"AAPL",1.25\nAAPL,1.75\nGOOG,9.99\n'
              b'"AA,PL",7.77\nXXXX,0.01\n'),
    "sl.csv": b"sym,qty\nAAPL,10\nMSFT,20\nZZZZ,30\nAAPL,40\n",
    "sr.csv": b"sym,price\nMSFT,2.50\nAAPL,1.25\nXXXX,0.01\n",
    "jl.csv": b"sym,day,qty\nAA,1,10\nAA,2,20\n",
    "jr.csv": b"sym,day,px\nAA,9,111\nAA,1,222\n",
    "ts.csv": (b"id,ts,d\n1,2024-01-02 03:04:05,2024-01-02\n"
               b"2,2023-12-31T23:59:59,1999-12-31\n3,bad,2024-02-30\n"),
    "semi.csv": b"a;b\n1;'x;y'\n2;z\n",
    "hq.csv": b'"a,1",b\n1,2\n3,4\n',
    "ragged.csv": b"a,b,c\n1,2,3,\n",
    "latin1.csv": b"a,b\n1,caf\xe9\n",
    "t.json": b'{"a": [1, {"b": "x,]"}], "c": 2}',
    "esc.json": (b'{"x": "\\\\\\"", "y": [1, {"z": "a\\\\"}, []], '
                 b'"w": "\\"[{"}\n[{"k": "\\\\\\\\"}]\n'),
}

# (id, arguments with file names) — each JAX CLI test's calls, and the
# paths no JAX test drives (the other column types, --decode on record
# and column, the dialect flags, the error paths)
CASES = [
    ("info golden", ["--backend", "golden", "info", "t.csv"]),
    ("info", ["info", "s.csv"]),
    ("info jnp", ["--backend", "jnp", "info", "q.csv"]),
    ("info native", ["--backend", "native", "info", "q.csv"]),
    ("info metrics", ["--metrics", "info", "s.csv"]),
    ("info dialect", ["--delimiter", ";", "--quote", "'", "info",
                      "semi.csv"]),
    ("info header quotes", ["--header-quotes", "info", "hq.csv"]),
    ("info ragged", ["info", "ragged.csv"]),
    ("info utf8", ["--validate-utf8", "info", "s.csv"]),
    ("info utf8 refused", ["--validate-utf8", "info", "latin1.csv"]),
    ("field", ["--backend", "golden", "field", "t.csv", "0", "1"]),
    ("field decode", ["--backend", "golden", "--decode", "field", "t.csv",
                      "0", "1"]),
    ("field out of range", ["field", "t.csv", "9", "0"]),
    ("field dialect", ["--delimiter", ";", "--quote", "'", "--decode",
                       "field", "semi.csv", "0", "1"]),
    ("record", ["--backend", "golden", "record", "s.csv", "1"]),
    ("record decode", ["--decode", "record", "t.csv", "0"]),
    ("record out of range", ["record", "t.csv", "5"]),
    ("column bytes", ["column", "q.csv", "0", "--limit", "15"]),
    ("column decode", ["--decode", "column", "q.csv", "0", "--limit",
                       "15"]),
    ("column int32", ["column", "s.csv", "1", "--type", "int32"]),
    ("column int32 bad", ["--backend", "golden", "column", "typed.csv",
                          "2", "--type", "int32"]),
    ("column decimal", ["--backend", "golden", "column", "typed.csv", "1",
                        "--type", "decimal", "--scale", "2"]),
    ("column decimal s.csv", ["column", "s.csv", "2", "--type", "decimal",
                              "--scale", "2"]),
    ("column float32", ["column", "q.csv", "2", "--type", "float32",
                        "--limit", "12"]),
    ("column float32exp", ["column", "q.csv", "4", "--type", "float32exp",
                           "--limit", "12"]),
    ("column date", ["column", "ts.csv", "2", "--type", "date"]),
    ("column datetime", ["column", "ts.csv", "1", "--type", "datetime"]),
    ("column datetime ms", ["column", "ts.csv", "1", "--type", "datetime",
                            "--unit", "ms"]),
    ("index offsets", ["--backend", "golden", "index", "t.csv", "-o",
                       "OUT/idx.npz"]),
    ("index packed_seq", ["--backend", "golden", "index", "t.csv", "-o",
                          "OUT/seq.npz", "--format", "packed_seq"]),
    ("frame", ["--backend", "golden", "frame", "prices.csv"]),
    ("frame schema packed", ["--backend", "golden", "frame", "prices.csv",
                             "--schema", "price=float,n=int32", "--engine",
                             "packed"]),
    ("frame where between", ["frame", "q.csv", "--where", "qty between 10 99",
                             "--limit", "3"]),
    ("frame where or", ["frame", "o.csv", "--where", "qty > 40 or sym == CC",
                        "--limit", "9"]),
    ("frame order by", ["frame", "o.csv", "--order-by", "sym,-qty",
                        "--limit", "9"]),
    ("frame where contains", ["frame", "q.csv", "--where",
                              "sym contains A,P", "--limit", "3"]),
    ("frame corpus", ["--backend", "golden", "frame", "p1.csv", "p2.csv",
                      "--order-by", "qty", "--desc", "--head", "3"]),
    ("frame corpus engine", ["frame", "p1.csv", "p2.csv", "--engine",
                             "packed"]),
    ("frame bad where", ["frame", "o.csv", "--where", "qty >"]),
    ("values", ["values", "q.csv", "sym", "--by-count"]),
    ("values typed", ["values", "q.csv", "qty", "--where", "qty > 1900",
                      "--limit", "5", "--engine", "packed"]),
    ("stats", ["stats", "q.csv", "qty"]),
    ("stats where", ["stats", "q.csv", "qty", "--where", "qty > 0",
                     "--where", "sym == AAPL"]),
    ("stats float packed", ["stats", "q.csv", "price", "--type", "float32",
                            "--engine", "packed"]),
    ("stats corpus", ["--backend", "golden", "stats", "p1.csv", "p2.csv",
                      "qty"]),
    ("describe", ["describe", "s.csv"]),
    ("describe columns", ["describe", "q.csv", "--columns", "qty,day,sym",
                          "--where", "qty > 0"]),
    ("groupby", ["groupby", "q.csv", "day", "qty", "--limit", "2"]),
    ("groupby composite", ["groupby", "q.csv", "sym,day", "qty", "--limit",
                           "2"]),
    ("groupby multi value", ["groupby", "q.csv", "sym", "qty,ratio"]),
    ("groupby having", ["groupby", "h.csv", "sym", "qty", "--having",
                        "count >= 2 or sum > 100"]),
    ("groupby corpus", ["--backend", "golden", "groupby", "p1.csv",
                        "p2.csv", "sym", "qty"]),
    ("join", ["join", "l.csv", "r.csv", "sym", "--limit", "3"]),
    ("join left packed", ["join", "l.csv", "r.csv", "sym", "--how", "left",
                          "--engine", "packed"]),
    ("join right on mismatch", ["join", "jl.csv", "jr.csv", "sym",
                                "--right-on", "sym,day"]),
    ("sql group by", ["sql", "SELECT sym, SUM(qty) AS s FROM t GROUP BY sym",
                      "s.csv"]),
    ("sql join", ["sql", "SELECT l.sym, price FROM l JOIN r ON l.sym = r.sym",
                  "sl.csv", "sr.csv"]),
    ("sql self join", ["sql", "SELECT * FROM t JOIN t ON sym = sym",
                       "sl.csv", "sr.csv"]),
    ("sql too many files", ["sql", "SELECT * FROM t", "sl.csv", "sr.csv"]),
    ("sql explain", ["sql", "EXPLAIN SELECT COUNT(*) FROM t"]),
    ("sql schema packed", ["sql", "SELECT sym, qty FROM t WHERE qty > 20 "
                           "ORDER BY qty DESC", "sl.csv", "--schema",
                           "qty=int32", "--engine", "packed"]),
    ("json-index", ["json-index", "t.json"]),
    ("json-index escapes", ["json-index", "esc.json", "--limit", "40"]),
]

_TO_PORT = {"jnp": "torch", "pallas": "cuda"}


def _paths(args, tmp) -> list:
    out = []
    for a in args:
        if a in FILES:
            out.append(str(tmp / a))
        elif a.startswith("OUT/"):
            out.append(str(tmp / a[4:]))
        else:
            out.append(a)
    return out


def _run(main, argv) -> tuple:
    """(exit code or the exception's type and text, stdout) of one
    in-process call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = ("SystemExit", str(e.code))
        except Exception as e:  # the same exception from both CLIs
            rc = (type(e).__name__, str(e))
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    for name, data in FILES.items():
        (tmp / name).write_bytes(data)
    return tmp


def _both(args, tmp) -> tuple:
    argv = _paths(args, tmp)
    want = _run(jax_main, ["--platform", "cpu", *argv])
    got = _run(port_main, ["--device", "cpu",
                           *[_TO_PORT.get(a, a) for a in argv]])
    return got, want


# cases whose output holds a float32 sum: its sum and mean within rtol 1e-5
FLOAT_SUMS = {"stats float packed"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_subcommand_matches_the_jax_cli(files, case):
    name, args = case
    got, want = _both(args, files)
    if name in FLOAT_SUMS:
        import json

        assert got[0] == want[0] == 0
        g, w = json.loads(got[1]), json.loads(want[1])
        for key in ("sum", "mean"):
            assert g.pop(key) == pytest.approx(w.pop(key), rel=1e-5)
        assert g == w
        return
    assert got == want


def test_every_subcommand_is_covered():
    subs = {a for _, args in CASES for a in args if a in {
        "info", "field", "record", "column", "index", "serve", "frame",
        "values", "stats", "describe", "groupby", "join", "sql",
        "json-index"}}
    # serve runs in the artifact tests below
    assert subs | {"serve"} == {
        "info", "field", "record", "column", "index", "serve", "frame",
        "values", "stats", "describe", "groupby", "join", "sql",
        "json-index"}


def test_error_paths_are_the_jax_clis(files):
    """A ragged CSV returns 1, a bad --where and the sql checks raise
    SystemExit, join's key count mismatch raises ValueError: the same
    way in both CLIs."""
    by_id = dict(CASES)
    rc, _ = _both(by_id["info ragged"], files)[0]
    assert rc == 1
    assert _both(by_id["frame bad where"], files)[0][0][0] == "SystemExit"
    assert _both(by_id["sql self join"], files)[0][0][0] == "SystemExit"
    assert _both(by_id["join right on mismatch"], files)[0][0][0] == \
        "ValueError"
    assert _both(by_id["info utf8 refused"], files)[0][0] == 1


@pytest.mark.parametrize("expr", [
    None, ["qty > 100"], ["sym in A|B"], ["d between 1 2"], ["0 <= 5"],
    ["qty > 100 or sym == AAPL"], ["desc contains red or blue"],
    ["qty > 1 or sym == A"], ["s startswith ab", "x isnull"],
])
def test_parse_where_matches_jax(expr):
    from csv_simd_tpu.__main__ import _parse_where as jax_parse

    assert _parse_where(expr) == jax_parse(expr)


@pytest.mark.parametrize("expr", [["qty >"], ["no operator here"]])
def test_parse_where_refuses_as_jax(expr):
    from csv_simd_tpu.__main__ import _parse_where as jax_parse

    with pytest.raises(SystemExit) as got:
        _parse_where(expr)
    with pytest.raises(SystemExit) as want:
        jax_parse(expr)
    assert str(got.value.code) == str(want.value.code)


@pytest.mark.parametrize("fmt", ["offsets", "packed_seq"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_serve_across_the_clis(files, tmp_path, fmt, writer):
    """An index written by one CLI is served by the other's `serve`,
    with the output the writer's own `serve` gives."""
    art = str(tmp_path / f"{writer}-{fmt}.npz")
    src = str(files / "q.csv")
    index = ["index", src, "-o", art, "--format", fmt]
    if writer == "jax":
        assert _run(jax_main, ["--platform", "cpu", *index])[0] == 0
    else:
        assert _run(port_main, ["--device", "cpu", *index])[0] == 0
    for rec, fld in ((0, 0), (9, 0), (599, 4), (600, 0), (3, 9)):
        serve = ["serve", src, "--from-index", art, str(rec), str(fld)]
        want = _run(jax_main, ["--platform", "cpu", *serve])
        got = _run(port_main, ["--device", "cpu", *serve])
        assert got == want and got[0] == 0


def test_default_device_needs_a_card(files):
    """Without a card the default --device cuda is an error (exit 2, the
    device message on stderr), never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    err = io.StringIO()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(["info", str(files / "s.csv")])
    assert rc == 2 and out.getvalue() == ""
    assert "torch.cuda.is_available() is False" in err.getvalue()


def test_backend_refuses_the_jax_names(files):
    for name in ("jnp", "pallas"):
        with contextlib.redirect_stderr(io.StringIO()) as err, \
                pytest.raises(SystemExit) as e:
            port_main(["--device", "cpu", "--backend", name, "info",
                       str(files / "s.csv")])
        assert e.value.code == 2 and "invalid choice" in err.getvalue()


def test_module_runs_without_jax(files):
    """`python -m csv_simd_tpu_torch --device cpu info` prints what the
    JAX CLI prints, and the process never imports jax or csv_simd_tpu."""
    src = str(files / "q.csv")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "csv_simd_tpu_torch", "--device", "cpu",
         "info", src], capture_output=True, text=True, cwd=REPO, env=env,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert (0, r.stdout) == _run(jax_main, ["--platform", "cpu", "info",
                                            src])
    check = ("import runpy, sys\n"
             f"sys.argv = ['csv_simd_tpu_torch', '--device', 'cpu', 'info', "
             f"{src!r}]\n"
             "try:\n"
             "    runpy.run_module('csv_simd_tpu_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert not e.code, e.code\n"
             "bad = [m for m in ('jax', 'csv_simd_tpu') if m in sys.modules]\n"
             "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", check], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
