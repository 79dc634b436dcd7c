"""The ClickBench hits configuration, its cell and the two cells added with
it, on the CPU: the generated table's 105 columns and quoting, the
reference's parse of it, both cells correct at a small size, the
bfloat16 control and a broken top-k called not correct, and the readers
of the program's top-k spans and counters on canned traces."""

import csv
import importlib
import io

import numpy as np
import pytest
import torch

from benchmark import control, gen, run
from benchmark.check import Reference
from benchmark.reference import clickbench
from benchmark.trace import ITER_SPAN, Trace

from .conftest import SEED, small_run

CONFIG = "clickbench-hits-1of40"
READERS = ("group_topk_ms.hits", "group_keys_s.hits",
           "group_keys_read.hits", "host_typed_key_rows.hits")


@pytest.fixture(scope="module")
def hits():
    cfg = run.load_json("configs", CONFIG)
    table = gen.Table(cfg, SEED, "cpu", 3000)
    return cfg, table.to_bytes()


def test_the_table_has_create_sqls_105_columns_and_rfc4180_quoting(hits):
    cfg, data = hits
    rows = list(csv.reader(io.StringIO(data.decode())))
    names = [c["name"] for c in cfg["columns"]]
    assert rows[0] == names and len(names) == 105
    assert names[:6] == ["WatchID", "JavaEnable", "Title", "GoodEvent",
                         "EventTime", "EventDate"]
    assert names[-3:] == ["RefererHash", "URLHash", "CLID"]
    assert len(rows) == 3001 and {len(r) for r in rows} == {105}
    assert data.endswith(b"\n") and b"\r" not in data
    url = [r[names.index("URL")] for r in rows[1:]]
    assert all(20 <= len(u.strip(" ")) <= 255 or u != u.strip(" ")
               for u in url)
    # commas and quotes inside text values are quoted and doubled
    assert any('"' in u or "," in u for u in url)
    assert b'""' in data


def test_the_reference_parses_the_generated_table(hits):
    cfg, data = hits
    ref = Reference(np.frombuffer(data, np.uint8))
    assert ref.n_records == 3000 and ref.n_fields == 105
    users, ok = clickbench.integers(ref.columns, "UserID", 64)
    assert ok.all() and (users < 0).any() and (users > 0).any()
    assert all(len(str(abs(int(u)))) == 19 for u in users)
    regions, rok = clickbench.integers(ref.columns, "RegionID", 32)
    assert rok.all() and 1 <= regions.min() and regions.max() <= 9973
    phrase = clickbench.text(ref.columns, "SearchPhrase")
    share = sum(p != b"" for p in phrase) / len(phrase)
    assert 0.09 < share < 0.17
    watch = clickbench.integers(ref.columns, "WatchID", 64)[1]
    assert watch.all()
    # the 19-digit ids are exact: the reference's parse is Python's
    first = data.split(b"\n")[1].split(b",")[0]
    assert int(first) == clickbench.integers(ref.columns, "WatchID",
                                             64)[0][0]


@pytest.mark.parametrize("cell", ["hits-sql-topk", "lineitem-sql-packed"])
def test_the_new_cells_run_correct_on_the_cpu(spec, cell, monkeypatch):
    out = small_run(spec, cell, monkeypatch)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"stmt_s", "setup_s"}
    assert res["checks"]["sql_mismatch"] == {"value": 0, "limit": 0}


def test_a_wrong_top_k_is_not_correct(spec, monkeypatch):
    """The program's top-k cut one group short: the check sees it."""
    q = importlib.import_module("csv_simd_tpu_torch.query")
    real = q.groupby_topk

    def short(*a, **k):
        if k.get("limit"):
            k["limit"] -= 1
        return real(*a, **k)

    monkeypatch.setattr(q, "groupby_topk", short)
    res = small_run(spec, "hits-sql-topk", monkeypatch)["result"]
    assert res["correct"] is False
    assert res["checks"]["sql_mismatch"]["value"] > 0


def test_the_bfloat16_control_is_not_correct(spec):
    """At 30,000 rows some counts pass 256, where a bfloat16 count stops."""
    outs = control.run_control(spec, "hits-sql-topk", SEED, "cpu",
                               rows=30000)
    assert [o["control"]["dtype"] for o in outs] == ["bfloat16"]
    assert outs[0]["correct"] is False
    assert outs[0]["checks"]["sql_mismatch"]["value"] > 0


def test_bfloat16_counts_stop_at_256():
    inv = np.zeros(1000, np.int64)
    assert clickbench._counts(inv, 1, True).tolist() == [256]
    assert clickbench._counts(inv, 1, False).tolist() == [1000]


def _host(name, ts, dur, cat="user_annotation"):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def _trace(spans=None, host=(), steps=2):
    events = [_host(ITER_SPAN, 0, 400), _host(ITER_SPAN, 500, 500)]
    kernel = [{"name": "k", "cat": "kernel", "ts": 10.0, "dur": 5.0}]
    return Trace(kernel, events + list(host),
                 {"steps": steps, "units": 10.0, "file_bytes": 1 << 20},
                 dict(spans or {}))


ROUND = [
    _host("sql.q9", 0, 150), _host("sql.q13", 160, 100),
    _host("sql.q21", 300, 50), _host("sql.q34", 500, 400),
    _host("query.group_keys", 10, 30), _host("query.group_keys", 170, 20),
    _host("query.group_keys", 510, 200),
    _host("query.group_keys", 920, 10),  # outside every statement
    _host("query.group_keys", 0, 900, "gpu_user_annotation"),
    _host("sql.parse", 1, 2),
]
SPANS = {"query.group_topk": (0.012, 8),
         "query.group_keys_read": (0.0, 80),
         "query.host_typed_key_rows": (0.0, 0)}


def _read(name, trace):
    return run.load_reader("metrics", name)(trace)


def test_each_hits_reader_reads_its_value():
    t = _trace(SPANS, ROUND)
    assert _read("group_topk_ms.hits", t) == pytest.approx(6.0)
    assert _read("group_keys_s.hits", t) == pytest.approx(125e-6)
    assert _read("group_keys_read.hits", t) == pytest.approx(40.0)
    assert _read("host_typed_key_rows.hits", t) == 0
    one = _trace(SPANS, ROUND, steps=1)
    assert _read("group_keys_read.hits", one) == pytest.approx(80.0)


@pytest.mark.parametrize("name", READERS)
def test_each_hits_reader_reads_none_without_what_it_reads(name):
    mod = run.load_module("metrics", name)
    assert mod.__doc__ and mod.READS
    assert mod.read(_trace()) is None
    for gone in mod.READS:
        spans = {k: v for k, v in SPANS.items() if k != gone}
        host = [e for e in ROUND if e["name"] != gone
                and not (gone == "sql.q*" and e["name"].startswith("sql.q"))]
        assert mod.read(_trace(spans, host)) is None, gone


@pytest.mark.parametrize("name", READERS)
def test_the_hits_readers_are_listed_for_the_hits_cell_alone(spec, name):
    m = next(m for m in spec["per_layer"] if m["name"] == name)
    assert m["workloads"] == ["hits-sql-topk"]
    assert m["layer"] == "relational executors" and m["moves"] == "stmt_s"


def test_the_int64_reference_parse_refuses_what_the_program_refuses():
    data = (b"UserID\n9223372036854775807\n-9223372036854775808\n"
            b"9223372036854775808\n 7\n7 \n+7\n\n-\n")
    ref = Reference(np.frombuffer(data, np.uint8))
    vals, ok = clickbench.integers(ref.columns, "UserID", 64)
    assert ok.tolist() == [True, True, False, True, False, True, False,
                           False]
    assert vals[:2].tolist() == [2**63 - 1, -(2**63)]
    assert torch.tensor(vals).dtype == torch.int64
