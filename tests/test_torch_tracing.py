"""The port's spans and counters (utils/metrics.py) and the paths they
instrument, on the CPU.

A span records calls, host seconds and bytes into a `Metrics`; while a
torch profiler runs it also opens a `record_function` of its name, so it
nests in the profiler's trace, and with none running it never enters
one. A counter keeps its count in `calls` with its seconds at 0. The
instrumented paths: the pad (`offsetfree.pad`, `offsetfree.pin_alloc`),
the host index build (`index.words_to_host`, `index.extract`,
`device_tape.index_upload`), the packed serve (`offsetfree.serve`,
`offsetfree.rank_select`, the counter `offsetfree.lookups`) and SQL
(`sql.parse`, `query.group_keys`, `query.key_factorize`,
`query.key_factorize_int`, `query.parse_column`, `query.group_reduce`,
`query.group_topk`, the counters `query.device_key_rows`,
`query.host_key_rows`, `query.host_typed_key_rows`, `query.groups` and
`query.group_keys_read`)."""

import json

import numpy as np
import pytest
import torch

import csv_simd_tpu_torch as ct
from csv_simd_tpu_torch.device_tape import DeviceTape
from csv_simd_tpu_torch.utils import metrics
from csv_simd_tpu_torch.utils.metrics import GLOBAL, Metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SCHEMA = {"flag": "str", "status": "str", "qty": "int32",
          "price": "float32", "day": "date"}


def _table(n: int = 400, seed: int = 7) -> bytes:
    """A small LINEITEM-like table: two one-letter text keys, an int, a
    float and a date."""
    rng = np.random.default_rng(seed)
    rows = ["flag,status,qty,price,day"]
    for _ in range(n):
        rows.append(f"{'ANR'[rng.integers(3)]},{'OF'[rng.integers(2)]},"
                    f"{rng.integers(1, 50)},{rng.uniform(1, 100):.2f},"
                    f"1998-0{rng.integers(1, 10)}-1{rng.integers(0, 9)}")
    return ("\n".join(rows) + "\n").encode()


DATA = _table()


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tracing") / "t.csv"
    p.write_bytes(DATA)
    return str(p)


@pytest.fixture(scope="module")
def device_tape(path):
    return DeviceTape.from_tape(ct.create(path, device="cpu"), device="cpu")


class _Delta:
    """What GLOBAL recorded inside the block: name -> (calls, seconds)."""

    def __enter__(self):
        self.before = {k: (s.calls, s.seconds)
                       for k, s in GLOBAL.stages.items()}
        return self

    def __exit__(self, *exc):
        self.got = {}
        for k, s in GLOBAL.stages.items():
            c0, t0 = self.before.get(k, (0, 0.0))
            if s.calls != c0 or k not in self.before:
                self.got[k] = (s.calls - c0, s.seconds - t0)
        return False

    def calls(self, name):
        return self.got[name][0]


@pytest.fixture
def entries(monkeypatch):
    """Counts each entry into torch.profiler.record_function."""
    seen = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        seen.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return seen


def _rows_kept(day_le: str) -> int:
    days = [ln.split(b",")[4].decode() for ln in DATA.splitlines()[1:]]
    return sum(d <= day_le for d in days)


# --- the registry --------------------------------------------------------

def test_span_without_a_profiler_records_and_never_enters_record_function(
        entries):
    m = Metrics()
    assert not torch._C._autograd._profiler_enabled()
    for _ in range(3):
        with m.span("x.step", n_bytes=10):
            pass
    st = m.stages["x.step"]
    assert (st.calls, st.bytes, st.counter) == (3, 30, False)
    assert st.seconds > 0
    assert entries == []


def test_program_paths_without_a_profiler_never_enter_record_function(
        entries, path):
    with _Delta() as d:
        tape = ct.create_packed(path, device="cpu")
        tape.gather_fields(np.arange(4), np.zeros(4, np.int32))
        ct.sql("SELECT flag, status, COUNT(*) AS n FROM t GROUP BY flag, "
               "status", path, schema=SCHEMA, device="cpu")
    assert "offsetfree.pad" in d.got and "query.group_keys" in d.got
    assert entries == []


def _chrome(prof, tmp_path) -> list:
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    return [e for e in json.loads(out.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_span_under_a_profiler_lands_in_its_trace_nested(tmp_path):
    m = Metrics()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("outer.block"):
            with m.span("x.inner"):
                torch.ones(8).sum()
    assert m.stages["x.inner"].calls == 1
    ev = _chrome(prof, tmp_path)
    outer = [e for e in ev if e["name"] == "outer.block"]
    inner = [e for e in ev if e["name"] == "x.inner"]
    assert len(outer) == 1 and len(inner) == 1
    assert _inside(inner[0], outer[0])


def test_program_spans_under_a_profiler_nest_in_the_callers(tmp_path,
                                                            device_tape):
    acts = [torch.profiler.ProfilerActivity.CPU]
    q = ("SELECT flag, status, SUM(price) AS s FROM t WHERE day <= "
         "'1998-06-01' GROUP BY flag, status")
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("sql.q1"):
            ct.sql(q, device_tape, schema=SCHEMA, device="cpu")
    ev = _chrome(prof, tmp_path)
    (stmt,) = [e for e in ev if e["name"] == "sql.q1"]
    (keys,) = [e for e in ev if e["name"] == "query.group_keys"]
    factorize = [e for e in ev if e["name"] == "query.key_factorize"]
    assert _inside(keys, stmt)
    assert len(factorize) == 2 and all(_inside(e, keys) for e in factorize)
    assert any(e["name"] == "query.parse_column" and _inside(e, stmt)
               for e in ev)


def test_count_adds_to_calls_and_leaves_seconds_at_zero():
    m = Metrics()
    m.count("x.rows", 5)
    m.count("x.rows", 0)
    m.count("x.rows", 7)
    st = m.stages["x.rows"]
    assert (st.calls, st.seconds, st.bytes, st.counter) == (12, 0.0, 0, True)
    m.count("x.none", 0)
    assert m.stages["x.none"].calls == 0


def test_a_name_is_a_span_or_a_counter_never_both():
    m = Metrics()
    m.count("x.rows", 1)
    with pytest.raises(ValueError, match="counter"):
        with m.span("x.rows"):
            pass
    with m.span("x.step"):
        pass
    with pytest.raises(ValueError, match="span"):
        m.count("x.step", 1)


def test_report_prints_counters_in_rows_of_their_own():
    m = Metrics()
    with m.span("x.step", 1 << 20):
        pass
    m.count("x.rows", 42)
    lines = m.report().splitlines()
    assert lines[0].split() == ["stage", "calls", "ms", "GB/s"]
    assert lines[1].split()[:2] == ["x.step", "1"]
    assert lines[2].split() == ["counter", "count"]
    assert lines[3].split() == ["x.rows", "42"]


def test_registry_has_no_json_lines_and_global_is_a_metrics():
    assert isinstance(metrics.GLOBAL, Metrics)
    assert not hasattr(Metrics, "json_lines")


# --- the instrumented paths ---------------------------------------------

def test_create_packed_records_the_pad(path):
    with _Delta() as d:
        ct.create_packed(path, device="cpu")
    assert d.calls("offsetfree.pad") == 1
    assert d.calls("offsetfree.pin_alloc") == 1
    assert GLOBAL.stages["offsetfree.pad"].bytes >= len(DATA)


def test_create_records_the_words_to_host_and_the_extraction(path):
    with _Delta() as d:
        tape = ct.create(path, backend="torch", device="cpu")
    assert d.calls("index.words_to_host") == 1
    assert d.calls("index.extract") == 1
    assert d.calls("offsetfree.pad") == 1  # B3's upload
    assert d.calls("index_build[torch]") == 1
    assert tape.num_data_records == len(DATA.splitlines()) - 1


def test_from_tape_records_the_index_upload(path):
    host = ct.create(path, device="cpu")
    with _Delta() as d:
        DeviceTape.from_tape(host, device="cpu")
    assert d.calls("device_tape.index_upload") == 1
    assert d.calls("offsetfree.pad") == 1  # the tape's bytes


def test_packed_serve_records_its_spans_and_counts_the_lookups(path):
    tape = ct.create_packed(path, device="cpu")
    recs = np.repeat(np.arange(0, 300, 7), 5)
    fields = np.tile(np.arange(5), recs.size // 5)
    with _Delta() as d:
        tape.gather_fields(recs, fields)
        tape.gather_fields(recs[:10], fields[:10])
    assert d.calls("offsetfree.serve") == 2
    assert d.calls("offsetfree.rank_select") == 2
    assert d.calls("offsetfree.lookups") == recs.size + 10
    assert d.got["offsetfree.lookups"][1] == 0.0


def test_two_text_key_group_by_sends_both_keys_to_the_host(device_tape):
    q = ("SELECT flag, status, COUNT(*) AS n FROM t WHERE day <= "
         "'1998-06-01' GROUP BY flag, status ORDER BY flag, status")
    with _Delta() as d:
        r = ct.sql(q, device_tape, schema=SCHEMA, device="cpu")
    kept = _rows_kept("1998-06-01")
    assert int(np.asarray(r["n"]).sum()) == kept
    assert d.calls("sql.parse") == 1
    assert d.calls("query.group_keys") == 1
    assert d.calls("query.key_factorize") == 2
    assert d.calls("query.device_key_rows") == 2 * kept
    assert d.got.get("query.host_key_rows", (0,))[0] == 0
    assert GLOBAL.stages["query.host_key_rows"].counter
    assert "query.key_to_host" not in d.got


def test_one_text_key_group_by_counts_its_rows(device_tape):
    with _Delta() as d:
        ct.sql("SELECT flag, SUM(qty) AS s FROM t GROUP BY flag",
               device_tape, schema=SCHEMA, device="cpu")
    assert d.calls("query.device_key_rows") == len(DATA.splitlines()) - 1
    assert d.got.get("query.host_key_rows", (0,))[0] == 0
    assert d.calls("query.key_factorize") == 1
    assert "query.key_to_host" not in d.got
    assert d.calls("query.group_reduce") >= 1


def test_int_key_group_by_counts_no_host_key_rows(device_tape, monkeypatch):
    monkeypatch.delitem(GLOBAL.stages, "query.host_key_rows", raising=False)
    with _Delta() as d:
        ct.sql("SELECT qty, COUNT(*) AS n FROM t GROUP BY qty",
               device_tape, schema=SCHEMA, device="cpu")
    st = GLOBAL.stages["query.host_key_rows"]  # present, at 0
    assert st.counter and st.calls == 0
    assert "query.key_to_host" not in d.got
    assert d.calls("query.group_keys") == 1
    assert d.calls("query.parse_column") >= 1


def test_typed_parses_of_a_filtered_sum_are_spanned(device_tape):
    with _Delta() as d:
        ct.sql("SELECT SUM(price * qty) AS rev FROM t WHERE day >= "
               "'1998-02-01' AND day < '1998-05-01' AND qty < 24",
               device_tape, schema=SCHEMA, device="cpu")
    assert d.calls("query.parse_column") >= 2
    assert "query.group_keys" not in d.got


def test_explain_analyze_lists_the_new_spans_and_counters(device_tape):
    txt = ct.sql("EXPLAIN ANALYZE SELECT flag, status, SUM(price) AS s "
                 "FROM t GROUP BY flag, status", device_tape,
                 schema=SCHEMA, device="cpu")
    analyze = txt.split("-- ANALYZE --", 1)[1]
    for name in ("sql.parse", "query.group_keys", "query.key_factorize",
                 "query.parse_column", "query.group_reduce"):
        assert f"{name} " in analyze and "calls" in analyze, name
    rows = len(DATA.splitlines()) - 1
    assert any(ln.split() == ["query.device_key_rows", str(2 * rows),
                              "counted"] for ln in analyze.splitlines())


def test_top_k_group_by_spans_its_choice_and_reads_k_keys(device_tape):
    q = ("SELECT flag, status, COUNT(*) AS n FROM t GROUP BY flag, status "
         "ORDER BY n DESC, flag, status LIMIT 2")
    with _Delta() as d:
        r = ct.sql(q, device_tape, schema=SCHEMA, device="cpu")
    assert len(r) == 2
    assert d.calls("query.group_topk") == 1
    assert d.calls("query.groups") == 6
    # the two kept groups' flags and statuses, each distinct key once
    kept = {c: len(set(np.asarray(r[c]).tolist())) for c in r.keys()}
    assert d.calls("query.group_keys_read") == kept["flag"] + kept["status"]
    assert d.got["query.groups"][1] == 0.0


def test_typed_composite_keys_factorize_on_the_device(device_tape):
    with _Delta() as d:
        ct.sql("SELECT qty, day, COUNT(*) AS n FROM t GROUP BY qty, day",
               device_tape, schema=SCHEMA, device="cpu")
    assert d.calls("query.key_factorize_int") == 2
    assert d.got.get("query.host_typed_key_rows", (0,))[0] == 0
    assert GLOBAL.stages["query.host_typed_key_rows"].counter


def test_a_decimal_key_counts_its_rows_grouped_on_the_host(device_tape):
    rows = len(DATA.splitlines()) - 1
    with _Delta() as d:
        r = ct.sql("SELECT price, SUM(qty) AS s FROM t GROUP BY price",
                   device_tape, schema=dict(SCHEMA, price="decimal:2"),
                   device="cpu")
    assert d.calls("query.host_typed_key_rows") == rows
    assert d.calls("query.group_keys_read") == len(r)


def test_explain_analyze_lists_the_top_k_spans_and_counters(device_tape):
    txt = ct.sql("EXPLAIN ANALYZE SELECT qty, COUNT(DISTINCT day) AS u "
                 "FROM t GROUP BY qty ORDER BY u DESC, qty LIMIT 3",
                 device_tape, schema=SCHEMA, device="cpu")
    analyze = txt.split("-- ANALYZE --", 1)[1]
    names = {ln.split()[0]: ln.split()[-1] for ln in analyze.splitlines()
             if ln.startswith("  ")}
    assert names["query.group_topk"] == "ms"
    assert names["query.groups"] == names["query.group_keys_read"] == \
        "counted"
    assert any(ln.split() == ["query.group_keys_read", "3", "counted"]
               for ln in analyze.splitlines())


def test_a_decorating_span_opens_a_fresh_span_every_call():
    m = Metrics()

    @m.span("x.depth")
    def depth(k):
        return depth(k - 1) + 1 if k else 0

    assert "x.depth" not in m.stages  # nothing recorded until a call
    assert depth(3) == 3
    assert m.stages["x.depth"].calls == 4
    assert depth.__name__ == "depth"


def test_spans_and_counts_from_many_threads_lose_no_update():
    import sys
    import threading

    m = Metrics()
    n_threads, n = 16, 2000

    def work():
        for _ in range(n):
            with m.span("x.step", 3):
                pass
            m.count("x.rows", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert m.stages["x.step"].calls == n_threads * n
    assert m.stages["x.step"].bytes == 3 * n_threads * n
    assert m.stages["x.rows"].calls == 2 * n_threads * n
