"""The per-layer readers and the end-to-end readers on canned data: a
profiler table built by hand, and an empty trace that must raise."""

import re

import pytest

from benchmark import run, work
from benchmark.trace import ITER_SPAN, EmptyTrace, Trace, base_name, \
    parse_chrome

FILE_BYTES = 1 << 30


def _trace(device, spans=None, steps=2, units=2.0):
    host = [{"name": ITER_SPAN, "cat": "user_annotation", "ts": 0.0,
             "dur": 400.0},
            {"name": ITER_SPAN, "cat": "user_annotation", "ts": 500.0,
             "dur": 500.0},
            {"name": "build.create", "cat": "user_annotation", "ts": 0.0,
             "dur": 300.0}]
    return Trace(device, host, {"steps": steps, "units": units,
                                "file_bytes": FILE_BYTES}, spans or {})


def _k(name, ts, dur, cat="kernel"):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


CANNED = [
    _k("void (anonymous namespace)::mask_pack<4>(uint4 const*, long long)",
       100, 100),
    _k("void (anonymous namespace)::fold_words(unsigned int const*)", 150,
       50),  # overlaps mask_pack: the union counts 150-200 once
    _k("Memcpy HtoD (Pinned -> Device)", 600, 200, "gpu_memcpy"),
    _k("void at::native::reduce_kernel<512, 1>(float*)", 950, 100),
]


def test_base_names():
    assert base_name(CANNED[0]["name"]) == "mask_pack"
    assert base_name(CANNED[2]["name"]) == "Memcpy HtoD"
    assert base_name(CANNED[3]["name"]) == "at::native::reduce_kernel"


def test_union_and_idle_share():
    t = _trace(CANNED)
    # busy: 100-200, 600-800, 950-1000 (clipped to the window's end)
    assert t.busy_us() == 100 + 200 + 50
    assert t.window_us() == 1000
    assert run.load_reader("metrics", "device_idle_pct.ingest")(t) == \
        pytest.approx(65.0)
    for name in ("device_idle_pct.lookup", "device_idle_pct.sql"):
        assert run.load_reader("metrics", name)(t) == pytest.approx(65.0)


def test_rooflines():
    t = _trace(CANNED)
    b1 = run.load_reader("metrics", "b1_roofline_pct")(t)
    want = 100 * (work.stage1_bytes(FILE_BYTES) / work.HBM_BYTES_PER_S) \
        / 50e-6
    assert b1 == pytest.approx(want)
    b3 = run.load_reader("metrics", "b3_roofline_pct")(t)
    assert b3 == pytest.approx(want * 100 / 150)
    assert run.load_reader("metrics", "b1_roofline_pct")(
        _trace(CANNED[2:])) is None


def test_spans_and_per_unit_readers():
    t = _trace(CANNED, spans={"index_build[auto]": (2.4, 2)}, units=2e6)
    assert run.load_reader("metrics", "index_build_ms.offsets")(t) == \
        pytest.approx(1200.0)
    assert run.load_reader("metrics", "index_build_ms.offsets")(
        _trace(CANNED)) is None
    assert run.load_reader("metrics", "serve_device_ms_per_Mlookup")(t) == \
        pytest.approx(0.35 / 2)
    # the two traced steps, of 400 and 500 us, ingested 2e6 bytes
    assert run.load_reader("metrics", "ingest_GBps.traced")(t) == \
        pytest.approx(2e6 / 900e-6 / 1e9)
    rounds = _trace(CANNED, steps=1, units=2.0)  # one round of two
    assert run.load_reader("metrics", "sql_device_ms_per_stmt")(rounds) == \
        pytest.approx(0.35 / 2)


def test_breakdown_names_ops_and_idle_gaps():
    b = _trace(CANNED).breakdown()
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "Memcpy HtoD" and "mask_pack" in names
    gaps = dict(b["idle_gaps"])
    # the gaps 0-100, 200-600 and 800-950: only the first one's middle
    # falls inside build.create
    assert gaps["build.create"] == pytest.approx(100e-6)
    assert gaps["host (no span)"] == pytest.approx(550e-6)


def _round(device):
    """A traced SQL round: Q1 over 0-700 us and Q6 over 720-1000 us, each
    with its span on the host (and on the device, which is no host
    span)."""
    t = _trace(device, steps=1, units=2.0)
    t.host += [{"name": "sql.q1", "cat": "user_annotation", "ts": 0.0,
                "dur": 700.0},
               {"name": "sql.q6", "cat": "user_annotation", "ts": 720.0,
                "dur": 280.0},
               {"name": "sql.q6", "cat": "gpu_user_annotation", "ts": 0.0,
                "dur": 1000.0}]
    return t


def test_per_statement_readers():
    t = _round(CANNED)
    assert run.load_reader("metrics", "q1_s")(t) == pytest.approx(700e-6)
    assert run.load_reader("metrics", "q6_s")(t) == pytest.approx(280e-6)
    # busy 100-200 and 600-700 inside Q1's span; 720-800 and 950-1000
    # inside Q6's
    assert run.load_reader("metrics", "sql_device_ms.q1")(t) == \
        pytest.approx(0.2)
    assert run.load_reader("metrics", "sql_device_ms.q6")(t) == \
        pytest.approx(0.13)
    assert run.load_reader("metrics", "q6_s")(_trace(CANNED)) is None


@pytest.mark.parametrize("name", ["b1_roofline_pct", "b3_roofline_pct",
                                  "index_build_ms.offsets", "q6_s",
                                  "sql_device_ms.q6"])
def test_a_listed_metric_that_reads_nothing_fails_the_run(spec, name):
    """A kernel or span gone from the trace fails the run, naming it,
    instead of leaving its metric out of the line."""
    mod = run.load_module("metrics", name)
    metric = next(m for m in spec["per_layer"] if m["name"] == name)
    only = dict(spec, per_layer=[metric])
    bare = _trace([_k("void other_kernel(int)", 100, 100)])
    with pytest.raises(run.MissingMetric, match=re.escape(mod.READS[0])):
        run.per_layer_metrics(only, metric["workloads"][0], bare)


@pytest.mark.parametrize("name", ["device_idle_pct.ingest",
                                  "b1_roofline_pct",
                                  "serve_device_ms_per_Mlookup",
                                  "sql_device_ms_per_stmt",
                                  "sql_device_ms.q1"])
def test_an_empty_trace_raises(name):
    t = _trace([])
    t.host.append({"name": "sql.q1", "cat": "user_annotation", "ts": 0.0,
                   "dur": 700.0})
    with pytest.raises(EmptyTrace):
        run.load_reader("metrics", name)(t)


def test_parse_chrome_splits_device_from_host():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1, "dur": 2},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "a", "ts": 1,
         "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3}]}
    dev, host = parse_chrome(doc)
    assert [e["name"] for e in dev] == ["k"]
    assert sorted(e["name"] for e in host) == ["a", "aten::add"]


def test_end_to_end_readers():
    w = run.Window(10.0, 12.0, [(10.0, 10.5, 2e9), (10.5, 12.0, 2e9)])
    assert run.load_reader("end_to_end", "ingest_GBps")(w) == \
        pytest.approx(2.0)
    assert run.load_reader("end_to_end", "lookups_per_s")(w) == \
        pytest.approx(2e9)
    rounds = run.Window(0.0, 6.0, [(0.0, 3.0, 2.0), (3.0, 6.0, 2.0)])
    assert run.load_reader("end_to_end", "stmt_s")(rounds) == \
        pytest.approx(1.5)
    lat = run.Window(0.0, 1.0, [(0.0, 0.001 * (i + 1), 1) for i in range(100)])
    assert run.load_reader("end_to_end", "lookup_p99_ms")(lat) == \
        pytest.approx(99.01)
    peak = run.Window(0.0, 1.0, [(0.0, 1.0, 1)], memory_peak_bytes=2266717184)
    assert run.load_reader("end_to_end", "device_memory_GB")(peak) == \
        pytest.approx(2.266717184)


def test_padded_bytes_follow_the_pad_rule():
    assert work.padded_bytes(1) == 512 * 512
    assert work.padded_bytes(8192 * 512 + 1) == 2 * 8192 * 512
    assert work.stage1_bytes(1 << 30) == (1 << 30) + (1 << 27)
