"""The per-layer readers of the program's own spans and counters on canned
traces: each reads its value, each reads None without what it READS, a
counter present at 0 reads 0, and the statement readers count only the
spans that start inside their statement's span."""

import pytest

from benchmark import run
from benchmark.trace import ITER_SPAN, Trace

NEW = ("pad_ms.ingest", "extract_ms.offsets", "serve_host_ms_per_Mlookup",
       "group_keys_s.q1", "typed_parse_ms.q6", "host_key_rows.sql",
       "stream_feed_ms.streaming")


def _host(name, ts, dur, cat="user_annotation"):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def _trace(spans=None, host=(), steps=2):
    """Two traced steps over 0-1000 us, with `host` spans beside them and
    the program's registry deltas `spans` (name -> (seconds, calls))."""
    events = [_host(ITER_SPAN, 0, 400), _host(ITER_SPAN, 500, 500)]
    kernel = [{"name": "k", "cat": "kernel", "ts": 10.0, "dur": 5.0}]
    return Trace(kernel, events + list(host),
                 {"steps": steps, "units": 2.0, "file_bytes": 1 << 20},
                 dict(spans or {}))


def _read(name, trace):
    return run.load_reader("metrics", name)(trace)


# a traced SQL round: Q1 over 0-700 us and Q6 over 720-1000 us, with the
# program's spans inside them, one group-key span outside both, and the
# device copy of a span (no host span)
ROUND = [
    _host("sql.q1", 0, 700), _host("sql.q6", 720, 280),
    _host("query.group_keys", 100, 300),
    _host("query.group_keys", 450, 100),
    _host("query.group_keys", 705, 10),  # between the statements
    _host("query.group_keys", 120, 900, "gpu_user_annotation"),
    _host("query.parse_column", 50, 40),  # inside Q1: not Q6's
    _host("query.parse_column", 730, 60),
    _host("query.parse_column", 800, 20),
]


def test_each_reader_reads_its_value():
    spans = {"offsetfree.pad": (0.9, 6), "index.extract": (2.4, 2),
             "offsetfree.serve": (0.03, 10),
             "offsetfree.lookups": (0.0, 19_456 * 10),
             "query.host_key_rows": (0.0, 2 * 5_900_000),
             "streaming_chunk": (1.5, 60)}
    t = _trace(spans, ROUND)
    assert _read("pad_ms.ingest", t) == pytest.approx(450.0)
    assert _read("stream_feed_ms.streaming", t) == pytest.approx(750.0)
    assert _read("extract_ms.offsets", t) == pytest.approx(1200.0)
    assert _read("serve_host_ms_per_Mlookup", t) == \
        pytest.approx(30.0 / 0.19456)
    assert _read("host_key_rows.sql", t) == pytest.approx(5_900_000)
    one = _trace(spans, ROUND, steps=1)
    assert _read("host_key_rows.sql", one) == pytest.approx(11_800_000)
    assert _read("group_keys_s.q1", t) == pytest.approx(400e-6)
    assert _read("typed_parse_ms.q6", t) == pytest.approx(0.08)


def test_statement_readers_count_only_spans_inside_their_statement():
    two_q1 = ROUND + [_host("sql.q1", 1000, 0)]  # outside the window
    assert _read("group_keys_s.q1", _trace(host=two_q1)) == \
        pytest.approx(400e-6)
    # a second Q1 inside the window halves the per-statement sum
    wide = [_host("sql.q1", 0, 300), _host("sql.q1", 300, 400)] + ROUND[1:]
    assert _read("group_keys_s.q1", _trace(host=wide)) == \
        pytest.approx(200e-6)
    outside = [_host("sql.q1", 0, 90), _host("sql.q6", 720, 5)] + ROUND[2:]
    assert _read("group_keys_s.q1", _trace(host=outside)) is None
    assert _read("typed_parse_ms.q6", _trace(host=outside)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_none_without_what_it_reads(name):
    mod = run.load_module("metrics", name)
    assert mod.READS
    assert mod.read(_trace()) is None
    others = {"offsetfree.pad": (0.9, 6), "offsetfree.serve": (0.03, 10),
              "offsetfree.lookups": (0.0, 194_560), "index.extract": (1, 2),
              "query.host_key_rows": (0.0, 10),
              "streaming_chunk": (1.5, 60)}
    for gone in mod.READS:
        spans = {k: v for k, v in others.items() if k != gone}
        host = [e for e in ROUND if e["name"] != gone]
        assert mod.read(_trace(spans, host)) is None, gone


def test_a_counter_present_at_zero_reads_zero():
    t = _trace({"query.host_key_rows": (0.0, 0)})
    assert _read("host_key_rows.sql", t) == 0


@pytest.mark.parametrize("name", NEW)
def test_each_reader_has_a_file_and_a_docstring(name):
    mod = run.load_module("metrics", name)
    assert mod.__doc__ and callable(mod.read)
