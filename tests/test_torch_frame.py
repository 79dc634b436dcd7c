"""The port's frame.py and corpus_api.py against the JAX package's, on the
CPU.

The same seeded CSVs (relational_csv, tests/test_torch_gpu.py: int, float,
decimal, date, datetime and text columns with quoted, escaped, empty and
unparsable fields) go through `read_typed`, `write_csv`, the Frame
surface and a three-file `CsvCorpus` of both packages, the port's with
device="cpu", on both engines where a path or bytes is the source.

Tolerance: columns, ok masks, record ids, counts, integer sums, min/max
and quantiles are exact (float columns bit for bit); the float32 sums of
column_stats and float group sums are within rtol=1e-5."""

import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt
from csv_simd_tpu import frame as jf
from csv_simd_tpu_torch import frame as pf

from test_torch_gpu import relational_csv
from test_torch_query import DATA, FLOAT_RTOL, SCHEMA, same

ENGINES = ("offsets", "packed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_query.py)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def same_frame(got, want):
    """Two Frames alike: names, schema, length, records, every column and
    ok mask (float columns bit for bit)."""
    assert type(got).__name__ == "Frame"
    assert got.names == want.names and len(got) == len(want)
    assert {n: (c.type, c.max_len, c.scale, c.trim, c.unit)
            for n, c in got.schema.items()} == \
        {n: (c.type, c.max_len, c.scale, c.trim, c.unit)
         for n, c in want.schema.items()}
    same(got.records, want.records)
    for n in want.names:
        g, w = got[n], want[n]
        if w.dtype.kind == "f":
            g, w = g.view(np.int32), w.view(np.int32)
        same(g, w, path=n)
        same(got.ok(n), want.ok(n), path=f"ok({n})")


READS = [
    dict(),
    dict(schema=SCHEMA),
    dict(schema={"v": "int32", 3: "float32", "s": "str:64", "t": "bytes"}),
    dict(columns=["ts", "d", "k"]),
    dict(schema={"k": "int32", "x": "auto"}, columns=["x", "k", "s"]),
    dict(schema=SCHEMA, where=[("k", ">", 0), ("s", "like", "%a%")]),
    dict(schema=SCHEMA, order_by="f", descending=True, limit=40),
    dict(schema=SCHEMA, order_by=["t", "v"], descending=[False, True]),
    dict(schema=SCHEMA, order_by="s", where=("v", "<", 0)),
    dict(schema=SCHEMA, records=[5, 3, 250, 0, 299]),
    dict(schema=SCHEMA, limit=7),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("i", range(len(READS)))
def test_read_typed_matches_jax(engine, i):
    """Every column, ok mask and record id: exact."""
    kw = READS[i]
    same_frame(pt.read_typed(DATA, engine=engine, device="cpu", **kw),
               jx.read_typed(DATA, engine=engine, **kw))


@pytest.mark.parametrize("engine", ENGINES)
def test_read_typed_of_a_path_and_a_tape(engine, tmp_path):
    """A path, a host Tape and a serving tape as the source: exact."""
    path = tmp_path / "t.csv"
    path.write_bytes(DATA)
    same_frame(pt.read_typed(str(path), SCHEMA, engine=engine, device="cpu"),
               jx.read_typed(str(path), SCHEMA, engine=engine))
    jtape = jx.create_from_bytes(DATA, backend="golden")
    ptape = pt.create_from_bytes(DATA, backend="golden", device="cpu")
    same_frame(pt.read_typed(ptape, SCHEMA, device="cpu"),
               jx.read_typed(jtape, SCHEMA))
    dev = pt.DeviceTape.from_tape(ptape, device="cpu")
    same_frame(pt.read_typed(dev, SCHEMA), jx.read_typed(jtape, SCHEMA))


def test_read_typed_strict_raises_in_both():
    with pytest.raises(jx.InvalidCsvFormat):
        jx.read_typed(DATA, {"v": "int32"}, strict=True)
    with pytest.raises(pt.InvalidCsvFormat):
        pt.read_typed(DATA, {"v": "int32"}, strict=True, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_infer_schema_matches_jax(engine):
    jt, _ = jf._resolve_tape(DATA, None, "auto", engine, False)
    ptt, names = pf._resolve_tape(DATA, None, "auto", engine, False, "cpu")
    for sample in (3, 64, 256):
        got = pt.infer_schema(ptt, names, sample=sample)
        want = jx.infer_schema(jt, names, sample=sample)
        assert {n: repr(c) for n, c in got.items()} == \
            {n: repr(c) for n, c in want.items()}


@pytest.mark.parametrize("spec", ["decimal:4", "str:128", "int32", "float",
                                  "datetime:us", "date", "bytes:16"])
def test_col_and_parse_spec_match_jax(spec):
    assert repr(pf.parse_spec(spec)) == repr(jf.parse_spec(spec))
    assert pt.Col is pf.Col and pt.Col is not jx.Col


@pytest.mark.parametrize("engine", ENGINES)
def test_write_csv_round_trip_matches_jax(engine):
    """write_csv gives the JAX package's bytes, and read_typed of them
    gives an equal Frame again."""
    fr = pt.read_typed(DATA, SCHEMA, engine=engine, device="cpu")
    want = jx.write_csv(jx.read_typed(DATA, SCHEMA, engine=engine))
    blob = pt.write_csv(fr)
    assert blob == want
    back = pt.read_typed(blob, SCHEMA, engine=engine, device="cpu")
    same_frame(back, jx.read_typed(want, SCHEMA, engine=engine))
    for n in ("v", "d", "day", "ts", "s"):
        assert np.array_equal(back[n][back.ok(n) if back.ok(n) is not None
                                      else slice(None)],
                              fr[n][fr.ok(n) if fr.ok(n) is not None
                                    else slice(None)])
    d = pt.Dialect(delimiter=0x3B, quote=0x27)
    assert pt.write_csv(fr, dialect=d, header=False) == jx.write_csv(
        jx.read_typed(DATA, SCHEMA, engine=engine),
        dialect=jx.Dialect(delimiter=0x3B, quote=0x27), header=False)


def test_frame_surface_and_save_load(tmp_path):
    fr = pt.read_typed(DATA, SCHEMA, device="cpu")
    jfr = jx.read_typed(DATA, SCHEMA)
    assert repr(fr) == repr(jfr) and fr.keys() == jfr.keys()
    assert ("v" in fr) and ("nope" not in fr)
    same_frame(fr.take([9, 1, 1, 4]), jfr.take([9, 1, 1, 4]))
    # the numeric parses stay on the device beside the host copies
    vals, ok = fr._dev["v"]
    assert isinstance(vals, torch.Tensor) and vals.device.type == "cpu"
    fr.save(tmp_path / "f.npz")
    same_frame(pt.Frame.load(tmp_path / "f.npz"), jfr)
    jfr.save(tmp_path / "j.npz")
    same_frame(pt.Frame.load(tmp_path / "j.npz"), jfr)
    pd = pytest.importorskip("pandas")
    got, want = fr.to_pandas(), jfr.to_pandas()
    assert isinstance(got, pd.DataFrame)
    assert got.equals(want)


# ----------------------------------------------------------------- corpus

@pytest.fixture(scope="module")
def corpus_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = []
    for i, n in enumerate((120, 0, 90)):
        p = root / f"part{i}.csv"
        p.write_bytes(relational_csv(100 + i, n) if n else
                      relational_csv(100, 1).split(b"\n")[0] + b"\n")
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def corpora(corpus_paths):
    return (jx.CsvCorpus(corpus_paths), pt.CsvCorpus(corpus_paths,
                                                     device="cpu"))


def test_corpus_addressing_matches_jax(corpora):
    jc, pc = corpora
    assert pc.num_records == jc.num_records == 210
    assert len(pc) == len(jc) and pc.field_cnt == jc.field_cnt
    assert pc.header_names() == jc.header_names()
    assert repr(pc) == repr(jc)
    for r in (0, 119, 120, 209, 210, -1):
        assert pc.seek_field(r, 8) == jc.seek_field(r, 8)
        assert pc.seek_record(r) == jc.seek_record(r)
        assert pc.owner(r) == jc.owner(r)
    assert pc.column(0) == jc.column(0)
    st = pc.serving_tape()
    assert isinstance(st, pt.CorpusTape) and st is pc.serving_tape()
    assert all(d.device.type == "cpu" for d in pc.device_tapes())


def test_corpus_tape_gathers_match_jax(corpora):
    """CorpusTape's routed gather: bytes, lengths and validity exact, in
    request order, ids of every file and out of range among them."""
    jc, pc = corpora
    rng = np.random.default_rng(5)
    recs = np.r_[rng.integers(0, 210, 200), 210, -3, 119, 120]
    flds = rng.integers(0, 10, recs.size)
    got = pc.serving_tape().gather_fields(recs, flds, 32)
    want = jc.serving_tape().gather_fields(recs, flds, 32)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


CORPUS_CALLS = [
    ("column_stats", ("v", "int32"), {}),
    ("column_stats", ("f", "float32"), {"where": ("k", ">", 0),
                                        "schema": SCHEMA}),
    ("column_stats", ("d", None), {}),
    ("column_quantiles", ("v", (0.1, 0.5, 0.9), "int32"), {}),
    ("column_quantiles", ("x", (0.0, 0.5, 1.0), "float"), {}),
    ("column_quantiles", ("d", (0.25, 0.75), "decimal:2"), {}),
    ("describe", (["v", "f", "s", "day"],), {"schema": SCHEMA}),
    ("value_counts", ("t",), {}),
    ("distinct", ("k", "int32"), {}),
    ("groupby_typed", ("t", "v"), {"value_spec": "int32"}),
    ("groupby_typed", (["t", "k"], ["v", "f"]),
     {"key_spec": ["str", "int32"], "value_spec": ["int32", "float32"],
      "having": ("count", ">", 1)}),
    ("select_records", ([("k", ">", 1), ("s", "like", "%A%")],),
     {"schema": SCHEMA}),
]


@pytest.mark.parametrize("i", range(len(CORPUS_CALLS)))
def test_corpus_aggregates_match_jax(corpora, i):
    """Per-file map-reduce over the corpus: counts, ids, integer sums,
    min/max and quantiles exact; float sums within rtol=1e-5."""
    jc, pc = corpora
    name, args, kw = CORPUS_CALLS[i]
    same(getattr(pt, name)(pc, *args, **kw),
         getattr(jx, name)(jc, *args, **kw), FLOAT_RTOL)


@pytest.mark.parametrize("kw", [
    dict(), dict(schema=SCHEMA, where=("k", ">=", 0)),
    dict(schema=SCHEMA, order_by="v", descending=True, limit=25),
    dict(schema={"s": "str", "id": "int32"}, order_by="day"),
    dict(columns=["id", "t"]),
])
def test_corpus_read_typed_matches_jax(corpora, kw):
    jc, pc = corpora
    same_frame(pt.read_typed(pc, **kw), jx.read_typed(jc, **kw))


def test_corpus_order_and_join_through_the_corpus_tape(corpora):
    """order_records and join_records over CorpusTape: exact."""
    jc, pc = corpora
    jt, pt_ = jc.serving_tape(), pc.serving_tape()
    same(pt.order_records(pt_, "f", schema=SCHEMA, descending=True),
         jx.order_records(jt, "f", schema=SCHEMA, descending=True))
    same(pt.order_records(pt_, ["t", "ts"], schema=SCHEMA),
         jx.order_records(jt, ["t", "ts"], schema=SCHEMA))
    same(pt.join_records(pt_, pt_, "k", how="inner",
                         left_spec="int32", right_spec="int32"),
         jx.join_records(jt, jt, "k", how="inner",
                         left_spec="int32", right_spec="int32"))
