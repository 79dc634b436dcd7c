"""The generator: seeded, vectorised, RFC 4180, and read back by the
plain reference as it laid the rows out."""

import csv
import io
import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen, run
from benchmark.check import Reference

CONFIGS = ["nyc-taxi-yellow-2015-01", "tpch-lineitem-sf1"]


def _config(name):
    with open(os.path.join(run.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_same_seed_same_bytes_other_seed_other_bytes(name):
    cfg = _config(name)
    a = gen.Table(cfg, 2**33 + 1, "cpu", rows=600).to_bytes()
    b = gen.Table(cfg, 2**33 + 1, "cpu", rows=600).to_bytes()
    c = gen.Table(cfg, 2**33 + 2, "cpu", rows=600).to_bytes()
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_reads_the_generated_layout(name):
    cfg = _config(name)
    table = gen.Table(cfg, 99, "cpu", rows=1500)
    raw = table.to_bytes()
    ref = Reference(np.frombuffer(raw, np.uint8))
    cols = [c["name"] for c in cfg["columns"]]
    assert ref.names == cols
    assert ref.n_fields == len(cols) and ref.jump == len(cols)
    assert ref.n_records == table.n == 1500
    # every field the reference serves is the field Python's csv module
    # reads, quotes and all
    rows = list(csv.reader(io.StringIO(raw.decode())))[1:]
    assert len(rows) == 1500 and all(len(r) == len(cols) for r in rows)
    recs = np.arange(1500)
    out, length, valid = ref.serve(recs, 64)
    assert valid.all()
    for i, (r, f) in enumerate(zip(np.repeat(recs, len(cols)),
                                   np.tile(np.arange(len(cols)), 1500))):
        field = bytes(out[i, : length[i]]).decode()
        want = rows[r][f]
        if field.startswith('"'):
            field = field[1:-1].replace('""', '"')
        assert field == want


def test_reference_columns_hold_the_drawn_values():
    cfg = _config("tpch-lineitem-sf1")
    table = gen.Table(cfg, 7, "cpu", rows=2000)
    ref = Reference(np.frombuffer(table.to_bytes(), np.uint8))
    cents = ref.columns.decimal("l_extendedprice") * 100
    assert np.array_equal(np.round(cents).astype(np.int64),
                          table.values["l_extendedprice"].numpy())
    assert np.array_equal(ref.columns.date_days("l_shipdate"),
                          table.values["l_shipdate"].numpy())
    flags = ref.columns.code("l_returnflag")
    assert np.array_equal(flags, np.frombuffer(b"RAN", np.uint8)[
        table.values["l_returnflag"].numpy()])
    # quoted comments with commas are part of the table
    assert (np.frombuffer(table.to_bytes(), np.uint8) == ord('"')).any()


def test_groups_keep_the_published_row_count_for_every_seed():
    spec = {"parents": 1000, "sizes": [1, 2, 3, 4, 5, 6, 7], "rows": 4003}
    for seed in (1, 2**40):
        sizes = gen._group_sizes(spec, gen.seed_generator(seed, "cpu"), "cpu")
        assert int(sizes.sum()) == 4003 and sizes.numel() == 1000
        assert int(sizes.min()) >= 1 and int(sizes.max()) <= 7


def test_g17_prints_float32_coordinates_as_printf():
    rng = np.random.default_rng(0)
    for bits, lo, hi in ((17, -74.3, -73.5), (18, 40.3, 41.2)):
        m = np.concatenate([(rng.uniform(lo, hi, 4000) * 2**bits).round()
                            .astype(np.int64), [0, 2**bits,
                                                73 * 2**bits + 2]])
        mat, ln = gen._fmt_g17(torch.from_numpy(m), bits)
        got = [bytes(mat[i, : ln[i]].tolist()).decode() for i in range(m.size)]
        assert got == ["%.17g" % (int(x) / 2**bits) for x in m]


def test_decimal_date_and_quote_formats():
    v = torch.tensor([0, 5, 50, 100, 1705, 1450, -30])
    fixed = gen._fmt_decimal(v, 2, short=False)
    short = gen._fmt_decimal(v, 2, short=True)

    def strs(m):
        return [bytes(m[0][i, : m[1][i]].tolist()).decode()
                for i in range(m[0].shape[0])]

    assert strs(fixed) == ["0.00", "0.05", "0.50", "1.00", "17.05", "14.50",
                           "-0.30"]
    assert strs(short) == ["0", "0.05", "0.5", "1", "17.05", "14.5", "-0.3"]
    assert strs(gen._fmt_datetime(torch.tensor(
        [gen.sec("2015-01-31 23:59:59"), 0]))) == [
        "2015-01-31 23:59:59", "1970-01-01 00:00:00"]
    assert strs(gen._fmt_date(torch.tensor([gen.day("1998-09-02")]))) == [
        "1998-09-02"]
    q = gen._quote(*gen._fmt_choice(torch.tensor([0, 1, 2]),
                                    ['a"b', "x,y", "plain"]))
    assert strs(q) == ['"a""b"', '"x,y"', "plain"]
