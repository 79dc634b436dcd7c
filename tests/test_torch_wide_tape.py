"""The packed tape's byte positions past 2**31 bytes, on the CPU with no
2 GiB allocation: the plain rank-select's int64 answers where row * 512
passes 2**31 (words of 2**22 and more rows, most of them zero), the byte
window's arithmetic on int64 starts, the int32 path of a small tape, the
refusal of a structural count past int32, the rehearsal at 1 MiB of the
card test's CSV, and the benchmark's configuration and readers of the
quarter's cell."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import csv_simd_tpu_torch as ct
from csv_simd_tpu_torch.device_tape import (
    _byte_window,
    _masked_take,
    _position_dtype,
)
from csv_simd_tpu_torch.offsetfree import (
    PackedDeviceTape,
    _kth_positions,
    _kth_positions_plain,
    _serve,
)
from csv_simd_tpu_torch.utils.metrics import GLOBAL

from wide_cases import FIELDS, PastCsv, check_tape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes side by side on the same cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _calls(name: str) -> int:
    st = GLOBAL.stages.get(name)
    return st.calls if st is not None else 0


def test_position_dtype_turns_at_two_gib():
    assert _position_dtype(0) == torch.int32
    assert _position_dtype(2**31 - 1) == torch.int32
    assert _position_dtype(2**31) == torch.int64
    assert _position_dtype(6 * 10**9) == torch.int64


def _sparse_words(rows: int, tail: int, seed: int) -> tuple:
    """(words (rows, 16) int32: zero but for one set bit in 64 rows before
    the last `tail` and random words in those, their inclusive row
    prefix, the flat positions of every set bit in order)."""
    rng = np.random.default_rng(seed)
    words = torch.zeros((rows, 16), dtype=torch.int32)
    lone = np.sort(rng.choice(rows - tail, 64, replace=False))
    bit = rng.integers(0, 512, lone.size)
    dense = rng.integers(-2**31, 2**31, (tail, 16), dtype=np.int64).astype(
        np.int32)
    wn = words.numpy()
    wn[lone, bit // 32] = (np.uint32(1) << (bit % 32).astype(np.uint32)
                           ).view(np.int32)
    wn[rows - tail:] = dense
    bits = np.unpackbits(dense.view(np.uint8), bitorder="little").reshape(
        tail, 512)
    counts = np.zeros(rows, np.int64)
    counts[lone] = 1
    counts[rows - tail:] = bits.sum(1)
    cum = torch.from_numpy(np.cumsum(counts).astype(np.int32))
    r, b = np.nonzero(bits)
    where = np.concatenate([lone.astype(np.int64) * 512 + bit,
                            (r.astype(np.int64) + rows - tail) * 512 + b])
    return words, cum, where


def test_plain_rank_select_answers_int64_past_two_gib():
    """Words of 2**22 + 64 rows cover 2**31 + 32 KiB: every k, the lone
    bits before row 2**22 and the random words from it on, answers in
    int64, positions past 2**31 included, as np.nonzero reckons them; both
    layouts, and through `_kth_positions` counted as wide."""
    rows = (1 << 22) + 64
    words, cum, where = _sparse_words(rows, 64, seed=5)
    ks = torch.arange(where.size, dtype=torch.int32)
    for layout in (words, words.view(-1, 128)):
        got = _kth_positions_plain(layout, cum, ks)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), where)
    assert where.max() > 2**31 and where.min() < 2**31
    before = _calls("offsetfree.kth_wide_queries")
    got = _kth_positions(words.view(-1, 128), cum, ks[-100:])
    assert np.array_equal(got.numpy(), where[-100:])
    assert _calls("offsetfree.kth_wide_queries") == before + 100


def test_plain_rank_select_on_repeated_rows_needs_no_copy():
    """Words that are one row repeated 2**23 + 8 times (a stride-0 view: 64
    bytes of memory standing for 4 GiB of input): k's position is k * 512
    plus the bit, in int64, past 2**32 at the last k."""
    rows = (1 << 23) + 8
    one = torch.zeros((1, 16), dtype=torch.int32)
    one[0, 9] = 1 << 5  # bit 9 * 32 + 5 of every row
    cum = torch.arange(1, rows + 1, dtype=torch.int32)
    ks = torch.tensor([0, 1, rows // 2, rows - 1], dtype=torch.int32)
    got = _kth_positions_plain(one.expand(rows, 16), cum, ks)
    assert got.dtype == torch.int64
    assert torch.equal(got, ks.to(torch.int64) * 512 + 9 * 32 + 5)
    assert int(got[-1]) > 2**32


@pytest.mark.parametrize("rows,wide", [((1 << 23) + 8, True),
                                       ((1 << 22) - 8, False)])
def test_serve_counts_each_query_twice_as_wide(rows, wide):
    """A serve counts its queries' two k (start and end bit) as wide on
    words that cover 2**31 bytes or more, and 0 (the counter present)
    under: one row with one set bit repeated (a stride-0 view), one field
    a record, so each field is the 511 bytes between two rows' bits, at
    int64 positions past 2**31 on the wide words."""
    one = torch.zeros((1, 16), dtype=torch.int32)
    one[0, 9] = 1 << 5  # bit 293 of every row
    words = one.expand(rows, 16)
    cum = torch.arange(1, rows + 1, dtype=torch.int32)
    data = torch.arange(4096, dtype=torch.int64).remainder(251).to(
        torch.uint8)
    records = torch.tensor([0, rows // 2, rows - 2, rows - 1, -1],
                           dtype=torch.int32)
    before = _calls("offsetfree.kth_wide_queries")
    out, lengths, valid = _serve(data, words, cum, records,
                                 torch.zeros(5, dtype=torch.int32), 1, 1,
                                 rows, 8)
    assert GLOBAL.stages["offsetfree.kth_wide_queries"].counter
    assert _calls("offsetfree.kth_wide_queries") == before + (10 if wide
                                                              else 0)
    assert valid.tolist() == [True, True, True, False, False]
    assert lengths.tolist() == [511, 511, 511, 0, 0]
    # the bytes are read at positions clamped into the 4,096 here
    assert out[3:].eq(0).all() and out[2].eq(data[-1]).all()


def test_byte_window_reads_int64_starts_past_two_gib():
    """The window of int64 starts past 2**31: the positions handed to
    `take` are int64 and exact, the lengths int32, the bytes those at the
    positions, cut at the field's end, and an invalid query's zero."""
    base = 2**31 + 1000
    data = torch.arange(4096, dtype=torch.int64).remainder(251).to(
        torch.uint8)
    starts = torch.tensor([0, 7, 4000, 3], dtype=torch.int64) + base
    ends = torch.tensor([5, 7, 4090, 40], dtype=torch.int64) + base
    valid = torch.tensor([True, True, True, False])
    seen = []

    def take(d, pos, keep):
        seen.append(pos.clone())
        return _masked_take(d, pos - base, keep)

    out, lengths, v = _byte_window(data, starts, ends, valid, 16, take=take)
    assert seen[0].dtype == torch.int64
    assert int(seen[0][2, 15]) == base + 4015 > 2**31
    assert lengths.dtype == torch.int32
    assert lengths.tolist() == [5, 0, 90, 0]
    assert out[0, :5].tolist() == data[:5].tolist()
    assert out[0, 5:].eq(0).all() and out[1].eq(0).all()
    assert out[2].tolist() == data[4000:4016].tolist()
    assert out[3].eq(0).all() and torch.equal(v, valid)


def test_small_create_packed_keeps_int32_positions(tmp_path):
    """Under 2 GiB the tape's positions stay int32 and none is counted as
    wide, while the counter is registered."""
    path = tmp_path / "s.csv"
    path.write_bytes(b"a,b\n1,22\n333,4\n")
    tape = ct.create_packed(path, device="cpu")
    before = _calls("offsetfree.kth_wide_queries")
    pos = _kth_positions(tape.words, tape.cum_incl,
                         torch.arange(6, dtype=torch.int32))
    assert pos.dtype == torch.int32
    assert pos.tolist() == [1, 3, 5, 8, 12, 14]
    assert GLOBAL.stages["offsetfree.kth_wide_queries"].counter
    assert _calls("offsetfree.kth_wide_queries") == before
    out, lengths, _ = tape.gather_fields([0, 1], [1, 0], 8)
    assert lengths.dtype == torch.int32 and lengths.tolist() == [2, 3]


def test_a_structural_count_past_int32_is_refused():
    """A wide tape whose int32 row prefix wrapped (its structural count
    reached 2**31) raises, whatever the prefix's last entry reads."""
    tape = PackedDeviceTape(b"a,b\n1,2\n", device="cpu")
    rows = 1 << 22  # 2 GiB of words: a wide tape
    tape.words = torch.zeros((1, 16), dtype=torch.int32).expand(rows, 16)
    cum = torch.full((rows,), 4, dtype=torch.int32)
    cum[rows // 2] = -(2**31) + 300  # passed 2**31 there
    tape.cum_incl = cum
    with pytest.raises(ValueError, match="2\\*\\*31 or more delimiters"):
        tape._set_stride()
    tape.cum_incl = torch.full((rows,), 4, dtype=torch.int32)
    tape._set_stride()
    assert tape.record_cnt == 2


def test_the_card_tests_csv_at_one_mib_on_the_cpu(tmp_path):
    """The CSV of the card test past 2**31, built to pass 1 MiB instead:
    its quoted field straddles the byte, and create_packed's tape agrees
    with the reckoning on records before, across and past it."""
    case = PastCsv(1 << 20)
    lo, hi = case.straddle
    assert lo < (1 << 20) < hi - 4096 and case.data.size > (1 << 20)
    path = tmp_path / "past.csv"
    case.data.tofile(path)
    tape = ct.create_packed(path, device="cpu")
    records = case.records(np.random.default_rng(3), 500)
    assert check_tape(tape, case, records) > 1 << 20
    assert case.ends().shape[1] == FIELDS


# -- the benchmark's quarter of taxi trips -------------------------------

def _load(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def test_quarter_configuration_is_january_over_the_quarter():
    """The quarter's file is January's columns and formats, with pickups
    over the quarter's 90 days, at the three files' published rows."""
    jan = _load("benchmark", "configs", "nyc-taxi-yellow-2015-01.json")
    q1 = _load("benchmark", "configs", "nyc-taxi-yellow-2015-q1.json")
    files = q1["published"]["files"]
    assert [f["rows"] for f in files] == [12748986, 12450521, 13351609]
    assert q1["rows"] == q1["published"]["rows"] == 38551116 == \
        sum(f["rows"] for f in files)
    assert q1["reduced"] == {}
    assert q1["derive"] == jan["derive"]
    assert len(q1["columns"]) == len(jan["columns"]) == 19
    for a, b in zip(q1["columns"], jan["columns"]):
        assert a["name"] == b["name"] and a["format"] == b["format"]
        if a["name"] != "tpep_pickup_datetime":
            assert a["value"] == b["value"]
    assert "90 * 86400" in q1["columns"][1]["value"]
    spec = _load("BENCHMARK.json")
    (cfg,) = [c for c in spec["configs"] if c["name"] == q1["name"]]
    assert cfg["source"] == q1["source"] and len(cfg["source"]) <= 200
    assert cfg["reduced"] == []


def test_quarter_pickups_span_the_quarter():
    from benchmark import gen

    q1 = _load("benchmark", "configs", "nyc-taxi-yellow-2015-q1.json")
    table = gen.Table(q1, 2**33 + 7, "cpu", rows=4000)
    pick = table.values["tpep_pickup_datetime"]
    lo = gen.sec("2015-01-01 00:00:00")
    assert int(pick.min()) >= lo
    assert int(pick.max()) < gen.sec("2015-04-01 00:00:00")
    assert int(pick.max()) >= gen.sec("2015-03-01 00:00:00")


def test_uniform_lookup_traffic_is_ycsb_c_with_uniform_keys():
    zipf = _load("benchmark", "traffic", "ycsb-c-packed.json")
    uni = _load("benchmark", "traffic", "ycsb-c-uniform-packed.json")
    assert uni["keys"] == {"dist": "uniform"}
    rest = {k: v for k, v in uni.items() if k not in ("keys", "about")}
    assert rest == {k: v for k, v in zipf.items()
                    if k not in ("keys", "about")}


def _canned(spans: dict, steps: int = 3):
    from benchmark.trace import ITER_SPAN, Trace

    host = [{"name": ITER_SPAN, "cat": "user_annotation", "ts": 0.0,
             "dur": 100.0}]
    kernel = [{"name": "k", "cat": "kernel", "ts": 1.0, "dur": 1.0}]
    return Trace(kernel, host, {"steps": steps, "units": 6e9,
                                "file_bytes": 6 * 10**9}, dict(spans))


@pytest.mark.parametrize("name", ["build_ms.packed_wide",
                                  "wide_kth_queries.ingest"])
def test_quarter_readers_read_the_program_and_none_without_it(name):
    from benchmark import run

    read = run.load_reader("metrics", name)
    spans = {"offsetfree.build": (3.3, 3),
             "offsetfree.kth_wide_queries": (0.0, 3 * 38_912)}
    want = {"build_ms.packed_wide": 1100.0,
            "wide_kth_queries.ingest": 38_912.0}[name]
    assert read(_canned(spans)) == pytest.approx(want)
    assert read(_canned({})) is None
    if name == "wide_kth_queries.ingest":
        assert read(_canned({"offsetfree.kth_wide_queries": (0.0, 0)})) == 0


@pytest.mark.parametrize("cell", ["taxi-q1-ingest-packed",
                                  "taxi-lookup-uniform"])
def test_quarter_cells_run_small_on_the_cpu(cell, monkeypatch):
    """Each new cell through the harness at 1,500 rows on the CPU: the
    plain versions, correct, with its end-to-end metrics."""
    from benchmark import run

    load = run.load_json

    def small(kind, name):
        d = copy.deepcopy(load(kind, name))
        if kind == "traffic":
            d["pool_batches"] = 16
        return d

    monkeypatch.setattr(run, "load_json", small)
    spec = run.load_spec(run.ROOT)
    out = run.run_cell(spec, cell, 2**31 + 24, 0.2, False, device="cpu",
                       rows=1500)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0
    want = {"taxi-q1-ingest-packed": {"ingest_GBps", "setup_s"},
            "taxi-lookup-uniform": {"lookups_per_s", "lookup_p99_ms",
                                    "setup_s"}}[cell]
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("n", [0, 7, (1 << 20) - 1, 1 << 20,
                               (1 << 20) + 13, 9_000_011])
def test_the_upload_fill_copies_every_byte_on_the_pool(n):
    """The staging buffers' fill, cut over the copy threads above 1 MiB
    (and on one thread below it), copies every byte, odd sizes and the
    last part's remainder included."""
    from csv_simd_tpu_torch.offsetfree import _fill

    src = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    dst = np.full(n + 3, 7, np.uint8)
    _fill(dst[:n], src)
    assert np.array_equal(dst[:n], src) and (dst[n:] == 7).all()
