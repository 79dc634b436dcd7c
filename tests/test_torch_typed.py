"""The port's decode module and the typed, decoded and filter columns of
its device tapes against the JAX package's, on the CPU.

Every case of tests/test_decode.py and tests/test_device_parse.py runs
through the port, on `DeviceTape` and on `PackedDeviceTape` ("device" and
"packed"): the same bytes go to the JAX tape and the port's tape
(device="cpu"), the same column call runs on both, and the results must
be equal, floats bit for bit (compared as int32), `ok` flags included;
the cases' own expected values hold on the port too. Beside them: the
float32 parses on random fields, on fields whose value is subnormal in
float32 (XLA flushes those to zero, and so must the port) and with
exponents -60..60; the power-of-ten table against jnp.power; and the
decode on random quoted fields. Tolerance: exact everywhere."""

import datetime
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as ct
from csv_simd_tpu import device_tape as jdt
from csv_simd_tpu import golden
from csv_simd_tpu.decode import DecodedView as JDecodedView
from csv_simd_tpu.decode import decode_field as j_decode_field
from csv_simd_tpu.decode import decode_str as j_decode_str
from csv_simd_tpu_torch import device_tape as pdt
from csv_simd_tpu_torch.decode import DecodedView, decode_field, decode_str

from corpus import basic_cases, synthetic_wide_table

KINDS = ("device", "packed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _tapes(data: bytes, kind: str, dialect: dict | None = None):
    """(JAX tape, port tape) over the same bytes."""
    kw = dialect or {}
    if kind == "device":
        jt = jdt.DeviceTape.from_tape(jx.create_from_bytes(
            data, jx.Dialect(**kw), backend="golden"))
        pt = ct.DeviceTape.from_tape(ct.create_from_bytes(
            data, ct.Dialect(**kw), backend="golden", device="cpu"),
            device="cpu")
    else:
        jt = jx.PackedDeviceTape(data, jx.Dialect(**kw))
        pt = ct.PackedDeviceTape(data, ct.Dialect(**kw), device="cpu")
    return jt, pt


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want) -> None:
    """Exact equality of two results (tuples, lists of bytes or arrays):
    same dtypes and shapes, floats bit for bit."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, list):
        assert got == want
        return
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    if w.dtype == np.float32:
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    else:
        np.testing.assert_array_equal(g, w)


def _both(data: bytes, kind: str, method: str, *args, dialect=None, **kw):
    """Run tape.method(*args, **kw) on the JAX tape and the port's tape
    of `data`; assert equal results and return the port's as numpy."""
    jt, pt = _tapes(data, kind, dialect)
    want = getattr(jt, method)(*args, **kw)
    got = getattr(pt, method)(*args, **kw)
    _same(got, want)
    if isinstance(got, tuple):
        return tuple(_np(x) for x in got)
    return got if isinstance(got, list) else _np(got)


def _rows(rows) -> bytes:
    return ("\n".join(rows) + "\n").encode()


def _batch(fields, max_len: int):
    """Fields as a gathered batch (out (N, max_len) uint8, TRUE lengths
    int32, valid bool), numpy, as both packages' parsers take it."""
    out = np.zeros((len(fields), max_len), np.uint8)
    lengths = np.zeros(len(fields), np.int32)
    for i, f in enumerate(fields):
        b = f[:max_len]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(f)
    return out, lengths, np.ones(len(fields), bool)


def _parse_both(name: str, fields, max_len: int):
    """jdt.name and pdt.name on the same batch: equal results, returned."""
    out, lengths, valid = _batch(fields, max_len)
    want = getattr(jdt, name)(out, lengths, valid)
    got = getattr(pdt, name)(torch.from_numpy(out), torch.from_numpy(lengths),
                             torch.from_numpy(valid))
    _same(got, want)
    return tuple(_np(x) for x in got)


# -- tests/test_decode.py --

def test_decode_field_basics():
    cases = [
        (b"plain", b"plain"), (b'"quoted"', b"quoted"), (b'"a,b"', b"a,b"),
        (b'"he said ""hi"""', b'he said "hi"'), (b"  padded  ", b"padded"),
        (b' "q" ', b"q"), (b'"  inner  "', b"  inner  "), (None, None),
        (b'"', b'"'), (b'""', b""),
    ]
    for raw, want in cases:
        assert decode_field(raw) == want == j_decode_field(raw)
        assert decode_str(raw) == j_decode_str(raw)
    assert decode_field(b"  padded  ", trim=False) == b"  padded  "


def test_decode_custom_dialect():
    d = ct.Dialect(delimiter=0x3B, quote=0x27)
    assert decode_field(b"'x;y'", d) == b"x;y"
    assert decode_field(b"'it''s'", d) == b"it's"


def test_decoded_view_matches_python_csv():
    """With decoding, the port's values equal Python csv's parse."""
    import csv as pycsv

    for case in basic_cases():
        if not case.should_build or case.name in (
            "unterminated_quote_masks_rest",
            "mac_cr_endings",  # python csv's \r-only handling differs
        ):
            continue
        text = case.data.decode("utf-8")
        if text.startswith("﻿"):
            text = text[1:]
        rows = list(pycsv.reader(io.StringIO(text)))
        tape = ct.create_from_bytes(case.data, backend="golden", device="cpu")
        view = DecodedView(tape, trim=False)
        for r in range(tape.num_data_records):
            for f in range(tape.field_cnt):
                assert view.seek_field_str(r, f) == rows[r + 1][f], \
                    (case.name, r, f)


def test_typed_columns():
    data = b"id,score\n1,2.5\n2,3.5\n3,4.0\n"
    view = DecodedView(ct.create_from_bytes(data, backend="golden",
                                            device="cpu"))
    np.testing.assert_array_equal(view.column_int(0), [1, 2, 3])
    np.testing.assert_array_equal(view.column_float(1), [2.5, 3.5, 4.0])


def test_decoded_rows_iter():
    data = b'a,b\n1,"x,y"\n2,z\n'
    view = DecodedView(ct.create_from_bytes(data, backend="golden",
                                            device="cpu"))
    assert list(view.iter_rows()) == [[b"1", b"x,y"], [b"2", b"z"]]
    assert view.row(99) is None
    jview = JDecodedView(jx.create_from_bytes(data, backend="golden"))
    assert list(view.iter_rows()) == list(jview.iter_rows())


def test_streaming_checkpoint_resume(tmp_path):
    data = synthetic_wide_table(120_000)
    cut = 53_211
    b1 = ct.StreamingIndexBuilder(backend="torch", device="cpu")
    b1.feed(data[:cut])
    p = str(tmp_path / "ckpt.npz")
    b1.save(p)
    b2 = ct.StreamingIndexBuilder.load(p, backend="torch", device="cpu")
    assert b2.bytes_consumed == cut
    assert b2.quote_parity == b1.quote_parity
    b2.feed(data[cut:])
    np.testing.assert_array_equal(b2.finish(), golden.structural_index(data))


DECODE_DATA = (
    b"a,b,c\n"
    b'1,"x,y",  pad  \n'
    b'"he said ""hi""",2,3\n'
    b' "q" ,"""",  \n'
    b'"  inner  ",plain,"5"\n'
)


@pytest.mark.parametrize("kind", KINDS)
def test_device_decode_matches_decoded_view(kind):
    view = DecodedView(ct.create_from_bytes(DECODE_DATA, backend="golden",
                                            device="cpu"))
    for f in range(3):
        got = _both(DECODE_DATA, kind, "column_decoded", f, max_len=32)
        assert got == view.column(f), f


@pytest.mark.parametrize("kind", KINDS)
def test_device_decode_no_trim(kind):
    data = b"a,b\n  x  ,\"  y  \"\n"
    view = DecodedView(ct.create_from_bytes(data, backend="golden",
                                            device="cpu"), trim=False)
    for f in range(2):
        got = _both(data, kind, "column_decoded", f, max_len=16, trim=False)
        assert got == view.column(f)


@pytest.mark.parametrize("kind", KINDS)
def test_device_decode_corpus(kind):
    built = 0
    for case in basic_cases():
        if not case.should_build:
            continue
        if kind == "packed":
            try:
                jx.PackedDeviceTape(case.data)
            except jx.InvalidCsvFormat:
                with pytest.raises(ct.InvalidCsvFormat):
                    ct.PackedDeviceTape(case.data, device="cpu")
                continue
        view = DecodedView(ct.create_from_bytes(case.data, backend="golden",
                                                device="cpu"))
        jt, pt = _tapes(case.data, kind)
        for f in range(view._tape.field_cnt):
            got = pt.column_decoded(f, max_len=96)
            assert got == jt.column_decoded(f, max_len=96), (case.name, f)
            assert got == view.column(f), (case.name, f)
        built += 1
    assert built >= 5


@pytest.mark.parametrize("kind", KINDS)
def test_device_decode_custom_dialect(kind):
    d = dict(delimiter=0x3B, quote=0x27)
    data = b"a;b\n'x;y';'it''s'\n"
    view = DecodedView(ct.create_from_bytes(data, ct.Dialect(**d),
                                            backend="golden", device="cpu"),
                       dialect=ct.Dialect(**d))
    jt, pt = _tapes(data, kind, d)
    for f in range(2):
        got = pt.column_decoded(f, max_len=16, dialect=ct.Dialect(**d))
        assert got == jt.column_decoded(f, max_len=16,
                                        dialect=jx.Dialect(**d))
        assert got == view.column(f)


@pytest.mark.parametrize("kind", KINDS)
def test_device_decode_offsetfree(kind):
    data = b'a,b\n"x,""z""",  2  \nplain,"y"\n'
    view = DecodedView(ct.create_from_bytes(data, backend="golden",
                                            device="cpu"))
    recs = np.array([0, 0, 1, 1])
    flds = np.array([0, 1, 0, 1])
    jt, pt = _tapes(data, kind)
    got = pt.gather_decoded(recs, flds, max_len=24)
    _same(got, jt.gather_decoded(recs, flds, max_len=24))
    want = [view.seek_field(int(r), int(f)) for r, f in zip(recs, flds)]
    assert pt.to_host_lists(*got) == want


@pytest.mark.parametrize("kind", KINDS)
def test_float_exp_parse(kind):
    data = (
        b"a,b\n"
        b"1.5e3,x\n"
        b"-2.25E-2,x\n"
        b"1e0,x\n"
        b"+.5e1,x\n"
        b"3.,x\n"
        b"7,x\n"
        b" 42e1,x\n"
        b"bad e,x\n"
        b"1e,x\n"
        b"1e+,x\n"
        b"2e3q,x\n"
        b"1.2.3e1,x\n"
    )
    vals, ok = _both(data, kind, "column_float32_exp", 0)
    want = [1500.0, -0.0225, 1.0, 5.0, 3.0, 7.0, 420.0]
    assert ok[:7].all() and not ok[7:].any(), ok
    np.testing.assert_allclose(vals[:7], np.float32(want), rtol=1e-6)


# -- tests/test_device_parse.py --

@pytest.mark.parametrize("kind", KINDS)
def test_column_int32(kind):
    data = _rows(["id,v", "1,42", "2,-17", "3,0", "4,2147483647", "5, 88"])
    vals, ok = _both(data, kind, "column_int32", 1)
    assert ok.all()
    np.testing.assert_array_equal(vals, [42, -17, 0, 2147483647, 88])


@pytest.mark.parametrize("kind", KINDS)
def test_column_int32_malformed(kind):
    data = _rows(["id,v", "1,42", "2,abc", "3,", "4,1.5", "5,+7"])
    vals, ok = _both(data, kind, "column_int32", 1)
    np.testing.assert_array_equal(ok, [True, False, False, False, True])
    assert vals[0] == 42 and vals[4] == 7


@pytest.mark.parametrize("kind", KINDS)
def test_column_float32(kind):
    data = _rows(["id,v", "1,3.5", "2,-0.25", "3,100", "4,2.", "5,.5",
                  "6, 7.125"])
    vals, ok = _both(data, kind, "column_float32", 1)
    assert ok.all()
    np.testing.assert_array_equal(vals, np.float32(
        [3.5, -0.25, 100.0, 2.0, 0.5, 7.125]))


@pytest.mark.parametrize("kind", KINDS)
def test_column_float32_malformed(kind):
    data = _rows(["id,v", "1,1e5", "2,1.2.3", "3,nope", "4,8"])
    vals, ok = _both(data, kind, "column_float32", 1)
    np.testing.assert_array_equal(ok, [False, False, False, True])
    assert vals[3] == 8.0


@pytest.mark.parametrize("kind", KINDS)
def test_column_int_random_differential(kind):
    rng = np.random.default_rng(5)
    nums = rng.integers(-(2**31) + 1, 2**31 - 1, 300)
    data = _rows(["a,b"] + [f"{i},{v}" for i, v in enumerate(nums)])
    vals, ok = _both(data, kind, "column_int32", 1)
    assert ok.all()
    np.testing.assert_array_equal(vals, nums.astype(np.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_filter_equals(kind):
    data = _rows(["k,v", "x,1", "y,2", "x,3", "z,4", "x,5"])
    hits = _both(data, kind, "filter_equals", 0, b"x")
    np.testing.assert_array_equal(hits, [0, 2, 4])
    assert hits.dtype == np.int32
    assert _both(data, kind, "filter_equals", 0, b"nope").size == 0
    # a prefix must not match
    assert _both(data, kind, "filter_equals", 0, b"xx").size == 0
    # ids from `records`, as a list and as an array
    for recs in ([4, 1, 2, 0], np.array([3, 4], np.int32)):
        got = _both(data, kind, "filter_equals", 0, b"x", records=recs)
        np.testing.assert_array_equal(
            got, [r for r in np.asarray(recs) if r in (0, 2, 4)])


@pytest.mark.parametrize("kind", KINDS)
def test_int32_overflow_edges(kind):
    data = _rows([
        "a,b",
        "0,-2147483648",   # INT32_MIN: exact, accepted
        "1,2147483648",    # INT32_MAX+1: rejected
        "2,9999999999",    # wraps: rejected
        "3,-6442450944",   # aliases INT32_MIN mod 2^32: rejected
        "4,2147483647",    # INT32_MAX: accepted
    ])
    vals, ok = _both(data, kind, "column_int32", 1)
    np.testing.assert_array_equal(ok, [True, False, False, False, True])
    assert vals[0] == -(2**31) and vals[4] == 2**31 - 1


@pytest.mark.parametrize("kind", KINDS)
def test_column_date_days(kind):
    rows = [
        b"1970-01-01", b"2026-08-17", b"2000-02-29", b"1969-12-31",
        b"0001-01-01", b"9999-12-31", b"2023-02-29", b"2024-13-01",
        b"2024-00-10", b"24-01-01", b"2024/01/01", b"x024-01-01",
    ]
    data = b"d,x\n" + b"".join(r + b",1\n" for r in rows)
    days, ok = _both(data, kind, "column_date_days", 0)
    assert ok[:6].all() and not ok[6:].any(), ok
    epoch = datetime.date(1970, 1, 1)
    for i in range(6):
        want = (datetime.date.fromisoformat(rows[i].decode()) - epoch).days
        assert days[i] == want, (rows[i], days[i], want)


@pytest.mark.parametrize("kind", KINDS)
def test_column_datetime64_differential(kind):
    good = [
        b"1970-01-01 00:00:00", b"2026-08-17T13:45:09",
        b"2000-02-29 23:59:59", b"1969-12-31T23:59:59",
        b"2024-06-01 12:00:00Z", b"0001-01-01T00:00:00",
    ]
    data = b"t,x\n" + b"".join(r + b",1\n" for r in good)
    vals, ok = _both(data, kind, "column_datetime64", 0, unit="s")
    assert ok.all(), ok
    for i, r in enumerate(good):
        txt = r.decode().replace("T", " ").rstrip("Z")
        want = datetime.datetime.fromisoformat(txt).replace(
            tzinfo=datetime.timezone.utc).timestamp()
        assert vals[i] == int(want), (r, vals[i], want)


@pytest.mark.parametrize("kind", KINDS)
def test_column_datetime64_fractions_and_rejects(kind):
    rows = [
        b"2024-01-02 03:04:05.123",   # ms
        b"2024-01-02 03:04:05.5",     # 500 ms
        b"2024-01-02 03:04:05.123456",  # us precision
        b"2024-01-02 03:04:05",
        b"2024-01-02 03:04:05.1234",  # > ms at unit=ms
        b"2024-02-30 03:04:05",       # bad civil date
        b"2024-01-02 24:00:00",       # bad hour
        b"2024-01-02 03:60:00",       # bad minute
        b"2024-01-0203:04:05",        # missing separator
        b"2024-01-02 03:04:05+01:00",  # tz offset unsupported
        b"2024-01-02 03:04:05.",      # dot with no digits
    ]
    data = b"t,x\n" + b"".join(r + b",1\n" for r in rows)
    base = 1704164645000  # 2024-01-02 03:04:05 UTC in ms
    vals, ok = _both(data, kind, "column_datetime64", 0, unit="ms")
    np.testing.assert_array_equal(ok, [True, True, False, True] + [False] * 7)
    assert vals[0] == base + 123 and vals[1] == base + 500
    assert vals[3] == base
    # at unit=s any fraction refuses; at unit=us all three parse
    _, ok_s = _both(data, kind, "column_datetime64", 0, unit="s")
    np.testing.assert_array_equal(ok_s[:4], [False, False, False, True])
    vals_us, ok_us = _both(data, kind, "column_datetime64", 0, unit="us")
    np.testing.assert_array_equal(ok_us[:5], [True] * 5)
    assert vals_us[2] == base * 1000 + 123456
    assert vals_us[4] == base * 1000 + 123400


def test_column_datetime64_packed_and_frame():
    """The packed tape's datetime column (the frame half of the JAX test
    needs frame.py, which the port has not ported)."""
    data = b"t,n\n2024-01-02 03:04:05,1\n2024-01-02T03:04:06.250,2\n"
    vals, ok = _both(data, "packed", "column_datetime64", 0, unit="ms")
    assert ok.all() and vals[1] - vals[0] == 1250


@pytest.mark.parametrize("kind", KINDS)
def test_column_decimal64_basic(kind):
    data = _rows(["id,price", "1,12.34", "2,-0.05", "3,100", "4,7.5",
                  "5,.25", "6,3.", "7, 9.99", "8,+1.01"])
    vals, ok = _both(data, kind, "column_decimal64", 1, scale=2)
    assert ok.all()
    np.testing.assert_array_equal(vals, [1234, -5, 10000, 750, 25, 300, 999,
                                         101])


@pytest.mark.parametrize("kind", KINDS)
def test_column_decimal64_rejects(kind):
    data = _rows(["id,v", "1,1.234", "2,1e3", "3,abc", "4,12..3",
                  "5,9999999999999999999", "6,1.23"])
    vals, ok = _both(data, kind, "column_decimal64", 1, scale=2)
    np.testing.assert_array_equal(ok, [False] * 5 + [True])
    assert vals[5] == 123


@pytest.mark.parametrize("kind", KINDS)
def test_column_decimal64_18_digits_exact(kind):
    big = 10**18 - 1  # 18 nines: the documented ceiling
    data = _rows(["id,v", f"1,{big}", f"2,-{big}", f"3,{10**18}"])
    vals, ok = _both(data, kind, "column_decimal64", 1, scale=0)
    np.testing.assert_array_equal(ok, [True, True, False])
    np.testing.assert_array_equal(vals[:2], [big, -big])


@pytest.mark.parametrize("kind", KINDS)
def test_column_decimal64_differential_host_oracle(kind):
    rng = np.random.default_rng(12)
    cells = []
    for _ in range(400):
        k = rng.integers(0, 6)
        if k == 0:
            cells.append(str(rng.integers(-10**9, 10**9)))
        elif k == 1:
            cells.append(f"{rng.integers(-10**6, 10**6)}."
                         f"{rng.integers(0, 100):02d}")
        elif k == 2:
            cells.append(f"{rng.integers(0, 10)}.{rng.integers(0, 10**4)}")
        elif k == 3:
            cells.append(str(rng.integers(0, 10**17)))
        elif k == 4:
            cells.append(" " + str(rng.integers(-99, 99)) + ".5")
        else:
            cells.append(rng.choice(["", "x", "1e2", ".", "-", "1.2.3"]))
    data = _rows(["a,b"] + [f"{i},{c}" for i, c in enumerate(cells)])
    vals, ok = _both(data, kind, "column_decimal64", 1, scale=2)
    tape = ct.create_from_bytes(data, backend="golden", device="cpu")
    want_vals, want_ok = DecodedView(tape).column_decimal(1, scale=2)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(vals, want_vals)
    assert 100 < ok.sum() < 400


def test_column_decimal64_packed_tape():
    data = _rows(["id,amt", "1,5.25", "2,-12.00", "3,bad.x"])
    vals, ok = _both(data, "packed", "column_decimal64", 1, scale=2)
    np.testing.assert_array_equal(ok, [True, True, False])
    np.testing.assert_array_equal(vals, [525, -1200, 0])


@pytest.mark.parametrize("kind", KINDS)
def test_float32_rejects_digitless(kind):
    """'.', '-.', '+.', ' .' are not numbers, for both float parses."""
    data = b"v\n.\n-.\n+.\n .\n1.\n.5\n2\n"
    vals, ok = _both(data, kind, "column_float32", 0)
    assert ok.tolist() == [False] * 4 + [True] * 3
    assert vals[4:].tolist() == [1.0, 0.5, 2.0]
    _, ok = _both(data, kind, "column_float32_exp", 0)
    assert ok.tolist()[:4] == [False] * 4


@pytest.mark.parametrize("kind", KINDS)
def test_filter_equals_rejects_long_needle(kind):
    """A needle longer than max_len raises instead of comparing a cut
    window (which would match any field that shares its prefix and true
    length)."""
    data = b"v\nabcdYY\nabcdXX\n"
    jt, pt = _tapes(data, kind)
    for tape in (jt, pt):
        with pytest.raises(ValueError, match="max_len"):
            tape.filter_equals(0, b"abcdXX", max_len=4)
    hits = _both(data, kind, "filter_equals", 0, b"abcdXX", max_len=8)
    assert hits.tolist() == [1]


@pytest.mark.parametrize("kind", KINDS)
def test_datetime_window_too_small_raises(kind):
    jt, pt = _tapes(b"t\n2024-01-02 03:04:05\n", kind)
    for tape in (jt, pt):
        with pytest.raises(ValueError, match=">= 21"):
            tape.column_datetime64(0, max_len=20)


# -- beyond the JAX tests: float32 bits, the flush, records, decode fuzz --

SUBNORMAL_FIELDS = [
    b"0." + b"0" * 37 + b"1",     # 1e-38: subnormal, XLA flushes it
    b"-0." + b"0" * 37 + b"1",    # -> -0.0
    b"0." + b"0" * 36 + b"1",     # 1e-37: normal
    b"0." + b"0" * 44 + b"1",     # 1e-45
    b"0.00000000000000000000000000000000000001175494",  # < 2**-126
    b"0.000000000000000000000000000000000000011754944",  # >= 2**-126
]


def test_column_float32_flushes_subnormals():
    """The float32 flush: a field whose float32 value is below 2**-126
    parses to a zero of its sign, as XLA flushes it (torch keeps
    subnormals)."""
    data = b"v\n" + b"\n".join(SUBNORMAL_FIELDS) + b"\n"
    for kind in KINDS:
        vals, ok = _both(data, kind, "column_float32", 0, max_len=48)
        assert ok.all()
        assert vals[0].view(np.int32) == 0
        assert vals[1].view(np.int32) == np.float32(-0.0).view(np.int32)
        assert vals[2] == np.float32(1e-37)
        # past 38 fraction digits the float32 scale is inf: 0 either way
        assert vals[3] == vals[4] == vals[5] == 0.0


def test_ftz_keeps_the_sign_and_normal_values():
    tiny = np.float32(2.0**-126)
    x = torch.tensor([0.0, -0.0, 1e-38, -1e-38, 1e-45, float(tiny),
                      -float(tiny), 1.0, float("inf"), float("nan")],
                     dtype=torch.float32)
    got = pdt._ftz(x).numpy()
    want = np.array([0.0, -0.0, 0.0, -0.0, 0.0, tiny, -tiny, 1.0, np.inf,
                     np.nan], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_pow10_table_matches_jnp_power():
    ks = np.arange(-60, 61, dtype=np.int32)
    want = np.asarray(jnp.power(jnp.float32(10.0),
                                jnp.asarray(ks, jnp.float32)))
    got = pdt._pow10(torch.from_numpy(ks)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # far outside the table: 0 and inf, as jnp.power gives
    far = torch.tensor([-9999, -100, 100, 9999], dtype=torch.int32)
    assert pdt._pow10(far).tolist() == [0.0, 0.0, np.inf, np.inf]


def test_float32_exp_bits_for_exponents_minus60_to_60():
    rng = np.random.default_rng(21)
    fields = []
    for e in range(-60, 61):
        for mant in (b"1", b"9.99", b"123456789", b"-4.2", b"0.000123",
                     b"3.4028235", b"1.1754944"):
            fields.append(mant + b"e" + str(e).encode())
        digits = "".join(map(str, rng.integers(0, 10, 12)))
        fields.append(f"{digits[:5]}.{digits[5:]}E{e:+d}".encode())
    fields += [b"0e999", b"-0e999", b"1e99999", b"5e-39", b"1e-38",
               b"1.5e-40", b"1e39", b"-1e39"]
    vals, ok = _parse_both("_parse_float32_exp", fields, 32)
    assert ok.all()
    # the reference's limits, kept: NaN for 0e999, inf past float32
    assert np.isnan(vals[-8]) and np.isnan(vals[-7])
    assert vals[-6] == np.inf and vals[-2] == np.inf and vals[-1] == -np.inf
    assert (vals[-5:-2] == 0.0).all()


def test_float32_bits_on_random_fields():
    rng = np.random.default_rng(33)
    fields = []
    for _ in range(3000):
        nd = int(rng.integers(1, 22))
        m = "".join(map(str, rng.integers(0, 10, nd)))
        if rng.random() < 0.7:
            k = int(rng.integers(0, nd + 1))
            m = m[:k] + "." + m[k:]
        sign = rng.choice(["", "-", "+", " "])
        fields.append((sign + m).encode())
    for name in ("_parse_float32", "_parse_float32_exp"):
        vals, ok = _parse_both(name, fields, 24)
        assert ok.mean() > 0.9
    exp_fields = [f + b"e" + str(int(rng.integers(-50, 50))).encode()
                  for f in fields]
    _parse_both("_parse_float32_exp", exp_fields, 32)
    _parse_both("_parse_float32", SUBNORMAL_FIELDS, 48)
    _parse_both("_parse_float32_exp", SUBNORMAL_FIELDS, 48)


@pytest.mark.parametrize("kind", KINDS)
def test_typed_columns_on_records(kind):
    data = _rows(["d,t,v", "2024-01-02,2024-01-02 03:04:05.5,1.25",
                  "1999-12-31,1999-12-31T23:59:59,-7e-2",
                  "bad,bad,x", "2000-02-29,2000-02-29 00:00:00Z,12"])
    recs = [3, 0, 2, 1, 0]
    _both(data, kind, "column_date_days", 0, records=recs)
    _both(data, kind, "column_datetime64", 1, unit="ms", records=recs)
    _both(data, kind, "column_float32_exp", 2, records=recs)
    _both(data, kind, "column_decimal64", 2, scale=3, records=recs)
    _both(data, kind, "column_float32", 2, records=recs)


def _quoted_table(rng, n_rows: int) -> bytes:
    """Rows of fields that are plain, padded, quoted, with doubled quotes,
    tabs, empty or all spaces."""
    pieces = ["ab", "x y", "", "  ", "\t", '""', ",", "q"]
    rows = ["a,b,c"]
    for _ in range(n_rows):
        fields = []
        for _ in range(3):
            body = "".join(rng.choice(pieces) for _ in range(rng.integers(
                0, 4)))
            kind = rng.integers(0, 4)
            if kind == 0:
                fields.append(body.replace('"', "").replace(",", ""))
            elif kind == 1:
                fields.append(" " * int(rng.integers(0, 3)) + '"' + body
                              + '"' + "\t" * int(rng.integers(0, 2)))
            elif kind == 2:
                fields.append('"' + body + '"')
            else:
                fields.append(" \t ")
        rows.append(",".join(fields))
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.parametrize("kind", KINDS)
def test_decode_random_quoted_fields(kind):
    rng = np.random.default_rng(44)
    data = _quoted_table(rng, 300)
    view = DecodedView(ct.create_from_bytes(data, backend="golden",
                                            device="cpu"))
    jview = JDecodedView(jx.create_from_bytes(data, backend="golden"))
    for trim in (True, False):
        for f in range(3):
            got = _both(data, kind, "column_decoded", f, max_len=40,
                        trim=trim)
            want = DecodedView(view._tape, trim=trim).column(f)
            assert got == want == JDecodedView(jview._tape,
                                               trim=trim).column(f)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_decoded_refuses_a_cut_window(kind):
    data = b'a\n"0123456789"\n'
    jt, pt = _tapes(data, kind)
    for tape in (jt, pt):
        with pytest.raises(ValueError, match="max_len"):
            tape.gather_decoded(np.array([0]), np.array([0]), max_len=8)
