"""The port's offsets route against the JAX package: `build_index`,
`create` / `create_from_bytes` and the `Tape` they return, on the CPU.

The same bytes go through the port (backend "torch", "native" or
"golden" with device="cpu") and the JAX package (backend "jnp"), and
the indexes, record counts and served fields must be equal. Tolerance
0: these are integer offsets and bytes."""

import os

import numpy as np
import pytest
import torch

import csv_simd_tpu
import csv_simd_tpu_torch as ct
from csv_simd_tpu import golden
from csv_simd_tpu.index import build_index as jbuild_index

from corpus import all_cases, synthetic_wide_table

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


DIALECTS = {
    "default": {},
    "semicolon_apostrophe": dict(delimiter=0x3B, quote=0x27),
}


def _jax_tape(data: bytes, kw: dict):
    """The JAX tape, or the exception type it raises."""
    try:
        return csv_simd_tpu.create_from_bytes(
            data, csv_simd_tpu.Dialect(**kw), backend="jnp")
    except (csv_simd_tpu.InvalidCsvFormat, csv_simd_tpu.errors.InvalidState) as e:
        return type(e).__name__


def _same_tape(pt, jt) -> None:
    np.testing.assert_array_equal(pt.index, jt.index)
    assert pt.index.dtype == np.int64
    assert pt.record_cnt == jt.record_cnt
    assert pt.record_jump_size == jt.record_jump_size
    assert pt.field_cnt == jt.field_cnt
    assert list(pt.header_names()) == list(jt.header_names())
    n = jt.num_data_records
    for r in range(-1, min(n, 40) + 1):
        assert pt.seek_record(r) == jt.seek_record(r)
        for f in range(-1, jt.field_cnt + 1):
            assert pt.seek_field(r, f) == jt.seek_field(r, f)
    for f in range(jt.field_cnt):
        assert pt.column(f) == jt.column(f)


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_build_index_matches_jax_on_corpus(case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    for kw in DIALECTS.values():
        jd, td = csv_simd_tpu.Dialect(**kw), ct.Dialect(**kw)
        want = jbuild_index(arr, jd, backend="jnp")
        np.testing.assert_array_equal(want, golden.structural_index(arr, jd))
        for backend in ("torch", "native", "golden", "auto"):
            got = ct.build_index(arr, td, backend=backend, device="cpu")
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_create_from_bytes_matches_jax(case):
    for kw in DIALECTS.values():
        jt = _jax_tape(case.data, kw)
        for backend in ("torch", "native"):
            if isinstance(jt, str):
                with pytest.raises(Exception) as err:
                    ct.create_from_bytes(case.data, ct.Dialect(**kw),
                                         backend=backend, device="cpu")
                assert type(err.value).__name__ == jt
                continue
            pt = ct.create_from_bytes(case.data, ct.Dialect(**kw),
                                      backend=backend, device="cpu")
            assert isinstance(pt, ct.Tape)
            _same_tape(pt, jt)


@pytest.mark.parametrize("name,data,kw", [
    ("crlf", b"a,b,c\r\n1,2,3\r\n\"x\r\ny\",5,6\r\n", {}),
    ("bom", b"\xef\xbb\xbfid,name\n1,\"a,b\"\n2,c\n", {}),
    ("semicolon", b"a;b\n'x;y';2\n3;'4\n5'\n",
     dict(delimiter=0x3B, quote=0x27)),
    ("escaped_quotes", b'a,b\n"he said ""hi""",2\n3,4\n', {}),
])
def test_create_matches_jax(tmp_path, name, data, kw):
    path = tmp_path / f"{name}.csv"
    path.write_bytes(data)
    jt = csv_simd_tpu.create(str(path), csv_simd_tpu.Dialect(**kw),
                             backend="jnp")
    pt = ct.create(str(path), ct.Dialect(**kw), backend="torch",
                   device="cpu")
    _same_tape(pt, jt)
    assert repr(pt) == repr(jt)


def test_create_ragged_raises_the_jax_message(tmp_path):
    data = b"a,b,c\n1,2,3,\n4,5,6\n"
    path = tmp_path / "ragged.csv"
    path.write_bytes(data)
    with pytest.raises(csv_simd_tpu.InvalidCsvFormat) as want:
        csv_simd_tpu.create(str(path), backend="jnp")
    with pytest.raises(ct.InvalidCsvFormat) as got:
        ct.create(str(path), backend="torch", device="cpu")
    assert str(got.value) == str(want.value)


def test_create_io_errors(tmp_path):
    with pytest.raises(ct.IoError):
        ct.create(str(tmp_path / "missing.csv"), device="cpu")
    empty = tmp_path / "empty.csv"
    empty.write_bytes(b"")
    with pytest.raises(ct.IoError):
        ct.create(str(empty), device="cpu")


def test_backends_that_need_another_device_raise():
    data = b"a,b\n1,2\n"
    for backend in ("pallas", "jnp"):
        with pytest.raises(ValueError, match="counterpart"):
            ct.build_index(data, backend=backend, device="cpu")
    with pytest.raises(ValueError):
        ct.build_index(data, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        ct.create_from_bytes(data, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        ct.build_index(data, backend="vulkan", device="cpu")


def test_validate_utf8(tmp_path):
    path = tmp_path / "ascii.csv"
    path.write_bytes(b"a,b\n1,2\n")
    assert ct.create(str(path), validate_utf8=True, backend="torch",
                     device="cpu").record_cnt == 2
    good = "a,b\né,2\n".encode()
    tape = ct.create_from_bytes(good, validate_utf8=True, backend="torch",
                                device="cpu")
    assert tape.seek_field(0, 0) == csv_simd_tpu.create_from_bytes(
        good, backend="jnp", validate_utf8=True).seek_field(0, 0)
    for bad in (b"a,b\n\xff,2\n", b"a,b\n1,\xe6\x97\n"):
        with pytest.raises(csv_simd_tpu.InvalidCsvFormat, match="UTF-8"):
            csv_simd_tpu.create_from_bytes(bad, backend="jnp",
                                           validate_utf8=True)
        with pytest.raises(ct.InvalidCsvFormat, match="UTF-8"):
            ct.create_from_bytes(bad, validate_utf8=True, backend="torch",
                                 device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tape_artifact_round_trip(tmp_path, direction):
    data = synthetic_wide_table(50_000)
    path = str(tmp_path / "tape.npz")
    if direction == "jax_to_port":
        jt = csv_simd_tpu.create_from_bytes(data, backend="jnp")
        csv_simd_tpu.save_tape(jt, path)
        back = ct.load_tape(path, data)
        src = jt
    else:
        pt = ct.create_from_bytes(data, backend="torch", device="cpu")
        ct.save_tape(pt, path)
        back = csv_simd_tpu.load_tape(path, data)
        src = pt
    np.testing.assert_array_equal(back.index, src.index)
    assert back.record_cnt == src.record_cnt
    assert back.seek_field(10, 3) == src.seek_field(10, 3)


def test_slice_end_to_end_wide_table(tmp_path):
    """The slice on the CPU: create on a few hundred KB of the wide
    table gives JAX's index and serves the same fields."""
    data = synthetic_wide_table(400_000)
    path = tmp_path / "wide.csv"
    path.write_bytes(data)
    pt = ct.create(str(path), backend="torch", device="cpu")
    jt = csv_simd_tpu.create(str(path), backend="jnp")
    np.testing.assert_array_equal(pt.index, jt.index)
    assert pt.record_cnt == jt.record_cnt > 2000
    rng = np.random.default_rng(9)
    for r, f in zip(rng.integers(0, jt.num_data_records, 500),
                    rng.integers(0, 16, 500)):
        assert pt.seek_field(int(r), int(f)) == jt.seek_field(int(r), int(f))
    assert pt.column(0) == jt.column(0)
    dt = ct.DeviceTape.from_tape(pt, device="cpu")
    jdt = csv_simd_tpu.DeviceTape.from_tape(jt)
    recs = rng.integers(-2, jt.record_cnt + 2, 3000).astype(np.int32)
    flds = rng.integers(-1, 17, 3000).astype(np.int32)
    for g, w in zip(dt.gather_fields(recs, flds, 48),
                    jdt.gather_fields(recs, flds, 48)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert os.path.getsize(path) == len(data)
