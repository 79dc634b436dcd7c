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


# --- kernel E1's plain version and the card index's hand-over -----------

E1_CASES = {
    "quoted_commas_newlines": b'a,b,c\n"x,y",2,"3\n4"\n"",",",\n',
    "crlf": b'a,b\r\n1,"2\r\n3"\r\n4,5\r\n',
    "empty": b"",
    "no_structural_byte": b"abcdef" * 100,
    "odd_size": (b'id,"n,m"\n' + b'7,"q\nr"\n' * 125)[:1000],
    "past_one_tile": b"a,bb,ccc\n" * 40_000,
}


def _fold_words(arr: np.ndarray, td, tile: int):
    """B3's plain fold-layout words of `arr` at fold tile `tile`."""
    from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
    from csv_simd_tpu_torch.ops.stage1_v3 import stage1_fused

    w = torch.from_numpy(pad_to_words(arr, row_align=tile))
    return stage1_fused(w, 0, td, row_tile=tile)[0]


@pytest.mark.parametrize("tile", [8, 64, 512])
@pytest.mark.parametrize("name", list(E1_CASES))
def test_fold_offsets_plain_matches_golden_and_jax(name, tile):
    """E1's plain version (`ops.stage1_v3.fold_offsets` on a CPU tensor)
    on B3's words: golden.structural_index and the JAX build_index, the
    0 included, for sizes that are no multiple of 512 or of the tile."""
    from csv_simd_tpu_torch.ops.stage1_v3 import fold_offsets

    arr = np.frombuffer(E1_CASES[name], dtype=np.uint8)
    for kw in DIALECTS.values():
        jd, td = csv_simd_tpu.Dialect(**kw), ct.Dialect(**kw)
        got = fold_offsets(_fold_words(arr, td, tile), tile, arr.size)
        assert got.dtype == torch.int32
        want = golden.structural_index(arr, jd)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), jbuild_index(arr, jd, backend="jnp"))


@pytest.mark.parametrize("cut", [0, 1, 511, 512, 513, 4097])
def test_fold_offsets_plain_drops_bits_past_n_bytes(cut):
    """Set bits at and past n_bytes (in the last row and in padding rows)
    are dropped, as native.extract_offsets_v3 drops them."""
    from csv_simd_tpu_torch import native
    from csv_simd_tpu_torch.ops.stage1_v3 import fold_offsets

    rng = np.random.default_rng(cut)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 128),
                                          dtype=np.int64).astype(np.int32))
    got = fold_offsets(words, 64, cut).numpy()
    assert got[0] == 0 and np.all(got[1:] < cut)
    assert np.all(np.diff(got[1:]) > 0)
    if native.available():
        np.testing.assert_array_equal(
            got[1:], native.extract_offsets_v3(words.numpy(), 64, cut))
    mask = ct.ops.stage1_v3.unpack_packed_host(words.numpy(), cut, tile=64)
    np.testing.assert_array_equal(got[1:], np.flatnonzero(mask))


@pytest.mark.parametrize("words,tile,n_bytes", [
    (torch.zeros((8, 128), dtype=torch.int32), 12, 10),
    (torch.zeros((8, 128), dtype=torch.int32), 128, 10),
    (torch.zeros((8, 128), dtype=torch.int32), 64, 2**31),
    (torch.zeros((8, 128), dtype=torch.int32), 64, -1),
    (torch.zeros((8, 64), dtype=torch.int32), 64, 10),
    (torch.zeros((8, 128), dtype=torch.int64), 64, 10),
    (torch.zeros((0, 128), dtype=torch.int32), 8, 0),
])
def test_fold_offsets_refuses_bad_input(words, tile, n_bytes):
    from csv_simd_tpu_torch.ops.stage1_v3 import fold_offsets

    with pytest.raises(ValueError):
        fold_offsets(words, tile, n_bytes)


def _count(name: str) -> int:
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    st = GLOBAL.stages.get(name)
    return st.calls if st is not None else 0


@pytest.mark.parametrize("backend", ["torch", "native", "golden", "auto"])
def test_from_tape_uploads_a_tape_without_a_card_index(backend):
    """A Tape built off the card holds no device index: from_tape casts
    and uploads its host index, and device_tape.index_shared stays."""
    data = b'a,b\n"x,\ny",2\n3,4\n' * 50
    tape = ct.create_from_bytes(data, backend=backend, device="cpu")
    assert tape._device_index is None
    shared, uploads = (_count("device_tape.index_shared"),
                       _count("device_tape.index_upload"))
    dt = ct.DeviceTape.from_tape(tape, device="cpu")
    assert _count("device_tape.index_shared") == shared
    assert _count("device_tape.index_upload") == uploads + 1
    assert dt.index.dtype == torch.int32
    np.testing.assert_array_equal(dt.index.numpy(), tape.index)
    jdt = csv_simd_tpu.DeviceTape.from_tape(
        csv_simd_tpu.create_from_bytes(data, backend="jnp"))
    recs = np.arange(-1, tape.record_cnt + 1, dtype=np.int32)
    for f in range(3):
        flds = np.full(recs.size, f - 1, np.int32)
        for g, w in zip(dt.gather_fields(recs, flds, 16),
                        jdt.gather_fields(recs, flds, 16)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype,shared", [(torch.int32, True),
                                          (torch.int64, False)])
def test_from_tape_takes_a_device_index_on_its_device(dtype, shared):
    """A Tape that holds its index on the requested device hands that
    tensor to the DeviceTape (the same object when it is int32, so no
    cast, copy or upload), counted by device_tape.index_shared."""
    data = b"a,b,c\n1,2,3\n4,5,6\n"
    host = ct.create_from_bytes(data, backend="native", device="cpu")
    card = torch.from_numpy(host.index.astype(np.int32)).to(dtype)
    tape = ct.Tape(data, host.index, host.header, device_index=card)
    before = _count("device_tape.index_shared")
    dt = ct.DeviceTape.from_tape(tape, device="cpu")
    assert _count("device_tape.index_shared") == before + 1
    assert (dt.index is card) == shared
    assert dt.index.dtype == torch.int32
    assert dt.gather_fields([1], [2])[0][0, 0] == ord("6")


def test_device_tape_guard_reads_a_tensor_index_without_copying_it():
    """The 2 GiB guard holds for a tensor index too: an int64 index whose
    last entry addresses 2**31 or more is refused."""
    index = torch.tensor([0, 5, 2**31], dtype=torch.int64)
    with pytest.raises(ValueError, match="2 GiB"):
        ct.DeviceTape(b"x" * 8, index, 1, 1, 2, device="cpu")
    ok = ct.DeviceTape(b"ab\ncd\n", torch.tensor([0, 2, 5]), 1, 1, 2,
                       device="cpu")
    assert ok.index.dtype == torch.int32
