"""The port's sharded tapes (csv_simd_tpu_torch/parallel/serving.py)
against csv_simd_tpu.parallel.serving on the CPU, bit for bit: every
served byte, length and validity of ShardedTape and ShardedPackedTape
(out-of-range records and fields included), gather_column,
gather_decoded, validate_utf8, the packed_seq artifact loaded in both
directions, from_numpy_state from the JAX tape, and the (row, offset)
arithmetic at shards of 8 rows, where every field crosses a shard cut.
The JAX side runs on the 8-device virtual CPU mesh of conftest.py; the
port on make_mesh(n, device="cpu"). Tolerance 0."""

import os

import numpy as np
import pytest
import torch

from csv_simd_tpu import create_from_bytes
from csv_simd_tpu.artifact import load_tape as jload_tape
from csv_simd_tpu.offsetfree import PackedDeviceTape as JPacked
from csv_simd_tpu.parallel import serving as jserving
from csv_simd_tpu.parallel.sharded import make_mesh as jmake_mesh
from csv_simd_tpu_torch import create_from_bytes as pcreate_from_bytes
from csv_simd_tpu_torch.device_tape import DeviceTape
from csv_simd_tpu_torch.errors import InvalidCsvFormat
from csv_simd_tpu_torch.offsetfree import PackedDeviceTape
from csv_simd_tpu_torch.parallel.serving import ShardedPackedTape, ShardedTape
from csv_simd_tpu_torch.parallel.sharded import make_mesh

from corpus import synthetic_wide_table


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mesh(n):
    return make_mesh(n, device="cpu")


def _queries(tape, n: int, seed: int):
    """n random in-range (record, field) pairs, then out-of-range ones:
    negative and past-the-end records and fields."""
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, tape.num_data_records, n)
    flds = rng.integers(0, tape.field_cnt, n)
    bad_r = [-1, tape.num_data_records, 10**8, 0, 0, -5]
    bad_f = [0, 0, 0, -1, tape.field_cnt, 10**6]
    return (np.concatenate([recs, bad_r]).astype(np.int32),
            np.concatenate([flds, bad_f]).astype(np.int32))


def _same_gather(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w))


def _quoted_csv(rows: int = 3000) -> bytes:
    body = b"".join(b'%d,"val,%d",zz%d\n' % (i, i * 3, i)
                    for i in range(rows))
    return b"a,b,c\n" + body


@pytest.fixture(scope="module")
def offsets_setup():
    data = synthetic_wide_table(200_000)
    jt = create_from_bytes(data, backend="golden")
    pt = pcreate_from_bytes(data, backend="golden")
    return (jt, jserving.ShardedTape.from_tape(jt, jmake_mesh(8)),
            {n: ShardedTape.from_tape(pt, _mesh(n)) for n in (1, 3, 8)})


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sharded_tape_lookups_match_jax(offsets_setup, n):
    jt, jst, pst = offsets_setup
    st = pst[n]
    recs, flds = _queries(jt, 400, n)
    _same_gather(st.gather_fields(recs, flds, max_len=48),
                 jst.gather_fields(recs, flds, max_len=48))
    vals = st.to_host_lists(*st.gather_fields(recs[:64], flds[:64], 48))
    assert vals == [jt.seek_field(int(r), int(f))
                    for r, f in zip(recs[:64], flds[:64])]
    assert st.device == torch.device("cpu") and len(st.data) == n


def test_sharded_tape_refuses_a_2gib_index():
    with pytest.raises(ValueError, match="ShardedPackedTape"):
        ShardedTape(np.zeros(16, np.uint8), np.array([0, 2**31]), 1, 1, 1,
                    _mesh(2))


@pytest.fixture(scope="module")
def packed_setup():
    data = _quoted_csv()
    jt = create_from_bytes(data, backend="golden")
    jst = jserving.ShardedPackedTape(data, jmake_mesh(8))
    return data, jt, jst


@pytest.fixture(scope="module")
def unsharded_tapes(packed_setup):
    """The same bytes on the port's two one-device tapes: DeviceTape (the
    int32 index) and PackedDeviceTape (rank-select)."""
    data = packed_setup[0]
    return (DeviceTape.from_tape(pcreate_from_bytes(data, backend="golden"),
                                 device="cpu"),
            PackedDeviceTape(data, device="cpu"))


@pytest.mark.parametrize("use_pallas", [None, False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_sharded_packed_lookups_match_jax(packed_setup, unsharded_tapes, n,
                                          use_pallas):
    """Every served byte, length and validity against the JAX tape, and
    the same queries (out-of-range records and fields, windows shorter
    than the fields) through DeviceTape and PackedDeviceTape give the
    same answers: one slot arithmetic and one byte window serve all
    three."""
    data, jt, jst = packed_setup
    st = ShardedPackedTape(data, _mesh(n), use_pallas=use_pallas)
    assert (st.record_cnt, st.field_cnt, st.jump, st.num_data_records) == \
        (int(jst.record_cnt), int(jst.field_cnt), int(jst.jump),
         jst.num_data_records)
    # the same prefix over the rows both pads hold, flat past the bytes
    got, want = st.cum_incl.numpy(), np.asarray(jst.cum_incl)
    rows = min(got.size, want.size)
    np.testing.assert_array_equal(got[:rows], want[:rows])
    assert (got[rows:] == want[-1]).all() and (want[rows:] == got[-1]).all()
    recs, flds = _queries(jt, 300, n)
    for max_len in (1, 16, 48):
        got = st.gather_fields(recs, flds, max_len=max_len)
        _same_gather(got, jst.gather_fields(recs, flds, max_len=max_len))
        for tape in unsharded_tapes:
            _same_gather(tape.gather_fields(recs, flds, max_len=max_len),
                         got)
    _same_gather(st.gather_column(2, max_len=16),
                 jst.gather_column(2, max_len=16))
    assert st.to_host_lists(*st.gather_column(1, max_len=16)) == \
        jt.column(1)
    # the layout: words and bytes on the shards, the prefix replicated
    assert len(st.words) == len(st.data) == n
    assert st.cum_incl.dim() == 1 and st.device == torch.device("cpu")
    wide = st.words[0].shape[1] == 128
    assert wide == bool(use_pallas)


def test_sharded_packed_words_match_jax_wide_pipeline(packed_setup):
    """The kernels' wide pipeline (seq_wide) against the JAX one in
    interpret mode: the same words shard for shard."""
    data = synthetic_wide_table(60_000)
    jst = jserving.ShardedPackedTape(data, jmake_mesh(8), use_pallas=True,
                                     interpret=True)
    st = ShardedPackedTape(data, _mesh(8), use_pallas=True)
    np.testing.assert_array_equal(torch.cat(st.words).numpy(),
                                  np.asarray(jst.words))
    jt = create_from_bytes(data, backend="golden")
    recs, flds = _queries(jt, 200, 4)
    _same_gather(st.gather_fields(recs, flds, 48),
                 jst.gather_fields(recs, flds, 48))


def test_sharded_packed_gather_decoded_and_columns(packed_setup):
    data, jt, jst = packed_setup
    st = ShardedPackedTape(data, _mesh(8))
    recs = np.array([0, 3, 10, 2999], np.int32)
    flds = np.array([1, 1, 2, 0], np.int32)
    _same_gather(st.gather_decoded(recs, flds, max_len=48),
                 jst.gather_decoded(recs, flds, max_len=48))
    vals, ok = st.column_int32(0)
    jvals, jok = jst.column_int32(0)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert list(st.filter_equals(2, b"zz17")) == \
        list(jst.filter_equals(2, b"zz17")) == [17]


def test_sharded_packed_quotes_spanning_shards():
    inner = "x," * 30000  # a 60 KB quoted span across several shards
    data = f'a,b\n"{inner}end",2\nq,w\n'.encode()
    jt = create_from_bytes(data, backend="golden")
    jst = jserving.ShardedPackedTape(data, jmake_mesh(8))
    recs, flds = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    for n in (2, 8):
        st = ShardedPackedTape(data, _mesh(n))
        got = st.gather_fields(recs, flds, max_len=70000)
        _same_gather(got, jst.gather_fields(recs, flds, max_len=70000))
        assert st.to_host_lists(*got) == [jt.seek_field(r, f) for r, f
                                          in zip(recs, flds)]


def test_row_offset_arithmetic_at_8_row_shards():
    """Shards of 8 rows (4 KiB) and fields of 4.5-5.5 KB: every field's
    bytes cross a shard cut, so each lookup reads two or three shards and
    each start carries into the next row."""
    rng = np.random.default_rng(5)
    rows = [b"h0,h1,h2"]
    for _ in range(2):
        rows.append(b",".join(
            bytes(rng.choice(np.frombuffer(b"abc xyz\"", np.uint8),
                             int(rng.integers(4500, 5500)))).replace(
                                 b'"', b"q") for _ in range(3)))
    data = b"\n".join(rows) + b"\n"
    assert len(data) <= 8 * 8 * 512
    st = ShardedPackedTape(data, _mesh(8))
    assert st.shard_rows == 8
    jst = jserving.ShardedPackedTape(data, jmake_mesh(8))
    assert jst.shard_rows == 8
    jt = create_from_bytes(data, backend="golden")
    recs = np.array([0, 0, 0, 1, 1, 1, 2, -1], np.int32)
    flds = np.array([0, 1, 2, 0, 1, 2, 0, 0], np.int32)
    got = st.gather_fields(recs, flds, max_len=6000)
    _same_gather(got, jst.gather_fields(recs, flds, max_len=6000))
    vals = st.to_host_lists(*got)
    assert vals[:6] == [jt.seek_field(int(r), int(f))
                        for r, f in zip(recs[:6], flds[:6])]
    assert vals[6:] == [None, None]
    starts = [int(jt.index[(r + 1) * 3 + f]) + 1
              for r, f in zip(recs[:6], flds[:6])]
    ends = [s + len(v) for s, v in zip(starts, vals)]
    assert all(s // 4096 != (e - 1) // 4096 for s, e in zip(starts, ends))


def test_sharded_packed_validate_utf8():
    mesh, jmesh = _mesh(4), jmake_mesh(4)
    ascii_csv = b"a,b\n1,2\n3,4\n"
    t = ShardedPackedTape(ascii_csv, mesh, validate_utf8=True)
    assert t.nonascii_count == 0 == jserving.ShardedPackedTape(
        ascii_csv, jmesh, validate_utf8=True).nonascii_count
    utf8_csv = "a,b\nschön,2\nnaïve,4\n".encode()
    for use_pallas in (None, True):
        t = ShardedPackedTape(utf8_csv, mesh, validate_utf8=True,
                              use_pallas=use_pallas)
        assert t.nonascii_count == 4
        o, ln, v = t.gather_fields(np.array([0], np.int32),
                                   np.array([0], np.int32))
        assert bytes(o[0][: int(ln[0])].numpy()).decode() == "schön"
    bad = b"a,b\n\xff\xfe,2\n3,4\n"
    with pytest.raises(InvalidCsvFormat, match="not valid UTF-8"):
        ShardedPackedTape(bad, mesh, validate_utf8=True)
    assert ShardedPackedTape(bad, mesh).nonascii_count is None


def test_artifacts_load_in_both_directions(tmp_path, packed_setup):
    """The port's sharded save loads in both packages' PackedDeviceTape
    and JAX's load_tape; the JAX sharded save loads in the port's."""
    data, jt, jst = packed_setup
    st = ShardedPackedTape(data, _mesh(3))
    recs, flds = _queries(jt, 100, 9)
    mine = tmp_path / "port_sharded.npz"
    st.save(mine)
    theirs = tmp_path / "jax_sharded.npz"
    jst.save(theirs)
    want = jst.gather_fields(recs, flds, max_len=48)
    _same_gather(PackedDeviceTape.load(mine, data, device="cpu")
                 .gather_fields(recs, flds, max_len=48), want)
    _same_gather(PackedDeviceTape.load(theirs, data, device="cpu")
                 .gather_fields(recs, flds, max_len=48), want)
    jp = JPacked.load(mine, data)
    for g, w in zip(jp.gather_fields(recs, flds, max_len=48), want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert jload_tape(mine, data).seek_field(0, 1) == jt.seek_field(0, 1)
    with np.load(mine) as a, np.load(theirs) as b:
        np.testing.assert_array_equal(a["meta"], b["meta"])
        rows = min(a["packed"].shape[0], b["packed"].shape[0])
        np.testing.assert_array_equal(a["packed"][:rows], b["packed"][:rows])
        assert not a["packed"][rows:].any() and not b["packed"][rows:].any()


@pytest.mark.parametrize("n", [3, 8])
def test_from_numpy_state_of_the_jax_tape(packed_setup, n):
    """The JAX tape's words (its 8-shard pad), header and bytes, cut into
    this mesh's shards with no re-scan."""
    data, jt, jst = packed_setup
    st = ShardedPackedTape.from_numpy_state(np.asarray(jst.words),
                                            jst.header, data, _mesh(n))
    assert st.nonascii_count is None and len(st.words) == n
    recs, flds = _queries(jt, 200, n)
    _same_gather(st.gather_fields(recs, flds, 48),
                 jst.gather_fields(recs, flds, 48))
    with pytest.raises(InvalidCsvFormat, match="cover"):
        ShardedPackedTape.from_numpy_state(np.asarray(jst.words)[:8],
                                           jst.header, data, _mesh(n))


def test_two_gib_messages_name_the_sharded_tape():
    """DeviceTape's 2 GiB refusal names the routes for such a file: the
    packed tape of create_packed (which has no 2 GiB limit any more) and
    the sharded tape."""
    from csv_simd_tpu_torch import offsetfree

    assert not hasattr(offsetfree, "_TWO_GIB_MSG")
    with pytest.raises(ValueError, match="ShardedPackedTape") as e:
        DeviceTape(np.zeros(4, np.uint8), np.array([0, 2**31]), 1, 1, 1,
                   device="cpu")
    assert "create_packed" in str(e.value)


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedPackedTape(b"a,b\n1,2\n", make_mesh())


@pytest.mark.skipif(
    not os.environ.get("CSV_SIMD_BIG_TESTS"),
    reason="2.5 GiB sharded serving is slow; set CSV_SIMD_BIG_TESTS=1",
)
def test_sharded_packed_serves_past_2gib():
    """Fields whose bytes lie past byte 2^31: shard-local int32 addressing
    (a flat int32 position would wrap negative)."""
    header = b"a,b\n"
    payload = b"x" * 57
    n_rows = (2**31 + (1 << 26)) // 64
    one = payload + b",00042\n"
    data = header + one * n_rows
    assert len(data) > 2**31
    st = ShardedPackedTape(data, _mesh(8), use_pallas=False)
    assert st.record_cnt == n_rows + 1
    far = (2**31 - len(header)) // 64 + 10
    assert len(header) + far * 64 + 64 > 2**31
    out, ln, v = st.gather_fields(np.array([far - 1, far - 1]),
                                  np.array([0, 1]), max_len=64)
    assert st.to_host_lists(out, ln, v) == [payload, b"00042"]
