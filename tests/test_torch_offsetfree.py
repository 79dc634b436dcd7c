"""The port's offsets-free tape against csv_simd_tpu.offsetfree, bit for
bit: the row prefix (plain version against the Pallas kernel in
interpret mode and the XLA twin), rank-select, batched serving, typed
columns and the packed_seq artifact in both directions. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import create_from_bytes, golden
from csv_simd_tpu.offsetfree import PackedDeviceTape as JTape
from csv_simd_tpu.offsetfree import _kth_positions as j_kth_positions
from csv_simd_tpu.offsetfree import _prefix_for_packed_pallas as jprefix_pallas
from csv_simd_tpu.offsetfree import _prefix_for_packed_xla as jprefix_xla
from csv_simd_tpu.offsetfree import _select_bit as j_select_bit
from csv_simd_tpu.offsetfree import _serve as j_serve
from csv_simd_tpu.ops.stage1_v3 import stage1_seq_xla as jstage1_seq_xla
from csv_simd_tpu_torch.errors import InvalidCsvFormat
from csv_simd_tpu_torch.device_tape import _byte_window, _slots
from csv_simd_tpu_torch.offsetfree import (
    PackedDeviceTape,
    _kth_positions,
    _kth_positions_plain,
    _select_bit,
    _serve,
    _serve_plain,
    prefix_for_packed,
)
from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words

from corpus import basic_cases, synthetic_wide_table
from rank_select_cases import (
    CASES,
    MAX_LENS,
    RANKS,
    STRIDES,
    brute_positions,
    ranks,
    serve_case,
    serve_reckoning,
    words_for,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _random_words(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (rows, 16),
                        dtype=np.int64).astype(np.int32)


def _same(t, j):
    np.testing.assert_array_equal(
        t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        np.asarray(j))


@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("rows", [64, 512, 2048, 8192])
def test_prefix_matches_jax(rows, layout):
    words = _random_words(rows, rows)
    shaped = words if layout == "narrow" else words.reshape(-1, 128)
    got = prefix_for_packed(torch.from_numpy(shaped.copy()))
    assert got.dtype == torch.int32 and got.shape == (rows,)
    _same(got, jprefix_pallas(jnp.asarray(shaped), interpret=True))
    _same(got, jprefix_xla(jnp.asarray(shaped)))


def test_prefix_any_row_count():
    """The port takes any row count (the JAX kernel needed rows % 64)."""
    for rows in (1, 3, 63, 65, 2049):
        words = _random_words(rows, rows)
        _same(prefix_for_packed(torch.from_numpy(words.copy())),
              jprefix_xla(jnp.asarray(words)))


def test_select_bit_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    w[0], w[1] = -1, -2**31
    pc = np.array([bin(int(x) & 0xFFFFFFFF).count("1") for x in w], np.int32)
    j = (rng.integers(0, 1 << 30, w.size) % np.maximum(pc, 1)).astype(np.int32)
    _same(_select_bit(torch.from_numpy(w), torch.from_numpy(j)),
          j_select_bit(jnp.asarray(w), jnp.asarray(j)))


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_kth_positions_matches_jax_and_golden(layout):
    data = synthetic_wide_table(50_000)
    arr = np.frombuffer(data, dtype=np.uint8)
    w = pad_to_words(arr, row_align=8)
    packed, _ = jstage1_seq_xla(jnp.asarray(w), 0)
    words = np.asarray(packed)
    if layout == "wide":
        words = words.reshape(-1, 128)
    tw = torch.from_numpy(words.copy())
    cum = prefix_for_packed(tw)
    offs = golden.structural_index(data)[1:]
    ks = np.r_[0, 1, 17, len(offs) - 1, np.arange(0, len(offs), 37)]
    ks = ks.astype(np.int32)
    got = _kth_positions(tw, cum, torch.from_numpy(ks))
    _same(got, offs[ks])
    _same(got, j_kth_positions(jnp.asarray(words), jnp.asarray(cum.numpy()),
                               jnp.asarray(ks)))


@pytest.mark.parametrize("kind", RANKS)
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("case", CASES)
def test_kth_positions_matches_brute_force(case, layout, kind):
    """The plain version, which the card's rank-select kernel is held to,
    against the positions of the unpacked bits and the JAX package's
    `_kth_positions`: empty rows, rows of 512 set bits, bits in the last
    place of a word and of a row, one bit a row and random words; every k
    sorted and shuffled, the k at each row boundary, Q = 1 and Q = 0."""
    words = words_for(case, seed=CASES.index(case))
    shaped = words if layout == "narrow" else words.reshape(-1, 128)
    tw = torch.from_numpy(shaped.copy())
    cum = prefix_for_packed(tw)
    ks = ranks(kind, words, seed=7)
    got = _kth_positions(tw, cum, torch.from_numpy(ks))
    assert got.dtype == torch.int32 and got.shape == ks.shape
    _same(got, brute_positions(words)[ks].astype(np.int32))
    _same(got, j_kth_positions(jnp.asarray(shaped), jnp.asarray(cum.numpy()),
                               jnp.asarray(ks)))


def test_cpu_rank_select_never_reaches_the_kernels(monkeypatch):
    """A CPU tensor takes the plain version: the kernel's wrapper is not
    called, launches nothing and the kernel's counter does not move."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    def refuse(*args):
        raise AssertionError("a CPU tensor reached _kernels.kth_positions")

    monkeypatch.setattr(_kernels, "kth_positions", refuse)
    launches = _kernels.launch_counts()["kth_positions"]
    st = GLOBAL.stages.get("offsetfree.kth_kernel_queries")
    before = st.calls if st is not None else 0
    words = words_for("random")
    tw = torch.from_numpy(words.copy())
    ks = ranks("sorted", words)
    _same(_kth_positions(tw, prefix_for_packed(tw), torch.from_numpy(ks)),
          brute_positions(words)[ks].astype(np.int32))
    tape = PackedDeviceTape(synthetic_wide_table(20_000), device="cpu")
    tape.gather_column(2, max_len=32)
    assert _kernels.launch_counts()["kth_positions"] == launches
    st = GLOBAL.stages.get("offsetfree.kth_kernel_queries")
    assert (st.calls if st is not None else 0) == before


def test_cpu_gather_fields_never_reaches_the_kernels(monkeypatch):
    """A CPU tape serves through the plain version: neither the serve
    kernel's wrapper nor the rank-select kernel's is called, no launch is
    counted and neither kernel's query counter moves."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    def refuse(*args):
        raise AssertionError("a CPU tensor reached _kernels")

    monkeypatch.setattr(_kernels, "serve_packed", refuse)
    monkeypatch.setattr(_kernels, "kth_positions", refuse)
    names = ("offsetfree.serve_kernel_queries",
             "offsetfree.kth_kernel_queries")

    def calls(name):
        st = GLOBAL.stages.get(name)
        return st.calls if st is not None else 0

    before = [calls(name) for name in names]
    launches = _kernels.launch_counts()
    tape = PackedDeviceTape(synthetic_wide_table(20_000), device="cpu")
    out, lengths, valid = tape.gather_fields([0, 1, 2, -1], [3, 0, 15, 0],
                                             max_len=24)
    assert out.device.type == "cpu" and valid.tolist() == [True] * 3 + [
        False]
    tape.column_int32(0)
    assert _kernels.launch_counts() == launches
    assert [calls(name) for name in names] == before


@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("case", CASES)
def test_plain_serve_is_rank_select_and_byte_window(case, max_len):
    """The plain serve, which the card's serve kernel is held to, is what
    `_serve` was before the kernel: `_slots`, `_kth_positions_plain` of
    each query's start and end bits and `_byte_window`; and it equals the
    JAX package's `_serve` on the same words and queries and the
    reckoning from the unpacked bits. The words of the rank-select cases
    with commas at their bits, both word layouts, LF and CRLF strides,
    bytes cut at the last bit; valid queries, negative and last records,
    out-of-range fields: TRUE lengths beyond max_len, empty fields, fields
    across words and rows and after empty rows."""
    words = words_for(case, seed=CASES.index(case) + 11)
    for (jump, field_cnt), layout in zip(STRIDES, (16, 128)):
        tw = torch.from_numpy(words.reshape(-1, layout).copy())
        cum = prefix_for_packed(tw)
        for cut in (False, True):
            data, record_cnt, recs, flds = serve_case(
                words, jump, field_cnt, 300, seed=max_len, cut=cut)
            args = (torch.from_numpy(data), tw, cum, torch.from_numpy(recs),
                    torch.from_numpy(flds), jump, field_cnt, record_cnt,
                    max_len)
            got = _serve_plain(*args)
            slots, valid = _slots(args[3], args[4], jump, field_cnt,
                                  record_cnt)
            pos = _kth_positions_plain(tw, cum, torch.cat([slots - 1, slots]))
            n = slots.shape[0]
            want = _byte_window(args[0], pos[:n] + 1, pos[n:], valid, max_len)
            reckoned = serve_reckoning(data, words, recs, flds, jump,
                                       field_cnt, record_cnt, max_len)
            jax_got = j_serve(jnp.asarray(data), jnp.asarray(tw.numpy()),
                              jnp.asarray(cum.numpy()), jnp.asarray(recs),
                              jnp.asarray(flds), jump, field_cnt,
                              record_cnt, max_len=max_len)
            assert got[0].shape == (recs.size, max_len)
            assert [t.dtype for t in got] == [torch.uint8, torch.int32,
                                              torch.bool]
            for g, w, r, s, j in zip(got, want, reckoned, _serve(*args),
                                     jax_got):
                assert torch.equal(g, w) and torch.equal(g, s)
                _same(g, r)
                _same(g, j)


def _queries(n_records: int, n_fields: int, seed: int):
    rng = np.random.default_rng(seed)
    recs = rng.integers(0, max(n_records, 1), 48)
    flds = rng.integers(0, n_fields, recs.size)
    # out-of-range queries: served as invalid, zero bytes, length 0
    recs = np.r_[recs, n_records, -1, 0, 10**7].astype(np.int32)
    flds = np.r_[flds, 0, 0, n_fields, 0].astype(np.int32)
    return recs, flds


@pytest.mark.parametrize(
    "case", [c for c in basic_cases() if c.should_build],
    ids=lambda c: c.name)
def test_gather_fields_matches_jax(case):
    jt = JTape(case.data)
    pt = PackedDeviceTape(case.data, device="cpu")
    assert pt.num_data_records == jt.num_data_records
    assert (pt.jump, pt.field_cnt, pt.record_cnt) == (
        int(jt.jump), int(jt.field_cnt), int(jt.record_cnt))
    _same(pt.words.reshape(-1, 16), jt.words)
    _same(pt.cum_incl, jt.cum_incl)
    recs, flds = _queries(pt.num_data_records, pt.field_cnt, 1)
    got = pt.gather_fields(recs, flds, max_len=96)
    want = jt.gather_fields(recs, flds, max_len=96)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        _same(g, w)
    host = create_from_bytes(case.data, backend="golden")
    vals = pt.to_host_lists(*got)
    for i in range(48):
        if pt.num_data_records:
            assert vals[i] == host.seek_field(int(recs[i]), int(flds[i]))
    assert vals[48:] == [None] * 4


def test_gather_column_matches_jax():
    data = synthetic_wide_table(80_000)
    jt = JTape(data)
    pt = PackedDeviceTape(data, device="cpu")
    for field in (0, 3, 15):
        for g, w in zip(pt.gather_column(field, max_len=48),
                        jt.gather_column(field, max_len=48)):
            _same(g, w)
    recs = [5, 1, 3]
    for g, w in zip(pt._column_gather(2, 32, recs),
                    jt._column_gather(2, 32, recs)):
        _same(g, w)
    out, ln, v = pt.gather_column(3, max_len=8)
    with pytest.raises(ValueError):
        pt.to_host_lists(out, ln, v)
    assert pt.to_host_lists(out, ln, v, allow_truncated=True) == \
        jt.to_host_lists(*jt.gather_column(3, max_len=8),
                         allow_truncated=True)


NUMERIC = (
    b"id,num\n"
    b"1,2.5\n-7,0.25\n2147483647,3.\n-2147483648,.5\n2147483648,-.5\n"
    b"6442450944,+1.25\n  42, 7.125\n+13,1.2.3\n-,.\n,\n  ,-\n"
    b"12a,1e5\n0007,0.1\n-0,123456789.123456789\n 9 ,99999999999999999\n"
    b"214748364,-0.0\n2147483640,3.4028235\n-2147483649,0.30000001\n"
)


@pytest.mark.parametrize("max_len", [8, 20, 24])
def test_typed_columns_bit_identical(max_len):
    rng = np.random.default_rng(max_len)
    extra = b"".join(
        b"%d,%d.%0*d\n" % (int(rng.integers(-2**33, 2**33)),
                           int(rng.integers(0, 10**6)), int(rng.integers(1, 9)),
                           int(rng.integers(0, 10**8)))
        for _ in range(300))
    data = NUMERIC + extra
    jt = JTape(data)
    pt = PackedDeviceTape(data, device="cpu")
    for field in (0, 1):
        iv, iok = pt.column_int32(field, max_len=max_len)
        jiv, jiok = jt.column_int32(field, max_len=max_len)
        _same(iv, jiv)
        _same(iok, jiok)
        fv, fok = pt.column_float32(field, max_len=max_len)
        jfv, jfok = jt.column_float32(field, max_len=max_len)
        assert fv.dtype == torch.float32
        _same(fv.numpy().view(np.int32), np.asarray(jfv).view(np.int32))
        _same(fok, jfok)
    recs = [3, 0, 2]
    for g, w in zip(pt.column_int32(0, records=recs),
                    jt.column_int32(0, records=recs)):
        _same(g, w)


def test_typed_columns_known_values():
    pt = PackedDeviceTape(b"id,score\n1,2.5\n-7,0.25\n2147483647,3.\n",
                          device="cpu")
    v, ok = pt.column_int32(0)
    assert ok.all()
    assert v.tolist() == [1, -7, 2147483647]
    f, ok = pt.column_float32(1)
    assert ok.all()
    assert f.tolist() == [2.5, 0.25, 3.0]


def test_ragged_rejected():
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape(b"a,b,c\n1,2,3,\n", device="cpu")


def test_validate_utf8_fast_path():
    pt = PackedDeviceTape(b"a,b\n1,2\n", validate_utf8=True, device="cpu")
    assert int(pt.nonascii_count) == 0
    assert pt.num_data_records == 1
    # a byte >= 0x80 sends the bytes through the validator's plain version
    pt = PackedDeviceTape("a,b\né,2\n".encode(), validate_utf8=True,
                          device="cpu")
    assert int(pt.nonascii_count) == 2
    assert pt.num_data_records == 1
    with pytest.raises(InvalidCsvFormat, match="UTF-8"):
        PackedDeviceTape(b"a,b\n\xff,2\n", validate_utf8=True, device="cpu")


def test_artifact_port_to_jax(tmp_path):
    data = synthetic_wide_table(60_000)
    pt = PackedDeviceTape(data, device="cpu")
    p = str(tmp_path / "port")
    pt.save(p)  # np.savez_compressed appends .npz
    jt = JTape.load(p, data)
    assert jt.num_data_records == pt.num_data_records
    recs, flds = _queries(pt.num_data_records, pt.field_cnt, 2)
    for g, w in zip(pt.gather_fields(recs, flds), jt.gather_fields(recs, flds)):
        _same(g, w)
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape.load(p, data[:-5], device="cpu")
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape.load(p, data[:-1] + b"!", device="cpu")


def test_artifact_jax_to_port(tmp_path):
    data = synthetic_wide_table(60_000)
    jt = JTape(data)
    p = str(tmp_path / "jax.npz")
    jt.save(p)
    pt = PackedDeviceTape.load(p, data, device="cpu")
    assert pt.words.shape[1] == 128  # served wide
    assert pt.header.names == jt.header.names
    assert pt.num_data_records == jt.num_data_records
    recs, flds = _queries(pt.num_data_records, pt.field_cnt, 3)
    for g, w in zip(pt.gather_fields(recs, flds), jt.gather_fields(recs, flds)):
        _same(g, w)
    # and the port's own save of a loaded tape is the same file content
    q = str(tmp_path / "again.npz")
    pt.save(q)
    a, b = np.load(p), np.load(q)
    np.testing.assert_array_equal(a["packed"], b["packed"])
    np.testing.assert_array_equal(a["meta"], b["meta"])


@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_from_numpy_state(layout):
    data = synthetic_wide_table(40_000)
    jt = JTape(data)
    words = np.asarray(jt.words)
    if layout == "wide":
        words = words.reshape(-1, 128)
    pt = PackedDeviceTape.from_numpy_state(words, jt.header, data,
                                           device="cpu")
    assert pt.num_data_records == jt.num_data_records
    recs, flds = _queries(pt.num_data_records, pt.field_cnt, 4)
    for g, w in zip(pt.gather_fields(recs, flds), jt.gather_fields(recs, flds)):
        _same(g, w)
    with pytest.raises(InvalidCsvFormat):
        PackedDeviceTape.from_numpy_state(words[:8],
                                          jt.header, data, device="cpu")


def test_fma10_matches_xla_multiply_add():
    """The float parse's step v * 10 + d: XLA's CPU compilation fuses it
    (one rounding); _fma10 must give the same bits, large values and
    float32 rounding ties included."""
    import jax

    from csv_simd_tpu_torch.device_tape import _fma10

    rng = np.random.default_rng(8)
    mant = rng.integers(1 << 23, 1 << 24, 20_000)
    expo = rng.integers(-30, 100, mant.size)
    v = np.ldexp(mant.astype(np.float64), expo - 23).astype(np.float32)
    # values whose product with 10 sits exactly on a float32 tie
    ties = (np.arange(1, 2001, dtype=np.float64) * 2 + 1) * 2.0**24 / 5
    v = np.r_[v, ties.astype(np.float32), np.float32(214748352.0)]
    d = rng.integers(0, 10, v.size).astype(np.float32)
    want = jax.jit(lambda a, b: a * 10.0 + b)(jnp.asarray(v), jnp.asarray(d))
    got = _fma10(torch.from_numpy(v), torch.from_numpy(d))
    _same(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_check_not_truncated_matches_jax():
    from csv_simd_tpu.device_tape import _check_not_truncated as jcheck
    from csv_simd_tpu_torch.device_tape import _check_not_truncated

    lengths = np.array([3, 9, 12, 4], np.int32)
    valid = np.array([True, True, False, True])
    for max_len in (8, 9, 12):
        raised = []
        for check, ln, v in ((_check_not_truncated, torch.from_numpy(lengths),
                              torch.from_numpy(valid)),
                             (jcheck, jnp.asarray(lengths), jnp.asarray(valid))):
            try:
                check(ln, v, max_len)
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        assert raised[0] == raised[1]
        assert (raised[0] is None) == (max_len >= 9)
