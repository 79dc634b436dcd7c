"""The port's CUDA kernels against their plain PyTorch versions, on the
card, bit for bit, and the relational layer (query, frame, corpus_api,
join) and SQL (sql, window, setops) on the card against their own
device="cpu" results. Every test needs
an NVIDIA card and skips without one. This file imports no JAX, so it
also runs where JAX is absent (and `relational_csv`, the seeded table of
the CPU differential tests, lives here for that reason):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import csv_simd_tpu_torch as ct
from csv_simd_tpu_torch import Dialect, PackedDeviceTape, create_packed
from csv_simd_tpu_torch import _kernels, golden
from csv_simd_tpu_torch.offsetfree import (
    _kth_positions_plain,
    _prefix_for_packed_xla,
    _serve,
    _serve_plain,
    prefix_for_packed,
)
from csv_simd_tpu_torch.ops.stage1_pallas import _stage1_pallas_plain, stage1_pallas
from csv_simd_tpu_torch.ops.stage1_v2 import stage1_pallas_v2, stage1_swar_jnp
from csv_simd_tpu_torch.ops.stage1_v3 import (
    stage1_fused,
    stage1_fused_seq,
    stage1_seq_xla,
    stage1_swar_xla,
    unpack_packed_host,
)
from csv_simd_tpu_torch.ops.stage1_v4 import _stage1_v4_plain, stage1_fused_v4
from csv_simd_tpu_torch.tools import _lab_kernels as lab

from corpus import all_cases, synthetic_wide_table
from rank_select_cases import (
    CASES,
    MAX_LENS,
    RANKS,
    STRIDES,
    ranks,
    serve_case,
    words_for,
)
from wide_cases import PastCsv, check_tape

DIALECTS = ({}, dict(delimiter=0x3B, quote=0x27), dict(quote=0xA2))

_TEXT = ('AAPL', '"AA,PL"', '"say ""hi"""', 'ms_ft', '50%off', 'a\\b',
         '', '  pad  ', 'MSFT', 'goog', '"x""y"', 'aapl', 'a_b%c')


def relational_csv(seed: int, n: int = 300) -> bytes:
    """A seeded table: id, an int key k (some empty or bad), an int value
    v (int32 extremes among them), floats f (no exponent) and x (with
    one), a decimal d, a date, a datetime ts, text s (quoted, escaped,
    empty, LIKE metacharacters) and a small text key t."""
    rng = np.random.default_rng(seed)
    rows = ["id,k,v,f,x,d,day,ts,s,t"]
    for i in range(n):
        r = rng.random(9)
        k = ("" if r[0] < 0.05 else "k?" if r[0] < 0.08
             else str(int(rng.integers(-3, 6))))
        v = ("" if r[1] < 0.04 else "x!" if r[1] < 0.07
             else str(int(rng.choice([-2**31, 2**31 - 1])))
             if r[1] < 0.1 else str(int(rng.integers(-10**6, 10**6))))
        f = ("" if r[2] < 0.05 else "-0.0" if r[2] < 0.08
             else f"{rng.uniform(-500, 500):.3f}")
        x = ("" if r[3] < 0.05 else
             f"{rng.uniform(1, 9):.2f}e{int(rng.integers(-5, 6))}")
        d = ("" if r[4] < 0.05 else "1.234" if r[4] < 0.08
             else f"{int(rng.integers(-10**5, 10**5))}.{int(rng.integers(0, 100)):02d}")
        day = ("2023-02-29" if r[5] < 0.04 else
               str(np.datetime64("2020-01-01") + int(rng.integers(0, 2000))))
        ts = (str(np.datetime64("2021-03-04T05:06:07.000")
                  + int(rng.integers(0, 10**9))).replace(
                      "T", " " if r[6] < 0.5 else "T"))
        s = _TEXT[int(rng.integers(0, len(_TEXT)))]
        t = "abc"[int(rng.integers(0, 3))] if r[7] > 0.05 else ""
        rows.append(f"{i},{k},{v},{f},{x},{d},{day},{ts},{s},{t}")
    return ("\n".join(rows) + "\n").encode()


# Text keys that Python `bytes` order and a packed-word order could tell
# apart: embedded NULs, bytes >= 0x80, the empty key, true prefixes, and
# keys on both sides of each 7- and 8-byte word boundary.
KEY_CASES = tuple(dict.fromkeys(
    (b"", b"a", b"a\x00", b"ab", b"\x00", b"\x00\x00", b"\x00a", b"\x7f",
     b"\x80", b"\xff", b"a\xff", b"\xe9t\xe9", b"A", b"N")
    + tuple(k for n in (1, 6, 7, 8, 9, 15, 16, 17)
            for k in (b"k" * n, b"k" * (n - 1) + b"\x00",
                      b"k" * (n - 1) + b"\xff", b"k" * (n - 1) + b"j"))))


def key_batch(keys, valid, width: int, seed: int = 0):
    """A decoded gather of `keys` as (out (N, width) uint8, lengths (N,)
    int32, valid (N,) bool) CPU tensors, with random bytes past each
    length and in invalid rows."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (len(keys), width), dtype=np.uint8)
    lengths = np.zeros(len(keys), np.int32)
    for i, k in enumerate(keys):
        out[i, :len(k)] = np.frombuffer(k, np.uint8)
        lengths[i] = len(k)
    return (torch.from_numpy(out), torch.from_numpy(lengths),
            torch.from_numpy(np.asarray(valid, bool)))


def lineitem_flags(n: int, seed: int):
    """TPC-H LINEITEM's two GROUP BY keys of Q1 as decoded gathers 16
    bytes wide: l_returnflag (A, N, R) and l_linestatus (F, O), each
    with about 1% invalid rows."""
    rng = np.random.default_rng(seed)
    cols = []
    for letters in (b"ANR", b"FO"):
        out = rng.integers(0, 256, (n, 16), dtype=np.uint8)
        out[:, 0] = np.frombuffer(letters, np.uint8)[
            rng.integers(0, len(letters), n)]
        cols.append((torch.from_numpy(out),
                     torch.ones(n, dtype=torch.int32),
                     torch.from_numpy(rng.random(n) > 0.01)))
    return cols


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _bytes(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b'a",\n\r\xa2\x8a\'; ', np.uint8),
                      size=rows * 512)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 100, 128, 129, 512, 2056])
def test_stage1_kernel_matches_plain(cuda_device, rows):
    arr = _bytes(rows, rows)
    w = torch.from_numpy(arr.view("<i4").copy()).to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            for cn in (True, False):
                before = _kernels.launch_counts()["stage1_v4"]
                got = stage1_fused_v4(w.view(rows, 128), carry, d,
                                      count_nonascii=cn)
                assert _kernels.launch_counts()["stage1_v4"] == before + 1
                want = _stage1_v4_plain(w, carry, d, cn)
                torch.cuda.synchronize()
                assert torch.equal(got[0].reshape(-1), want[0])
                assert int(got[1]) == int(want[1])
                assert int(got[2]) == int(want[2])


@pytest.mark.gpu
def test_stage1_kernel_quoted_span_across_chunks(cuda_device):
    """A quoted region that crosses many 64 KiB chunks, both carries."""
    data = b'a,b\n"' + b"x,\n" * 200_000 + b'end",2\nq,w\n'
    pad = (-len(data)) % 512
    arr = np.frombuffer(data + b"\0" * pad, dtype=np.uint8)
    w = torch.from_numpy(arr.view("<i4").copy()).to(cuda_device)
    for carry in (0, 1):
        got = stage1_fused_v4(w.view(-1, 128), carry)
        want = _stage1_v4_plain(w, carry, Dialect(), True)
        assert torch.equal(got[0].reshape(-1), want[0])
        assert int(got[1]) == int(want[1])


@pytest.mark.gpu
def test_stage1_kernel_rejects_bad_input(cuda_device):
    w = torch.zeros((512, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        _kernels.stage1_v4(w.to(torch.int64), 0, Dialect(), True)
    with pytest.raises(ValueError):
        _kernels.stage1_v4(w.t(), 0, Dialect(), True)
    with pytest.raises(ValueError):
        _kernels.stage1_v4(w.view(-1)[:12], 0, Dialect(), True)
    with pytest.raises(ValueError):
        _kernels.stage1_v4(w.cpu(), 0, Dialect(), True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 7, 64, 2048, 2049, 8192, 70_001])
def test_prefix_kernel_matches_plain(cuda_device, rows):
    rng = np.random.default_rng(rows)
    words = torch.from_numpy(rng.integers(
        -2**31, 2**31, (rows, 16), dtype=np.int64).astype(np.int32))
    words = words.to(cuda_device)
    before = _kernels.launch_counts()["row_prefix"]
    got = prefix_for_packed(words)
    assert _kernels.launch_counts()["row_prefix"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, _prefix_for_packed_xla(words))
    if rows % 8 == 0:
        assert torch.equal(prefix_for_packed(words.view(-1, 128)), got)


@pytest.mark.gpu
def test_tape_on_card_matches_cpu(cuda_device):
    data = synthetic_wide_table(300_000)
    gpu = PackedDeviceTape(data, device=cuda_device)
    cpu = PackedDeviceTape(data, device="cpu")
    assert torch.equal(gpu.words.cpu(), cpu.words)
    assert torch.equal(gpu.cum_incl.cpu(), cpu.cum_incl)
    assert gpu.num_data_records == cpu.num_data_records
    rng = np.random.default_rng(5)
    recs = np.r_[rng.integers(0, cpu.num_data_records, 500), -1, 10**7]
    flds = np.r_[rng.integers(0, 16, 500), 0, 0]
    for g, c in zip(gpu.gather_fields(recs, flds),
                    cpu.gather_fields(recs, flds)):
        assert torch.equal(g.cpu(), c)
    for g, c in zip(gpu.column_float32(1), cpu.column_float32(1)):
        assert torch.equal(g.cpu(), c)
    for g, c in zip(gpu.column_int32(0), cpu.column_int32(0)):
        assert torch.equal(g.cpu(), c)


@pytest.mark.gpu
def test_create_packed_on_card_matches_cpu(cuda_device, tmp_path):
    path = tmp_path / "wide.csv"
    path.write_bytes(synthetic_wide_table(1 << 20))
    gpu = create_packed(str(path), device=cuda_device)
    cpu = create_packed(str(path), device="cpu")
    assert torch.equal(gpu.words.cpu(), cpu.words)
    assert torch.equal(gpu.cum_incl.cpu(), cpu.cum_incl)
    assert gpu.num_data_records == cpu.num_data_records
    q = tmp_path / "idx.npz"
    gpu.save(str(q))
    back = PackedDeviceTape.load(str(q), path.read_bytes(), device=cuda_device)
    assert torch.equal(back.cum_incl, gpu.cum_incl)


def _same(got, want) -> None:
    """Kernel outputs against plain outputs, bit for bit."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g).reshape(-1).cpu(),
                           torch.as_tensor(w).reshape(-1).cpu())


def _launches() -> dict:
    """The launch counts of the product's kernels and the lab's probes,
    together: some probes run the product's B1 and relayouts inside."""
    return {**_kernels.launch_counts(), **lab.launch_counts()}


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(8, 8), (64, 8), (64, 32), (512, 64),
                                       (1024, 512), (4096, 512), (2056, 8),
                                       (2048, 1024), (264, 24)])
def test_fold_kernel_matches_plain(cuda_device, rows, tile):
    arr = _bytes(rows, rows + tile)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            before = _kernels.launch_counts()["stage1_fold"]
            got = stage1_fused(w, carry, d, row_tile=tile)
            assert _kernels.launch_counts()["stage1_fold"] == before + 1
            _same(got, stage1_swar_xla(w, carry, d, row_tile=tile))
            mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
            np.testing.assert_array_equal(
                mask, golden.structural_mask(arr, d, carry_in=carry))


@pytest.mark.gpu
def test_fold_kernel_device_carry_chain(cuda_device):
    """Three chunks cut inside quoted regions, the parity chained as a
    device scalar, against one plain pass over the whole input."""
    data = (b'a,"b\n' + b"x,y\n" * 3000 + b'",c\n') * 6
    arr = np.frombuffer(data + b"\0" * (-len(data) % 12288), np.uint8)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    third = w.shape[0] // 3
    parity = torch.ones((), dtype=torch.int32, device=cuda_device)
    parts = []
    for i in range(3):
        packed, parity = stage1_fused(w[i * third:(i + 1) * third], parity,
                                      row_tile=8)
        parts.append(packed)
    want, want_par = stage1_swar_xla(w, 1, row_tile=8)
    _same((torch.cat(parts), parity), (want, want_par))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 24, 512, 2056])
def test_v2_kernel_matches_plain(cuda_device, rows):
    arr = _bytes(rows, 7 * rows)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            before = _kernels.launch_counts()["stage1_v2"]
            got = stage1_pallas_v2(w, carry, d, row_tile=8)
            assert _kernels.launch_counts()["stage1_v2"] == before + 1
            _same(got, stage1_swar_jnp(w, carry, d))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [32, 96, 1024, 8192])
def test_v1_kernel_matches_plain(cuda_device, rows):
    rng = np.random.default_rng(rows)
    b = rng.choice(np.frombuffer(b'a",\n\r\xa2\x8a\'; ', np.uint8),
                   size=(rows, 128))
    t = torch.from_numpy(b).to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            before = _kernels.launch_counts()["stage1_v1"]
            got = stage1_pallas(t, carry, d)
            assert _kernels.launch_counts()["stage1_v1"] == before + 1
            _same(got, _stage1_pallas_plain(t, carry, d))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 512, 2056])
def test_seq_kernel_matches_plain(cuda_device, rows):
    arr = _bytes(rows, 3 * rows)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            _same(stage1_fused_seq(w, carry, d, row_tile=8),
                  stage1_seq_xla(w, carry, d))


@pytest.mark.gpu
def test_wide_mode_on_card(cuda_device):
    arr = _bytes(64, 11)
    w = torch.from_numpy(arr.view("<i4").reshape(64, 128).copy())
    w = w.to(cuda_device)
    for shape in ((64, 128), (8, 1024)):
        got = stage1_fused_v4(w.view(*shape), 1, out_mode="wide")
        assert got[0].shape == (64, 16)
        _same(got, _stage1_v4_plain(w.view(-1), 1, Dialect(), True))


@pytest.mark.gpu
def test_pack_kernels_reject_bad_input(cuda_device):
    w = torch.zeros((512, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        _kernels.stage1_fold(w, 0, Dialect(), 12)
    with pytest.raises(ValueError):
        _kernels.stage1_fold(w, 0, Dialect(), 1 << 20)
    with pytest.raises(ValueError):
        _kernels.stage1_v2(w.to(torch.uint8), 0, Dialect())
    with pytest.raises(ValueError):
        _kernels.stage1_v1(w, 0, Dialect())
    with pytest.raises(ValueError):
        _kernels.stage1_v2(w.view(-1)[:1000], 0, Dialect())


@pytest.mark.gpu
def test_create_on_card_matches_golden(cuda_device, tmp_path):
    cases = [c for c in all_cases() if c.data][:12]
    for i, case in enumerate(cases):
        arr = np.frombuffer(case.data, np.uint8)
        try:
            want = ct.create_from_bytes(case.data, backend="golden")
        except ct.InvalidCsvFormat:
            with pytest.raises(ct.InvalidCsvFormat):
                ct.create_from_bytes(case.data, backend="cuda",
                                     device=cuda_device)
            continue
        path = tmp_path / f"case{i}.csv"
        path.write_bytes(case.data)
        before = _kernels.launch_counts()["stage1_fold"]
        got = ct.create(str(path), backend="cuda", device=cuda_device)
        assert _kernels.launch_counts()["stage1_fold"] == before + 1
        np.testing.assert_array_equal(got.index, want.index)
        np.testing.assert_array_equal(
            got.index, golden.structural_index(arr))


@pytest.mark.gpu
def test_offsets_route_on_card(cuda_device, tmp_path):
    data = synthetic_wide_table(3 << 20)
    path = tmp_path / "wide.csv"
    path.write_bytes(data)
    want = golden.structural_index(np.frombuffer(data, np.uint8))
    tape = ct.create(str(path), device=cuda_device)
    np.testing.assert_array_equal(tape.index, want)
    streamed = ct.create_streaming(str(path), chunk_bytes=1 << 20,
                                   device=cuda_device)
    np.testing.assert_array_equal(streamed.index, want)
    np.testing.assert_array_equal(
        ct.build_index(data, backend="torch", device=cuda_device), want)
    offs, count = ct.build_index_device(data, device=cuda_device)
    assert count == want.size - 1
    np.testing.assert_array_equal(offs.cpu().numpy(), want)
    words, n, par = ct.index.stage1_words(data, device=cuda_device)
    plain = ct.index.stage1_words(data, backend="torch", device=cuda_device)
    np.testing.assert_array_equal(words, plain[0])
    assert (n, par) == plain[1:]
    dt = ct.DeviceTape.from_tape(tape, device=cuda_device)
    rng = np.random.default_rng(1)
    recs = rng.integers(0, tape.record_cnt - 1, 2000)
    flds = rng.integers(0, 16, 2000)
    out, lengths, valid = dt.gather_fields(recs, flds)
    assert bool(valid.all())
    got = dt.to_host_lists(out, lengths, valid)
    assert got == [tape.seek_field(int(r), int(f)) for r, f in zip(recs, flds)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 100, 128, 129, 512, 2056, 20_000])
def test_b1n_kernel_matches_plain(cuda_device, rows):
    """emit_counts and emit_prefix (narrow; prefix also wide-native)
    against the plain versions, three dialects, carries 0, 1 and a
    device 1; the words equal B1's without emits."""
    from csv_simd_tpu_torch.ops.stage1_v4 import _row_emits_plain

    arr = _bytes(rows, 5 * rows)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    dev_one = torch.ones((), dtype=torch.int32, device=cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1, dev_one):
            before = _kernels.launch_counts()["stage1_v4_emit"]
            got = stage1_fused_v4(w, carry, d, emit_counts=True,
                                  emit_prefix=True)
            assert _kernels.launch_counts()["stage1_v4_emit"] == before + 1
            plain = stage1_fused_v4(w, carry, d)
            _same(got[:3], plain)
            _same(got[3:], _row_emits_plain(plain[0]))
            if rows % 8 == 0:
                wide = stage1_fused_v4(w.view(-1, 1024), carry, d,
                                       out_mode="wide_native",
                                       emit_prefix=True)
                _same(wide[3:], (got[4],))
                _same((wide[3],), (prefix_for_packed(plain[0]),))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [512, 1536, 8192])
def test_stream_probe_matches_plain(cuda_device, rows):
    from csv_simd_tpu_torch.tools import dma_probe
    from csv_simd_tpu_torch.tools._common import random_words

    w = random_words(rows, cuda_device, rows)
    for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                   device=cuda_device)):
        for mode in dma_probe.WRITE_MODES:
            _same(dma_probe.mk_write(w, mode, carry),
                  dma_probe._write_plain(w, mode, carry))
        _same(dma_probe.mk_read(w, carry), dma_probe._read_plain(w, carry))


@pytest.mark.gpu
def test_alu_probe_matches_plain(cuda_device):
    from csv_simd_tpu_torch.tools import vpu_roofline
    from csv_simd_tpu_torch.tools._common import random_words

    # 32,768 rows: past one pass of the kernel's grid-stride loop
    for rows in (1024, 32_768):
        w = random_words(rows, cuda_device, 9)
        for n_ops in lab.probe_alu_op_counts():
            for mix in vpu_roofline.MIXES:
                for s in (0, -5, torch.tensor(77, dtype=torch.int32,
                                              device=cuda_device)):
                    _same((vpu_roofline.probe(w, n_ops, mix, s),),
                          (vpu_roofline._probe_plain(w, n_ops, mix, s),))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(64, 8), (1024, 64), (2048, 512),
                                       (264, 24), (8192, 1024), (1000, 8),
                                       (1152, 128), (1000, 200),
                                       (4096, 2048), (8192, 4096)])
def test_ablate_probe_matches_plain(cuda_device, rows, tile):
    from csv_simd_tpu_torch.tools import ablate
    from csv_simd_tpu_torch.tools._common import random_words

    for w in (random_words(rows, cuda_device, rows),
              ablate.csv_words(rows, cuda_device, tile)):
        for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                       device=cuda_device)):
            for mode in ablate.MODES:
                _same(ablate.mk(w, mode, tile, carry),
                      ablate._ablate_plain(w, mode, tile, carry))


@pytest.mark.gpu
def test_probe_kernels_reject_bad_input(cuda_device):
    w = torch.zeros((1024, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        lab.probe_stream_write(w[:1000], "narrow", 0)
    with pytest.raises(ValueError):
        lab.probe_stream_read(w.cpu(), 0)
    with pytest.raises(ValueError):
        lab.probe_alu(w, 17, 0, [1] * 256, 0)
    with pytest.raises(ValueError):
        lab.probe_ablate(w, "full", 12, 0)
    with pytest.raises(ValueError):
        _kernels.stage1_v4(w.view(-1)[:8], 0, Dialect(), True,
                           emit_counts=True)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(64, 8), (1000, 8), (1024, 64),
                                       (2048, 512), (264, 24), (8192, 1024)])
def test_ablate2_probe_matches_plain(cuda_device, rows, tile):
    """B1's stage cuts, words and side words, against their plain
    versions; v4full also against B1's narrow words."""
    from csv_simd_tpu_torch.tools import ablate2
    from csv_simd_tpu_torch.tools._common import csv_words, random_words

    for w in (random_words(rows, cuda_device, rows),
              csv_words(rows, cuda_device, tile)):
        for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                       device=cuda_device)):
            before = _launches()["probe_ablate2"]
            for mode in ablate2.MICRO:
                _same(ablate2.mk(w, mode, tile, carry),
                      ablate2.plain(w, mode, tile, carry))
            assert _launches()["probe_ablate2"] == \
                before + len(ablate2.MICRO)
            _same((ablate2.mk(w, "v4full", tile, carry)[0],),
                  (stage1_fused_v4(w, carry)[0],))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(32, 32), (1024, 64), (1536, 512),
                                       (4096, 1024), (8192, 32)])
def test_kbench_probe_matches_plain(cuda_device, rows, tile):
    """The v1-layout variants, words and last-tile count, against their
    plain versions; full's words also against B6's."""
    from csv_simd_tpu_torch.tools import kbench

    from csv_simd_tpu_torch.tools._common import csv_words, random_words

    for b in (kbench.as_bytes(random_words(rows // 4, cuda_device, rows)),
              kbench.as_bytes(csv_words(rows // 4, cuda_device, tile))):
        for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                       device=cuda_device)):
            for name in kbench.VARIANTS:
                _same(kbench.make_variant(b, name, tile, carry),
                      kbench._variant_plain(b, name, tile, carry))
            _same((kbench.make_variant(b, "roll", tile, carry)[0],),
                  (stage1_pallas(b, carry, row_tile=tile)[0],))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(8, 8), (64, 8), (1000, 8),
                                       (1024, 64), (264, 24), (2048, 512),
                                       (8192, 2048), (384, 16), (640, 32),
                                       (128, 128), (1152, 128),
                                       (8192, 8192)])
def test_vnext_direct_pack_matches_b3(cuda_device, rows, tile):
    """The atomic-free fold pack against its plain version and B3 (words
    and parity), and against golden on CSV bytes."""
    from csv_simd_tpu_torch.tools import vnext

    arr = _bytes(rows, 3 * rows + tile)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                   device=cuda_device)):
        before = _launches()["probe_vnext"]
        got = vnext.make(w, tile, carry, directpack=True)
        assert _launches()["probe_vnext"] == before + 1
        _same(got, vnext._vnext_plain(w, tile, carry, True))
        _same(got, stage1_fused(w, carry, row_tile=tile))
        mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
        np.testing.assert_array_equal(
            mask, golden.structural_mask(arr, carry_in=int(carry)))


@pytest.mark.gpu
def test_lab_kernels_reject_bad_input(cuda_device):
    w = torch.zeros((1024, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        lab.probe_ablate2(w, "pack3", 8, 0)
    with pytest.raises(ValueError):
        lab.probe_ablate2(w, "lane", 12, 0)
    with pytest.raises(ValueError):
        lab.probe_kbench(w, "full", 64, 0)
    with pytest.raises(ValueError):
        lab.probe_kbench(w.to(torch.uint8), "full", 48, 0)
    # no tile limit: any multiple of 8 that divides the rows
    with pytest.raises(ValueError):
        lab.probe_vnext(w, 1000, 0)
    with pytest.raises(ValueError):
        lab.probe_vnext(w, 12, 0)
    with pytest.raises(ValueError):
        lab.probe_vnext(w[:1000], 64, 0)
    _same(lab.probe_vnext(w, 1024, 0), stage1_fused(w, 0,
                                                         row_tile=1024))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 64, 65, 1000, 4097])
def test_widestore_kernels_match_plain(cuda_device, m):
    """The gather and the lane sum, and the pack product with both
    probes' weights and random int8 weights, against their plain versions
    at M rows of the (M, 1024) view (8M of the (rows, 128) words); each
    call launches its kernel once."""
    from csv_simd_tpu_torch.tools import widestore_probe2 as ws2
    from csv_simd_tpu_torch.tools import widestore_probe3 as ws3
    from csv_simd_tpu_torch.tools._common import random_words

    x = random_words(8 * m, cuda_device, m)
    wide = x.view(-1, 1024)
    before = _launches()
    _same((ws2.s8_st16(x), ws3.laneload(wide)),
          (ws2._gather_plain(x), ws3._lanesum_plain(wide)))
    weights = ws2.weight_sets(cuda_device)
    for w in weights.values():
        _same((ws2.mm_lanes(x, w), ws3.mm_lanes_b(wide, w)),
              (ws2._packmm_plain(wide, w),) * 2)
    after = _launches()
    assert after["probe_ws_gather"] == before["probe_ws_gather"] + 1
    assert after["probe_ws_lanesum"] == before["probe_ws_lanesum"] + 1
    assert after["probe_ws_packmm"] == \
        before["probe_ws_packmm"] + 2 * len(weights)


@pytest.mark.gpu
def test_widestore_tpu_probes_bit_exact_on_card(cuda_device):
    from csv_simd_tpu_torch.tools import widestore_probe2 as ws2
    from csv_simd_tpu_torch.tools import widestore_probe3 as ws3

    before = _launches()
    for _name, probe in ws2.PROBES + ws3.PROBES:
        assert probe(cuda_device)
    after = _launches()
    for kernel, n in (("probe_ws_gather", 1), ("probe_ws_lanesum", 1),
                      ("probe_ws_packmm", 2)):
        assert after[kernel] == before[kernel] + n


@pytest.mark.gpu
def test_widestore_kernels_reject_bad_input(cuda_device):
    x = torch.zeros((64, 1024), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((1024, 128), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        lab.probe_ws_gather(x.view(-1, 128)[:100])
    with pytest.raises(ValueError):
        lab.probe_ws_lanesum(x[:, :512])
    with pytest.raises(ValueError):
        lab.probe_ws_packmm(x.cpu(), w)
    with pytest.raises(ValueError):
        lab.probe_ws_packmm(x, w.to(torch.uint8))
    with pytest.raises(ValueError):
        lab.probe_ws_packmm(x, w[:512])
    with pytest.raises(ValueError):
        lab.probe_ws_packmm(x, w.t())


@pytest.mark.gpu
def test_widestore_tools_gate_check_and_run_on_card(cuda_device):
    """Each tool's gate, its check of the timed input and a short run,
    as chip_smoke.py and `python -m` drive them."""
    from csv_simd_tpu_torch.tools import widestore_probe2 as ws2
    from csv_simd_tpu_torch.tools import widestore_probe3 as ws3
    from csv_simd_tpu_torch.tools._common import random_words

    assert ws2.gate(cuda_device) == {
        "s8_st16": {"checks": 8, "max_abs_err": 0},
        "mmL": {"checks": 22, "max_abs_err": 0}}
    assert ws3.gate(cuda_device) == {
        "laneload": {"checks": 8, "max_abs_err": 0},
        "mmLb": {"checks": 22, "max_abs_err": 0}}
    w = random_words(8192, cuda_device, 1)
    one = {"checks": 1, "max_abs_err": 0}
    assert ws2.check(w) == {"s8_st16": one, "mmL": one}
    assert ws3.check(w.view(-1, 1024)) == {"laneload": one, "mmLb": one}
    for got in (ws2.run(w, reps=2, plain_reps=1),
                ws3.run(w.view(-1, 1024), reps=2, plain_reps=1)):
        assert all(v["ms"] > 0 and v["plain_ms"] > 0 for v in got.values())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 56, 512, 520, 8000])
def test_mosaic_kernels_match_plain(cuda_device, rows):
    """Each T9 kernel against its plain version on full-range inputs (the
    product also on |v| <= 256, the gather also on idx outside [0, 128));
    each call launches its kernel once."""
    from csv_simd_tpu_torch.tools import mosaic_probes as mp

    cases = mp._cases(rows, cuda_device, rows)
    before = _launches()
    for kernel, runs in cases.items():
        for args, _what in runs:
            _same((mp.FUNCTIONS[kernel](*args),), (mp.PLAIN[kernel](*args),))
    after = _launches()
    for kernel, runs in cases.items():
        counter = mp.LAUNCH_COUNTER[kernel]
        assert after[counter] == before[counter] + len(runs)


@pytest.mark.gpu
def test_mosaic_tpu_probes_fixed_on_card(cuda_device):
    """The eight probe lines: the seven bodies on their kernels, bit-exact
    against the plain versions and the NumPy statements, and B1 on the
    mm1 probe's bytes against golden."""
    from csv_simd_tpu_torch.tools import mosaic_probes as mp

    before = _launches()
    assert set(mp.report(cuda_device).values()) == {"fixed"}
    after = _launches()
    for kernel, n in (("probe_mosaic_mm32", 2), ("probe_mosaic_gather", 1),
                      ("probe_mosaic_cmp8", 1), ("probe_mosaic_select8", 1),
                      ("probe_mosaic_shift_add", 1),
                      ("probe_mosaic_usum", 1), ("stage1_v4", 1)):
        assert after[kernel] == before[kernel] + n


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 7, 64, 65, 1000, 4097])
def test_concat_mm_kernel_matches_plain(cuda_device, m):
    """The tensor-core product against its plain version with the probe's
    W, full-range random int8 W and all -128, on full-range int32 x."""
    from csv_simd_tpu_torch.tools import widestore_probe4 as ws4
    from csv_simd_tpu_torch.tools._common import random_words

    x = random_words(8 * m, cuda_device, 7 * m).view(-1, 1024)
    weights = ws4.weight_sets(cuda_device)
    before = _launches()["probe_concat_mm"]
    for w in weights.values():
        _same((ws4.concat_mm(x, w),), (ws4._concat_mm_plain(x, w),))
    assert _launches()["probe_concat_mm"] == \
        before + len(weights)


@pytest.mark.gpu
def test_concat_mm_tpu_probe_bit_exact_on_card(cuda_device):
    from csv_simd_tpu_torch.tools import widestore_probe4 as ws4

    before = _launches()["probe_concat_mm"]
    assert ws4.probe_concat_mm(cuda_device)
    assert _launches()["probe_concat_mm"] == before + 1


@pytest.mark.gpu
def test_mosaic_and_concat_kernels_reject_bad_input(cuda_device):
    x = torch.zeros((64, 1024), dtype=torch.int32, device=cuda_device)
    w = torch.zeros((1024, 128), dtype=torch.int8, device=cuda_device)
    v = x.view(-1, 128)
    a = torch.zeros((64, 128), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        lab.probe_mosaic_mm32(v[:, :64])
    with pytest.raises(ValueError):
        lab.probe_mosaic_mm32(v.cpu())
    with pytest.raises(ValueError):
        lab.probe_mosaic_cmp8(v)
    with pytest.raises(ValueError):
        lab.probe_mosaic_select8(a.to(torch.int8))
    with pytest.raises(ValueError):
        lab.probe_mosaic_gather(a.to(torch.int8), v[:32])
    with pytest.raises(ValueError):
        lab.probe_mosaic_shift_add(v[:0])
    with pytest.raises(ValueError):
        lab.probe_mosaic_usum(v.to(torch.int64))
    with pytest.raises(ValueError):
        lab.probe_concat_mm(x, w.to(torch.uint8))
    with pytest.raises(ValueError):
        lab.probe_concat_mm(x[:, :512], w)
    with pytest.raises(ValueError):
        lab.probe_concat_mm(x, w.t())


@pytest.mark.gpu
def test_mosaic_and_widestore4_tools_gate_check_and_run_on_card(cuda_device):
    """Each tool's gate, its check of the timed input and a short run, as
    chip_smoke.py and `python -m` drive them."""
    from csv_simd_tpu_torch.tools import mosaic_probes as mp
    from csv_simd_tpu_torch.tools import widestore_probe4 as ws4
    from csv_simd_tpu_torch.tools._common import random_words

    gate = mp.gate(cuda_device)
    assert set(gate) == set(mp.KERNELS)
    assert all(r["max_abs_err"] == 0 for r in gate.values())
    assert ws4.gate(cuda_device) == {
        "concat_mm": {"checks": 22, "max_abs_err": 0}}
    small = {k: tuple(t[:4096] for t in v)
             for k, v in mp.timed_inputs(cuda_device).items()}
    assert all(r["checks"] == 2 for r in mp.check(small).values())
    x = random_words(8192, cuda_device, 1).view(-1, 1024)
    assert ws4.check(x) == {"concat_mm": {"checks": 2, "max_abs_err": 0}}
    for got in (mp.run(small, reps=2, plain_reps=1),
                ws4.run(x, reps=2, plain_reps=1)):
        assert all(v["ms"] > 0 and v["plain_ms"] > 0 and v["library_ms"] > 0
                   for v in got.values())


def _quoted_span(chunks: int, seed: int) -> np.ndarray:
    """chunks * 64 KiB of CSV-ish bytes (non-ASCII among them, and the
    other dialects' quotes ' and 0xA2) with no 0x22 but one opened in the
    first chunk and one closing it in the last, so B1's look-back carries
    the default dialect's open quote across every chunk."""
    rng = np.random.default_rng(seed)
    arr = rng.choice(np.frombuffer(b"ab,\n\r x9;'\xa2\xc3\xa9", np.uint8),
                     size=chunks << 16)
    arr[100] = arr[arr.size - 100] = 0x22
    return arr


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 2, 33, 257, 1024])
def test_b1_one_pass_across_chunks(cuda_device, chunks):
    """B1's one pass at 1, 2, 33, 257 and 1,024 chunks (more than the
    card holds at once), one quote open from chunk 0 to the last: three
    dialects (the SWAR and the __vcmpeq4 classify), carries 0, 1 and a
    device 1, count_nonascii both ways, and B1n's counts and prefix."""
    from csv_simd_tpu_torch.ops.stage1_v4 import _row_emits_plain

    arr = _quoted_span(chunks, chunks)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    dev_one = torch.ones((), dtype=torch.int32, device=cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1, dev_one):
            for cn in (True, False):
                _same(stage1_fused_v4(w, carry, d, count_nonascii=cn),
                      _stage1_v4_plain(w.view(-1), int(carry), d, cn))
            got = stage1_fused_v4(w, carry, d, emit_counts=True,
                                  emit_prefix=True)
            _same(got[3:], _row_emits_plain(got[0]))
    mask = _unpack_words(stage1_fused_v4(w, 1)[0], arr.size)
    np.testing.assert_array_equal(mask, golden.structural_mask(arr,
                                                               carry_in=1))


def _unpack_words(packed: torch.Tensor, n: int) -> np.ndarray:
    host = packed.cpu().numpy().reshape(-1)
    return np.unpackbits(host.view("<u4").view(np.uint8),
                         bitorder="little")[:n]


@pytest.mark.gpu
def test_b1_launches_and_graph_replays_agree(cuda_device):
    """The same input launched three times in a row and replayed three
    times from one captured CUDA graph (outputs cleared before each): a
    chunk status word or ticket left from an earlier launch would show."""
    arr = _quoted_span(1024, 3)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    one = torch.ones((), dtype=torch.int32, device=cuda_device)
    want = _stage1_v4_plain(w.view(-1), 1, Dialect(), True)
    for _ in range(3):
        _same(stage1_fused_v4(w, one), want)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = stage1_fused_v4(w, one)
    for _ in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 2, 33, 257])
def test_v4full_cut_is_b1(cuda_device, chunks):
    """T6's v4full cut runs B1's one pass: its words equal B1's narrow
    words, carries 0, 1 and a device 1."""
    from csv_simd_tpu_torch.tools import ablate2

    arr = _quoted_span(chunks, 5 * chunks)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                   device=cuda_device)):
        _same((ablate2.mk(w, "v4full", 8, carry)[0],),
              (stage1_fused_v4(w, carry)[0],))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 15, 16, 17, 1000, 4097])
def test_int8_products_on_tile_edges(cuda_device, m):
    """Both instantiations of the tensor-core product at the edges of its
    16-row tiles: mmL and mmLb (the OR of block products) with both
    probes', random, all -128 and same-column weights, held against
    _packmm_plain and never against a sum; the concat product with its
    own weight sets."""
    from csv_simd_tpu_torch.tools import widestore_probe2 as ws2
    from csv_simd_tpu_torch.tools import widestore_probe3 as ws3
    from csv_simd_tpu_torch.tools import widestore_probe4 as ws4
    from csv_simd_tpu_torch.tools._common import random_words

    x = random_words(8 * m, cuda_device, 3 * m)
    wide = x.view(-1, 1024)
    weights = {**ws2.weight_sets(cuda_device),
               "min": torch.full((1024, 128), -128, dtype=torch.int8,
                                 device=cuda_device),
               "overlap": ws2.overlap_weights(cuda_device)}
    before = _launches()
    for w in weights.values():
        want = ws2._packmm_plain(wide, w)
        _same((ws2.mm_lanes(x, w), ws3.mm_lanes_b(wide, w)), (want, want))
    for w in ws4.weight_sets(cuda_device).values():
        _same((ws4.concat_mm(wide, w),), (ws4._concat_mm_plain(wide, w),))
    after = _launches()
    assert after["probe_ws_packmm"] == \
        before["probe_ws_packmm"] + 2 * len(weights)
    assert after["probe_concat_mm"] == before["probe_concat_mm"] + 3


# --- the relayouts: B3 and B6 as B1's one pass and a relayout ----------


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(8, 8), (48, 24), (1024, 64),
                                       (4096, 512), (8192, 2048),
                                       (6400, 3200), (16_384, 16_384)])
def test_fold_words_matches_plain(cuda_device, rows, tile):
    """`fold_words` alone on full-range sequential words against
    _fold_from_seq_plain, one launch counted a call."""
    from csv_simd_tpu_torch.ops.stage1_v3 import _fold_from_seq_plain

    rng = np.random.default_rng(rows + tile)
    seq = torch.from_numpy(rng.integers(-2**31, 2**31, rows * 16,
                                        dtype=np.int64).astype(np.int32))
    seq = seq.to(cuda_device)
    before = _kernels.launch_counts()["fold_words"]
    got = _kernels.fold_words(seq, tile)
    assert _kernels.launch_counts()["fold_words"] == before + 1
    _same((got,), (_fold_from_seq_plain(seq, tile),))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,count_from", [(32, 0), (32, 100), (1024, 0),
                                             (8192, 8192 * 4 - 128 * 32),
                                             (65_536, 1)])
def test_v1_words_matches_plain(cuda_device, rows, count_from):
    """`v1_words` alone on full-range sequential words against
    _v1_from_seq_plain, words and the count from count_from on."""
    from csv_simd_tpu_torch.ops.stage1_pallas import _v1_from_seq_plain

    rng = np.random.default_rng(rows + count_from)
    seq = torch.from_numpy(rng.integers(-2**31, 2**31, rows * 4,
                                        dtype=np.int64).astype(np.int32))
    seq = seq.to(cuda_device)
    before = _kernels.launch_counts()["v1_words"]
    got = _kernels.v1_words(seq, count_from)
    assert _kernels.launch_counts()["v1_words"] == before + 1
    _same(got, _v1_from_seq_plain(seq, count_from))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(4096, 2048), (6400, 3200),
                                       (16_384, 8192), (32_768, 32_768)])
def test_fold_kernel_at_large_tiles(cuda_device, rows, tile):
    """B3 at tiles 2,048 and 3,200 (the two-pass kernel's largest) and
    past them (no limit now), three dialects, carries 0, 1 and a device
    1, against its plain version and golden."""
    arr = _bytes(rows, rows + 7 * tile)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                       device=cuda_device)):
            got = stage1_fused(w, carry, d, row_tile=tile)
            _same(got, stage1_swar_xla(w, int(carry), d, row_tile=tile))
        mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
        np.testing.assert_array_equal(
            mask, golden.structural_mask(arr, d, carry_in=1))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 64, 512, 2048])
def test_fold_quote_across_chunk_and_tile(cuda_device, tile):
    """One quoted field opened 100 bytes before the first 64 KiB chunk of
    B1's one pass ends and closed past the 1 MiB fold-tile edge of tile
    2,048 (and so past many chunk and tile edges of every tile here):
    B3's words and parity against its plain version and golden, carries
    0, 1 and a device 1."""
    rows = 4 * 2048
    arr = np.frombuffer(b"ab,cd\n" * (rows * 512 // 6 + 1),
                        np.uint8)[:rows * 512].copy()
    arr[(1 << 16) - 100] = arr[(1 << 20) + 100] = 0x22
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    for carry in (0, 1, torch.ones((), dtype=torch.int32,
                                   device=cuda_device)):
        got = stage1_fused(w, carry, row_tile=tile)
        _same(got, stage1_swar_xla(w, int(carry), row_tile=tile))
        mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
        np.testing.assert_array_equal(
            mask, golden.structural_mask(arr, carry_in=int(carry)))
        assert int(got[1]) == golden.quote_parity_out(arr,
                                                      carry_in=int(carry))


def _counter(name: str) -> int:
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    st = GLOBAL.stages.get(name)
    return st.calls if st is not None else 0


def _native_index(packed: torch.Tensor, tile: int, n_bytes: int):
    """native.extract_offsets_v3 on the same words, behind the 0."""
    from csv_simd_tpu_torch import native

    offs = native.extract_offsets_v3(packed.cpu().numpy(), tile, n_bytes)
    return np.concatenate([np.zeros(1, np.int64), offs])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,tile", [(8, 8), (64, 8), (512, 64),
                                       (512, 512), (2048, 512),
                                       (16384, 16384), (24576, 512)])
def test_fold_offsets_kernel_matches_native(cuda_device, rows, tile):
    """Kernel E1 on B3's words of seeded random bytes with quotes, cut at
    whole rows, inside a row and inside a word, and on random words (bits
    in the padding): bit for bit native.extract_offsets_v3's offsets
    behind a 0 and its plain version's; one launch a call."""
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        _fold_offsets_plain,
        fold_offsets,
    )

    arr = _bytes(rows, 3 * rows + tile)
    w = torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())
    w = w.to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(rows + tile)
    noise = torch.randint(-2**31, 2**31, (rows // 8, 128),
                          dtype=torch.int64, generator=gen,
                          device=cuda_device).to(torch.int32)
    for kw in DIALECTS:
        packed = stage1_fused(w, 0, Dialect(**kw), row_tile=tile)[0]
        for words in (packed, noise):
            for n in sorted({rows * 512, rows * 512 - 1, rows * 512 - 700,
                             rows * 300 + 3, 1, 0}):
                before = _kernels.launch_counts()["fold_offsets"]
                got = fold_offsets(words, tile, n)
                assert _kernels.launch_counts()["fold_offsets"] == before + 1
                assert got.dtype == torch.int32
                want = _native_index(words, tile, n)
                np.testing.assert_array_equal(got.cpu().numpy(), want)
                _same((got,), (_fold_offsets_plain(words, tile, n),))


@pytest.mark.gpu
def test_fold_offsets_kernel_refuses_bad_input(cuda_device):
    w = torch.zeros((64, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        _kernels.fold_offsets(w, 12, 100)
    with pytest.raises(ValueError):
        _kernels.fold_offsets(w, 1024, 100)
    with pytest.raises(ValueError):
        _kernels.fold_offsets(w, 512, 2**31)
    with pytest.raises(ValueError):
        _kernels.fold_offsets(w.cpu(), 512, 100)
    with pytest.raises(ValueError):
        _kernels.fold_offsets(w.view(-1)[:100], 8, 100)


def _quoted_csv(seed: int, n: int) -> bytes:
    """Seeded CSV of n rows: quoted fields with commas, newlines, CRLF and
    escaped quotes among plain ones."""
    rng = np.random.default_rng(seed)
    cells = ('plain', '"a,b"', '"line\nbreak"', '"say ""hi"""', '', '7',
             '"x\r\ny"', 'z z')
    rows = ["a,b,c,d"]
    for _ in range(n):
        rows.append(",".join(cells[int(i)] for i in rng.integers(0, 8, 4)))
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["corpus", "quoted", "wide"])
def test_create_on_card_index_equals_native(cuda_device, tmp_path, source):
    """create on the card: the int64 index, sentinel included, equals the
    "native" backend's; kernel E1 ran once a create, inside its span and
    one host copy's, the counter index.device_offsets counts the offsets
    it compacted, and the host extractor did not run."""
    if source == "corpus":
        datas = [c.data for c in all_cases() if c.data]
    elif source == "quoted":
        datas = [_quoted_csv(seed, n) for seed, n in
                 ((1, 1), (2, 100), (3, 5000), (4, 40_000))]
    else:
        datas = [synthetic_wide_table(3 << 20)]
    for i, data in enumerate(datas):
        try:
            want = ct.create_from_bytes(data, backend="native", device="cpu")
        except ct.InvalidCsvFormat:
            with pytest.raises(ct.InvalidCsvFormat):
                ct.create_from_bytes(data, device=cuda_device)
            continue
        path = tmp_path / f"{source}{i}.csv"
        path.write_bytes(data)
        before = _kernels.launch_counts()["fold_offsets"]
        spans = {k: _counter(k) for k in (
            "index.device_offsets", "index.device_extract",
            "index.offsets_to_host", "index.extract", "index.words_to_host")}
        got = ct.create(str(path), device=cuda_device)
        assert _kernels.launch_counts()["fold_offsets"] == before + 1
        assert {k: _counter(k) - v for k, v in spans.items()} == {
            "index.device_offsets": want.index.size - 1,
            "index.device_extract": 1, "index.offsets_to_host": 1,
            "index.extract": 0, "index.words_to_host": 0}
        assert got.index.dtype == np.int64
        np.testing.assert_array_equal(got.index, want.index)
        card = got._device_index
        assert card.dtype == torch.int32 and card.device.type == "cuda"
        np.testing.assert_array_equal(card.cpu().numpy(), want.index)


@pytest.mark.gpu
def test_from_tape_shares_the_card_index(cuda_device, tmp_path):
    """DeviceTape.from_tape on a Tape that create built on the card serves
    from the card's own index tensor, counted by device_tape.index_shared;
    a Tape of another backend, or a DeviceTape on the CPU, uploads, and
    all of them answer alike."""
    data = _quoted_csv(9, 20_000)
    path = tmp_path / "q.csv"
    path.write_bytes(data)
    tape = ct.create(str(path), device=cuda_device)
    shared = _counter("device_tape.index_shared")
    dt = ct.DeviceTape.from_tape(tape, device=cuda_device)
    assert _counter("device_tape.index_shared") == shared + 1
    assert dt.index is tape._device_index
    native = ct.create_from_bytes(data, backend="native", device="cpu")
    assert native._device_index is None
    uploaded = ct.DeviceTape.from_tape(native, device=cuda_device)
    on_cpu = ct.DeviceTape.from_tape(tape, device="cpu")
    assert _counter("device_tape.index_shared") == shared + 1
    assert uploaded.index is not tape._device_index
    rng = np.random.default_rng(3)
    recs = rng.integers(-2, tape.record_cnt + 2, 3000).astype(np.int32)
    flds = rng.integers(-1, 5, 3000).astype(np.int32)
    want = [t.cpu() for t in on_cpu.gather_fields(recs, flds)]
    for dev_tape in (dt, uploaded):
        _same(dev_tape.gather_fields(recs, flds, 64), want)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 3, 257])
def test_v1_kernel_total_count(cuda_device, chunks):
    """B6's count is the structural count of the whole input (every
    word), across chunks of B1's one pass, against golden; its words and
    parity against the plain version."""
    arr = _quoted_span(chunks, 11 * chunks)
    b = torch.from_numpy(arr.reshape(-1, 128).copy()).to(cuda_device)
    for carry in (0, 1):
        got = stage1_pallas(b, carry, row_tile=512)
        _same(got, _stage1_pallas_plain(b, carry, Dialect()))
        assert int(got[1]) == int(golden.structural_mask(
            arr, carry_in=carry).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("tile,chunks", [(8, 64), (24, 48), (128, 64),
                                         (512, 64), (4096, 64)])
def test_ablate_modes_launch_their_routes(cuda_device, tile, chunks):
    """Each ablation mode is one call of its wrapper (the folds at tiles
    that do not divide 128 also launch fold_words inside it, counted
    nowhere else), at tiles up to 4,096 rows, with one quote open across
    every 64 KiB chunk."""
    from csv_simd_tpu_torch.tools import ablate

    arr = _quoted_span(chunks, tile)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    one = torch.ones((), dtype=torch.int32, device=cuda_device)
    for mode in ablate.MODES:
        before = _launches()
        got = ablate.mk(w, mode, tile, one)
        after = _launches()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"probe_ablate": 1}, mode
        _same(got, ablate._ablate_plain(w, mode, tile, one))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 128, 512])
def test_vnext_routes_and_launches(cuda_device, tile):
    """The direct pack is one call of its wrapper at every tile, over a
    quote open across every 64 KiB chunk, and equals B3 and golden."""
    from csv_simd_tpu_torch.tools import vnext

    arr = _quoted_span(64, 3 * tile)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    before = _launches()
    got = vnext.make(w, tile, 1, directpack=True)
    after = _launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"probe_vnext": 1}
    _same(got, stage1_fused(w, 1, row_tile=tile))
    mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
    np.testing.assert_array_equal(mask,
                                  golden.structural_mask(arr, carry_in=1))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [128, 512])
def test_chained_cuts_and_direct_pack_graph_replays(cuda_device, tile):
    """The chained ablation cuts and the direct pack replayed three times
    from one captured CUDA graph (outputs cleared before each), with a
    device carry and a quote open across every chunk: a status word,
    ticket or side word left from an earlier replay would show."""
    from csv_simd_tpu_torch.tools import ablate, vnext

    arr = _quoted_span(32, tile)
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
    w = w.to(cuda_device)
    one = torch.ones((), dtype=torch.int32, device=cuda_device)
    calls = {mode: (lambda m=mode: ablate.mk(w, m, tile, one))
             for mode in ("full", "v3", "v3_mmonly", "noscan")}
    calls["directpack"] = lambda: vnext.make(w, 128, one, directpack=True)
    want = {"directpack": vnext._vnext_plain(w, 128, 1, True),
            **{m: ablate._ablate_plain(w, m, tile, 1) for m in calls
               if m != "directpack"}}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = {name: fn() for name, fn in calls.items()}
    for _ in range(3):
        for outs in got.values():
            for g in outs:
                g.zero_()
        graph.replay()
        for name in calls:
            _same(got[name], want[name])


def _quoted_rows(rows: int, seed: int) -> torch.Tensor:
    """(rows, 128) int32 of _quoted_span's bytes, cut to rows x 512 bytes
    (a last chunk that may be partial), the default dialect's quote
    opened at byte 100 and closed 100 bytes before the end."""
    arr = _quoted_span(-(-rows // 128), seed)[:rows * 512].copy()
    arr[arr == 0x22] = ord("x")
    arr[100] = arr[arr.size - 100] = 0x22
    return torch.from_numpy(arr.view("<i4").reshape(rows, 128).copy())


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 1_000, 40_000, 80_008])
def test_v2_pack_past_the_resident_grid(cuda_device, rows):
    """B5 at up to 626 chunks, more than the card holds at once (about
    264 blocks, several chunks each), the last chunk partial, a quote
    open from the first chunk to the last: three dialects (the SWAR and
    the __vcmpeq4 classify), carries 0, 1 and a 0-d device 1; one launch
    a call; words, count and parity == the plain version."""
    w = _quoted_rows(rows, rows).to(cuda_device)
    dev_one = torch.ones((), dtype=torch.int32, device=cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1, dev_one):
            before = _kernels.launch_counts()["stage1_v2"]
            got = stage1_pallas_v2(w, carry, d, row_tile=8)
            assert _kernels.launch_counts()["stage1_v2"] == before + 1
            _same(got, stage1_swar_jnp(w, int(carry), d))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 136, 40_000])
def test_v2_pack_is_the_relaid_b1_words(cuda_device, rows):
    """`v2_pack`'s words and count == `_v2_from_seq_plain` on B1's own
    words from the card, and its parity == B1's, three dialects."""
    from csv_simd_tpu_torch.ops.stage1_v2 import _v2_from_seq_plain

    w = _quoted_rows(rows, 3 * rows).to(cuda_device)
    for kw in DIALECTS:
        d = Dialect(**kw)
        for carry in (0, 1):
            seq, par = stage1_fused_v4(w, carry, d)[:2]
            words, count = _v2_from_seq_plain(seq)
            _same(stage1_pallas_v2(w, carry, d, row_tile=8),
                  (words, count, par))


@pytest.mark.gpu
def test_v2_pack_graph_replays(cuda_device):
    """One B5 call with a device carry captured in a CUDA graph and
    replayed three times (outputs cleared before each): a status word,
    ticket or count left from an earlier replay would show."""
    w = _quoted_rows(40_000, 11).to(cuda_device)
    one = torch.ones((), dtype=torch.int32, device=cuda_device)
    want = stage1_swar_jnp(w, 1)
    _same(stage1_pallas_v2(w, one, row_tile=8), want)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = stage1_pallas_v2(w, one, row_tile=8)
    for _ in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        _same(got, want)


# -- the UTF-8 validator (csrc/utf8.cu) and the typed columns on the card --

UTF8_CASES = [
    b"hello", "héllo wörld ©®™".encode(), "日本語テキスト𝄞".encode(),
    "emoji \U0001f389".encode(), b"\xed\x9f\xbf", b"\xee\x80\x80",
    b"\xf4\x8f\xbf\xbf", b"\x80", b"\xbf", b"\x80\x80", b"\xc0\x80",
    b"\xc1\xbf", b"\xe0\x80\x80", b"\xe0\x9f\xbf", b"\xed\xa0\x80",
    b"\xf0\x80\x80\x80", b"\xf0\x8f\xbf\xbf", b"\xf4\x90\x80\x80",
    b"\xf5\x80\x80\x80", b"\xe2\x82", b"\xf0\x9f\x98", b"a\xc3", b"ok\xff",
    b"\xfe", b"\xff\xfe bad", b"ok \xc3\x28 overlong-ish", b"trunc \xe6\x97",
    "edge߿ࠀ￿".encode() + "\U0010FFFF".encode(),
]
_UTF8_CHARS = ["a", ",", "\n", "é", "ß", "日", "€", "😀", "\U0010FFFF"]
_UTF8_BAD = [b"\x80", b"\xbf", b"\xff", b"\xf5", b"\xc0\x80", b"\xe6\x97",
             b"\xf0\x9f\x98", b"\xed\xa0\x80", b"\xe0\x80\x80",
             b"\xf4\x90\x80\x80", b"\xc3"]


def _utf8_text(n_bytes: int, seed: int, bad_rate: float) -> np.ndarray:
    """n_bytes of 1-4 byte characters, with bad byte runs at bad_rate."""
    rng = np.random.default_rng(seed)
    out, size = [], 0
    while size < n_bytes:
        if rng.random() < bad_rate:
            piece = _UTF8_BAD[rng.integers(len(_UTF8_BAD))]
        else:
            piece = _UTF8_CHARS[rng.integers(len(_UTF8_CHARS))].encode()
        out.append(piece)
        size += len(piece)
    return np.frombuffer(b"".join(out)[:n_bytes], dtype=np.uint8).copy()


def _utf8_pair(cuda_device, arr: np.ndarray) -> tuple:
    """(kernel count, plain count on the CPU) of the same bytes."""
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain

    got = _kernels.utf8_errs(torch.from_numpy(arr).to(cuda_device))
    return int(got), _utf8_errs_plain(torch.from_numpy(arr))


@pytest.mark.gpu
def test_utf8_kernel_matches_plain_on_the_cpu_cases(cuda_device):
    """The kernel's count == the plain version's, and 0 iff Python
    decodes the bytes, on the CPU tests' cases and random mixed text."""
    cases = [np.frombuffer(c, dtype=np.uint8).copy() for c in UTF8_CASES]
    cases += [_utf8_text(n, n, 0.08) for n in (9, 17, 100, 255, 513, 4096)]
    for arr in cases:
        before = _kernels.launch_counts()["utf8_errs"]
        got, want = _utf8_pair(cuda_device, arr)
        assert _kernels.launch_counts()["utf8_errs"] == before + 1
        assert got == want, arr.tobytes()[:40]
        try:
            arr.tobytes().decode("utf-8")
            valid = True
        except UnicodeDecodeError:
            valid = False
        assert (got == 0) == valid


@pytest.mark.gpu
def test_utf8_kernel_at_chunk_warp_and_block_edges(cuda_device):
    """A bad byte, a valid 3-byte character and a cut one at every offset
    0-19 around each 16-byte chunk, warp half (512 bytes), warp (1 KiB),
    block (8 KiB) and grid step edge of the kernel's loop."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for edge in (16, 512, 1024, 8192, 4 * sms * 8192):
        base = _utf8_text(edge + 64, edge, 0.0)
        base[base >= 0x80] = ord("x")  # ASCII around the edge
        for off in range(20):
            p = edge - 10 + off
            for piece in (b"\xff", b"\xe6\x97\xa5", b"\xe6\x97", b"\xc3\xa9",
                          b"\xf0\x9f\x98\x80", b"\xed\xa0\x80"):
                arr = base.copy()
                arr[p:p + len(piece)] = np.frombuffer(piece, np.uint8)
                got, want = _utf8_pair(cuda_device, arr)
                assert got == want, (edge, off, piece)
                assert (got == 0) == (piece in (b"\xe6\x97\xa5", b"\xc3\xa9",
                                                b"\xf0\x9f\x98\x80"))


@pytest.mark.gpu
def test_utf8_kernel_lengths_1_to_4097(cuda_device):
    """Every length 1-4,097 (the ragged last chunk and the end's cut
    sequences), prefixes of one buffer of dense multi-byte text."""
    arr = _utf8_text(4097, 7, 0.02)
    full = torch.from_numpy(arr).to(cuda_device)
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain

    got = torch.stack([_kernels.utf8_errs(full[:n])
                       for n in range(1, 4098)]).cpu()
    host = torch.from_numpy(arr)
    want = [_utf8_errs_plain(host[:n]) for n in range(1, 4098)]
    assert got.tolist() == want


@pytest.mark.gpu
def test_utf8_kernel_large_and_rejects(cuda_device):
    """64 MiB of mixed text against the plain version on the card; the
    wrapper refuses CPU, non-uint8, unaligned and empty input, and
    validate_utf8_device copies an unaligned view first."""
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain, validate_utf8_device

    arr = np.tile(_utf8_text(1 << 20, 3, 0.0001), 64)
    t = torch.from_numpy(arr).to(cuda_device)
    assert int(_kernels.utf8_errs(t)) == _utf8_errs_plain(t) > 0
    with pytest.raises(ValueError):
        _kernels.utf8_errs(t.cpu())
    with pytest.raises(ValueError):
        _kernels.utf8_errs(t[:64].view(torch.int8))
    with pytest.raises(ValueError):
        _kernels.utf8_errs(t[1:])
    with pytest.raises(ValueError):
        _kernels.utf8_errs(t[:0])
    ok = torch.from_numpy(np.frombuffer(b"x" + "héllo".encode(),
                                        np.uint8).copy()).to(cuda_device)
    assert validate_utf8_device(ok[1:]) and not validate_utf8_device(ok[3:])


@pytest.mark.gpu
def test_utf8_routing_launches(cuda_device, tmp_path):
    """create_packed(validate_utf8=True) launches the validator only on
    input with a byte >= 0x80; create_from_bytes always does on a card;
    invalid input raises InvalidCsvFormat either way."""
    ascii_path = tmp_path / "a.csv"
    ascii_path.write_bytes(b"a,b\n1,2\n")
    text_path = tmp_path / "t.csv"
    text_path.write_bytes("a,b\né,2\n".encode())
    bad_path = tmp_path / "b.csv"
    bad_path.write_bytes(b"a,b\n\xff,2\n")
    for path, launches in ((ascii_path, 0), (text_path, 1)):
        _kernels.reset_launch_counts()
        tape = create_packed(str(path), validate_utf8=True)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["utf8_errs"] == launches
        assert tape.num_data_records == 1
    with pytest.raises(ct.InvalidCsvFormat, match="UTF-8"):
        create_packed(str(bad_path), validate_utf8=True)
    _kernels.reset_launch_counts()
    tape = ct.create_from_bytes("a,b\né,2\n".encode(), validate_utf8=True,
                                backend="native")
    assert _kernels.launch_counts()["utf8_errs"] == 1
    assert tape.seek_field(0, 0) == "é".encode()
    with pytest.raises(ct.InvalidCsvFormat, match="UTF-8"):
        ct.create_from_bytes(b"a,b\n1,\xe6\x97\n", validate_utf8=True,
                             backend="native")


def _typed_table() -> bytes:
    rng = np.random.default_rng(17)
    rows = ["id,dec,exp,date,ts,txt"]
    for i in range(3000):
        day = int(rng.integers(-20000, 40000))
        d = np.datetime64(day, "D")
        ts = np.datetime64(int(rng.integers(-10**9, 3 * 10**9)) * 1000
                           + int(rng.integers(0, 1000)), "ms")
        txt = rng.choice(['plain', '" pad "', '"say ""hi"""', "  x  ", '""'])
        rows.append(f"{i},{rng.integers(-10**6, 10**6)}.{i % 100:02d},"
                    f"{rng.integers(1, 10**6)}e{rng.integers(-50, 50)},"
                    f"{d},{str(ts).replace('T', ' ')},{txt}")
    rows.append("x,1.234,1e,2023-02-29,2024-01-02 24:00:00,\"a\"b")
    return ("\n".join(rows) + "\n").encode()


@pytest.mark.gpu
def test_typed_columns_on_the_card_match_the_cpu(cuda_device):
    """Each new column of both tapes on the card == the same call with
    device="cpu", bit for bit (floats as int32)."""
    data = _typed_table()
    tapes = (
        (PackedDeviceTape(data), PackedDeviceTape(data, device="cpu")),
        (ct.DeviceTape.from_tape(ct.create_from_bytes(data, backend="native",
                                                      device="cpu")),
         ct.DeviceTape.from_tape(ct.create_from_bytes(data, backend="native",
                                                      device="cpu"),
                                 device="cpu")),
    )
    recs = np.array([5, 3000, 0, 17, 2999, 3001, -1], np.int32)
    calls = (
        ("column_decimal64", (1,), {}), ("column_decimal64", (1,),
                                          {"scale": 3, "records": recs}),
        ("column_float32_exp", (2,), {}), ("column_float32", (1,), {}),
        ("column_date_days", (3,), {}),
        ("column_datetime64", (4,), {"unit": "ms"}),
        ("column_datetime64", (4,), {"unit": "us", "records": recs}),
        ("filter_equals", (5, b'"say ""hi"""'), {}),
        ("filter_equals", (0, b"17"), {"records": recs}),
        ("gather_decoded", (recs.clip(0, 3000), np.full(7, 5)), {}),
        ("column_decoded", (5,), {}),
    )
    for card, cpu in tapes:
        for name, args, kw in calls:
            got = getattr(card, name)(*args, **kw)
            want = getattr(cpu, name)(*args, **kw)
            for g, w in (zip(got, want) if isinstance(got, tuple)
                         else [(got, want)]):
                if isinstance(w, list):
                    assert g == w, name
                    continue
                g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
                w = w.numpy() if isinstance(w, torch.Tensor) else w
                assert g.dtype == w.dtype, name
                if w.dtype == np.float32:
                    g, w = g.view(np.int32), w.view(np.int32)
                assert np.array_equal(g, w), name


# ------------------------------------------------------- relational layer

REL_SCHEMA = {"id": "int32", "k": "int32", "v": "int32", "f": "float32",
              "x": "float", "d": "decimal:2", "day": "date",
              "ts": "datetime:ms", "s": "str", "t": "str"}
REL_RTOL = 1e-5


def _alike(got, want, path="result"):
    """got (card) == want (CPU): exact, float arrays and float sums of
    Stats within rtol=1e-5 (the card adds in another order)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _alike(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _alike(g, w, f"{path}[{i}]")
    elif isinstance(want, ct.Stats):
        for f in ("count", "ok_count", "min", "max"):
            assert getattr(got, f) == getattr(want, f), (path, f)
        for f in ("sum", "sum_sq"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g == pytest.approx(w, rel=REL_RTOL)
                    if isinstance(w, float) else g == w), (path, f)
    elif isinstance(want, ct.Frame):
        assert got.names == want.names and len(got) == len(want), path
        _alike(got.records, want.records, f"{path}.records")
        for n in want.names:
            _alike(got[n], want[n], f"{path}[{n}]")
            _alike(got.ok(n), want.ok(n), f"{path}.ok({n})")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=REL_RTOL,
                                       err_msg=path)
        elif want.dtype == object:
            assert got.tolist() == want.tolist(), path
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), (path, got,
                                                              want)


def _rel_calls(src):
    """(name, thunk) for each public relational function on `src`."""
    s = REL_SCHEMA
    return [
        ("column_stats int", lambda: ct.column_stats(src, "v", "int32")),
        ("column_stats float", lambda: ct.column_stats(
            src, "f", "float32", where=("k", ">", 0), schema=s)),
        ("column_stats decimal", lambda: ct.column_stats(src, "d",
                                                         "decimal:2")),
        ("column_quantiles", lambda: ct.column_quantiles(
            src, "x", (0.01, 0.5, 0.99), "float")),
        ("describe", lambda: ct.describe(src, ["v", "f", "s"], schema=s)),
        ("value_counts", lambda: ct.value_counts(src, "s", "str")),
        ("distinct", lambda: ct.distinct(src, "k", "int32")),
        ("groupby_typed", lambda: ct.groupby_typed(
            src, ["t", "k"], ["v", "f"], key_spec=["str", "int32"],
            value_spec=["int32", "float32"], having=("count", ">", 0))),
        ("read_typed", lambda: ct.read_typed(
            src, s, where=[("s", "like", "%a%"), ("v", "<", 0)],
            order_by="f", descending=True)),
        ("join_typed", lambda: ct.join_typed(
            src, src, "k", how="left", schema=s, right_schema=s,
            columns=["id", "v"], right_columns=["s"])),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["offsets", "packed"])
def test_relational_layer_on_the_card_matches_the_cpu(cuda_device, engine):
    """Each public relational function on a CUDA tape == the same call on
    a device="cpu" tape of the same bytes."""
    data = relational_csv(11)
    from csv_simd_tpu_torch.frame import _resolve_tape
    card, _ = _resolve_tape(data, None, "auto", engine, False, cuda_device)
    cpu, names = _resolve_tape(data, None, "auto", engine, False, "cpu")
    assert card.device.type == "cuda"
    for (name, got), (_, want) in zip(_rel_calls(card), _rel_calls(cpu)):
        _alike(got(), want(), name)
    for by in ("v", "f", "d", "s", ["t", "day"]):
        _alike(ct.order_records(card, by, schema=REL_SCHEMA, descending=True),
               ct.order_records(cpu, by, schema=REL_SCHEMA, descending=True),
               f"order_records({by})")
    where = ("or", [("s", "like", "a_b%"), ("x", "between", (1.0, 100.0)),
                    ("s", "in", ["AAPL", ""])])
    _alike(ct.select_records(card, where, schema=REL_SCHEMA),
           ct.select_records(cpu, where, schema=REL_SCHEMA), "select")
    for how in ("inner", "outer", "semi", "anti"):
        _alike(ct.join_records(card, card, ["t", "k"], how=how),
               ct.join_records(cpu, cpu, ["t", "k"], how=how), how)
        _alike(ct.join_records(card, card, "k", how=how, left_spec="int32",
                               right_spec="int32"),
               ct.join_records(cpu, cpu, "k", how=how, left_spec="int32",
                               right_spec="int32"), how)
    assert ct.write_csv(ct.read_typed(card, REL_SCHEMA)) == ct.write_csv(
        ct.read_typed(cpu, REL_SCHEMA))
    assert {n: repr(c) for n, c in ct.infer_schema(card, names).items()} \
        == {n: repr(c) for n, c in ct.infer_schema(cpu, names).items()}
    # the values and masks stay on the card
    from csv_simd_tpu_torch import query
    vals, ok, _ = query._parse_column(card, 2, ct.Col("int32"), None)
    assert vals.device.type == ok.device.type == "cuda"
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(rng.integers(-9, 9, 70_000).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, 70_000)
                            .astype(np.int32))
    _alike(ct.group_aggregate(keys.to(cuda_device), vals.to(cuda_device)),
           ct.group_aggregate(keys, vals), "group_aggregate")


@pytest.mark.gpu
def test_corpus_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """A three-file CsvCorpus on the card == on the CPU: its per-file
    aggregates, the corpus tape's routed gathers (tensors on the card)
    and ORDER BY through the corpus tape."""
    paths = []
    for i, n in enumerate((150, 40, 90)):
        p = tmp_path / f"part{i}.csv"
        p.write_bytes(relational_csv(60 + i, n))
        paths.append(str(p))
    card = ct.CsvCorpus(paths, device=cuda_device)
    cpu = ct.CsvCorpus(paths, device="cpu")
    for (name, got), (_, want) in zip(_rel_calls(card), _rel_calls(cpu)):
        if name != "join_typed":
            _alike(got(), want(), name)
    _alike(ct.column_quantiles(card, "v", (0.0, 0.3, 1.0), "int32"),
           ct.column_quantiles(cpu, "v", (0.0, 0.3, 1.0), "int32"),
           "corpus quantiles")
    recs = np.r_[np.arange(0, 280, 7), 279, 280, -1]
    flds = np.arange(recs.size) % 10
    got = card.serving_tape().gather_fields(recs, flds, 32)
    want = cpu.serving_tape().gather_fields(recs, flds, 32)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    _alike(ct.order_records(card.serving_tape(), "ts", schema=REL_SCHEMA),
           ct.order_records(cpu.serving_tape(), "ts", schema=REL_SCHEMA),
           "corpus order")


# -------------------------------------------------------------------- SQL

WINDOW_FNS = ("row_number", "rank", "dense_rank", "percent_rank",
              "cume_dist", "lag", "lead", "ntile", "first_value",
              "last_value", "nth_value", "count", "sum", "mean", "min",
              "max")


def _same_payload(got, want, path):
    """window_column / set-operation results: exact, floats bit for bit
    (the card's float32 additions round as the CPU's)."""
    assert (got is None) == (want is None), path
    if want is None:
        return
    if isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_payload(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.gpu
def test_window_column_on_the_card_matches_the_cpu(cuda_device,
                                                   monkeypatch):
    """Every window function family over device-resident and host keys
    (NULLS FIRST among them), int and float32 values, the default frame
    and ROWS frames: the card's payload == the CPU's."""
    from csv_simd_tpu_torch import window
    from csv_simd_tpu_torch.query import SortDir

    monkeypatch.setattr(window, "DEVICE_WINDOW_MIN_ROWS", 1)
    rng = np.random.default_rng(5)
    n = 40_000
    part = rng.integers(0, 400, n).astype(np.int32)
    pok = rng.random(n) > 0.05
    text = rng.choice(np.array(["a", "bb", "c"], object), n)
    order = rng.integers(-900, 900, n).astype(np.int32)
    ook = rng.random(n) > 0.1
    vi = rng.integers(-10**6, 10**6, n).astype(np.int32)
    big = rng.choice([1e6, -1e6, 3e7], n) * rng.integers(0, 2, n)
    vf = (big + rng.standard_normal(n)).astype(np.float32)
    vok = rng.random(n) > 0.1

    def run(fn, dev, vals, frame):
        t = (lambda a: torch.from_numpy(a).to(dev))
        keys = [(part, pok, (t(part), t(pok))), (text, None)]
        orders = [(order, ook, SortDir(True, True), (t(order), t(ook)))]
        value = fn in ("count", "sum", "mean", "min", "max")
        return window.window_column(
            fn, n, keys, orders, vals if value else None,
            vok if value else None,
            offset={"lag": 2, "ntile": 7, "nth_value": 3}.get(fn, 1),
            is_int=vals.dtype.kind == "i", frame=frame,
            dev=(t(vals), t(vok)) if value else None, device=dev)

    for fn in WINDOW_FNS:
        frames = [None] if fn in WINDOW_FNS[:8] else \
            [None, ("rows", None, 0), ("rows", -3, None), ("rows", -3, 3),
             ("rows", -5000, 5000)]
        for vals in (vi, vf):
            for frame in frames:
                got = run(fn, cuda_device, vals, frame)
                want = run(fn, "cpu", vals, frame)
                assert got is not None, (fn, frame)
                assert got[0] == want[0], (fn, frame)
                _same_payload(got[1], want[1], f"{fn} {frame} {vals.dtype}")


@pytest.mark.gpu
def test_set_operations_on_the_card_match_the_cpu(cuda_device):
    from csv_simd_tpu_torch import setops

    rng = np.random.default_rng(6)
    n = 30_000
    cols = {"a": rng.integers(0, 30, n).astype(np.int32),
            "f": rng.integers(0, 9, n) / 4.0}
    oks = {"a": rng.random(n) > 0.05, "f": None}
    fr = ct.Frame(["a", "f"], cols, oks,
                  {"a": ct.Col("int32"), "f": ct.Col("float")}, n)
    _same_payload(setops.dedupe_keep(fr, cuda_device),
                  setops.dedupe_keep(fr, "cpu"), "dedupe")
    for op in ("except", "intersect"):
        for na in (1, 12_345, n - 1):
            _same_payload(
                setops.setop_keep_concat(fr, na, op, device=cuda_device),
                setops.setop_keep_concat(fr, na, op, device="cpu"),
                f"{op} {na}")


SQL_STATEMENTS = (
    "SELECT id, ROW_NUMBER() OVER (PARTITION BY k ORDER BY v) AS rn,"
    " SUM(v) OVER (PARTITION BY k) AS s, AVG(f) OVER (PARTITION BY t"
    " ORDER BY id) AS m, COUNT(*) OVER (PARTITION BY k) AS c FROM t",
    "SELECT id, RANK() OVER (ORDER BY f DESC, id) AS r,"
    " LAG(s) OVER (ORDER BY f DESC, id) AS p,"
    " MIN(v) OVER (ORDER BY f ROWS BETWEEN 3 PRECEDING AND"
    " 3 FOLLOWING) AS lo FROM t",
    "SELECT k, v FROM t UNION SELECT k, v FROM t WHERE v > 0",
    "SELECT k, f FROM t EXCEPT SELECT k, f FROM t WHERE f < 0",
    "SELECT k, f FROM t INTERSECT SELECT k, f FROM t WHERE f < 0",
    "SELECT t, COUNT(*), SUM(v), AVG(f) FROM t GROUP BY t"
    " HAVING COUNT(*) > 1 ORDER BY t LIMIT 10",
    "SELECT a.id, b.s FROM a JOIN b ON a.id = b.id WHERE a.v > 0",
    "SELECT id FROM t WHERE k IN (SELECT k FROM t WHERE v > 0)",
)


def _sql_alike(got, want, path):
    if type(want).__name__ == "SqlResult":
        assert got.names == want.names and len(got) == len(want), path
        for n in want.names:
            _alike(np.asarray(got[n]), np.asarray(want[n]), f"{path}[{n}]")
    else:
        _alike(got, want, path)


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["offsets", "packed"])
def test_sql_on_the_card_matches_the_cpu(cuda_device, engine, monkeypatch):
    """sql() over a CUDA tape == over a device="cpu" tape of the same
    bytes: windows and set operations on their device path (thresholds
    at 1), GROUP BY, a JOIN, an IN subquery and EXPLAIN ANALYZE."""
    from csv_simd_tpu_torch import setops, window
    from csv_simd_tpu_torch.frame import _resolve_tape

    monkeypatch.setattr(window, "DEVICE_WINDOW_MIN_ROWS", 1)
    monkeypatch.setattr(setops, "DEVICE_SETOP_MIN_ROWS", 1)
    data = relational_csv(11)
    card, _ = _resolve_tape(data, None, "auto", engine, False, cuda_device)
    cpu, _ = _resolve_tape(data, None, "auto", engine, False, "cpu")
    for q in SQL_STATEMENTS:
        got = ct.sql(q, card, tables={"a": card, "b": card},
                     schema=REL_SCHEMA, right_schema=REL_SCHEMA,
                     device=cuda_device)
        want = ct.sql(q, cpu, tables={"a": cpu, "b": cpu},
                      schema=REL_SCHEMA, right_schema=REL_SCHEMA,
                      device="cpu")
        _sql_alike(got, want, q)
    q = "EXPLAIN ANALYZE " + SQL_STATEMENTS[0]
    got = ct.sql(q, card, schema=REL_SCHEMA, device=cuda_device)
    want = ct.sql(q, cpu, schema=REL_SCHEMA, device="cpu")
    assert got.split("-- ANALYZE --")[0] == want.split("-- ANALYZE --")[0]
    assert "sql.window" in got


@pytest.mark.gpu
def test_sql_leaves_no_large_tensor_on_the_cpu(cuda_device, monkeypatch):
    """sql(device="cuda") over CUDA tapes of 6,000 rows: every aten op
    whose output has more than 4,096 elements runs on the card (copies
    between devices aside). The tapes are built first: a build stages
    its bytes in pinned host memory."""
    from csv_simd_tpu_torch import setops, window

    monkeypatch.setattr(window, "DEVICE_WINDOW_MIN_ROWS", 1)
    monkeypatch.setattr(setops, "DEVICE_SETOP_MIN_ROWS", 1)
    from csv_simd_tpu_torch.frame import _resolve_tape

    data = relational_csv(12, 6000)
    for engine in ("offsets", "packed"):
        tape, _ = _resolve_tape(data, None, "auto", engine, False,
                                cuda_device)
        for q in SQL_STATEMENTS:
            with _watch() as w:
                ct.sql(q, tape, tables={"a": tape, "b": tape},
                       schema=REL_SCHEMA, right_schema=REL_SCHEMA,
                       device=cuda_device)
            assert w.cuda_ops and not w.cpu_ops, (engine, q, w.cpu_ops[:5])


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["offsets", "packed"])
def test_top_k_group_by_on_the_card_matches_the_cpu(cuda_device, engine):
    """The ClickBench statements of the hits cell (top-k chosen on the
    device, int64 and long text keys, COUNT(DISTINCT), a LIKE) over a
    CUDA tape == over a device="cpu" tape of the same bytes, and no step
    leaves a tensor of more than 4,096 elements on the CPU."""
    from test_torch_topk_groups import Q, SCHEMA, hits_csv

    from csv_simd_tpu_torch.frame import _resolve_tape

    data = hits_csv(21, 6000)
    card, _ = _resolve_tape(data, None, "auto", engine, False, cuda_device)
    cpu, _ = _resolve_tape(data, None, "auto", engine, False, "cpu")
    stmts = [q.format(k=10) for q, _ in Q.values()] + [
        "SELECT COUNT(*) FROM hits WHERE URL LIKE '%google%'"]
    for q in stmts:
        with _watch() as w:
            got = ct.sql(q, card, schema=SCHEMA, device=cuda_device)
        assert w.cuda_ops and not w.cpu_ops, (engine, q, w.cpu_ops[:5])
        want = ct.sql(q, cpu, schema=SCHEMA, device="cpu")
        assert list(got.keys()) == list(want.keys())
        for k in want.keys():
            assert np.asarray(got[k]).tolist() == \
                np.asarray(want[k]).tolist(), (q, k)


def _watch():
    """A TorchDispatchMode that counts the aten ops whose outputs lie on
    the card and records every op that leaves a tensor of more than 4,096
    elements on the CPU (copies between devices aside)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    crossing = {"_to_copy", "copy_", "lift_fresh", "detach", "alias"}

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cuda_ops = 0
            self.cpu_ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    if t.device.type == "cuda":
                        self.cuda_ops += 1
                    elif t.numel() > 4096 and name not in crossing:
                        self.cpu_ops.append((name, tuple(t.shape)))
            return out

    return Watch()


# ------------------------------------------------------------ sharding

def _quote_bytes(n_bytes: int, density: float, quote: int,
                 seed: int) -> np.ndarray:
    """Random bytes with no `quote`, then `quote` at a share `density` of
    the positions."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    b = np.where(b == quote, quote ^ 1, b)
    return np.where(rng.random(n_bytes) < density, quote, b).astype(np.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 16, 24, 520, 1024, 4104, 70_001])
def test_shard_parity_kernel_matches_plain(cuda_device, rows):
    """S1 against its plain version on shards of 8 to 70,001 rows, quote
    densities 0, 1/64 and 1/2, three quote bytes."""
    from csv_simd_tpu_torch.parallel.sharded import _local_parity_plain

    for density in (0.0, 1 / 64, 0.5):
        for quote in (0x22, 0x27, 0xA2):
            b = _quote_bytes(rows * 512, density, quote, rows)
            w = torch.from_numpy(b.view(np.int32).copy())
            want = int(_local_parity_plain(w, Dialect(quote=quote)))
            before = _kernels.launch_counts()["quote_parity"]
            got = _kernels.quote_parity(w.to(cuda_device), quote)
            assert got.dtype == torch.int32 and got.dim() == 0
            assert got.device.type == "cuda"
            assert int(got) == want == int((b == quote).sum() & 1)
            assert _kernels.launch_counts()["quote_parity"] == before + 1


@pytest.mark.gpu
def test_shard_parity_kernel_at_its_edges(cuda_device):
    """One quote at the first and the last byte of sizes at the kernel's
    block and grid-step edges (1,024 chunks of 16 bytes a block step;
    8 blocks an SM a grid step), and an even count spread over both."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    step = 8 * sms * 1024
    for chunks in (1, 2, 1023, 1024, 1025, 4097, step - 1, step, step + 1,
                   4 * step + 3):
        n = 16 * chunks
        for at in (0, n - 1, n // 2):
            b = np.zeros(n, np.uint8)
            b[at] = 0x22
            t = torch.from_numpy(b).to(cuda_device).view(torch.int32)
            assert int(_kernels.quote_parity(t, 0x22)) == 1, (chunks, at)
        b[0] = 0x22  # with b[n // 2] (b[n - 1] too when n == 1)
        t = torch.from_numpy(b).to(cuda_device).view(torch.int32)
        assert int(_kernels.quote_parity(t, 0x22)) == int(
            (b == 0x22).sum() & 1), chunks


@pytest.mark.gpu
def test_shard_parity_kernel_rejects_bad_input(cuda_device):
    w = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.quote_parity(w, 0x22)
    with pytest.raises(ValueError, match="int32"):
        _kernels.quote_parity(w.to(cuda_device).to(torch.int64), 0x22)
    with pytest.raises(ValueError, match="multiple of 16"):
        _kernels.quote_parity(w[:2].to(cuda_device), 0x22)
    with pytest.raises(ValueError, match="multiple of 16"):
        _kernels.quote_parity(w[:0].to(cuda_device), 0x22)


def _spanning_table(n_rows: int = 6000, seed: int = 8) -> bytes:
    """A 16-field table with a quoted field of about 40 KB, which crosses
    several shard cuts, and non-ASCII bytes."""
    rows = synthetic_wide_table(n_rows * 90, seed=seed).split(b"\n")
    span = b'"' + b"x,y\n" * 10_000 + b'"'
    rows[len(rows) // 3] = b",".join([span] + [b"\xc3\xa9"] * 15)
    return b"\n".join(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["fold", "seq", "seq_wide"])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_sharded_stage1_on_card_matches_cpu(cuda_device, n, layout):
    """Every output of sharded_stage1 on a CUDA mesh (S1 and B1 or B3 a
    shard) against the same call on a CPU mesh, with a device carry."""
    from csv_simd_tpu_torch.parallel.sharded import (
        make_mesh,
        pad_words_for_mesh,
        sharded_stage1,
    )

    arr = np.frombuffer(_spanning_table(), np.uint8)
    w2d = torch.from_numpy(pad_words_for_mesh(arr, n))
    if layout == "seq_wide":
        w2d = w2d.view(-1, 1024)
    cpu = sharded_stage1(w2d, 1, make_mesh(n, device="cpu"),
                         use_pallas=True, layout=layout,
                         count_nonascii=True)
    _kernels.reset_launch_counts()
    got = sharded_stage1(w2d.to(cuda_device),
                         torch.ones((), dtype=torch.int32, device=cuda_device),
                         make_mesh(n), layout=layout, count_nonascii=True)
    launches = _kernels.launch_counts()
    assert launches["quote_parity"] == n
    kernel = "stage1_fold" if layout == "fold" else "stage1_v4"
    assert launches[kernel] == n
    assert len(got[0]) == n and all(p.is_cuda for p in got[0])
    for a, b in zip(got[0], cpu[0]):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(got[1:], cpu[1:]):
        assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4, 5])
def test_sharded_tapes_and_builds_on_card_match_cpu(cuda_device, n):
    """ShardedPackedTape (S1, B1 and B2 once a shard), ShardedTape,
    build_index_sharded and the sharded streaming build on a CUDA mesh
    against a CPU mesh and golden."""
    from csv_simd_tpu_torch.parallel.serving import (
        ShardedPackedTape,
        ShardedTape,
    )
    from csv_simd_tpu_torch.parallel.sharded import (
        build_index_sharded,
        make_mesh,
    )
    from csv_simd_tpu_torch.streaming import build_index_sharded_streaming

    data = _spanning_table()
    want_index = golden.structural_index(data)
    _kernels.reset_launch_counts()
    gpu = ShardedPackedTape(data, make_mesh(n), validate_utf8=True)
    launches = _kernels.launch_counts()
    for name in ("quote_parity", "stage1_v4", "row_prefix"):
        assert launches[name] == n, (name, launches)
    cpu = ShardedPackedTape(data, make_mesh(n, device="cpu"),
                            validate_utf8=True)
    assert gpu.nonascii_count == cpu.nonascii_count > 0
    assert (gpu.record_cnt, gpu.shard_rows) == (cpu.record_cnt,
                                                 cpu.shard_rows)
    assert torch.equal(torch.cat([w.reshape(-1) for w in gpu.words]).cpu(),
                       torch.cat([w.reshape(-1) for w in cpu.words]))
    assert torch.equal(gpu.cum_incl.cpu(), cpu.cum_incl)
    rng = np.random.default_rng(n)
    recs = np.concatenate([rng.integers(0, gpu.num_data_records, 2000),
                           [-1, gpu.num_data_records, 0]]).astype(np.int32)
    flds = np.concatenate([rng.integers(0, 16, 2000),
                           [0, 0, 16]]).astype(np.int32)
    host = ct.create_from_bytes(data, backend="golden")
    offsets = ShardedTape.from_tape(host, make_mesh(n))
    offsets_cpu = ShardedTape.from_tape(host, make_mesh(n, device="cpu"))
    for max_len in (8, 64, 50_000):
        want = cpu.gather_fields(recs, flds, max_len)
        for t in (gpu, offsets, offsets_cpu):
            got = t.gather_fields(recs, flds, max_len)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), max_len
    vals, ok = gpu.column_int32(0)
    cvals, cok = cpu.column_int32(0)
    assert torch.equal(vals.cpu(), cvals) and torch.equal(ok.cpu(), cok)
    _kernels.reset_launch_counts()
    got = build_index_sharded(data, make_mesh(n))
    assert _kernels.launch_counts()["quote_parity"] == n
    assert _kernels.launch_counts()["stage1_fold"] == n
    np.testing.assert_array_equal(got, want_index)
    np.testing.assert_array_equal(
        build_index_sharded_streaming([data[i:i + 65_536] for i in
                                       range(0, len(data), 65_536)],
                                      make_mesh(n)), want_index)


@pytest.mark.gpu
def test_sharded_column_leaves_no_large_tensor_on_the_cpu(cuda_device):
    """column_int32 and a gather over the card's ShardedPackedTape and
    ShardedTape: every op with a large output runs on the card (the
    tapes are built first: a build stages its bytes in pinned memory)."""
    from csv_simd_tpu_torch.parallel.serving import (
        ShardedPackedTape,
        ShardedTape,
    )
    from csv_simd_tpu_torch.parallel.sharded import make_mesh

    data = synthetic_wide_table(1 << 20)
    host = ct.create_from_bytes(data, backend="golden")
    for tape in (ShardedPackedTape(data, make_mesh(4)),
                 ShardedTape.from_tape(host, make_mesh(4))):
        with _watch() as w:
            vals, ok = tape.column_int32(0)
            stats = ct.column_stats(tape, 0)
        assert w.cuda_ops and not w.cpu_ops, w.cpu_ops[:5]
        n = host.num_data_records
        assert bool(ok.all()) and stats.count == n
        assert np.array_equal(vals.cpu().numpy(),
                              np.array(host.column(0)).astype(np.int32))


# -- kernel J1, the JSON stage-1 (csrc/json_stage1.cu) --

def _json_on_card(data, device) -> tuple:
    from csv_simd_tpu_torch.experiments.json_device import _depths_plain

    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else data
    t = torch.from_numpy(arr.copy()).to(device)
    got = _kernels.json_stage1(t)
    want = _depths_plain(t)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
def test_json_kernel_matches_plain_on_edge_cases(cuda_device):
    from json_cases import CASES, escape_runs, random_alphabet, straddling

    cases = [c for c in CASES if c] + escape_runs(70)
    cases += [c for _, c in straddling()]
    cases += [random_alphabet(n, n) for n in
              (1, 2, 3, 4, 5, 15, 16, 17, 127, 128, 129, 511, 512, 513,
               16_383, 16_384, 16_385, 100_003, 1 << 20)]
    for data in cases:
        (m, d), (wm, wd) = _json_on_card(data, cuda_device)
        assert torch.equal(m, wm) and torch.equal(d, wd), bytes(data[:60])


@pytest.mark.gpu
def test_json_kernel_unaligned_and_empty(cuda_device):
    from json_cases import random_alphabet
    from csv_simd_tpu_torch.experiments.json_device import _depths_plain

    t = torch.from_numpy(random_alphabet(40_001, 3)).to(cuda_device)
    for off in (1, 2, 3, 5):
        got = _kernels.json_stage1(t[off:])
        want = _depths_plain(t[off:])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = _kernels.launch_counts()["json_stage1"]
    m, d = _kernels.json_stage1(t[:0])
    assert m.numel() == 0 and d.numel() == 0
    assert _kernels.launch_counts()["json_stage1"] == before
    with pytest.raises(ValueError):
        _kernels.json_stage1(t.cpu())
    with pytest.raises(ValueError):
        _kernels.json_stage1(t.to(torch.int32))


@pytest.mark.gpu
def test_json_depths_device_launches_j1_once(cuda_device):
    from json_cases import json_lines
    from csv_simd_tpu_torch.experiments import json_device

    block = json_lines(1 << 20, 11)
    before = _kernels.launch_counts()["json_stage1"]
    mask, depth = json_device.json_depths_device(block, device="cuda")
    assert _kernels.launch_counts()["json_stage1"] == before + 1
    cm, cd = json_device.json_depths_device(block, device="cpu")
    assert torch.equal(mask.cpu(), cm) and torch.equal(depth.cpu(), cd)
    assert int(depth[-1]) == 0
    got = json_device.json_structural_index_device(block, device="cuda")
    assert np.array_equal(got, np.flatnonzero(cm.numpy()))
    assert torch.equal(
        json_device.json_structural_mask_device(block, device="cuda").cpu(),
        cm)


def _cli_on(device, argv) -> tuple:
    """(exit code, stdout, launch counts) of the port's CLI in process."""
    import contextlib
    import io

    from csv_simd_tpu_torch.__main__ import main

    out = io.StringIO()
    _kernels.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = main(["--device", device, *argv])
    torch.cuda.synchronize()
    return rc, out.getvalue(), _kernels.launch_counts()


@pytest.mark.gpu
def test_cli_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """info, column --type int32, --validate-utf8 info, index --format
    packed_seq and json-index on the card print what they print on the
    CPU, each launching the kernels its path reaches."""
    from json_cases import json_lines

    csv = tmp_path / "t.csv"
    csv.write_bytes(relational_csv(3, n=2000))
    doc = tmp_path / "t.json"
    doc.write_bytes(json_lines(200_000, 5, distinct=128))
    art = str(tmp_path / "seq.npz")
    for argv, kernels in (
            (["info", str(csv)], ("stage1_fold",)),
            (["column", str(csv), "2", "--type", "int32", "--limit", "50"],
             ("stage1_fold",)),
            (["--validate-utf8", "info", str(csv)],
             ("stage1_fold", "utf8_errs")),
            (["index", str(csv), "-o", art, "--format", "packed_seq"],
             ("stage1_v4", "row_prefix")),
            (["json-index", str(doc), "--limit", "200"], ("json_stage1",))):
        rc, out, launched = _cli_on("cuda", argv)
        want = _cli_on("cpu", argv)
        assert (rc, out) == want[:2], argv
        assert rc == 0
        for k in kernels:
            assert launched[k] >= 1, (argv, k, launched)
        assert not any(want[2].values()), argv


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lineitem", "adversarial"])
def test_text_key_factorize_on_the_card_matches_the_cpu(cuda_device, case):
    """query._factorize_text_device on the card: codes, validity and the
    distinct keys equal the CPU run's, for Q1's flag columns at 2 M rows
    and for KEY_CASES (widths 17 and 24)."""
    from csv_simd_tpu_torch.query import _factorize_text_device

    if case == "lineitem":
        batches = lineitem_flags(2_000_000, 19)
    else:
        rng = np.random.default_rng(19)
        batches = []
        for width in (17, 24):
            keys = [KEY_CASES[i]
                    for i in rng.integers(0, len(KEY_CASES), 5000)]
            batches.append(key_batch(keys, rng.random(5000) > 0.1, width))
    for out, ln, v in batches:
        want = _factorize_text_device(out, ln, v)
        got = _factorize_text_device(out.to(cuda_device), ln.to(cuda_device),
                                     v.to(cuda_device))
        assert got[0].device.type == "cuda"
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert list(got[2][np.arange(len(got[2]))]) == \
            list(want[2][np.arange(len(want[2]))])


def _kth_on_card(words: np.ndarray, layout: str, device):
    """(CPU words, their plain prefix, card words, B2's prefix) in the
    layout."""
    shaped = words if layout == "narrow" else words.reshape(-1, 128)
    cpu = torch.from_numpy(np.ascontiguousarray(shaped))
    card = cpu.to(device)
    return cpu, _prefix_for_packed_xla(cpu), card, prefix_for_packed(card)


def _same_kth(ks: np.ndarray, cpu, cpu_cum, card, card_cum) -> None:
    """The kernel on the card against the plain version on the CPU, bit
    for bit and of one dtype (int64 where the words cover 2**31 bytes or
    more), with one launch (none for Q = 0)."""
    before = _kernels.launch_counts()["kth_positions"]
    got = _kernels.kth_positions(
        card, card_cum, torch.from_numpy(ks).to(card.device))
    assert _kernels.launch_counts()["kth_positions"] == \
        before + (1 if ks.size else 0)
    torch.cuda.synchronize()
    want = _kth_positions_plain(cpu, cpu_cum, torch.from_numpy(ks))
    wide = card.numel() * 32 >= 2**31
    assert got.dtype == (torch.int64 if wide else torch.int32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["narrow", "wide"])
@pytest.mark.parametrize("case", CASES)
def test_kth_kernel_matches_plain(cuda_device, case, layout):
    """The rank-select kernel against the plain `_kth_positions` on the
    same words on the CPU, for every valid k sorted and shuffled, the k at
    each row boundary, Q = 1 and Q = 0: empty rows, rows of 512 set bits,
    bits in the last place of a word and of a row, one bit a row, random
    words."""
    words = words_for(case, rows=4096, seed=CASES.index(case) + 21)
    parts = _kth_on_card(words, layout, cuda_device)
    for kind in RANKS:
        _same_kth(ranks(kind, words, seed=3), *parts)


@pytest.mark.gpu
def test_kth_kernel_past_two_to_the_22_rows(cuda_device):
    """A prefix of more than 2^22 rows (a binary search 23 levels deep):
    one set bit in most rows, random words in a few, every valid k in
    order and a shuffled sample. Positions of rows from 2^22 on pass
    2^31: the words cover more than 2 GiB, so both versions answer in
    int64."""
    rows = (1 << 22) + 4096
    rng = np.random.default_rng(22)
    words = np.zeros((rows, 16), np.int32)
    bit = rng.integers(0, 512, rows)
    hit = rng.random(rows) < 0.9
    words[hit, bit[hit] // 32] = (np.uint32(1) << (bit[hit] % 32).astype(
        np.uint32)).view(np.int32)
    dense = rng.random(rows) < 0.002
    words[dense] = rng.integers(-2**31, 2**31, (int(dense.sum()), 16),
                                dtype=np.int64).astype(np.int32)
    for layout in ("narrow", "wide"):
        parts = _kth_on_card(words, layout, cuda_device)
        total = int(parts[1][-1])
        _same_kth(np.arange(total, dtype=np.int32), *parts)
        _same_kth(rng.permutation(total)[:200_000].astype(np.int32), *parts)


@pytest.mark.gpu
def test_kth_kernel_outside_the_index_reads_inside_it(cuda_device):
    """k >= total, negative k and the int32 extremes: the answer is
    unspecified, and the kernel runs to its end with no fault."""
    for case in ("random", "empty_rows"):
        _, cpu_cum, card, card_cum = _kth_on_card(words_for(case, seed=5),
                                                  "narrow", cuda_device)
        total = int(cpu_cum[-1])
        ks = torch.tensor([total, total + 1, total + 10**6, 2**31 - 1, -1,
                           -2**31, 0], dtype=torch.int32, device=cuda_device)
        got = _kernels.kth_positions(card, card_cum, ks)
        torch.cuda.synchronize()
        assert got.shape == (7,)


@pytest.mark.gpu
def test_kth_kernel_rejects_bad_input(cuda_device):
    w = torch.zeros((64, 16), dtype=torch.int32, device=cuda_device)
    cum = prefix_for_packed(w)
    ks = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    for bad in ((w.cpu(), cum, ks), (w, cum.cpu(), ks), (w, cum, ks.cpu()),
                (w.to(torch.int64), cum, ks), (w, cum.to(torch.int64), ks),
                (w, cum, ks.to(torch.int64)), (w.t(), cum, ks),
                (w, cum[::2], ks), (w, cum, ks.view(5, 1)), (w, cum[:63], ks),
                (w[:0], cum[:0], ks)):
        with pytest.raises(ValueError):
            _kernels.kth_positions(*bad)


def _serve_on_card(words: np.ndarray, layout: int, jump: int,
                   field_cnt: int, max_len: int, device, n: int = 20_000,
                   seed: int = 0, cut: bool = False) -> None:
    """The serve kernel on the card against the plain serve on the CPU,
    bit for bit, on serve_case's bytes and queries over `words` in a
    layout of `layout` words a row, with one launch a call."""
    data, record_cnt, recs, flds = serve_case(words, jump, field_cnt, n,
                                              seed=seed, cut=cut)
    cpu = torch.from_numpy(np.ascontiguousarray(words.reshape(-1, layout)))
    args = [torch.from_numpy(data), cpu, _prefix_for_packed_xla(cpu),
            torch.from_numpy(recs), torch.from_numpy(flds)]
    card = [t.to(device) for t in args]
    card[2] = prefix_for_packed(card[1])
    tail = (jump, field_cnt, record_cnt, max_len)
    before = _kernels.launch_counts()
    got = _kernels.serve_packed(*card, *tail, False)
    after = _kernels.launch_counts()
    assert after["serve_packed"] == before["serve_packed"] + 1
    assert after["kth_positions"] == before["kth_positions"]
    torch.cuda.synchronize()
    want = _serve_plain(*args, *tail)
    for g, w in zip(got, want):
        assert g.device == card[0].device and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", MAX_LENS)
@pytest.mark.parametrize("case", CASES)
def test_serve_kernel_matches_plain(cuda_device, case, max_len):
    """The serve kernel against the plain serve on the same words on the
    CPU: the rank-select cases with commas at their bits (empty fields,
    fields across words and 512-byte rows, fields ending in the row after
    empty rows, fields longer than max_len with their TRUE lengths),
    both layouts, LF and CRLF strides, the bytes whole and cut at the
    last bit; valid queries, negative and last records, out-of-range
    fields, the int32 extremes."""
    words = words_for(case, rows=4096, seed=CASES.index(case) + 31)
    for (jump, field_cnt), layout in zip(STRIDES, (16, 128)):
        for cut in (False, True):
            _serve_on_card(words, layout, jump, field_cnt, max_len,
                           cuda_device, seed=max_len, cut=cut)


@pytest.mark.gpu
def test_serve_kernel_past_two_to_the_22_rows(cuda_device):
    """Words of more than 2^22 rows cover more than 2 GiB: the kernel's
    int64 positions, its fields past byte 2^31 and its forward search
    over runs of empty rows, against the plain serve; the bytes (4 MiB)
    are read at positions clamped into them, as the plain version's."""
    rows = (1 << 22) + 4096
    rng = np.random.default_rng(23)
    words = np.zeros((rows, 16), np.int32)
    bit = rng.integers(0, 512, rows)
    hit = rng.random(rows) < 0.3
    words[hit, bit[hit] // 32] = (np.uint32(1) << (bit[hit] % 32).astype(
        np.uint32)).view(np.int32)
    dense = rng.random(rows) < 0.002
    words[dense] = rng.integers(-2**31, 2**31, (int(dense.sum()), 16),
                                dtype=np.int64).astype(np.int32)
    cpu = torch.from_numpy(words.reshape(-1, 128))
    card = cpu.to(cuda_device)
    cum_cpu, cum = _prefix_for_packed_xla(cpu), prefix_for_packed(card)
    total = int(cum_cpu[-1])
    data = torch.from_numpy(rng.integers(0, 256, 4 << 20, dtype=np.uint8))
    record_cnt = total // 3
    recs = torch.from_numpy(np.r_[rng.integers(0, record_cnt - 1, 100_000),
                                  record_cnt - 2, record_cnt - 1, -1]
                            .astype(np.int32))
    flds = torch.from_numpy(rng.integers(0, 3, recs.numel()).astype(
        np.int32))
    for max_len in (8, 64):
        tail = (3, 3, record_cnt, max_len)
        got = _kernels.serve_packed(data.to(cuda_device), card, cum,
                                    recs.to(cuda_device),
                                    flds.to(cuda_device), *tail, True)
        want = _serve_plain(data, cpu, cum_cpu, recs, flds, *tail)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert int(want[1].max()) > 4096  # fields across many empty rows


@pytest.mark.gpu
def test_serve_kernel_takes_the_last_int32_record_as_invalid(cuda_device):
    """A record of 2^31 - 1 is invalid on the card (the plain version's
    `records + 1 < record_cnt` wraps there): zeros, length 0."""
    words = words_for("random", seed=4)
    data, record_cnt, _, _ = serve_case(words, 3, 3, 0)
    card = torch.from_numpy(words).to(cuda_device)
    out, lengths, valid = _kernels.serve_packed(
        torch.from_numpy(data).to(cuda_device), card,
        prefix_for_packed(card),
        torch.tensor([2**31 - 1, 0], dtype=torch.int32, device=cuda_device),
        torch.tensor([0, 1], dtype=torch.int32, device=cuda_device), 3, 3,
        record_cnt, 16, False)
    assert valid.tolist() == [False, True]
    assert lengths.tolist()[0] == 0 and out[0].eq(0).all()


@pytest.mark.gpu
def test_serve_kernel_with_no_queries_launches_nothing(cuda_device):
    words = words_for("random", seed=6)
    data, record_cnt, _, _ = serve_case(words, 3, 3, 0)
    card = torch.from_numpy(words).to(cuda_device)
    none = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    before = _kernels.launch_counts()["serve_packed"]
    for max_len in (0, 32):
        out, lengths, valid = _kernels.serve_packed(
            torch.from_numpy(data).to(cuda_device), card,
            prefix_for_packed(card), none, none, 3, 3, record_cnt, max_len,
            False)
        assert out.shape == (0, max_len) and out.dtype == torch.uint8
        assert lengths.shape == (0,) and valid.dtype == torch.bool
    assert _kernels.launch_counts()["serve_packed"] == before


@pytest.mark.gpu
def test_serve_kernel_rejects_bad_input(cuda_device):
    w = torch.zeros((64, 16), dtype=torch.int32, device=cuda_device)
    cum = prefix_for_packed(w)
    d = torch.zeros(100, dtype=torch.uint8, device=cuda_device)
    q = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    good = (d, w, cum, q, q)
    bad = [(d.cpu(), w, cum, q, q), (d, w.cpu(), cum, q, q),
           (d, w, cum, q.cpu(), q), (d, w, cum, q, q.cpu()),
           (d.to(torch.int32), w, cum, q, q), (d, w, cum, q.long(), q),
           (d, w, cum.long(), q, q), (d, w.t(), cum, q, q),
           (d, w, cum[:63], q, q), (d, w, cum, q, q[:4]),
           (d, w, cum, q.view(5, 1), q), (d[:0], w, cum, q, q),
           (d, w, cum, q[::2], q[::2])]
    for args in bad:
        with pytest.raises(ValueError):
            _kernels.serve_packed(*args, 3, 3, 10, 8, False)
    for tail in ((0, 3, 10, 8, False), (3, 3, 10, -1, False)):
        with pytest.raises(ValueError):
            _kernels.serve_packed(*good, *tail)


@pytest.mark.gpu
def test_gather_column_takes_the_rank_select_kernel(cuda_device):
    """One gather_column on a packed tape on the card: one launch of the
    serve kernel and none of the bare rank-select kernel, its N queries
    counted, and the column equal to the CPU tape's."""
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    data = synthetic_wide_table(300_000)
    gpu = PackedDeviceTape(data, device=cuda_device)
    cpu = PackedDeviceTape(data, device="cpu")

    def calls(name):
        st = GLOBAL.stages.get(name)
        return st.calls if st is not None else 0

    names = ("offsetfree.serve_kernel_queries",
             "offsetfree.kth_kernel_queries", "offsetfree.kth_wide_queries")
    queries = [calls(name) for name in names]
    before = _kernels.launch_counts()
    got = gpu.gather_column(3, max_len=48)
    after = _kernels.launch_counts()
    assert after["serve_packed"] == before["serve_packed"] + 1
    assert after["kth_positions"] == before["kth_positions"]
    assert [calls(name) for name in names] == [
        queries[0] + gpu.num_data_records, queries[1], queries[2]]
    for g, c in zip(got, cpu.gather_column(3, max_len=48)):
        assert torch.equal(g.cpu(), c)


@pytest.mark.gpu
def test_create_packed_past_two_gib_on_card(cuda_device, tmp_path):
    """create_packed of a file just past 2**31 bytes, with a quoted field
    of commas, line breaks and doubled quotes straddling byte 2**31: one
    PackedDeviceTape whose rank-select answers are int64 and, with the
    served fields and two int32 columns, equal to the NumPy reckoning for
    records before, across and past the boundary; every k counted as
    wide."""
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    case = PastCsv(2**31)
    assert case.data.size > 2**31 and case.straddle[0] < 2**31
    assert case.straddle[1] > 2**31 + 4096
    path = tmp_path / "past.csv"
    case.data.tofile(path)
    tape = create_packed(path, device=cuda_device)
    assert tape.words.is_cuda and tape.n_bytes == case.data.size
    records = case.records(np.random.default_rng(31), 20_000)
    st = GLOBAL.stages.get("offsetfree.kth_wide_queries")
    before = st.calls if st is not None else 0
    st = GLOBAL.stages.get("offsetfree.serve_kernel_queries")
    served = st.calls if st is not None else 0
    launches = _kernels.launch_counts()["serve_packed"]
    top = check_tape(tape, case, records)
    assert top > 2**31
    # a record's k: 3 of the check's own rank-select call, 2 a field of
    # the 3 served and of each of the 2 typed columns; the serve kernel
    # answered the served fields and both columns, one launch each
    assert GLOBAL.stages["offsetfree.kth_wide_queries"].calls == \
        before + 13 * records.size
    assert GLOBAL.stages["offsetfree.serve_kernel_queries"].calls == \
        served + 5 * records.size
    assert _kernels.launch_counts()["serve_packed"] == launches + 3
