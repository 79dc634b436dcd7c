"""The port's UTF-8 validation (csv_simd_tpu_torch.ops.utf8 and the
validate_utf8 flag of create_from_bytes and PackedDeviceTape) against the
JAX package's, on the CPU, where the device check runs its plain PyTorch
version `_utf8_errs_plain`.

Every case of tests/test_utf8.py runs through the port; the plain error
count equals `_utf8_errs_jit`'s on short and random buffers; and the
flag gives the JAX package's result, the same bytes or the same error.
Tolerance: exact (booleans and integer counts)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csv_simd_tpu
import csv_simd_tpu_torch as ct
from csv_simd_tpu.offsetfree import PackedDeviceTape as JTape
from csv_simd_tpu.ops import utf8 as jutf8
from csv_simd_tpu_torch.ops import utf8 as putf8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _py_valid(b: bytes) -> bool:
    try:
        b.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def _device_valid(b: bytes) -> bool:
    return putf8.validate_utf8_device(torch.from_numpy(
        np.frombuffer(b, dtype=np.uint8).copy()))


def _plain_errs(b: bytes) -> int:
    return putf8._utf8_errs_plain(torch.from_numpy(
        np.frombuffer(b, dtype=np.uint8).copy()))


def _jit_errs(b: bytes) -> int:
    return int(jutf8._utf8_errs_jit(jnp.asarray(
        np.frombuffer(b, dtype=np.uint8))))


EDGES = [
    (b"", True),
    (b"hello", True),
    ("héllo wörld".encode(), True),
    ("日本語テキスト".encode(), True),
    ("emoji \U0001f389".encode(), True),
    (b"\xed\x9f\xbf", True),        # U+D7FF, last before surrogates
    (b"\xee\x80\x80", True),        # U+E000, first after surrogates
    (b"\xf4\x8f\xbf\xbf", True),    # U+10FFFF max
    (b"\x80", False),               # lone continuation
    (b"\xbf", False),
    (b"\x80\x80", False),
    (b"\xc0\x80", False),           # overlong 2
    (b"\xc1\xbf", False),
    (b"\xe0\x80\x80", False),       # overlong 3
    (b"\xe0\x9f\xbf", False),
    (b"\xed\xa0\x80", False),       # surrogate
    (b"\xf0\x80\x80\x80", False),   # overlong 4
    (b"\xf0\x8f\xbf\xbf", False),
    (b"\xf4\x90\x80\x80", False),   # > U+10FFFF
    (b"\xf5\x80\x80\x80", False),
    (b"\xe2\x82", False),           # truncated 3
    (b"\xf0\x9f\x98", False),       # truncated 4
    (b"a\xc3", False),              # truncated 2
    (b"ok\xff", False),
    (b"\xfe", False),
]


@pytest.mark.parametrize("data,want", EDGES, ids=lambda v: repr(v)[:24])
def test_edges(data, want):
    assert putf8.validate_utf8(data) == want == _py_valid(data)
    assert jutf8.validate_utf8(data) == want
    assert _device_valid(data) == want
    if data:
        assert _plain_errs(data) == _jit_errs(data)


def test_fuzz_random_bytes():
    rng = random.Random(7)
    for _ in range(2000):
        b = bytes(rng.randint(0, 255) for _ in range(rng.randint(0, 48)))
        want = _py_valid(b)
        assert putf8.validate_utf8(b) == want, b.hex()
        assert _device_valid(b) == want, b.hex()


def test_fuzz_valid_strings():
    rng = random.Random(8)
    for _ in range(400):
        s = "".join(chr(rng.randint(1, 0x10FFFF))
                    for _ in range(rng.randint(0, 24)))
        s = "".join(ch for ch in s if not 0xD800 <= ord(ch) < 0xE000)
        assert putf8.validate_utf8(s.encode("utf-8"))
        assert _device_valid(s.encode("utf-8"))


def test_is_ascii():
    assert putf8.is_ascii(b"plain text 123")
    assert not putf8.is_ascii("café".encode())
    assert putf8.is_ascii(b"")


DEVICE_CASES = [
    "plain ascii".encode(),
    "héllo wörld ©®™".encode(),
    "日本語テキスト𝄞".encode(),
    b"\xff\xfe bad",
    b"ok \xc3\x28 overlong-ish",   # invalid continuation
    b"trunc \xe6\x97",             # truncated 3-byte at end
    "edge߿ࠀ￿".encode() + "\U0010FFFF".encode(),
    b"\xed\xa0\x80",               # surrogate
    b"\xf4\x90\x80\x80",           # > U+10FFFF
]


def test_validate_utf8_device_matches_host():
    for c in DEVICE_CASES:
        arr = np.frombuffer(c, dtype=np.uint8)
        want = jutf8.validate_utf8_device(arr)
        assert want == jutf8.validate_utf8(arr), c
        assert putf8.validate_utf8_device(arr, device="cpu") == want, c
        assert putf8.validate_utf8_device(torch.from_numpy(arr.copy())) \
            == want, c
        assert putf8.validate_utf8(arr) == want, c


def test_validate_utf8_device_takes_host_bytes_and_views():
    # an odd-offset view of a CPU tensor, and bytes to upload to the CPU
    data = b"x" + "héllo".encode()
    t = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    assert putf8.validate_utf8_device(t[1:])
    assert putf8.validate_utf8_device(data[1:], device="cpu")
    assert not putf8.validate_utf8_device(t[3:])  # starts mid-sequence
    assert putf8.validate_utf8_device(b"", device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        putf8.validate_utf8_device(t.to(torch.int32))


def test_create_validate_utf8_flag():
    good = "a,b\n1,héllo\n".encode()
    t = ct.create_from_bytes(good, backend="golden", validate_utf8=True,
                             device="cpu")
    assert t.seek_field(0, 1) == "héllo".encode()
    bad = b"a,b\n1,\xff\xfe\n"
    with pytest.raises(ct.InvalidCsvFormat, match="UTF-8"):
        ct.create_from_bytes(bad, backend="golden", validate_utf8=True,
                             device="cpu")
    # without the flag the bytes pass through untouched (reference
    # behavior: from_utf8_unchecked, record_source.rs:135-139)
    t2 = ct.create_from_bytes(bad, backend="golden", device="cpu")
    assert t2.seek_field(0, 1) == b"\xff\xfe"


def test_packed_tape_validate_utf8():
    good = "a,b\n1,héllo\n".encode()
    pt = ct.PackedDeviceTape(good, validate_utf8=True, device="cpu")
    assert int(pt.record_cnt) == 2
    with pytest.raises(ct.InvalidCsvFormat, match="UTF-8"):
        ct.PackedDeviceTape(b"a,b\n1,\xff\xfe\n", validate_utf8=True,
                            device="cpu")


@pytest.mark.parametrize("n", range(8))
def test_plain_count_equals_jit_at_short_lengths(n):
    rng = np.random.default_rng(100 + n)
    pool = np.array([0x00, 0x41, 0x80, 0x9F, 0xA0, 0xBF, 0xC0, 0xC2, 0xDF,
                     0xE0, 0xED, 0xEF, 0xF0, 0xF4, 0xF5, 0xFF], np.uint8)
    for _ in range(60):
        b = rng.choice(pool, size=n).tobytes()
        got = _plain_errs(b)
        if n == 0:
            # _utf8_errs_jit cannot index an empty array; both device
            # checks call the empty buffer valid
            assert got == 0
            assert jutf8.validate_utf8_device(np.zeros(0, np.uint8))
            continue
        assert got == _jit_errs(b), b.hex()
        assert (got == 0) == _py_valid(b), b.hex()


def _mixed_buffer(rng, n_chars: int) -> bytes:
    """Valid text of 1-4 byte characters with bad bytes injected: lone
    continuations, invalid leads, cut sequences, overlongs, surrogates."""
    chars = ["a", ",", "\n", "é", "ß", "日", "語", "€", "😀", "\U0010FFFF"]
    bad = [b"\x80", b"\xbf", b"\xff", b"\xf5", b"\xc0\x80", b"\xe6\x97",
           b"\xf0\x9f\x98", b"\xed\xa0\x80", b"\xe0\x80\x80",
           b"\xf4\x90\x80\x80", b"\xc3"]
    out = []
    for _ in range(n_chars):
        if rng.random() < 0.08:
            out.append(bad[rng.integers(len(bad))])
        else:
            out.append(chars[rng.integers(len(chars))].encode())
    return b"".join(out)


def test_plain_count_equals_jit_on_random_buffers():
    rng = np.random.default_rng(11)
    lengths = (9, 16, 17, 31, 64, 100, 255, 513)  # few shapes: few compiles
    n_invalid = 0
    for i in range(200):
        n = lengths[i % len(lengths)]
        b = _mixed_buffer(rng, n)[:n]
        b = b + b"a" * (n - len(b))
        got = _plain_errs(b)
        assert got == _jit_errs(b), b.hex()
        assert (got == 0) == _py_valid(b) == putf8.validate_utf8(b), b.hex()
        n_invalid += got != 0
    assert 20 < n_invalid < 200  # both outcomes are exercised


@pytest.mark.parametrize("data", [b"a,b\n\xc3\xa9,2\n", b"a,b\n\xff,2\n"],
                         ids=["valid_e_acute", "invalid_ff"])
def test_create_from_bytes_and_packed_tape_match_jax(data):
    try:
        want = csv_simd_tpu.create_from_bytes(
            data, backend="jnp", validate_utf8=True).seek_field(0, 0)
    except csv_simd_tpu.InvalidCsvFormat:
        want = "InvalidCsvFormat"
    try:
        got = ct.create_from_bytes(data, backend="torch", validate_utf8=True,
                                   device="cpu").seek_field(0, 0)
    except ct.InvalidCsvFormat:
        got = "InvalidCsvFormat"
    assert got == want
    try:
        jt = JTape(data, validate_utf8=True)
        want = (int(jt.record_cnt), jt.to_host_lists(
            *jt.gather_fields(np.array([0]), np.array([0]), 8)))
    except csv_simd_tpu.InvalidCsvFormat:
        want = "InvalidCsvFormat"
    try:
        pt = ct.PackedDeviceTape(data, validate_utf8=True, device="cpu")
        got = (int(pt.record_cnt), pt.to_host_lists(
            *pt.gather_fields([0], [0], 8)))
    except ct.InvalidCsvFormat:
        got = "InvalidCsvFormat"
    assert got == want
    assert (want == "InvalidCsvFormat") == (data == b"a,b\n\xff,2\n")
