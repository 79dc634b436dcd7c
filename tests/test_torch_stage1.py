"""The port's stage-1 build against the JAX package, bit for bit.

The same padded input goes through the port's `stage1_fused_v4` (the
plain PyTorch version: the tensors lie on the CPU), the JAX
`stage1_fused_v4` in interpret mode with out_mode="wide_native", the
JAX `stage1_seq_xla` and `golden.structural_mask`. Tolerance 0. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import golden
from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.ops.stage1_v2 import pad_to_words as jpad_to_words
from csv_simd_tpu.ops.stage1_v3 import stage1_seq_xla as jstage1_seq_xla
from csv_simd_tpu.ops.stage1_v4 import stage1_fused_v4 as jstage1_fused_v4
from csv_simd_tpu_torch.config import DEFAULT_DIALECT, Dialect
from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words, padded_rows
from csv_simd_tpu_torch.ops.stage1_v3 import stage1_seq_xla
from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4

from corpus import all_cases

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
    "non_ascii_quote": dict(quote=0xA2),
}


def _unpack(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(
        np.ascontiguousarray(packed).view("<u4").view(np.uint8),
        bitorder="little")[:n]


def _check_all(arr: np.ndarray, dialect_kw: dict, carry: int,
               count_nonascii: bool) -> None:
    """Port (narrow and wide_native) == JAX interpret wide_native ==
    JAX stage1_seq_xla == golden, for one input and configuration."""
    w = pad_to_words(arr)
    td, jd = Dialect(**dialect_kw), JDialect(**dialect_kw)
    wide, tpar, tna = stage1_fused_v4(
        torch.from_numpy(w.reshape(-1, 1024).copy()), carry, td,
        count_nonascii=count_nonascii, out_mode="wide_native")
    narrow, tpar2, tna2 = stage1_fused_v4(
        torch.from_numpy(w.copy()), carry, td,
        count_nonascii=count_nonascii, out_mode="narrow")
    assert wide.shape == (w.shape[0] // 8, 128)
    assert narrow.shape == (w.shape[0], 16)
    np.testing.assert_array_equal(wide.numpy().reshape(-1, 16),
                                  narrow.numpy())
    jwide, jpar, jna = jstage1_fused_v4(
        jnp.asarray(w.reshape(-1, 1024)), carry, jd, interpret=True,
        count_nonascii=count_nonascii, out_mode="wide_native")
    np.testing.assert_array_equal(wide.numpy(), np.asarray(jwide))
    assert int(tpar) == int(tpar2) == int(jpar)
    assert int(tna) == int(tna2) == int(jna)
    seq, spar = jstage1_seq_xla(jnp.asarray(w), carry, jd)
    np.testing.assert_array_equal(narrow.numpy(), np.asarray(seq))
    assert int(spar) == int(tpar)
    np.testing.assert_array_equal(
        _unpack(narrow.numpy(), arr.size),
        golden.structural_mask(arr, jd, carry_in=carry))
    assert int(tpar) == golden.quote_parity_out(arr, jd, carry_in=carry)
    if count_nonascii:
        assert int(tna) == int((arr >= 0x80).sum())
    else:
        assert int(tna) == -1


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_stage1_matches_jax_on_corpus(case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    for name, kw in DIALECTS.items():
        for carry in (0, 1):
            for count_nonascii in (True, False):
                _check_all(arr, kw, carry, count_nonascii)


@pytest.mark.parametrize("seed", range(4))
def test_stage1_matches_jax_on_fuzz(seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
    arr = rng.choice(alphabet, size=int(rng.integers(1, 300_000)))
    for kw in DIALECTS.values():
        _check_all(arr, kw, seed & 1, bool(seed & 2))


@pytest.mark.parametrize("carry", [0, 1])
def test_stage1_multi_tile_quoted_span(carry):
    """More than 512 rows (several JAX tiles, several 64 KiB kernel
    chunks), with a quoted region that crosses them."""
    inner = b"x," * 200_000
    data = b'a,b\n"' + inner + b'end",2\nq,w\n'
    arr = np.frombuffer(data, dtype=np.uint8)
    assert pad_to_words(arr).shape[0] > 512
    _check_all(arr, {}, carry, True)


@pytest.mark.parametrize("lanes", [128, 1024])
@pytest.mark.parametrize("seed", range(3))
def test_stage1_wide_mode_matches_jax(lanes, seed):
    """out_mode="wide": a (rows, 128) or (rows/8, 1024) input gives the
    (rows, 16) words, as the JAX function does in interpret mode."""
    rng = np.random.default_rng(20 + seed)
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
    arr = rng.choice(alphabet, size=int(rng.integers(1, 40_000)))
    w = pad_to_words(arr).reshape(-1, lanes)
    for kw in DIALECTS.values():
        got, tpar, tna = stage1_fused_v4(
            torch.from_numpy(w.copy()), seed & 1, Dialect(**kw),
            out_mode="wide")
        want, jpar, jna = jstage1_fused_v4(
            jnp.asarray(w), seed & 1, JDialect(**kw), interpret=True,
            out_mode="wide")
        assert got.shape == np.asarray(want).shape == (w.size // 128, 16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(tpar) == int(jpar)
        assert int(tna) == int(jna)


@pytest.mark.parametrize(
    "n", [0, 1, 511, 512, 262_144, 262_145, 4 * 2**20, 4 * 2**20 + 1])
def test_pad_to_words_matches_jax(n):
    arr = np.full(n, 0x41, np.uint8)
    got = pad_to_words(arr)
    want = jpad_to_words(arr)
    assert got.shape == want.shape == (padded_rows(n), 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_seq_oracle_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    arr = rng.choice(np.frombuffer(b'a",\n\r\xa2\x8a', np.uint8), size=70_000)
    w = pad_to_words(arr, row_align=8)
    for kw in DIALECTS.values():
        got, gpar = stage1_seq_xla(torch.from_numpy(w.copy()), seed & 1,
                                   Dialect(**kw))
        want, wpar = jstage1_seq_xla(jnp.asarray(w), seed & 1, JDialect(**kw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(gpar) == int(wpar)


def test_stage1_rejects_unported_options_and_bad_shapes():
    w = torch.zeros((512, 128), dtype=torch.int32)
    for mode in ("wide", "wide_native"):
        with pytest.raises(ValueError):  # JAX asserts the same
            stage1_fused_v4(w, 0, emit_counts=True, out_mode=mode)
    with pytest.raises(ValueError):
        stage1_fused_v4(w, 0, out_mode="wide_plus")
    with pytest.raises(ValueError):
        stage1_fused_v4(w.view(-1, 1024), 0, out_mode="narrow")
    with pytest.raises(ValueError):
        stage1_fused_v4(w.to(torch.int64), 0)
    with pytest.raises(ValueError):
        stage1_fused_v4(torch.zeros((12, 128), dtype=torch.int32), 0,
                        out_mode="wide_native")


def test_stage1_takes_the_jax_signature():
    """The JAX parameter order and keywords: row_tile positional (4th),
    count_nonascii positional (8th), and the Mosaic flags as keywords,
    which change nothing, give JAX interpret mode's words, parity and
    non-ASCII count."""
    rng = np.random.default_rng(31)
    arr = rng.choice(np.frombuffer(b'ab"",\n\rx\xc3\xa9', np.uint8),
                     size=150_000)
    w = pad_to_words(arr)
    want = jstage1_fused_v4(jnp.asarray(w), 1, JDialect(), 512,
                            interpret=True)
    got = stage1_fused_v4(torch.from_numpy(w.copy()), 1, DEFAULT_DIALECT,
                          512)
    kw = stage1_fused_v4(torch.from_numpy(w.copy()), 1, row_tile=512,
                         interpret=True, pack_mode="mm4i8", vma=(),
                         base_mode="shift", compress_mode="m80",
                         scan_mm="i8")
    for out in (got, kw):
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(want[0]))
        assert int(out[1]) == int(want[1])
        assert int(out[2]) == int(want[2]) > 0
    _, _, na = stage1_fused_v4(torch.from_numpy(w.copy()), 1,
                               DEFAULT_DIALECT, 512, False, (), False, False)
    assert int(na) == -1


def _check_emits(arr: np.ndarray, dialect_kw: dict, carry: int) -> None:
    """B1n narrow: the port's (words, parity, count, counts, prefix) equal
    JAX interpret mode's, and the prefix equals the separate B2 pass."""
    w = pad_to_words(arr)
    got = stage1_fused_v4(torch.from_numpy(w.copy()), carry,
                          Dialect(**dialect_kw), emit_counts=True,
                          emit_prefix=True)
    want = jstage1_fused_v4(jnp.asarray(w), carry, JDialect(**dialect_kw),
                            interpret=True, emit_counts=True,
                            emit_prefix=True)
    assert got[3].shape == (w.shape[0], 1) and got[4].shape == (w.shape[0],)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    np.testing.assert_array_equal(got[4].numpy(),
                                  np.cumsum(got[3].numpy()[:, 0]))
    assert int(got[4][-1]) == int(golden.structural_mask(
        arr, JDialect(**dialect_kw), carry_in=carry).sum())


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_stage1_emits_match_jax_on_corpus(case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    _check_emits(arr, {}, 0)
    _check_emits(arr, DIALECTS["semicolon_apostrophe"], 1)


@pytest.mark.parametrize("seed", range(2))
def test_stage1_emits_match_jax_on_fuzz(seed):
    rng = np.random.default_rng(40 + seed)
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
    arr = rng.choice(alphabet, size=int(rng.integers(100_000, 200_000)))
    for kw in (DIALECTS["default"], DIALECTS["semicolon_apostrophe"]):
        _check_emits(arr, kw, seed)


@pytest.mark.parametrize("carry", [0, 1])
@pytest.mark.parametrize("lanes", [128, 1024])
def test_stage1_wide_prefix_matches_jax_across_tiles(carry, lanes):
    """emit_prefix with out_mode="wide_native" over ~128 KB at JAX
    row_tile=64 (four tiles carry the running total), for both input
    shapes; the port's row_tile changes nothing."""
    rng = np.random.default_rng(50 + carry)
    arr = rng.choice(np.frombuffer(b'a",\n\rx;\'z7', np.uint8),
                     size=128 * 1024 - 77)
    w = pad_to_words(arr, row_align=64)
    assert w.shape[0] == 256
    for kw in (DIALECTS["default"], DIALECTS["semicolon_apostrophe"]):
        want = jstage1_fused_v4(
            jnp.asarray(w.reshape(-1, 1024)), carry, JDialect(**kw),
            row_tile=64, interpret=True, out_mode="wide_native",
            emit_prefix=True)
        got = stage1_fused_v4(
            torch.from_numpy(w.reshape(-1, lanes).copy()), carry,
            Dialect(**kw), row_tile=64, out_mode="wide_native",
            emit_prefix=True)
        assert got[0].shape == (32, 128) and got[3].shape == (256,)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
