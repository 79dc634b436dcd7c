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
from csv_simd_tpu_torch.config import Dialect
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
    with pytest.raises(NotImplementedError):
        stage1_fused_v4(w, 0, emit_counts=True)
    with pytest.raises(NotImplementedError):
        stage1_fused_v4(w, 0, emit_prefix=True)
    with pytest.raises(ValueError):
        stage1_fused_v4(w, 0, out_mode="wide_plus")
    with pytest.raises(ValueError):
        stage1_fused_v4(w.view(-1, 1024), 0, out_mode="narrow")
    with pytest.raises(ValueError):
        stage1_fused_v4(w.to(torch.int64), 0)
    with pytest.raises(ValueError):
        stage1_fused_v4(torch.zeros((12, 128), dtype=torch.int32), 0,
                        out_mode="wide_native")
