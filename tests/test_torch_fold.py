"""The port's fold-layout stage-1 build (B3's plain version and its
wrapper on the CPU) against the JAX package, bit for bit.

The same padded input goes through the port's `stage1_swar_xla` and
`stage1_fused` (the tensors lie on the CPU, so the wrapper runs the plain
version), the JAX `stage1_swar_xla` and the JAX `stage1_fused` in
interpret mode, at fold tiles 8, 32, 64 and 512, carries 0 and 1 and
three dialects. Tolerance 0: these are integer bit layouts. The CUDA
kernel is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import golden
from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.ops.stage1_v2 import pad_to_words as jpad_to_words
from csv_simd_tpu.ops.stage1_v3 import count_packed as jcount_packed
from csv_simd_tpu.ops.stage1_v3 import stage1_fused as jstage1_fused
from csv_simd_tpu.ops.stage1_v3 import stage1_swar_xla as jstage1_swar_xla
from csv_simd_tpu.ops.stage1_v3 import unpack_packed_host as junpack
from csv_simd_tpu_torch.config import Dialect
from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
from csv_simd_tpu_torch.ops.stage1_v3 import (
    count_packed,
    stage1_fused,
    stage1_swar_xla,
    unpack_packed_host,
)

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


DIALECTS = ({}, dict(delimiter=0x3B, quote=0x27), dict(quote=0xA2))
TILES = (8, 32, 64, 512)


def _check(arr: np.ndarray, tiles=TILES, dialects=DIALECTS) -> None:
    """Port == JAX twin == JAX interpret kernel == golden, for every
    tile, carry and dialect."""
    w = pad_to_words(arr, row_align=8)
    tw = torch.from_numpy(w.copy())
    jw = jnp.asarray(w)
    for kw in dialects:
        td, jd = Dialect(**kw), JDialect(**kw)
        for tile in tiles:
            t = min(tile, w.shape[0])
            for carry in (0, 1):
                got, par = stage1_swar_xla(tw, carry, td, row_tile=t)
                assert got.shape == (w.shape[0] // 8, 128)
                twin, tpar = jstage1_swar_xla(jw, carry, jd, row_tile=t)
                kern, kpar = jstage1_fused(jw, carry, jd, row_tile=t,
                                           interpret=True)
                np.testing.assert_array_equal(got.numpy(), np.asarray(twin))
                np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
                assert int(par) == int(tpar) == int(kpar)
                wrapped, wpar = stage1_fused(tw, carry, td, row_tile=t)
                assert torch.equal(wrapped, got) and int(wpar) == int(par)
                mask = unpack_packed_host(got.numpy(), arr.size, tile=t)
                np.testing.assert_array_equal(
                    mask, golden.structural_mask(arr, jd, carry_in=carry))
                assert int(par) == golden.quote_parity_out(arr, jd,
                                                           carry_in=carry)


@pytest.mark.parametrize("case", all_cases(), ids=lambda c: c.name)
def test_fold_matches_jax_on_corpus(case):
    _check(np.frombuffer(case.data, dtype=np.uint8))


@pytest.mark.parametrize("seed", range(4))
def test_fold_matches_jax_on_fuzz(seed):
    rng = np.random.default_rng(100 + seed)
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
    _check(rng.choice(alphabet, size=int(rng.integers(1, 60_000))))


@pytest.mark.parametrize("carry", [0, 1])
def test_fold_quoted_span_across_tiles(carry):
    """A quoted region across many 8-row tiles and 512-row tiles."""
    data = b'a,b\n"' + b"x," * 40_000 + b'end",2\nq,w\n'
    arr = np.frombuffer(data, dtype=np.uint8)
    w = torch.from_numpy(pad_to_words(arr, row_align=8).copy())
    for tile in (8, 512):
        got, par = stage1_swar_xla(w, carry, row_tile=tile)
        mask = unpack_packed_host(got.numpy(), arr.size, tile=tile)
        np.testing.assert_array_equal(
            mask, golden.structural_mask(arr, carry_in=carry))
        assert int(par) == golden.quote_parity_out(arr, carry_in=carry)


def test_fold_tensor_carry():
    """A 0-d tensor carry gives what the int carry gives."""
    arr = np.frombuffer(b'ab",c\nx,y\n' * 500, dtype=np.uint8)
    w = torch.from_numpy(pad_to_words(arr, row_align=8).copy())
    for carry in (0, 1):
        want = stage1_fused(w, carry, row_tile=32)
        got = stage1_fused(w, torch.tensor(carry, dtype=torch.int32),
                           row_tile=32)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.parametrize("case", all_cases()[:12], ids=lambda c: c.name)
def test_count_and_unpack_against_golden(case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    w = pad_to_words(arr)
    got, _ = stage1_swar_xla(torch.from_numpy(w.copy()), 0)
    want = golden.structural_mask(arr)
    assert int(count_packed(got)) == int(want.sum())
    assert int(count_packed(got)) == int(jcount_packed(jnp.asarray(got.numpy())))
    mask = unpack_packed_host(got.numpy(), arr.size)
    np.testing.assert_array_equal(mask, want)
    np.testing.assert_array_equal(mask, junpack(got.numpy(), arr.size))


@pytest.mark.parametrize("tile", [8, 16, 64])
def test_fold_pack_layout_roundtrip(tile):
    """Every bit position round-trips through the sigma/fold layout: a
    one-hot sweep of structural bytes over random non-quote bytes."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 4096 * 3, dtype=np.uint8)
    for pos in (0, 1, 511, 512, 513, 4095, 4096, 8191, 12287):
        data[pos] = 0x2C
    data[data == 0x22] = 0x61  # no quotes: the mask is the comma set
    w = pad_to_words(data, row_align=8)
    np.testing.assert_array_equal(w, jpad_to_words(data, row_align=8))
    got, _ = stage1_swar_xla(torch.from_numpy(w.copy()), 0, row_tile=tile)
    mask = unpack_packed_host(got.numpy(), data.size, tile=tile)
    np.testing.assert_array_equal(mask, golden.structural_mask(data))
    # one structural byte at a time: exactly one bit, where the layout
    # formula puts it
    t = min(tile, w.shape[0])
    for pos in (0, 7, 511, 512, 4099, 12287):
        one = np.zeros(data.size, np.uint8)
        one[pos] = 0x2C
        got, _ = stage1_swar_xla(
            torch.from_numpy(pad_to_words(one, row_align=8).copy()), 0,
            row_tile=t)
        words = got.numpy().reshape(-1)
        assert int(count_packed(got)) == 1
        row, lane, b = pos // 512, (pos % 512) // 4, pos % 4
        s, rt = divmod(row, t)
        j, g = divmod(rt, t // 8)
        sigma = (7, 3, 5, 1, 6, 2, 4, 0)[j]
        word = (s * t // 8 + g) * 128 + lane
        assert (words[word] >> (8 * b + sigma)) & 1 == 1


def test_fold_wrapper_rejects_bad_shapes():
    w = torch.zeros((64, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        stage1_fused(w, 0, row_tile=12)  # tile does not divide 64 rows
    with pytest.raises(ValueError):
        stage1_fused(w[:12], 0)  # rows % 8 != 0
    with pytest.raises(ValueError):
        stage1_fused(w.to(torch.int64), 0)
    with pytest.raises(ValueError):
        stage1_fused(w.view(-1, 1024), 0)
