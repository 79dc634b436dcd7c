"""The relayouts' plain versions against the JAX package, bit for bit.

On the card B3 (`stage1_fused`) and B6 (`stage1_pallas`) are B1's one
pass followed by a relayout of its sequential words: csrc/relayout.cu
`fold_words` (plain version `_fold_from_seq_plain`) and `v1_words`
(`_v1_from_seq_plain`). Here the same padded input goes through the
port's B1 plain version and each relayout's plain version, and through
the JAX `stage1_swar_xla` (B3's twin) and the JAX `stage1_pallas` in
interpret mode: words, count and parity, on the corpus and fuzz inputs
up to 128 KB, at fold tiles 8, 24, 64, 512 and 1024 (each cut to the
rows, as the JAX wrapper does), carries 0 and 1 and three dialects. The
kbench probe's `roll` count (the last tile's) is `v1_words`' count from
the last tile's first word, held against kbench's `_variant_plain`.
Tolerance 0: these are integer bit layouts. The kernels are held against
these plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.index import pad_to_grid as jpad_to_grid
from csv_simd_tpu.ops.stage1_pallas import stage1_pallas as jstage1_pallas
from csv_simd_tpu.ops.stage1_v3 import stage1_swar_xla as jstage1_swar_xla
from csv_simd_tpu_torch.config import Dialect
from csv_simd_tpu_torch.index import pad_to_grid
from csv_simd_tpu_torch.ops.stage1_pallas import _v1_from_seq_plain
from csv_simd_tpu_torch.ops.stage1_v3 import _fold_from_seq_plain
from csv_simd_tpu_torch.ops.stage1_v4 import _stage1_v4_plain
from csv_simd_tpu_torch.tools import kbench

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
TILES = (8, 24, 64, 512, 1024)
ALPHABET = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
FUZZ_SIZES = (1, 4_095, 30_001, 70_000, 128 << 10)


def _inputs() -> dict:
    """{name: bytes}: the corpus and fuzz inputs of up to 128 KB."""
    out = {c.name: np.frombuffer(c.data, np.uint8) for c in all_cases()}
    for seed, n in enumerate(FUZZ_SIZES):
        rng = np.random.default_rng(100 + seed)
        out[f"fuzz{seed}_{n}"] = rng.choice(ALPHABET, size=n)
    return out


INPUTS = _inputs()


def _fold_words_input(arr: np.ndarray, tile: int) -> tuple:
    """(rows, 128) int32 byte quads of arr, zero-padded to whole rows, a
    multiple of 8 and of the tile, and the tile cut to the rows."""
    rows = max(-(-arr.size // 512), 1)
    rows = -(-rows // 8) * 8
    if tile < rows:
        rows = -(-rows // tile) * tile
    padded = np.zeros(rows * 512, np.uint8)
    padded[:arr.size] = arr
    return padded.view("<i4").reshape(rows, 128), min(tile, rows)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", INPUTS)
def test_fold_from_seq_matches_jax(name, tile):
    """B1's words relaid by `_fold_from_seq_plain` == the JAX
    `stage1_swar_xla`: words and parity."""
    w, t = _fold_words_input(INPUTS[name], tile)
    tw, jw = torch.from_numpy(w.copy()), jnp.asarray(w)
    for kw in DIALECTS:
        d, jd = Dialect(**kw), JDialect(**kw)
        for carry in (0, 1):
            seq, par, _ = _stage1_v4_plain(tw.view(-1), carry, d, False)
            got = _fold_from_seq_plain(seq, t)
            want, want_par = jstage1_swar_xla(jw, carry, jd, row_tile=t)
            assert got.shape == (w.shape[0] // 8, 128)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(par) == int(want_par)


@pytest.mark.parametrize("name", INPUTS)
def test_v1_from_seq_matches_jax(name):
    """B1's words relaid by `_v1_from_seq_plain` == the JAX
    `stage1_pallas` in interpret mode: words, total count and parity."""
    arr = INPUTS[name]
    b2d = pad_to_grid(arr)
    np.testing.assert_array_equal(b2d, jpad_to_grid(arr))
    t, j = torch.from_numpy(b2d.copy()), jnp.asarray(b2d)
    for kw in DIALECTS:
        d, jd = Dialect(**kw), JDialect(**kw)
        for carry in (0, 1):
            seq, par, _ = _stage1_v4_plain(t.view(torch.int32).view(-1),
                                           carry, d, False)
            words, count = _v1_from_seq_plain(seq)
            jw, jc, jp = jstage1_pallas(j, carry, jd, interpret=True)
            np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
            assert int(count) == int(jc)
            assert int(par) == int(jp)


@pytest.mark.parametrize("name", INPUTS)
def test_last_tile_count_matches_kbench(name):
    """`v1_words`' count from the last tile's first word (what the kbench
    probe's `full` asks of it) == kbench's `roll` count, and its words ==
    `roll`'s, at every tile of 32 to 1,024 rows that divides the rows."""
    b2d = torch.from_numpy(pad_to_grid(INPUTS[name]).copy())
    rows = b2d.shape[0]
    seq_in = b2d.view(torch.int32).view(-1)
    for carry in (0, 1):
        seq = _stage1_v4_plain(seq_in, carry, Dialect(), False)[0]
        for tile in (32, 64, 512, 1024):
            if tile > rows:
                continue
            words, count = _v1_from_seq_plain(seq, (rows - tile) // 32 * 128)
            want_words, want = kbench._variant_plain(b2d, "roll", tile, carry)
            assert torch.equal(words, want_words)
            assert int(count) == int(want)
