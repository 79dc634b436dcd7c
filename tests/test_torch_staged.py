"""The bit permutations that the stage-1 probes build from B1's
sequential words, on the CPU. The stage ablation (tools/ablate.py) packs
full's and noscan's 8-row sums as a row-order transpose of one 4 KiB
step with the top byte negated (`_sum8_from_seq_plain`), and its v3 folds
as B3's fold in the bit order bitrev3(j) (`_v3_from_seq_plain`); the
direct fold pack (tools/vnext.py) is B3's fold of B1's words. The CUDA
kernels build these words from B1's words in shared memory (the staged
emit) or with relayout.cu `fold_words`.

Each permutation is held against the tool's plain version
(`_ablate_plain`, `_vnext_plain`) and against the JAX tool's own kernel
run in interpret mode, on random and CSV-ish words at tiles 8, 64, 128
and 512, carries 0 and 1; and the closed form of the 8-row sum against
the shift-and-wrap sum over all 256 values of each byte's flags.
Tolerance 0: these are integer words. The kernels are held against the
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu_torch.config import DEFAULT_DIALECT
from csv_simd_tpu_torch.ops.stage1_v3 import _fold_from_seq_plain
from csv_simd_tpu_torch.ops.stage1_v4 import _stage1_v4_plain
from csv_simd_tpu_torch.tools import ablate, vnext
from jax_tools import InterpretPl, interpret_tool, load_tool

TILES = (8, 64, 128, 512)
SUM8 = ("noscan", "full")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_ALPHABET = np.frombuffer(b'ab"",\n\rx,z":; \t\xa2', np.uint8)


def _words(rows: int, seed: int) -> dict:
    """(rows, 128) int32: uniformly random, and CSV-ish bytes with quotes
    and delimiters dense."""
    rng = np.random.default_rng(seed)
    return {"random": rng.integers(-2**31, 2**31, (rows, 128),
                                   dtype=np.int64).astype(np.int32),
            "csv": rng.choice(_ALPHABET, size=rows * 512).view(
                "<i4").reshape(rows, 128)}


def _rows(tile: int) -> int:
    """Two tiles, so that the chained cuts carry across one, and whole
    64 KiB chunks of B1's one pass when the tile divides 128 rows."""
    return max(2 * tile, 128)


def _permuted(w: torch.Tensor, mode: str, tile: int, carry: int):
    """A mode's words as the kernels build them: the permutation of B1's
    words of the flags it packs, plus the carry-in for the cuts that add
    it."""
    seq = ablate._seq_plain(w, mode, carry)
    out = (ablate._sum8_from_seq_plain(seq) if mode in SUM8
           else ablate._v3_from_seq_plain(seq, tile))
    return out if mode in ablate.CHAINED else out + carry


@pytest.mark.parametrize("byte", range(4))
def test_sum8_closed_form_over_all_flags_of_a_byte(byte):
    """The 8-row wrapping sum of arithmetically shifted 0x80 flags, sum
    over k < 8 of (int32)flags[k] >> (7 - k), against the transpose with
    its top byte negated, for every one of the 256 flag sets F of byte
    `byte` across a step's 8 rows (bit k of F: the flag of row k) in
    every lane, the other bytes' flags random."""
    rng = np.random.default_rng(byte)
    groups = 256
    lane = np.arange(128)
    f = (np.arange(groups)[:, None] + 37 * lane[None, :]) % 256  # (g, L)
    bits = rng.integers(0, 2, (groups, 8, 128, 4)).astype(np.uint32)
    bits[..., byte] = (f[:, None, :] >> np.arange(8)[None, :, None]) & 1
    flags = (bits << (8 * np.arange(4) + 7).astype(np.uint32)).sum(
        axis=-1, dtype=np.uint32).view(np.int32)  # (g, 8, L)
    shifted = flags.astype(np.int64) >> (7 - np.arange(8))[None, :, None]
    want = shifted.sum(axis=1) & 0xFFFFFFFF
    seq = ablate._seq_from_flags(torch.from_numpy(
        flags.reshape(groups * 8, 128).copy()))
    got = ablate._sum8_from_seq_plain(seq).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    # and the flags' byte b of every lane went through the closed form
    assert set(np.unique(f)) == set(range(256))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", ablate.PERMUTED)
def test_permutation_matches_ablate_plain(mode, tile):
    """Each mode's words, as the permutation of B1's words of its flags,
    against the tool's plain version (which sums and folds the flag
    words), on random and CSV-ish words, carries 0 and 1."""
    for name, a in _words(_rows(tile), tile + len(mode)).items():
        w = torch.from_numpy(a.copy())
        for carry in (0, 1):
            want, _side = ablate._ablate_plain(w, mode, tile, carry)
            np.testing.assert_array_equal(
                _permuted(w, mode, tile, carry).numpy(), want.numpy(),
                err_msg=f"{mode} tile={tile} {name} carry={carry}")


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", ablate.PERMUTED)
def test_permutation_matches_jax_tool_kernel(monkeypatch, mode, tile):
    """Each mode's permutation against the TPU tool's own kernel in
    interpret mode (its fori-loop chain run eagerly, then its pallas_call
    called again with each carry), on random and CSV-ish words."""
    tool = load_tool("ablate")
    pl = InterpretPl(tool.pl)
    monkeypatch.setattr(tool, "pl", pl)
    rows = _rows(tile)
    for name, a in _words(rows, 3 * tile + len(mode)).items():
        with jax.disable_jit():
            tool.mk(mode, tile, rows)(jnp.asarray(a), 1)
        call, args, _ = pl.calls[-1]
        for carry in (0, 1):
            want = call(jnp.asarray([carry], jnp.int32), *args[1:])
            np.testing.assert_array_equal(
                _permuted(torch.from_numpy(a.copy()), mode, tile,
                          carry).numpy(), np.asarray(want),
                err_msg=f"{mode} tile={tile} {name} carry={carry}")


@pytest.mark.parametrize("tile", TILES + (16, 32))
def test_direct_pack_is_b1_words_folded(monkeypatch, tile):
    """The direct fold pack's words and parity out as B3's fold of B1's
    words (what the staged emit builds at tiles that divide 128 rows, and
    B1 plus `fold_words` at others), against the tool's plain version and
    the TPU tool's directpack kernel in interpret mode."""
    tool = interpret_tool(monkeypatch, "vnext")
    rows = _rows(tile)
    for name, a in _words(rows, 5 * tile).items():
        w = torch.from_numpy(a.copy())
        for carry in (0, 1):
            seq, parity = _stage1_v4_plain(w.reshape(-1), carry,
                                           DEFAULT_DIALECT, False)[:2]
            got = _fold_from_seq_plain(seq, tile)
            want = vnext._vnext_plain(w, tile, carry, True)
            np.testing.assert_array_equal(got.numpy(), want[0].numpy())
            assert int(parity) == int(want[1])
            with jax.disable_jit():
                jwant = tool.make(tile, rows, False, True)(jnp.asarray(a),
                                                           carry)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jwant[0]),
                err_msg=f"tile={tile} {name} carry={carry}")
            assert int(parity) == int(jwant[1])
