"""B5's v2 words from B1's words, against the JAX package, bit for bit.

On the card B5 (`stage1_pallas_v2`) is one launch of csrc/stage1_pack.cu
`v2_pack`: B1's one pass with the v2 words written from its staged emit,
the fold at tile 8 in row order. Its plain version on B1's words is
`_v2_from_seq_plain`. Here the same padded input goes through the port's
B1 plain version and `_v2_from_seq_plain`, and through the JAX
`stage1_swar_jnp` (B5's twin) and the JAX `stage1_pallas_v2` in
interpret mode: words, structural count and parity, over the corpus and
fuzz inputs up to 128 KB, carries 0 and 1 and three dialects (the
non-ASCII quote 0xA2 among them). Tolerance 0: these are integer bit
layouts. The kernel is held against this plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.ops.stage1_v2 import stage1_pallas_v2 as jstage1_pallas_v2
from csv_simd_tpu.ops.stage1_v2 import stage1_swar_jnp as jstage1_swar_jnp
from csv_simd_tpu_torch.config import Dialect
from csv_simd_tpu_torch.ops.stage1_v2 import _v2_from_seq_plain, pad_to_words
from csv_simd_tpu_torch.ops.stage1_v4 import _stage1_v4_plain

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
ALPHABET = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)
FUZZ_SIZES = (1, 4_095, 4_096, 30_001, 128 << 10)


def _inputs() -> dict:
    """{name: bytes}: the corpus and fuzz inputs of up to 128 KB."""
    out = {c.name: np.frombuffer(c.data, np.uint8) for c in all_cases()}
    for seed, n in enumerate(FUZZ_SIZES):
        rng = np.random.default_rng(200 + seed)
        out[f"fuzz{seed}_{n}"] = rng.choice(ALPHABET, size=n)
    return out


INPUTS = _inputs()


@pytest.mark.parametrize("name", INPUTS)
def test_v2_from_seq_matches_jax(name):
    """B1's words relaid by `_v2_from_seq_plain` == the JAX
    `stage1_swar_jnp` and the JAX `stage1_pallas_v2` in interpret mode:
    words, count and parity."""
    arr = INPUTS[name]
    w = pad_to_words(arr, row_align=8)
    t, j = torch.from_numpy(w.copy()), jnp.asarray(w)
    for kw in DIALECTS:
        d, jd = Dialect(**kw), JDialect(**kw)
        for carry in (0, 1):
            seq, par, _ = _stage1_v4_plain(t.view(-1), carry, d, False)
            words, count = _v2_from_seq_plain(seq)
            assert words.shape == (w.shape[0] // 8, 128)
            for want in (jstage1_swar_jnp(j, carry, jd),
                         jstage1_pallas_v2(j, carry, jd, interpret=True,
                                           row_tile=min(64, w.shape[0]))):
                np.testing.assert_array_equal(words.numpy(),
                                              np.asarray(want[0]))
                assert int(count) == int(want[1])
                assert int(par) == int(want[2])

