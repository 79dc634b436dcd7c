"""Stage-1 v2 (csv_simd_tpu/ops/stage1_v2.py): input padding
(`pad_to_words`), kernel B5 (`stage1_pallas_v2`) and its plain version
`stage1_swar_jnp`.

The row bucketing is part of the artifact's contract: the packed words
hold one bit per padded byte, so a saved index is only interchangeable
between the two packages if both pad to the same row count.

v2 word layout: output word (g, lane), bit (8*b + r) covers flat byte
((g*8 + r) * 128 + lane) * 4 + b (b = byte-in-word 0..3, r = row in
group 0..7). `unpack_words_v2_host` inverts it. That is B3's fold at
tile 8 in row order, so every word lies in one 64 KiB chunk of B1's one
pass: on a CUDA tensor B5 launches csrc/stage1_pack.cu `v2_pack` once,
B1's one pass (the input read once, the carry by decoupled look-back)
with the v2 words written from its staged emit. Its plain version on
B1's words is `_v2_from_seq_plain`. On a CPU tensor B5 runs the plain
version, `stage1_swar_jnp`.
The JAX flags `row_tile`, `row_scan` and `interpret` chose the TPU
kernel's grid and scan construction and change nothing in the output;
they are accepted and do nothing here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_DIALECT, Dialect
from .stage1_v3 import (
    _as_carry,
    _check_rows,
    _fold_from_seq_plain,
    _on_device,
)
from .swar import (
    popcount32,
    swar_broadcast_flag,
    swar_eq,
    swar_popcount_flags,
    swar_prefix_xor_bytes,
    swar_word_parity,
)

LANES = 128
ROW_BYTES = LANES * 4  # one (rows, 128) int32 row = 512 input bytes
DEFAULT_ROW_TILE_V2 = 512


def padded_rows(n_bytes: int, row_align: int = 512) -> int:
    """Row count of the padded (rows, 128) int32 input: a multiple of
    `row_align`, bucketed to powers of two up to 8192 rows and to
    multiples of 8192 rows above that."""
    rows = max(-(-n_bytes // ROW_BYTES), 1)
    rows = -(-rows // row_align) * row_align
    if rows <= 8192:
        bucket = row_align
        while bucket < rows:
            bucket *= 2
        return bucket
    return -(-rows // 8192) * 8192


def pad_to_words(arr: np.ndarray, row_align: int = 512) -> np.ndarray:
    """uint8 1-D -> zero-padded (rows, 128) int32 little-endian byte-quad
    words, rows from padded_rows."""
    rows = padded_rows(arr.size, row_align)
    padded = np.zeros(rows * ROW_BYTES, dtype=np.uint8)
    padded[: arr.size] = arr
    return padded.view("<i4").reshape(rows, LANES)


def stage1_swar_jnp(w2d: torch.Tensor, carry_in=0,
                    dialect: Dialect = DEFAULT_DIALECT):
    """The plain version of B5 on any device: (rows, 128) int32 byte
    quads, rows % 8 == 0 -> (packed (rows//8, 128) int32 v2 words,
    structural count 0-d int32, parity_out 0-d int32)."""
    rows, lanes = w2d.shape
    carry = _as_carry(carry_in, w2d.device)
    x = w2d
    qf = swar_eq(x, dialect.quote)
    sf = swar_eq(x, dialect.delimiter)
    for nl in dialect.newlines:
        sf = sf | swar_eq(x, nl)
    p_in = swar_prefix_xor_bytes(qf)
    wp = swar_word_parity(p_in)
    incl = torch.cumsum(wp, dim=1, dtype=torch.int32)
    excl_lane = incl - wp
    row_tot = incl[:, -1]
    row_excl = (torch.cumsum(row_tot, dim=0, dtype=torch.int32)
                - row_tot)[:, None]
    base = (excl_lane + row_excl + carry) & 1
    inq = p_in ^ swar_broadcast_flag(base)
    masked = sf & ~inq
    t = ((masked >> 7) & 0x01010101).view(rows // 8, 8, lanes)
    packed = t[:, 0].clone()
    for r in range(1, 8):
        packed |= t[:, r] << r
    count = swar_popcount_flags(masked).sum(dtype=torch.int32)
    parity = (wp.sum(dtype=torch.int32) + carry) & 1
    return packed, count, parity


def _v2_from_seq_plain(seq_words: torch.Tensor):
    """The plain version of `v2_pack`'s staged emit on any device: B1's
    sequential words of rows x 512 bytes (rows * 16 int32, rows % 8 == 0,
    any shape; bit m of word w covers byte 32w + m) -> (v2-layout words
    (rows/8, 128) int32, structural count 0-d int32 of all the words).
    The v2 layout is the fold at tile 8 in row order: bit 8b + r of word
    (g, lane) is bit 4(lane % 8) + b of sequential word (8g + r)*16 +
    lane/8."""
    words = _fold_from_seq_plain(seq_words, 8, order=tuple(range(8)))
    return words, popcount32(seq_words.reshape(-1)).sum(dtype=torch.int32)


def stage1_pallas_v2(w2d: torch.Tensor, carry_in=0,
                     dialect: Dialect = DEFAULT_DIALECT,
                     row_tile: int = DEFAULT_ROW_TILE_V2,
                     row_scan: str = "roll", interpret: bool = False):
    """Kernel B5: (rows, 128) int32 byte quads + carry parity (an int or
    a 0-d integer tensor, read on the device) -> (packed (rows//8, 128)
    int32 v2 words, structural count, parity_out), both 0-d int32. On a
    CUDA tensor one launch of `v2_pack` (B1's one pass with the v2 words
    from its staged emit); on a CPU tensor the plain version."""
    _check_rows(w2d, row_tile)
    if w2d.dtype != torch.int32:
        raise ValueError(f"expected int32 byte quads, got {w2d.dtype}")
    carry = _as_carry(carry_in, w2d.device)
    if _on_device(w2d):
        from .. import _kernels

        return _kernels.stage1_v2(w2d, carry, dialect)
    return stage1_swar_jnp(w2d, carry, dialect)


def unpack_words_v2_host(packed: np.ndarray, n_bytes: int) -> np.ndarray:
    """(rows//8, 128) int32 v2 words -> flat 0/1 uint8 mask of n_bytes.

    Bit (8*b + r) of word (g, lane) covers flat byte
    ((g*8 + r) * 128 + lane) * 4 + b."""
    groups, lanes = packed.shape
    shifts = 8 * np.arange(4)[None, :] + np.arange(8)[:, None]  # (r=8, b=4)
    bits = (packed[:, None, :, None] >> shifts[None, :, None, :]) & 1
    return bits.reshape(-1)[:n_bytes].astype(np.uint8)
