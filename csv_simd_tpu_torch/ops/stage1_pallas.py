"""Stage-1 v1 (csv_simd_tpu/ops/stage1_pallas.py `stage1_pallas`): kernel
B6 on one byte per lane, (rows, 128) uint8 from `index.pad_to_grid`.

The words are the sublane-major layout of ops/pack.py: bit k of word
(s, lane) covers flat byte (s*32 + k) * 128 + lane, inverted by
`unpack_words_host` / `unpack_words_device`. On a CUDA tensor B6
launches the B1 kernel (csrc/stage1_v4.cu) and then `v1_words`
(csrc/relayout.cu), which transposes B1's sequential words into this
layout and counts them (its plain version is `_v1_from_seq_plain`); on
a CPU tensor it runs the plain version, `_stage1_pallas_plain`
(`index.stage1_jnp` plus the structural count). `row_tile` shaped the
TPU grid and changes nothing in the output; `interpret` is accepted and
does nothing here.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_DIALECT, Dialect
from .classify import classify_masks
from .pack import pack_words
from .scan import in_quote_parity, parity_out
from .stage1_v3 import _as_carry, _check_rows, _on_device
from .swar import popcount32

LANES = 128
DEFAULT_ROW_TILE = 1024


def _stage1_pallas_plain(b2d: torch.Tensor, carry_in, dialect: Dialect):
    """The plain version of B6 on any device: the same outputs."""
    struct, quote = classify_masks(b2d, dialect)
    inq = in_quote_parity(quote, carry_in)
    masked = (struct & (inq == 0)).to(torch.int32)
    return (pack_words(masked), masked.sum(dtype=torch.int32),
            parity_out(quote, carry_in))


def _v1_from_seq_plain(seq_words: torch.Tensor, count_from: int = 0):
    """The plain version of `v1_words` on any device: B1's sequential
    words of rows x 128 bytes (rows * 4 int32, rows % 32 == 0, any shape;
    bit m of word w covers byte 32w + m) -> (v1-layout words (rows/32,
    128) int32, structural count 0-d int32 of the words from flat index
    count_from on)."""
    seq = seq_words.reshape(-1)
    shifts = torch.arange(32, dtype=torch.int32, device=seq.device)
    mask = ((seq[:, None] >> shifts) & 1).reshape(-1, LANES)
    words = pack_words(mask)
    count = popcount32(words.reshape(-1)[count_from:]).sum(dtype=torch.int32)
    return words, count


def stage1_pallas(b2d: torch.Tensor, carry_in=0,
                  dialect: Dialect = DEFAULT_DIALECT,
                  row_tile: int = DEFAULT_ROW_TILE, interpret: bool = False):
    """(rows, 128) uint8 + carry parity (an int or a 0-d integer tensor,
    read on the device) -> (words (rows//32, 128) int32 bit patterns,
    total structural count 0-d int32, parity_out 0-d int32). rows must be
    a multiple of 32, and min(row_tile, rows) must divide it."""
    _check_rows(b2d, row_tile, align=32)
    if b2d.dtype != torch.uint8:
        raise ValueError(f"expected uint8 bytes, got {b2d.dtype}")
    carry = _as_carry(carry_in, b2d.device)
    if _on_device(b2d):
        from .. import _kernels

        return _kernels.stage1_v1(b2d, carry, dialect)
    return _stage1_pallas_plain(b2d, carry, dialect)
