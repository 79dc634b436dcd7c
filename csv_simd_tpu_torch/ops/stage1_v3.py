"""Stage-1 v3 (csv_simd_tpu/ops/stage1_v3.py): the fold-layout build
kernel B3 (`stage1_fused`), the sequential-layout B4
(`stage1_fused_seq`), and their plain versions `stage1_swar_xla` and
`stage1_seq_xla`.

Fold layout (tile-dependent, tile = min(row_tile, rows), default 512):
for tile s and output row group g in [0, tile/8), bit 8b + sigma(j) of
word (s*tile/8 + g, lane) covers byte b of input word
(s*tile + j*tile/8 + g, lane), sigma = [7,3,5,1,6,2,4,0]. Inverted by
`unpack_packed_host` and the native extractor.

The functions keep the JAX names so that each counterpart is easy to
find. On a CUDA tensor B3 launches the B1 kernel (csrc/stage1_v4.cu)
and then `fold_words` (csrc/relayout.cu), which permutes B1's
sequential words into the fold layout (its plain version is
`_fold_from_seq_plain`), and B4 launches B1 alone, whose narrow words
are B4's; on a CPU tensor each runs its plain version. The JAX flags `interpret`, `vma`
and `base_mode` chose between Mosaic constructions; they are accepted
and change nothing here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_DIALECT, Dialect
from .swar import (
    _HI1,
    popcount32,
    shift_right_logical,
    swar_broadcast_flag,
    swar_classify_raw,
    swar_classify_s80_q80,
    swar_eq,
    swar_prefix_xor_bytes,
    swar_word_parity,
)

LANES = 128
DEFAULT_ROW_TILE = 512  # x 512 B/row = 256 KiB of input per tile

_SIGMA = [7, 3, 5, 1, 6, 2, 4, 0]  # sigma(j) = 7 - bitrev3(j)


def _as_carry(carry_in, device: torch.device):
    """A carry-in as the kernels and plain versions take it: an int 0/1,
    or a 0-d int32 tensor on `device` (left there, so no host sync)."""
    if isinstance(carry_in, torch.Tensor):
        return carry_in.to(device=device, dtype=torch.int32).reshape(()) & 1
    return int(carry_in) & 1


def _check_rows(w2d: torch.Tensor, row_tile: int, align: int = 8) -> int:
    """The JAX wrappers' shape checks -> tile = min(row_tile, rows)."""
    if w2d.dim() != 2 or w2d.shape[1] != LANES:
        raise ValueError(f"expected (rows, {LANES}), got {tuple(w2d.shape)}")
    rows = w2d.shape[0]
    if rows == 0 or rows % align:
        raise ValueError(f"rows must be a positive multiple of {align}, "
                         f"got {rows}")
    tile = min(row_tile, rows)
    if tile <= 0 or rows % tile:
        raise ValueError(f"row tile {tile} does not divide {rows} rows")
    return tile


def _on_device(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _ascii_dialect(dialect: Dialect) -> bool:
    chars = dialect.newlines + (dialect.delimiter,)
    return dialect.quote < 0x80 and all(c < 0x80 for c in chars)


def _classify(x: torch.Tensor, dialect: Dialect):
    """0x80-flag (structural, quote) classify: the shared-subexpression
    detector for ASCII dialects, independent exact detectors otherwise."""
    chars = dialect.newlines + (dialect.delimiter,)
    if _ascii_dialect(dialect):
        return swar_classify_s80_q80(x, chars, dialect.quote)
    qf = swar_eq(x, dialect.quote)
    sf = swar_eq(x, dialect.delimiter)
    for nl in dialect.newlines:
        sf = sf | swar_eq(x, nl)
    return sf, qf


def _classify_raw(x: torch.Tensor, dialect: Dialect):
    """(s_nomatch, q_raw) under swar_classify_raw's bit-7-only contract."""
    if _ascii_dialect(dialect):
        chars = dialect.newlines + (dialect.delimiter,)
        s_no, q_raw, _ = swar_classify_raw(x, chars, dialect.quote)
        return s_no, q_raw
    sf, qf = _classify(x, dialect)
    return ~sf, qf


def _scan_masked(w2d: torch.Tensor, carry_in, dialect: Dialect):
    """Byte-quad words (rows, 128) int32 and a carry (int or 0-d tensor)
    -> (masked 0x80 flag words, quote parity out as a 0-d int32
    tensor)."""
    s_no, qf = _classify_raw(w2d, dialect)
    p_in = swar_prefix_xor_bytes(qf)
    wp = swar_word_parity(p_in)
    incl = torch.cumsum(wp, dim=1, dtype=torch.int32)
    lane_excl = incl - wp
    row_tot = incl[:, -1]
    row_excl = (torch.cumsum(row_tot, dim=0, dtype=torch.int32)
                - row_tot)[:, None]
    base = (lane_excl + row_excl + carry_in) & 1
    inq = p_in ^ swar_broadcast_flag(base)
    masked = ~(s_no | inq) & _HI1
    parity = (wp.sum(dtype=torch.int32) + carry_in) & 1
    return masked, parity


def stage1_seq_xla(w2d: torch.Tensor, carry_in=0,
                   dialect: Dialect = DEFAULT_DIALECT):
    """(rows, 128) int32 byte quads -> (packed (rows, 16) int32, parity
    out). Bit m of word (r, g) covers flat byte r*512 + 32*g + m: the
    flat little-endian bitstream of the structural mask. The plain
    version of B4."""
    rows = w2d.shape[0]
    masked, parity = _scan_masked(w2d, _as_carry(carry_in, w2d.device),
                                  dialect)
    u = shift_right_logical(masked, 7)
    v = ((u * 0x01020408) >> 24).view(rows, 16, 8)  # bit b = byte b's flag
    packed = v[..., 0].clone()
    for lane in range(1, 8):
        packed |= v[..., lane] << (4 * lane)
    return packed, parity


def _fold_pack(masked: torch.Tensor, tile: int) -> torch.Tensor:
    """(steps, tile, 128) 0x80-flag words -> (steps, tile/8, 128) packed
    words by three logical right-shift folds (shifts 1, 2, 4): flag bits
    start at 8b+7 and land at 8b + sigma(j)."""
    t = masked
    h = tile // 2
    t = t[:, :h] | shift_right_logical(t[:, h:], 1)
    h //= 2
    t = t[:, :h] | shift_right_logical(t[:, h:], 2)
    h //= 2
    return t[:, :h] | shift_right_logical(t[:, h:], 4)


def stage1_swar_xla(w2d: torch.Tensor, carry_in=0,
                    dialect: Dialect = DEFAULT_DIALECT,
                    row_tile: int = DEFAULT_ROW_TILE):
    """(rows, 128) int32 byte quads -> (fold-layout packed (rows/8, 128)
    int32, parity out), on any device. The plain version of B3."""
    rows, lanes = w2d.shape
    tile = min(row_tile, rows)
    masked, parity = _scan_masked(w2d, _as_carry(carry_in, w2d.device),
                                  dialect)
    packed = _fold_pack(masked.view(rows // tile, tile, lanes), tile)
    return packed.reshape(rows // 8, lanes), parity


def _fold_from_seq_plain(seq_words: torch.Tensor, tile: int,
                         order=_SIGMA) -> torch.Tensor:
    """The plain version of `fold_words` on any device: B1's sequential
    words of rows x 512 bytes (rows * 16 int32, any shape; bit m of word
    w covers byte 32w + m) -> B3's fold-layout (rows/8, 128) int32 at
    `tile` rows. Bit 8b + sigma(j) of word (s*tile/8 + g, lane) is bit
    4(lane % 8) + b of sequential word (s*tile + j*tile/8 + g)*16 +
    lane/8. `order` gives the bit of row segment j in place of sigma(j)
    (csrc/stage1_core.cuh `transpose_nibbles`)."""
    seq = seq_words.reshape(-1, 16)
    rows = seq.shape[0]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=seq.device)
    # nib[r, lane]: the structural bits of bytes 4*lane .. 4*lane+3 of row r
    nib = ((seq[:, :, None] >> shifts) & 0xF).reshape(rows, LANES)
    # bit b of a nibble -> bit 8b (the shifted copies do not overlap)
    spread = ((nib * 0x00204081) & 0x01010101).view(
        rows // tile, 8, tile // 8, LANES)
    out = spread[:, 0] << order[0]
    for j in range(1, 8):
        out |= spread[:, j] << order[j]
    return out.reshape(rows // 8, LANES)


def stage1_fused(w2d: torch.Tensor, carry_in=0,
                 dialect: Dialect = DEFAULT_DIALECT,
                 row_tile: int = DEFAULT_ROW_TILE, interpret: bool = False,
                 vma: tuple = (), base_mode: str = "mul"):
    """Kernel B3: (rows, 128) int32 byte quads + carry parity (an int or
    a 0-d integer tensor, read on the device) -> (fold-layout packed
    (rows/8, 128) int32, parity_out 0-d int32). rows % 8 == 0 and
    tile = min(row_tile, rows) must divide rows and be a multiple of 8."""
    tile = _check_rows(w2d, row_tile)
    if tile % 8:
        raise ValueError(f"the fold layout needs a tile that is a multiple "
                         f"of 8, got {tile}")
    if w2d.dtype != torch.int32:
        raise ValueError(f"expected int32 byte quads, got {w2d.dtype}")
    carry = _as_carry(carry_in, w2d.device)
    if _on_device(w2d):
        from .. import _kernels

        return _kernels.stage1_fold(w2d, carry, dialect, tile)
    return stage1_swar_xla(w2d, carry, dialect, row_tile=tile)


def stage1_fused_seq(w2d: torch.Tensor, carry_in=0,
                     dialect: Dialect = DEFAULT_DIALECT,
                     row_tile: int = DEFAULT_ROW_TILE,
                     interpret: bool = False):
    """Kernel B4: (rows, 128) int32 byte quads -> (sequential packed
    (rows, 16) int32, parity_out 0-d int32), the layout of
    stage1_seq_xla. On the card it is B1's narrow output without the
    non-ASCII count."""
    _check_rows(w2d, row_tile)
    if w2d.dtype != torch.int32:
        raise ValueError(f"expected int32 byte quads, got {w2d.dtype}")
    carry = _as_carry(carry_in, w2d.device)
    if _on_device(w2d):
        from .stage1_v4 import stage1_fused_v4

        packed, parity, _ = stage1_fused_v4(
            w2d.contiguous(), carry, dialect, count_nonascii=False,
            out_mode="narrow")
        return packed, parity
    return stage1_seq_xla(w2d, carry, dialect)


def count_packed(packed: torch.Tensor) -> torch.Tensor:
    """Total structural count from packed words (any layout), 0-d int32."""
    return popcount32(packed).sum(dtype=torch.int32)


def unpack_packed_host(packed: np.ndarray, n_bytes: int,
                       tile: int = DEFAULT_ROW_TILE) -> np.ndarray:
    """Invert the fold-pack: (rows//8, 128) int32 -> flat 0/1 uint8 mask
    of n_bytes. `tile` must match the build (min(row_tile, rows))."""
    g_total, lanes = packed.shape
    rows = g_total * 8
    tile = min(tile, rows)
    gp = tile // 8
    steps = g_total // gp
    p3 = packed.reshape(steps, gp, lanes)
    # out[steps, j, gp, lanes, b] = bit (8b + sigma(j))
    out = np.empty((steps, 8, gp, lanes, 4), np.uint8)
    for j in range(8):
        for b in range(4):
            out[:, j, :, :, b] = (p3 >> (8 * b + _SIGMA[j])) & 1
    return out.reshape(-1)[:n_bytes]
