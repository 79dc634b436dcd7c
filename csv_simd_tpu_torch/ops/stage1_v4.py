"""Stage-1 build: kernel B1, its fused row counts and prefix (B1n), and
their plain versions (csv_simd_tpu/ops/stage1_v4.py `stage1_fused_v4`).

One call over the padded input yields the packed structural bitmask in
SEQUENTIAL bit order (bit m of word w covers byte 32w + m), the quote
parity after the input, and the count of bytes with bit 7 set; on
request also the structural popcount of each 512-byte row
(`emit_counts`) and their inclusive prefix (`emit_prefix`). The narrow
(rows, 16) and wide (rows/8, 128) results are two views of one int32
buffer in the same row-major word order.

On a CUDA tensor this launches the hand-written Hopper kernel
csrc/stage1_v4.cu; on a CPU tensor it runs `_stage1_v4_plain` and
`_row_emits_plain`, the same functions as PyTorch ops.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_DIALECT, Dialect
from .stage1_v3 import _as_carry, _scan_masked
from .swar import _HI1, popcount32

LANES = 128
WORDS = 16  # packed int32 words per 512-byte row
OUT_MODES = ("narrow", "wide", "wide_native")
DEFAULT_ROW_TILE_V4 = 512


def _stage1_v4_plain(words: torch.Tensor, carry_in, dialect: Dialect,
                     count_nonascii: bool):
    """Plain PyTorch version of kernel B1 on any device: flat int32 byte
    quads (multiple of 8 words) and a carry (int or 0-d tensor) ->
    (packed flat int32, parity 0-d int32, non-ASCII count 0-d int32, held
    at 2**31 - 1 past it as the kernel holds it, -1 when not counted)."""
    masked, parity = _scan_masked(words.view(-1, 8), carry_in, dialect)
    # masked holds only bit-7 flags; the multiply-gather by 0x204081
    # lifts bits 7/15/23/31 to 28..31 (no carries), so a logical >> 28
    # gives the 4-bit nibble of each byte quad
    nib = ((masked * 0x204081) >> 28) & 0xF
    packed = nib[:, 0].clone()
    for lane in range(1, 8):
        packed |= nib[:, lane] << (4 * lane)
    if count_nonascii:
        nonascii = popcount32(words & _HI1).sum(dtype=torch.int64).clamp(
            max=2**31 - 1).to(torch.int32)
    else:
        nonascii = torch.full((), -1, dtype=torch.int32, device=words.device)
    return packed, parity.to(torch.int32), nonascii


def _row_emits_plain(packed: torch.Tensor):
    """Plain version of B1n on any device: packed words (16 per 512-byte
    row, row-major) -> (per-row structural counts (rows, 1) int32,
    inclusive prefix of the counts (rows,) int32)."""
    from ..offsetfree import _prefix_for_packed_xla

    counts = popcount32(packed.reshape(-1, WORDS)).sum(
        dim=1, dtype=torch.int32)
    return counts[:, None], _prefix_for_packed_xla(packed)


def stage1_fused_v4(w2d: torch.Tensor, carry_in=0,
                    dialect: Dialect = DEFAULT_DIALECT,
                    row_tile: int = DEFAULT_ROW_TILE_V4,
                    interpret: bool = False, vma: tuple = (),
                    emit_counts: bool = False, count_nonascii: bool = True,
                    pack_mode: str = "mm4i8", base_mode: str = "shift",
                    compress_mode: str = "m80", emit_prefix: bool = False,
                    scan_mm: str = "i8", out_mode: str = "narrow"):
    """(rows, 128) int32 byte quads, or the same stream as (rows/8, 1024)
    for "wide" and "wide_native" -> (packed, parity_out, nonascii_count
    [, row_counts][, row_prefix]), in the JAX package's parameter order.

    packed is (rows, 16) int32 for out_mode "narrow" and "wide", and the
    (rows/8, 128) view of the same buffer for "wide_native" (the wide
    modes need rows % 8 == 0). parity_out is carry_in XOR the quote
    parity of the input; nonascii_count is the number of bytes with bit
    7 set, or -1 when count_nonascii is False. Both are 0-d int32
    tensors on the input's device. carry_in is an int or a 0-d integer
    tensor, which the kernel reads on the device (no host sync).

    emit_counts (narrow only, as in the JAX package) adds the (rows, 1)
    int32 structural popcount of each 512-byte row; emit_prefix (any
    mode) adds their (rows,) int32 inclusive prefix, over the whole
    input. row_tile changes no output: the carry and the prefix run
    over the whole input, and any row count is taken. interpret, vma,
    pack_mode, base_mode, compress_mode and scan_mm chose between Mosaic
    constructions; they are accepted and ignored."""
    if out_mode not in OUT_MODES:
        raise ValueError(f"out_mode must be one of {OUT_MODES}: {out_mode!r}")
    if emit_counts and out_mode != "narrow":
        raise ValueError("emit_counts needs out_mode 'narrow', as in the "
                         f"JAX package; got {out_mode!r}")
    if w2d.dtype != torch.int32 or w2d.dim() != 2:
        raise ValueError(f"expected a 2-D int32 tensor, got {w2d.dtype} "
                         f"{tuple(w2d.shape)}")
    lanes = w2d.shape[1]
    if lanes == 8 * LANES:
        if out_mode == "narrow":
            raise ValueError("a (rows/8, 1024) input needs out_mode 'wide' "
                             "or 'wide_native'")
        rows = w2d.shape[0] * 8
    elif lanes == LANES:
        rows = w2d.shape[0]
    else:
        raise ValueError(f"expected 128 or 1024 lanes, got {lanes}")
    if rows == 0:
        raise ValueError("empty input")
    if out_mode != "narrow" and rows % 8:
        raise ValueError(f"{out_mode} needs rows % 8 == 0, got {rows}")
    carry = _as_carry(carry_in, w2d.device)
    if w2d.device.type == "cuda":
        from .. import _kernels

        packed, parity, nonascii, counts, prefix = _kernels.stage1_v4(
            w2d, carry, dialect, count_nonascii, emit_counts, emit_prefix)
    elif w2d.device.type == "cpu":
        packed, parity, nonascii = _stage1_v4_plain(
            w2d.contiguous().view(-1), carry, dialect, count_nonascii)
        counts = prefix = None
        if emit_counts or emit_prefix:
            counts, prefix = _row_emits_plain(packed)
    else:
        raise ValueError(f"unsupported device {w2d.device}")
    shape = (rows // 8, LANES) if out_mode == "wide_native" else (rows, WORDS)
    out = [packed.view(shape), parity, nonascii]
    if emit_counts:
        out.append(counts.view(rows, 1))
    if emit_prefix:
        out.append(prefix.view(rows))
    return tuple(out)
