"""Ablation of the stage-1 build on the card: which stage costs what
(tools/ablate.py).

`mk` runs the build over (rows, 128) int32 cut after one stage, with the
default dialect the TPU tool hard-coded (quote 0x22; delimiter 0x2C,
newlines 0x0A, 0x0D), and writes (rows/8, 128) int32, tile rows at a
time (see csrc/probe_ablate.cu for each mode's words): dma_only,
classify_only, inword, noscan, full, v3, v3i8, v3_foldonly and
v3_mmonly. full, v3, v3i8 and v3_mmonly carry the quote parity across
tiles; the others add the carry-in bit unchanged. v3i8 computes what v3
does (they differed in the TPU's matmul types). Besides the words, each
returns one side word a tile, the XOR of the value the mode stores over
the whole tile, which keeps every input word live on the card.

On a CUDA tensor `mk` launches csrc/probe_ablate.cu, on a CPU tensor its
plain version, `_ablate_plain`. Every mode is held against the plain
version at the gate's sizes and on the timed input; kernel times come
from CUDA graphs (`ms`) and from eager launches (`eager_ms`).

Every mode reads its input once in B1's 64 KiB chunks (the chained ones
on B1's one pass, with its look-back carry) and stores each word once,
with no shared-memory atomics and at any tile. full's and noscan's 8-row
sums are a bit transpose of one 4 KiB step's 8 rows with the top byte
negated (`_sum8_from_seq_plain`), and the v3 folds B3's fold in the bit
order bitrev3(j) (`_v3_from_seq_plain`): both from B1's words of the
flags they pack (`_seq_plain`), which is how the kernel builds them.

    python -m csv_simd_tpu_torch.tools.ablate [mode:tile ...]
        (default: every mode at tile 512, on 64 MiB and 1 GiB of random
        int32)
"""

from __future__ import annotations

import sys

import torch

from .._kernels import check_rows128
from ..config import DEFAULT_DIALECT
from ..ops.stage1_v3 import _as_carry, _fold_from_seq_plain
from ..ops.stage1_v4 import _stage1_v4_plain
from ..ops.swar import (
    shift_right_logical,
    swar_broadcast_flag,
    swar_eq,
    swar_prefix_xor_bytes,
    swar_word_parity,
)
from ._common import (
    card,
    check_all,
    csv_words,
    emit,
    interleaved_ms,
    kernel_ms,
    merge,
    need_card,
    random_words,
    wrap_sum,
    xor_reduce,
)

L = 128
SIZES = (64 << 20, 1 << 30)
MODES = ("dma_only", "classify_only", "inword", "noscan", "full", "v3",
         "v3i8", "v3_foldonly", "v3_mmonly")
CHAINED = ("full", "v3", "v3i8", "v3_mmonly")
# the modes whose words are a bit permutation of B1's words of their flags
PERMUTED = ("noscan", "full", "v3", "v3i8", "v3_foldonly")
_BITREV3 = (0, 4, 2, 6, 1, 5, 3, 7)


def _fold_pack(flags: torch.Tensor, tile: int) -> torch.Tensor:
    """(tiles, tile, 128) 0x80 flags -> (tiles, tile/8, 128): three
    halvings with shifts 1, 2, 4, so row j*tile/8 + g lands at bit
    8b + bitrev3(j) of word g (the TPU tool's `_fold_pack`)."""
    t = (flags >> 7) & 0x01010101
    h = tile // 2
    t = t[:, :h] | (t[:, h:] << 1)
    h //= 2
    t = t[:, :h] | (t[:, h:] << 2)
    h //= 2
    return t[:, :h] | (t[:, h:] << 4)


def _ablate_plain(words: torch.Tensor, mode: str, tile: int, carry_in):
    """Plain version of the probe: (out (rows/8, 128) int32, side
    (rows/tile,) int32)."""
    rows = words.shape[0]
    tiles = rows // tile
    c = _as_carry(carry_in, words.device)
    x = words
    qf = swar_eq(x, 0x22)
    sf = swar_eq(x, 0x2C) | swar_eq(x, 0x0A) | swar_eq(x, 0x0D)
    p_in = swar_prefix_xor_bytes(qf)
    wp = swar_word_parity(p_in)
    if mode in CHAINED:
        # the quote parity before each word, over the stream, from c
        flat = wp.reshape(-1)
        base = ((torch.cumsum(flat, 0, dtype=torch.int32) - flat + c)
                & 1).view(rows, L)
    # the value each cut stores
    if mode == "dma_only":
        val = x
    elif mode == "classify_only":
        val = sf | qf
    elif mode == "inword":
        val = (sf & ~p_in) + wp
    elif mode in ("noscan", "v3_foldonly"):
        val = sf & ~p_in
    elif mode == "v3_mmonly":
        val = base
    else:  # full, v3, v3i8: the structural mask
        val = sf & ~(p_in ^ swar_broadcast_flag(base))
    val3 = val.view(tiles, tile, L)
    side = xor_reduce(val3.reshape(tiles, -1))
    if mode in ("dma_only", "classify_only", "inword", "v3_mmonly"):
        out = val3[:, : tile // 8]
    elif mode in ("noscan", "full"):
        sh = 7 - torch.arange(tile, device=words.device) % 8
        t = (val3 >> sh[None, :, None].to(torch.int32))
        out = wrap_sum(t.view(tiles, tile // 8, 8, L), 2)
    else:
        out = _fold_pack(val3, tile)
    out = out.reshape(rows // 8, L)
    if mode not in CHAINED:
        out = out + c
    return out, side


def _seq_from_flags(flags: torch.Tensor) -> torch.Tensor:
    """(rows, 128) 0x80-flag words -> B1's sequential words (rows * 16
    int32): bit 4(L % 8) + b of word 16r + L/8 is byte b's flag of word
    (r, L)."""
    # the multiply lifts bits 7/15/23/31 to 28..31 with no carries
    nib = shift_right_logical(flags * 0x204081, 28).view(-1, 16, 8)
    seq = nib[:, :, 0].clone()
    for i in range(1, 8):
        seq |= nib[:, :, i] << (4 * i)
    return seq.reshape(-1)


def _seq_plain(words: torch.Tensor, mode: str, carry_in) -> torch.Tensor:
    """B1's words (rows * 16 int32) of the flags that a mode of PERMUTED
    packs: the structural mask for the chained ones (B1's own words), sf &
    ~p_in for noscan and v3_foldonly."""
    if mode in CHAINED:
        c = _as_carry(carry_in, words.device)
        return _stage1_v4_plain(words.reshape(-1), c, DEFAULT_DIALECT,
                                False)[0]
    qf = swar_eq(words, 0x22)
    sf = swar_eq(words, 0x2C) | swar_eq(words, 0x0A) | swar_eq(words, 0x0D)
    return _seq_from_flags(sf & ~swar_prefix_xor_bytes(qf))


def _sum8_from_seq_plain(seq_words: torch.Tensor) -> torch.Tensor:
    """full's and noscan's 8-row wrapping sums of shifted flags, sum over
    k < 8 of flags[8g + k] >> (7 - k), from B1's words of the flags (rows
    x 512 bytes) -> (rows/8, 128) int32: the row-order transpose of each
    4 KiB step (bit 8b + k of word (g, L): byte b's flag of row 8g + k)
    with its top byte negated. Bytes 0-2 shift onto bits of their own;
    byte 3's flag, sign-extended, adds -2^(24 + k)
    (csrc/stage1_core.cuh `sum8_word`)."""
    a = _fold_from_seq_plain(seq_words, 8, order=tuple(range(8)))
    top = -shift_right_logical(a, 24) & 0xFF
    return (a & 0x00FFFFFF) | (top << 24)


def _v3_from_seq_plain(seq_words: torch.Tensor, tile: int) -> torch.Tensor:
    """The v3 folds from B1's words of their flags: B3's fold at `tile`
    with row segment j at bit 8b + bitrev3(j)."""
    return _fold_from_seq_plain(seq_words, tile, order=_BITREV3)


def mk(words: torch.Tensor, mode: str, tile: int = 512, carry_in=0):
    """(rows, 128) int32, tile a multiple of 8 dividing rows -> (out
    (rows/8, 128) int32, side (rows/tile,) int32) of stage cut `mode`."""
    check_rows128(words, "mk", 1)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    rows = words.shape[0]
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"tile {tile} must be a positive multiple of 8 "
                         f"that divides the {rows} rows")
    if words.device.type == "cuda":
        from .. import _kernels

        return _kernels.probe_ablate(words, mode, tile, carry_in)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return _ablate_plain(words, mode, tile, carry_in)


def check(words: torch.Tensor, specs=None, carry=1) -> dict:
    """Each (mode, tile) of specs (default: every mode at tile 512)
    against the plain version on words, words and side words."""
    specs = specs or [(m, 512) for m in MODES]
    return check_all(
        (g, x, f"{mode} rows={words.shape[0]} tile={tile} {part}")
        for mode, tile in specs
        for g, x, part in zip(mk(words, mode, tile, carry),
                              _ablate_plain(words, mode, tile, carry),
                              ("out", "side")))


def gate(device) -> dict:
    """Every mode against the plain version on the card, words and side
    words, on random and CSV-ish input at tiles 8 to 8,192 (the folds'
    staged emit at tiles dividing 128, their relayout at 24, 200 and 512
    up; a partial last 64 KiB chunk; tiles that span chunks) and carries
    0, 1 and a device 1."""
    dev_one = torch.ones((), dtype=torch.int32, device=device)
    results = []
    for rows, tile in ((512, 8), (1000, 8), (1024, 64), (264, 24),
                       (1152, 128), (1000, 200), (2048, 512), (24_576, 512),
                       (4096, 2048), (8192, 4096), (8192, 8192)):
        for w in (random_words(rows, device, rows + tile),
                  csv_words(rows, device, rows + tile)):
            for carry in (0, 1, dev_one):
                results.append(check(w, [(m, tile) for m in MODES], carry))
    torch.cuda.synchronize()
    return merge(*results)


def run(words: torch.Tensor, specs=None, reps: int = 20) -> dict:
    """{"mode:tile": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}}, the kernels timed in turns."""
    specs = specs or [(m, 512) for m in MODES]
    ms = kernel_ms({f"{m}:{t}": (lambda m=m, t=t: mk(words, m, t, 1))
                    for m, t in specs}, reps)
    out = {}
    for m, t in specs:
        plain = interleaved_ms({0: lambda m=m, t=t: _ablate_plain(
            words, m, t, 1)}, 2, rounds=1)[0]
        k = f"{m}:{t}"
        out[k] = {**ms[k], "gbps": words.numel() * 4 / ms[k]["ms"] / 1e6,
                  "plain_ms": plain}
    return out


def main(argv) -> int:
    device = need_card("ablate")
    specs = [(s.split(":")[0], int(s.split(":")[1])) for s in argv] or None
    result = {**card(), "gate": gate(device), "sizes": {}}
    for n in SIZES:
        words = random_words(n // 512, device, n >> 20)
        result["sizes"][f"{n >> 20}MiB"] = {"check": check(words, specs),
                                            "modes": run(words, specs)}
        del words
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
