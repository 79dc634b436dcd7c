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

Its pass is B3's layout, not B1's: a block owns whole tiles (at least
64 KiB) with its out words in shared memory, written once at the end.

    python -m csv_simd_tpu_torch.tools.ablate [mode:tile ...]
        (default: every mode at tile 512, on 64 MiB and 1 GiB of random
        int32)
"""

from __future__ import annotations

import sys

import torch

from .._kernels import check_rows128
from ..ops.stage1_v3 import _as_carry
from ..ops.swar import (
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
    words, on random and CSV-ish input at tiles 8, 64 and 512 and carries
    0, 1 and a device 1."""
    dev_one = torch.ones((), dtype=torch.int32, device=device)
    results = []
    for rows, tile in ((512, 8), (1024, 64), (2048, 512), (24_576, 512)):
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
