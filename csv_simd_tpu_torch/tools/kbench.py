"""The v1-layout variants of B6 on the card (tools/kbench.py).

`make_variant` runs one variant over (rows, 128) uint8 -> (words,
count), with the default dialect the TPU tool hard-coded (quote 0x22;
delimiter 0x2C, newlines 0x0A, 0x0D). The words are B6's v1 layout (bit
k of word (s, lane) covers byte (32s + k) * 128 + lane) of:

- nopar: the structural bytes, no quote masking;
- lanescan: the structural bytes outside quotes by the quote parity
  within each 128-byte row only;
- roll, tril_input: outside quotes by the parity over the input from the
  carry-in, B6's words (they differed in how the TPU scanned the row
  totals: one cut, "full", here);
- current: B6 itself (`stage1_pallas`).

The count is what the TPU grid's last write left in its (0, 0) block: the
structural count of the last `tile` rows only, plus the carry-in for
nopar and lanescan; current returns B6's total count.

On a CUDA tensor nopar and lanescan launch csrc/probe_kbench.cu, roll
and tril_input B6's pair of kernels (B1's one pass, then
csrc/relayout.cu `v1_words` counting the last tile) and current B6
itself; on a CPU tensor each runs its plain version, `_variant_plain`.
Every variant is held against its plain version at the gate's sizes and
on the timed input; kernel times come from CUDA graphs (`ms`) and from
eager launches (`eager_ms`).

    python -m csv_simd_tpu_torch.tools.kbench [variant[:tile] ...]
        (default: every variant at tile 1024, on 64 MiB and 1 GiB of
        random bytes: the other tools' random int32 words, as bytes)
"""

from __future__ import annotations

import sys

import torch

from ..config import DEFAULT_DIALECT
from ..ops.pack import pack_words
from ..ops.scan import in_quote_parity
from ..ops.stage1_pallas import _stage1_pallas_plain, stage1_pallas
from ..ops.stage1_v3 import _as_carry
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
)

L = 128
SIZES = (64 << 20, 1 << 30)
VARIANTS = ("nopar", "lanescan", "roll", "tril_input", "current")
_CUT = {"nopar": "nopar", "lanescan": "lanescan", "roll": "full",
        "tril_input": "full"}


def _variant_plain(b2d: torch.Tensor, name: str, tile: int, carry_in):
    """Plain version of a variant: (words (rows/32, 128) int32, count 0-d
    int32)."""
    c = _as_carry(carry_in, b2d.device)
    if name == "current":
        words, count, _par = _stage1_pallas_plain(b2d, c, DEFAULT_DIALECT)
        return words, count
    b = b2d.to(torch.int32)
    struct = ((b == 44) | (b == 10) | (b == 13)).to(torch.int32)
    q = (b == 34).to(torch.int32)
    if name == "nopar":
        masked = struct
    elif name == "lanescan":
        within = torch.cumsum(q, 1, dtype=torch.int32)
        masked = struct * (1 - (within & 1))
    else:  # roll, tril_input: the parity over the whole input
        masked = struct * (1 - in_quote_parity(q, c).to(torch.int32))
    count = masked[-tile:].sum(dtype=torch.int32)
    if name in ("nopar", "lanescan"):
        count = count + c
    return pack_words(masked), count.to(torch.int32)


def _check(b2d: torch.Tensor, name: str, tile: int) -> None:
    if b2d.dtype != torch.uint8 or b2d.dim() != 2 or b2d.shape[1] != L:
        raise ValueError(f"expected (rows, 128) uint8, got {b2d.dtype} "
                         f"{tuple(b2d.shape)}")
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}: {name!r}")
    rows = b2d.shape[0]
    if tile <= 0 or tile % 32 or rows == 0 or rows % tile:
        raise ValueError(f"tile {tile} must be a positive multiple of 32 "
                         f"that divides the {rows} rows")


def make_variant(b2d: torch.Tensor, name: str, tile: int = 1024,
                 carry_in=0):
    """(rows, 128) uint8 -> (words (rows/32, 128) int32, count 0-d int32)
    of the named variant at `tile` rows."""
    _check(b2d, name, tile)
    if b2d.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {b2d.device}")
    if name == "current":
        words, count, _par = stage1_pallas(b2d, carry_in, row_tile=tile)
        return words, count
    if b2d.device.type == "cuda":
        from .. import _kernels

        return _kernels.probe_kbench(b2d, _CUT[name], tile, carry_in)
    return _variant_plain(b2d, name, tile, carry_in)


def as_bytes(words: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32 words -> the same bytes as (rows * 4, 128) uint8."""
    return words.view(torch.uint8).view(-1, L)


def check(b2d: torch.Tensor, specs=None, carry=1) -> dict:
    """Each (variant, tile) of specs (default: every variant at tile 1024)
    against its plain version on b2d, words and count."""
    specs = specs or [(v, 1024) for v in VARIANTS]
    return check_all(
        (g, x, f"{name} rows={b2d.shape[0]} tile={tile} {part}")
        for name, tile in specs
        for g, x, part in zip(make_variant(b2d, name, tile, carry),
                              _variant_plain(b2d, name, tile, carry),
                              ("words", "count")))


def gate(device) -> dict:
    """Every variant against its plain version on the card, words and
    count, on random and CSV-ish bytes at tiles 32, 64, 512 and 1024 and
    carries 0, 1 and a device 1; full's words also against B6's."""
    dev_one = torch.ones((), dtype=torch.int32, device=device)
    results = []
    for rows, tile in ((64, 32), (1024, 64), (1536, 512), (4096, 1024),
                       (65_536, 1024)):
        for b in (as_bytes(random_words(rows // 4, device, rows + tile)),
                  as_bytes(csv_words(rows // 4, device, rows + tile))):
            for carry in (0, 1, dev_one):
                results.append(check(b, [(v, tile) for v in VARIANTS], carry))
                results.append(check_all([(
                    make_variant(b, "roll", tile, carry)[0],
                    make_variant(b, "current", tile, carry)[0],
                    "roll vs B6 words")]))
    torch.cuda.synchronize()
    return merge(*results)


def run(b2d: torch.Tensor, specs=None, reps: int = 20,
        plain_reps: int = 2) -> dict:
    """{"variant:tile": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}}, the kernels timed in turns; plain_reps=0 skips the plain
    versions' times."""
    specs = specs or [(v, 1024) for v in VARIANTS]
    ms = kernel_ms({f"{v}:{t}": (lambda v=v, t=t: make_variant(b2d, v, t,
                                                               1))
                    for v, t in specs}, reps)
    out = {}
    for v, t in specs:
        k = f"{v}:{t}"
        out[k] = {**ms[k], "gbps": b2d.numel() / ms[k]["ms"] / 1e6}
        if plain_reps:
            out[k]["plain_ms"] = interleaved_ms(
                {0: lambda v=v, t=t: _variant_plain(b2d, v, t, 1)},
                plain_reps, rounds=1)[0]
    return out


def main(argv) -> int:
    device = need_card("kbench")
    specs = [(s.split(":")[0], int(s.split(":")[1]) if ":" in s else 1024)
             for s in argv] or None
    result = {**card(), "gate": gate(device), "sizes": {}}
    for n in SIZES:
        b = as_bytes(random_words(n // 512, device, n >> 20))
        result["sizes"][f"{n >> 20}MiB"] = {"check": check(b, specs),
                                            "variants": run(b, specs)}
        del b
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
