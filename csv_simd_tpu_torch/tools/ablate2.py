"""B1's own stage cuts on the card, with the package kernels beside them
(tools/ablate2.py).

`mk` runs one mode over (rows, 128) int32 with the default dialect the
TPU tool hard-coded (quote 0x22; delimiter 0x2C, newlines 0x0A, 0x0D):

- the cuts of B1's pass B (csrc/probe_ablate2.cu has each one's words):
  cls22, cls18, prep, mm1, pack1 (= pack1slice), pack2, px, lane and
  v4full. Each returns (out (rows, 16) int32, side): side is one word a
  64 KiB chunk (128 rows), the XOR over the chunk of the value the cut
  computes, for cls22, cls18, prep and mm1, whose words read part of
  the input, and empty for the others. Every cut but v4full adds the TPU
  kernel's SMEM toggle (c + i) & 1 at tile i (lane starts its in-row
  parity from it); v4full chains the parity and is B1's narrow words;
- the package kernels, as the TPU tool ran them: v3 is B3
  (`stage1_fused`), seq is B4 (`stage1_fused_seq`, B1's narrow words on
  the card), and v4, v4mm1, v4mm1r, v4nc, v4ncmm1, v4ncmm1r are B1
  (`stage1_fused_v4`; the nc modes skip the non-ASCII count, pack_mode
  chose a Mosaic pack and is ignored). Each returns its kernel's outputs;
- sol, the TPU tool's streaming reduce: sum(max(words, carry & 127)) in
  int32, a torch reduction (it was never a Pallas kernel).

On a CUDA tensor the cuts launch csrc/probe_ablate2.cu, on a CPU tensor
their plain version, `_micro_plain`. Every mode is held against its
plain version at the gate's sizes and on the timed input; kernel times
come from CUDA graphs (`ms`) and from eager launches (`eager_ms`).

    python -m csv_simd_tpu_torch.tools.ablate2 [mode:tile ...]
        (default: every cut and v4, v4nc, seq, v3 and sol at tile 512, on
        64 MiB and 1 GiB of random int32)
"""

from __future__ import annotations

import sys

import torch

from ..config import DEFAULT_DIALECT
from ..ops.stage1_v3 import (
    _as_carry,
    stage1_fused,
    stage1_fused_seq,
    stage1_seq_xla,
    stage1_swar_xla,
)
from ..ops.stage1_v4 import _stage1_v4_plain, stage1_fused_v4
from ..ops.swar import (
    swar_classify_u,
    swar_eq,
    swar_nibble_compress,
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
    xor_reduce,
)
from ._lab_kernels import check_rows128

L = 128
WORDS = 16
CHUNK_ROWS = 128  # the kernel's 64 KiB chunk
SIZES = (64 << 20, 1 << 30)
MICRO = ("cls22", "cls18", "prep", "mm1", "pack1", "pack1slice", "pack2",
         "px", "lane", "v4full")
SIDE = ("cls22", "cls18", "prep", "mm1")
PACKAGE = ("v3", "seq", "v4", "v4mm1", "v4mm1r", "v4nc", "v4ncmm1",
           "v4ncmm1r")
MODES = MICRO + PACKAGE + ("sol",)
RUN_MODES = ("cls22", "cls18", "prep", "mm1", "pack1", "pack2", "px",
             "lane", "v4full", "v4", "v4nc", "seq", "v3", "sol")


def _pack(v: torch.Tensor):
    """(rows, 128) 4-bit nibbles -> (lo, hi) (rows, 16): word g's low half
    holds the nibbles of lanes 8g..8g+3 at bits 4l, its high half those
    of lanes 8g+4..8g+7 (the TPU tool's pack matmul, exact integers)."""
    v = v.view(-1, WORDS, 8)
    lo = v[..., 0] | (v[..., 1] << 4) | (v[..., 2] << 8) | (v[..., 3] << 12)
    hi = v[..., 4] | (v[..., 5] << 4) | (v[..., 6] << 8) | (v[..., 7] << 12)
    return lo, hi


def _prefix_xor32(x: torch.Tensor) -> torch.Tensor:
    for s in (1, 2, 4, 8, 16):
        x = x ^ (x << s)
    return x


def _chunk_xor(val: torch.Tensor) -> torch.Tensor:
    """XOR of each 128-row chunk of val (rows, n), the last one partial."""
    rows = val.shape[0]
    pad = -rows % CHUNK_ROWS
    if pad:
        val = torch.cat([val, val.new_zeros((pad, val.shape[1]))])
    return xor_reduce(val.reshape(-1, CHUNK_ROWS * val.shape[1]))


def _micro_plain(words: torch.Tensor, mode: str, tile: int, carry_in):
    """Plain version of the cuts: (out (rows, 16) int32, side int32)."""
    rows = words.shape[0]
    c = _as_carry(carry_in, words.device)
    x = words
    rix = torch.arange(rows, device=words.device)[:, None]
    tog = ((rix // tile + c) & 1).to(torch.int32)  # the SMEM toggle
    if mode == "cls22":
        val = (swar_eq(x, 0x2C) | swar_eq(x, 0x0A) | swar_eq(x, 0x0D)
               | swar_eq(x, 0x22))
        return val[:, :WORDS] + tog, _chunk_xor(val)
    us, uq = swar_classify_u(x, (0x0A, 0x0D, 0x2C), 0x22)
    if mode == "cls18":
        val = us | uq
        return val[:, :WORDS] + tog, _chunk_xor(val)
    vs = swar_nibble_compress(us)
    vq = swar_nibble_compress(uq)
    if mode == "prep":
        val = vs + vq
        return val[:, :WORDS] + tog, _chunk_xor(val)
    lo, hi = _pack(vs)
    sw = lo | (hi << 16)
    empty = torch.zeros(0, dtype=torch.int32, device=words.device)
    if mode == "mm1":
        return lo + tog, _chunk_xor(sw)
    if mode in ("pack1", "pack1slice"):
        return sw + tog, empty
    qlo, qhi = _pack(vq)
    qw = qlo | (qhi << 16)
    if mode == "pack2":
        return (sw ^ qw) + tog, empty
    px = _prefix_xor32(qw)
    if mode == "px":
        return (sw & ~px) + tog, empty
    wp = (px >> 31) & 1
    lane_excl = torch.cumsum(wp, 1, dtype=torch.int32) - wp
    if mode == "lane":
        base = (lane_excl + tog) & 1
        return sw & ~(px ^ -base), empty
    # v4full: the row parity chained over every row from the carry-in
    rowpar = (lane_excl[:, -1:] + wp[:, -1:]) & 1
    row_excl = torch.cumsum(rowpar, 0, dtype=torch.int32) - rowpar
    base = (lane_excl + row_excl + c) & 1
    return sw & ~(px ^ -base), empty


def _sol(words: torch.Tensor, carry_in) -> torch.Tensor:
    floor = _as_carry(carry_in, words.device) & 127  # int or 0-d tensor
    if isinstance(floor, torch.Tensor):
        top = torch.maximum(words, floor)
    else:
        top = torch.clamp(words, min=floor)
    return top.sum(dtype=torch.int32)


def _package(words: torch.Tensor, mode: str, tile: int, carry, plain: bool):
    """A package kernel's outputs (plain: its plain version's)."""
    if mode == "v3":
        if plain:
            return stage1_swar_xla(words, carry, row_tile=tile)
        return stage1_fused(words, carry, row_tile=tile)
    if mode == "seq":
        if plain:
            return stage1_seq_xla(words, carry)
        return stage1_fused_seq(words, carry, row_tile=tile)
    count = "nc" not in mode
    if plain:
        packed, parity, nonascii = _stage1_v4_plain(
            words.reshape(-1), carry, DEFAULT_DIALECT, count)
        return packed.view(-1, WORDS), parity, nonascii
    return stage1_fused_v4(words, carry, row_tile=tile, count_nonascii=count)


def _check_mode(words: torch.Tensor, mode: str, tile: int) -> None:
    check_rows128(words, "mk", 1)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}: {mode!r}")
    rows = words.shape[0]
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"tile {tile} must be a positive multiple of 8 "
                         f"that divides the {rows} rows")


def mk(words: torch.Tensor, mode: str, tile: int = 512, carry_in=0):
    """(rows, 128) int32, tile a multiple of 8 dividing rows -> mode's
    outputs (module docstring)."""
    _check_mode(words, mode, tile)
    if words.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {words.device}")
    if mode == "sol":
        return _sol(words, carry_in)
    if mode in PACKAGE:
        return _package(words, mode, tile, _as_carry(carry_in, words.device),
                        plain=False)
    if words.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_ablate2(words, mode, tile, carry_in)
    return _micro_plain(words, mode, tile, carry_in)


def plain(words: torch.Tensor, mode: str, tile: int = 512, carry_in=0):
    """mode's plain version: the same outputs as `mk`, on any device."""
    _check_mode(words, mode, tile)
    if mode == "sol":
        return _sol(words, carry_in)
    if mode in PACKAGE:
        return _package(words, mode, tile, _as_carry(carry_in, words.device),
                        plain=True)
    return _micro_plain(words, mode, tile, carry_in)


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def check(words: torch.Tensor, specs=None, carry=1) -> dict:
    """Each (mode, tile) of specs (default: RUN_MODES at tile 512) against
    its plain version on words, every output."""
    specs = specs or [(m, 512) for m in RUN_MODES]
    return check_all(
        (g, x, f"{mode} rows={words.shape[0]} tile={tile} output {i}")
        for mode, tile in specs
        for i, (g, x) in enumerate(zip(_outputs(mk(words, mode, tile, carry)),
                                       _outputs(plain(words, mode, tile,
                                                      carry)))))


def gate(device) -> dict:
    """Every cut against its plain version on the card, words and side
    words, on random and CSV-ish input at tiles 8, 64 and 512 and carries
    0, 1 and a device 1; v4full also against B1's narrow words."""
    dev_one = torch.ones((), dtype=torch.int32, device=device)
    results = []
    for rows, tile in ((512, 8), (1000, 8), (1024, 64), (2048, 512),
                       (24_576, 512)):
        for w in (random_words(rows, device, rows + tile),
                  csv_words(rows, device, rows + tile)):
            for carry in (0, 1, dev_one):
                results.append(check(w, [(m, tile) for m in MICRO], carry))
                b1 = stage1_fused_v4(w, carry)[0]
                results.append(check_all([(mk(w, "v4full", tile, carry)[0],
                                           b1, "v4full vs B1 narrow")]))
    torch.cuda.synchronize()
    return merge(*results)


def run(words: torch.Tensor, specs=None, reps: int = 20,
        plain_reps: int = 2) -> dict:
    """{"mode:tile": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}}, the kernels timed in turns; plain_reps=0 skips the plain
    versions' times."""
    specs = specs or [(m, 512) for m in RUN_MODES]
    ms = kernel_ms({f"{m}:{t}": (lambda m=m, t=t: mk(words, m, t, 1))
                    for m, t in specs}, reps)
    out = {}
    for m, t in specs:
        k = f"{m}:{t}"
        out[k] = {**ms[k], "gbps": words.numel() * 4 / ms[k]["ms"] / 1e6}
        if plain_reps:
            out[k]["plain_ms"] = interleaved_ms(
                {0: lambda m=m, t=t: plain(words, m, t, 1)}, plain_reps,
                rounds=1)[0]
    return out


def main(argv) -> int:
    device = need_card("ablate2")
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
