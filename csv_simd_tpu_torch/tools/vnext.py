"""B3's candidate constructions on the card (tools/vnext.py): the
direct fold pack against B3.

`make(words, tile, carry, i8acc, directpack)` runs one variant over
(rows, 128) int32 -> (packed (rows/8, 128) int32, parity out 0-d int32),
with the default dialect the TPU tool hard-coded (quote 0x22; delimiter
0x2C, newlines 0x0A, 0x0D). All four variants give B3's fold-layout
words and parity out:

- base (i8acc=False, directpack=False) and i8acc: B3 itself
  (`stage1_fused`); int8 accumulation was a TPU matmul type and computes
  the same function here;
- directpack and both: each word built whole from its 8 rows tile/8
  apart (one shift-OR at bit sigma(j) = 7 - bitrev3(j), as the TPU
  tool's `direct_pack`). At a tile that divides 128 rows the 8 rows lie
  in one 64 KiB chunk of B1's one pass, and csrc/probe_vnext.cu writes
  the words from that pass's emit (one launch, the input read once, no
  atomics); at any other tile it is B3's pair, B1's one pass and
  `fold_words`. Timed at tiles 128 and 512, the pair at tile 128 is the
  direct emit against B1 plus the relayout's N/8 round trip.

On a CPU tensor every variant runs its plain version, `_vnext_plain`,
which packs with the TPU tool's own construction (`_direct_pack` or the
three-step `_fold_pack`). `check` holds the direct pack against B3 and,
unpacked, against golden, on words from the caller or a CSV file.

    python -m csv_simd_tpu_torch.tools.vnext [bench|check [FILE.csv]]
        bench (default): the gate, then every variant at tiles 128 and
        512 on 64 MiB and 1 GiB of random int32, each checked first;
        check: the direct pack against B3 and golden on FILE.csv
        (default: a 2 MB synthetic wide table, as the TPU tool's check)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import DEFAULT_DIALECT
from ..ops.stage1_v3 import (
    _as_carry,
    _fold_pack,
    _scan_masked,
    stage1_fused,
    unpack_packed_host,
)
from ..ops.swar import shift_right_logical
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
from ._lab_kernels import check_rows128

L = 128
SIZES = (64 << 20, 1 << 30)
TILES = (128, 512)
_BITREV3 = (0, 4, 2, 6, 1, 5, 3, 7)
VARIANTS = {"base": (False, False), "directpack": (False, True),
            "i8acc": (True, False), "both": (True, True)}


def _direct_pack(masked: torch.Tensor, tile: int) -> torch.Tensor:
    """(tiles, tile, 128) 0x80-flag words -> (tiles, tile/8, 128): row
    segment j shifted right (logically) by bitrev3(j), all eight ORed
    (the TPU tool's `direct_pack`)."""
    gp = tile // 8
    acc = None
    for j in range(8):
        term = shift_right_logical(masked[:, j * gp:(j + 1) * gp],
                                   _BITREV3[j])
        acc = term if acc is None else acc | term
    return acc


def _vnext_plain(words: torch.Tensor, tile: int, carry_in,
                 directpack: bool):
    """Plain version: (fold-layout packed (rows/8, 128), parity out)."""
    rows = words.shape[0]
    masked, parity = _scan_masked(words, _as_carry(carry_in, words.device),
                                  DEFAULT_DIALECT)
    m3 = masked.view(rows // tile, tile, L)
    packed = _direct_pack(m3, tile) if directpack else _fold_pack(m3, tile)
    return packed.reshape(rows // 8, L), parity


def _check(words: torch.Tensor, tile: int) -> None:
    check_rows128(words, "vnext", 8)
    rows = words.shape[0]
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"tile {tile} must be a positive multiple of 8 "
                         f"that divides the {rows} rows")


def make(words: torch.Tensor, tile: int = 512, carry_in=0,
         i8acc: bool = False, directpack: bool = False):
    """(rows, 128) int32 -> (B3's fold-layout words (rows/8, 128) int32,
    parity out 0-d int32) by the variant's construction."""
    _check(words, tile)
    if words.device.type == "cuda":
        if directpack:
            from . import _lab_kernels

            return _lab_kernels.probe_vnext(words, tile, carry_in)
        return stage1_fused(words, carry_in, row_tile=tile)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return _vnext_plain(words, tile, carry_in, directpack)


def _pairs(words: torch.Tensor, tile: int, carry) -> list:
    """(got, want, what) for every variant against its plain version and
    for the direct pack against B3, words and parity."""
    pairs = []
    for name, (i8, dp) in VARIANTS.items():
        pairs += [(g, x, f"{name} rows={words.shape[0]} tile={tile} {part}")
                  for g, x, part in zip(make(words, tile, carry, i8, dp),
                                        _vnext_plain(words, tile, carry, dp),
                                        ("words", "parity"))]
    pairs += [(g, x, f"directpack vs B3 {part}") for g, x, part in zip(
        make(words, tile, carry, directpack=True),
        stage1_fused(words, carry, row_tile=tile), ("words", "parity"))]
    return pairs


def check_timed(words: torch.Tensor, tile: int = 512) -> dict:
    """`_pairs` on the timed input at carry 1, as `run` times it."""
    return check_all(_pairs(words, tile, 1))


def check(words=None, path=None, tile: int = 512) -> dict:
    """`_pairs` at carry 0 and the direct pack, unpacked, against
    golden.structural_mask and its parity out against golden's: on
    `words` ((rows, 128) int32 byte quads on any device, rows a multiple
    of tile), or on the bytes of the CSV at `path`, or on a 2 MB synthetic
    wide table made here. Returns {checks, max_abs_err}."""
    from .. import golden
    from ..ops.stage1_v2 import pad_to_words

    if words is None:
        if path is not None:
            data = np.fromfile(path, dtype=np.uint8)
        else:
            data = np.frombuffer(_wide_table(2_000_000), np.uint8)
        device = (torch.device("cuda", 0) if torch.cuda.is_available()
                  else "cpu")
        words = torch.from_numpy(pad_to_words(data, row_align=tile)).to(
            device)
    else:
        data = words.cpu().numpy().view(np.uint8).reshape(-1)
    result = check_all(_pairs(words, tile, 0))
    direct = make(words, tile, 0, directpack=True)
    mask = unpack_packed_host(direct[0].cpu().numpy(), data.size, tile=tile)
    if not np.array_equal(mask, golden.structural_mask(data)):
        raise AssertionError("directpack differs from golden.structural_mask")
    if int(direct[1]) != golden.quote_parity_out(data):
        raise AssertionError("directpack parity out differs from golden")
    return {"checks": result["checks"] + 2,
            "max_abs_err": result["max_abs_err"]}


def _wide_table(n_bytes: int, n_fields: int = 16, seed: int = 7) -> bytes:
    """The TPU tool's check input: the test corpus's deterministic
    synthetic wide table of about n_bytes (tests/corpus.py
    `synthetic_wide_table`, which the package does not import)."""
    import random

    rng = random.Random(seed)
    header = ",".join(f"f{j}" for j in range(n_fields)) + "\n"
    out, size, row_id = [header], len(header), 0
    while size < n_bytes:
        fields = [str(row_id)]
        for j in range(1, n_fields):
            if j % 7 == 3:
                fields.append(f'"text, with comma {rng.randint(0, 9999)}"')
            else:
                fields.append(str(rng.randint(0, 10**9)))
        row = ",".join(fields) + "\n"
        out.append(row)
        size += len(row)
        row_id += 1
    return "".join(out).encode()


def gate(device) -> dict:
    """`_pairs` on the card on random and CSV-ish input at tiles 8 to
    128 (the direct emit; a partial last chunk among them) and 512, 2,048
    and 8,192 (B1 and `fold_words`), carries 0, 1 and a device 1."""
    dev_one = torch.ones((), dtype=torch.int32, device=device)
    results = []
    for rows, tile in ((64, 8), (1000, 8), (384, 16), (640, 32),
                       (1024, 64), (1152, 128), (24_576, 128), (1536, 512),
                       (24_576, 512), (8192, 2048), (8192, 8192)):
        for w in (random_words(rows, device, rows + tile),
                  csv_words(rows, device, rows + tile)):
            for carry in (0, 1, dev_one):
                results.append(check_all(_pairs(w, tile, carry)))
    torch.cuda.synchronize()
    return merge(*results)


def run(words: torch.Tensor, tiles=TILES, reps: int = 20,
        plain_reps: int = 2) -> dict:
    """{"variant:tile": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}}, the kernels timed in turns; plain_reps=0 skips the plain
    versions' times."""
    specs = {f"{name}:{tile}": (tile, i8, dp) for tile in tiles
             for name, (i8, dp) in VARIANTS.items()}
    ms = kernel_ms({k: (lambda t=t, i8=i8, dp=dp: make(words, t, 1, i8, dp))
                    for k, (t, i8, dp) in specs.items()}, reps)
    out = {}
    for k, (t, _i8, dp) in specs.items():
        out[k] = {**ms[k], "gbps": words.numel() * 4 / ms[k]["ms"] / 1e6}
        if plain_reps:
            out[k]["plain_ms"] = interleaved_ms(
                {0: lambda t=t, dp=dp: _vnext_plain(words, t, 1, dp)},
                plain_reps, rounds=1)[0]
    return out


def main(argv) -> int:
    device = need_card("vnext")
    if argv and argv[0] == "check":
        emit({**card(), "check": check(path=argv[1] if len(argv) > 1
                                       else None)})
        return 0
    result = {**card(), "gate": gate(device), "check": check(), "sizes": {}}
    for n in SIZES:
        words = random_words(n // 512, device, n >> 20)
        checked = merge(*(check_timed(words, t) for t in TILES))
        result["sizes"][f"{n >> 20}MiB"] = {"check": checked,
                                            "variants": run(words)}
        del words
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
