"""Dialect configuration and classification-table construction.

The reference hardcodes its byte classes into two 16-entry nibble lookup
tables (stage1.rs:24-35) with a bit-set code per class (stage1.rs:41-52):
newline=1, comma=2, space=4, escape=8, quote=16. Here the tables are
*generated* from a `Dialect` (the generalisation the reference planned:
"The delimiter value is not referencing a single value and is fixed ','",
tape.rs:216), and the construction is validated exhaustively over all 256
byte values so a dialect that cannot be expressed as `LO[b&15] & HI[b>>4]`
is rejected instead of silently misclassifying.

On TPU the hot kernels classify by direct vector compares (the VPU has
native byte compares; the nibble-LUT shuffle is an x86 `vpshufb` idiom),
but the LUTs remain the canonical definition of the byte->code map and the
golden model uses them verbatim for bit-level parity with the reference.

The port's own copy of csv_simd_tpu/config.py;
it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# Bit-set codes, matching stage1.rs:41-52.
CODE_NEWLINE = 1
CODE_DELIM = 2
CODE_SPACE = 4
CODE_ESCAPE = 8
CODE_QUOTE = 16

# Only newline|delimiter bytes are structural (avx/stage1.rs:394 uses mask 3);
# space/escape are classified but unused in the reference (stage1.rs:51).
CODE_STRUCTURAL = CODE_NEWLINE | CODE_DELIM


@dataclasses.dataclass(frozen=True)
class Dialect:
    """CSV dialect: which bytes play which structural role.

    Defaults reproduce the reference exactly: delimiter ',' (0x2C,
    tape.rs:270), quote '"' (0x22), newlines \\n/\\r (0x0A/0x0D), space
    0x20, escape '\\' (0x5C).
    """

    delimiter: int = 0x2C
    quote: int = 0x22
    newlines: Tuple[int, ...] = (0x0A, 0x0D)
    space: int = 0x20
    escape: int = 0x5C
    # Opt-in quote-aware HEADER parsing: the reference splits the header
    # on raw delimiters (tape.rs:258-262 — a known gap preserved for
    # parity by default). True = header names may be quoted and contain
    # delimiters/newlines/escaped "" quotes (tape.Header.parse). The
    # stage-1 index was always quote-aware; only the header split gated
    # on this.
    header_quotes: bool = False

    def __post_init__(self):
        roles = [self.delimiter, self.quote, self.space, self.escape]
        roles.extend(self.newlines)
        for b in roles:
            if not 0 <= b <= 0xFF:
                raise ValueError(f"byte value out of range: {b}")
        core = [self.delimiter, self.quote, *self.newlines]
        if len(set(core)) != len(core):
            raise ValueError(
                "delimiter, quote and newline bytes must be distinct"
            )
        # space/escape are classified-but-inert for stage-1 (trim and
        # escape act in stage-2 decode only), so they may legitimately
        # coincide with the delimiter/newlines — e.g. a space-delimited
        # dialect. They must not equal the QUOTE though: decode trims
        # spaces before unquoting, which would strip the quotes.
        if self.quote in (self.space, self.escape):
            raise ValueError(
                "space/escape must differ from the quote byte "
                "(stage-2 trim runs before unquote)"
            )

    def code_map(self) -> Dict[int, int]:
        """byte value -> bit-set code. Colliding roles OR their codes
        (a space-delimited dialect classifies 0x20 as DELIM|SPACE —
        plain dict assignment would have silently dropped the
        structural bit)."""
        m: Dict[int, int] = {}

        def add(b: int, code: int) -> None:
            m[b] = m.get(b, 0) | code

        for b in self.newlines:
            add(b, CODE_NEWLINE)
        add(self.delimiter, CODE_DELIM)
        add(self.space, CODE_SPACE)
        add(self.escape, CODE_ESCAPE)
        add(self.quote, CODE_QUOTE)
        return m


DEFAULT_DIALECT = Dialect()


def build_nibble_luts(dialect: Dialect = DEFAULT_DIALECT) -> Tuple[np.ndarray, np.ndarray]:
    """Build the two 16-entry nibble LUTs for a dialect.

    Construction: LO[l] = OR of codes of mapped bytes whose low nibble is l;
    HI[h] likewise for high nibbles. A byte b then classifies to
    `LO[b & 0xF] & HI[b >> 4]`. The construction is only sound when no
    (low, high) nibble collision produces a spurious nonzero code, so we
    verify all 256 byte values and raise otherwise.

    For the default dialect this reproduces the reference tables
    LO = [4,0,16,0,0,0,0,0,0,0,1,0,10,1,0,0],
    HI = [1,0,22,0,0,8,0,0,0,0,0,0,0,0,0,0]  (stage1.rs:24-35).
    """
    lo = np.zeros(16, dtype=np.uint8)
    hi = np.zeros(16, dtype=np.uint8)
    codes = dialect.code_map()
    for byte, code in codes.items():
        lo[byte & 0xF] |= code
        hi[byte >> 4] |= code
    for b in range(256):
        got = int(lo[b & 0xF] & hi[b >> 4])
        want = codes.get(b, 0)
        if got != want:
            raise ValueError(
                f"dialect not representable as nibble LUTs: byte {b:#04x} "
                f"classifies to {got}, expected {want}"
            )
    return lo, hi


def build_full_lut(dialect: Dialect = DEFAULT_DIALECT) -> np.ndarray:
    """256-entry byte -> code table (the nibble LUTs folded out)."""
    lo, hi = build_nibble_luts(dialect)
    b = np.arange(256, dtype=np.uint16)
    return (lo[b & 0xF] & hi[b >> 4]).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Shapes for the device pipeline.

    Bytes are laid out as (rows, LANES) uint8, row-major, so the flat byte
    position of element (r, c) is r*LANES + c. LANES is the VPU lane width;
    ROW_TILE rows form one kernel tile (must be a multiple of the int8
    sublane tile, 32).
    """

    lanes: int = 128
    row_tile: int = 1024  # 128 KiB per tile

    @property
    def tile_bytes(self) -> int:
        return self.lanes * self.row_tile


DEFAULT_BLOCKS = BlockConfig()
