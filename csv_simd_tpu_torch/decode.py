"""Field decoding: raw tape slices -> usable values (the port's own copy
of csv_simd_tpu/decode.py, host only).

The reference stops at raw slices — values keep surrounding quotes,
escaped quotes and whitespace; trim/escape support is an explicit TODO
(README.md:32; space and backslash are *classified* by the LUTs,
stage1.rs:51, but never used). This layer finishes it:

- `decode_field`: RFC-4180 unquote + `""` -> `"` unescape, optional
  whitespace trim (trim applies outside the quotes, so a quoted field's
  inner whitespace survives — the usual dialect behavior);
- batched vectorised variants over columns (device_tape's
  `gather_decoded` and `column_decoded` are the device side).

Decoding is intentionally separate from the tape: stage-1 stays a pure
structural pass (one streaming scan), and decode touches only the fields
actually served.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .config import DEFAULT_DIALECT, Dialect


def decode_field(
    raw: Optional[bytes],
    dialect: Dialect = DEFAULT_DIALECT,
    trim: bool = True,
) -> Optional[bytes]:
    """Raw slice -> decoded value (None passes through)."""
    if raw is None:
        return None
    q = dialect.quote.to_bytes(1, "little")
    sp = dialect.space.to_bytes(1, "little")
    val = raw
    if trim:
        val = val.strip(sp + b"\t")
    if len(val) >= 2 and val[:1] == q and val[-1:] == q:
        val = val[1:-1].replace(q + q, q)
    return val


def decode_str(
    raw: Optional[bytes],
    dialect: Dialect = DEFAULT_DIALECT,
    trim: bool = True,
    encoding: str = "utf-8",
) -> Optional[str]:
    out = decode_field(raw, dialect, trim)
    return None if out is None else out.decode(encoding, errors="surrogateescape")


class DecodedView:
    """Decoded serving facade over a Tape: same seek/column/iter API, but
    values come back unquoted/unescaped/trimmed."""

    def __init__(self, tape, dialect: Dialect = DEFAULT_DIALECT, trim: bool = True):
        self._tape = tape
        self._dialect = dialect
        self._trim = trim

    def seek_field(self, r: int, f: int) -> Optional[bytes]:
        return decode_field(self._tape.seek_field(r, f), self._dialect, self._trim)

    def seek_field_str(self, r: int, f: int) -> Optional[str]:
        return decode_str(self._tape.seek_field(r, f), self._dialect, self._trim)

    def column(self, f: int) -> List[bytes]:
        return [
            decode_field(v, self._dialect, self._trim)
            for v in self._tape.column(f)
        ]

    def row(self, r: int) -> Optional[List[bytes]]:
        if r < 0 or r + 1 >= self._tape.record_cnt:
            return None
        return [self.seek_field(r, f) for f in range(self._tape.field_cnt)]

    def iter_rows(self):
        for r in range(self._tape.num_data_records):
            yield self.row(r)

    # typed column helpers — the thing downstream tabular pipelines want
    def column_int(self, f: int) -> np.ndarray:
        return np.array(
            [int(v) if v else 0 for v in self.column(f)], dtype=np.int64
        )

    def column_float(self, f: int) -> np.ndarray:
        return np.array(
            [float(v) if v else np.nan for v in self.column(f)],
            dtype=np.float64,
        )

    def column_decimal(self, f: int, scale: int = 2):
        """Host oracle for the tapes' column_decimal64: exact scaled
        int64 via Python big ints, same ok contract (refuses >scale
        fractional digits, overflow, exponents). Returns (values, ok)."""
        vals = np.zeros(self._tape.num_data_records, np.int64)
        ok = np.zeros(vals.size, bool)
        for i, raw in enumerate(self.column(f)):
            v = _parse_decimal_host(raw, scale)
            if v is not None:
                vals[i], ok[i] = v, True
        return vals, ok


def _parse_decimal_host(raw, scale: int):
    """`[spaces][+|-]digits[.digits]` -> exact int scaled by 10^scale,
    or None. Twin of device_tape._parse_decimal_limbs."""
    if not raw:
        return None
    s = raw.decode("ascii", "replace").lstrip(" ")
    if not s:
        return None
    neg = s[0] == "-"
    if s[0] in "+-":
        s = s[1:]
    if s.count(".") > 1:
        return None
    intp, _, frac = s.partition(".")
    if not (intp + frac).isdigit() or (intp + frac) == "":
        return None
    if len(frac) > scale:
        return None
    v = int((intp or "0") + frac.ljust(scale, "0")) if (intp + frac) else None
    if v is None:
        return None
    if neg:
        v = -v
    # device limb contract: 18 significant digits (|v| <= 1e18-1)
    if abs(v) > 10**18 - 1:
        return None
    return v
