"""Debug helpers — the analog of the reference's helper.rs ByteReport
(pretty-print the head and tail of a byte buffer, helper.rs:4-53) plus
mask/word visualisers for kernel debugging.

The port's own copy of csv_simd_tpu/utils/debug.py;
it imports nothing of that package.
"""

from __future__ import annotations

import numpy as np
from ..utils import as_u8


def byte_report(data: bytes | np.ndarray, head: int = 1024, tail: int = 100) -> str:
    """Printable report of the first `head` and last `tail` bytes."""
    arr = as_u8(data)
    n = arr.size

    def render(chunk: np.ndarray) -> str:
        return "".join(
            chr(b) if 0x20 <= b < 0x7F else f"\\x{b:02x}" for b in chunk
        )

    lines = [f"ByteReport: {n} bytes"]
    lines.append(f"head[{min(head, n)}]: {render(arr[:head])}")
    if n > head and tail > 0:  # arr[-0:] would render the WHOLE buffer
        lines.append(f"tail[{min(tail, n)}]: {render(arr[-tail:])}")
    return "\n".join(lines)


def mask_report(data: bytes | np.ndarray, mask: np.ndarray, width: int = 64) -> str:
    """Render bytes with a ^ under every set mask position — the visual
    check for quote-masking bugs."""
    arr = as_u8(data)
    m = np.atleast_1d(np.asarray(mask))
    # padded data is often longer than the n-byte mask: render only the
    # covered prefix rather than dying with IndexError mid-report
    n = min(arr.size, m.size)
    lines = []
    if arr.size != m.size:
        lines.append(
            f"(mask covers {m.size} of {arr.size} bytes — showing {n})"
        )
    for start in range(0, n, width):
        chunk = arr[start : start + min(width, n - start)]
        text = "".join(chr(b) if 0x20 <= b < 0x7F else "." for b in chunk)
        marks = "".join(
            "^" if m[start + i] else " " for i in range(len(chunk))
        )
        lines.append(text)
        lines.append(marks)
    return "\n".join(lines)
