"""The yardstick's own arithmetic: the card's published peaks and the
bytes each kernel of the build has to move, worked out from the file's
size alone (never read from the program).

Peaks: NVIDIA H100 SXM5 80 GB data sheet, HBM3 at 3.35 TB/s, at the
card's full 700 W; a run prints the card's power limit beside every
roofline share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 512  # one packed row of the structural bitmask: 16 words


def padded_bytes(n_bytes: int) -> int:
    """The build's input as the card holds it: whole 512-byte rows, a
    multiple of 512 rows, bucketed to powers of two up to 8,192 rows and
    to multiples of 8,192 rows above (the port's published pad rule)."""
    rows = max(-(-n_bytes // ROW_BYTES), 1)
    rows = -(-rows // 512) * 512
    if rows <= 8192:
        bucket = 512
        while bucket < rows:
            bucket *= 2
        return bucket * ROW_BYTES
    return -(-rows // 8192) * 8192 * ROW_BYTES


def stage1_bytes(n_bytes: int) -> int:
    """Bytes a stage-1 build (B1, or B3's pass and fold) must move: the
    padded input read once and its bitmask, one bit a byte, written once."""
    p = padded_bytes(n_bytes)
    return p + p // 8


def roofline_pct(n_bytes_moved: int, device_s: float) -> float:
    """The share of the least time the bytes take at the HBM peak in the
    measured device time, in %."""
    return 100.0 * (n_bytes_moved / HBM_BYTES_PER_S) / device_s
