"""JSON structural indexing — the reference's json_test.rs experiment
(a replication of Lemire's JSON nibble-LUT classify on one 16-byte
fixture, never called from the live path) done for real.

Demonstrates that the framework's stage-1 machinery generalizes beyond
CSV: JSON needs (a) a bigger byte-class set ({ } [ ] : , whitespace "
\\), and (b) escape-aware string masking — a `\"` inside a string must
not toggle quote parity, which CSV's `\"\"` convention never needed.
Escapes are resolved with the simdjson odd-backslash-run trick before
the prefix-XOR string mask.

This module is the *golden* (exact, arbitrary-precision bitmask)
formulation: masks are Python ints, prefix-XOR is log-step shift-doubling.
It is the oracle the device JSON stage-1 (json_device.py, kernel J1 on a
card) is tested against, as golden.py anchors the CSV kernels.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from ..utils import as_u8

JSON_STRUCTURAL = frozenset(b'{}[]:,')
JSON_WS = frozenset(b" \t\n\r")
OPEN = frozenset(b"{[")
CLOSE = frozenset(b"}]")


def _mask_of(data: np.ndarray, byteset) -> int:
    """Bitmask int: bit i set iff data[i] in byteset (bit i = byte i)."""
    hits = np.isin(data, np.frombuffer(bytes(byteset), dtype=np.uint8))
    packed = np.packbits(hits.astype(np.uint8), bitorder="little")
    return int.from_bytes(packed.tobytes(), "little")


def _prefix_xor(x: int, n: int) -> int:
    """Inclusive prefix XOR over n bits (log-step doubling)."""
    shift = 1
    mask = (1 << n) - 1
    while shift < n:
        x ^= (x << shift) & mask
        shift *= 2
    return x


def _escaped_positions(bs: int, n: int) -> int:
    """Positions escaped by an odd-length backslash run immediately before
    them (the simdjson stage-1 construction)."""
    if bs == 0:
        return 0
    mask = (1 << n) - 1
    even_bits = int.from_bytes(b"\x55" * ((n + 7) // 8), "little") & mask
    odd_bits = even_bits << 1 & mask
    starts = bs & ~(bs << 1)
    even_starts = starts & even_bits
    odd_starts = starts & odd_bits
    even_carries = (bs + even_starts) & ~bs
    odd_carries = (bs + odd_starts) & ~bs
    # a run starting on an even bit escapes the char after an odd-length
    # prefix -> carry lands on an odd bit, and vice versa
    escaped = (even_carries & odd_bits) | (odd_carries & even_bits)
    return escaped & mask


def json_string_mask(data: bytes | np.ndarray) -> int:
    """Bitmask of positions inside JSON strings (opening quote included,
    closing excluded — clmul semantics), escape-aware."""
    arr = as_u8(data)
    n = arr.size
    if n == 0:
        return 0
    bs = _mask_of(arr, b"\\")
    quotes = _mask_of(arr, b'"') & ~_escaped_positions(bs, n)
    return _prefix_xor(quotes, n)


def json_structural_index(data: bytes | np.ndarray) -> np.ndarray:
    """Offsets of JSON structural characters outside strings."""
    arr = as_u8(data)
    n = arr.size
    struct = _mask_of(arr, JSON_STRUCTURAL)
    outside = struct & ~json_string_mask(arr)
    packed = np.frombuffer(
        outside.to_bytes((n + 7) // 8 or 1, "little"), dtype=np.uint8
    )
    bits = np.unpackbits(packed, bitorder="little")[:n]
    return np.flatnonzero(bits).astype(np.int64)


def level_sets(data: bytes | np.ndarray) -> List[Tuple[int, int]]:
    """(offset, depth) per structural char: the nesting 'level set' the
    reference's experiment was named for. Depth is the container depth
    AT the character ({ at depth d opens level d+1; } closes back to d)."""
    arr = as_u8(data)
    offsets = json_structural_index(arr)
    out = []
    depth = 0
    for off in offsets:
        b = arr[off]
        if b in OPEN:
            out.append((int(off), depth))
            depth += 1
        elif b in CLOSE:
            depth -= 1
            out.append((int(off), depth))
        else:
            out.append((int(off), depth))
    return out
