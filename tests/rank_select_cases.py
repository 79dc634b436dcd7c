"""Packed words that stress rank-select, shared by the CPU tests of the
plain `offsetfree._kth_positions` and the card's tests of the kernel
(it imports no JAX).

Each case is (rows, 16) int32 words, bit m of word w covering byte
32 w + m, with rows a multiple of 8 so that both the narrow (rows, 16)
and the wide (rows/8, 128) layout hold them. `ranks` gives the k a test
asks for, and `brute_positions` the answer from the unpacked bits."""

from __future__ import annotations

import numpy as np

ROWS = 64
CASES = ("empty_rows", "full_rows", "last_bits", "sparse", "random")
RANKS = ("sorted", "shuffled", "row_bounds", "one", "none")


def words_for(case: str, rows: int = ROWS, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    full = rng.integers(-2**31, 2**31, (rows, 16), dtype=np.int64)
    w = full.astype(np.int32)
    if case == "empty_rows":
        # runs of empty rows, the first and the last among them
        w[rng.random(rows) < 0.5] = 0
        w[:3] = 0
        w[-2:] = 0
    elif case == "full_rows":
        # rows of 512 set bits between empty and random rows
        pick = rng.random(rows)
        w[pick < 0.4] = -1
        w[(pick >= 0.4) & (pick < 0.6)] = 0
        w[0] = w[-1] = -1
    elif case == "last_bits":
        # only bit 31 of a word: the last bit of each word, and in some
        # rows only the row's last bit
        w[:] = np.int32(-2**31)
        only_last = rng.random(rows) < 0.3
        w[only_last, :15] = 0
        w[rng.random((rows, 16)) < 0.2] = 0
    elif case == "sparse":
        # one set bit in a row, at any of its 512 places, or none
        w[:] = 0
        bit = rng.integers(0, 512, rows)
        hit = rng.random(rows) < 0.7
        w[hit, bit[hit] // 32] = (np.uint32(1) << (bit[hit] % 32).astype(
            np.uint32)).view(np.int32)
    elif case != "random":
        raise ValueError(case)
    return np.ascontiguousarray(w)


def brute_positions(words: np.ndarray) -> np.ndarray:
    """The flat positions of every set bit, in order."""
    bits = np.unpackbits(np.ascontiguousarray(words).reshape(-1)
                         .view("<u4").view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int64)


def ranks(kind: str, words: np.ndarray, seed: int = 0) -> np.ndarray:
    """The int32 k of one kind, all inside [0, total)."""
    rng = np.random.default_rng(seed)
    counts = np.unpackbits(words.reshape(len(words), -1).view(np.uint8),
                           axis=1).sum(axis=1, dtype=np.int64)
    cum = np.cumsum(counts)
    total = int(cum[-1]) if cum.size else 0
    if kind == "sorted":
        k = np.arange(total)
    elif kind == "shuffled":
        k = rng.permutation(total)
    elif kind == "row_bounds":
        # the first and the last bit of every row: k at each row boundary
        k = np.unique(np.r_[cum - counts, cum - 1])
        k = k[(k >= 0) & (k < total)]
    elif kind == "one":
        k = np.array([total - 1 if total else 0])[: min(total, 1)]
    elif kind == "none":
        k = np.zeros(0)
    else:
        raise ValueError(kind)
    return k.astype(np.int32)
