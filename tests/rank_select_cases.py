"""Packed words that stress rank-select, shared by the CPU tests of the
plain `offsetfree._kth_positions` and `offsetfree._serve_plain` and the
card's tests of their kernels (it imports no JAX).

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


# -- the packed tape's serve on these words --------------------------------

MAX_LENS = (1, 8, 17, 32, 64, 320)
STRIDES = ((3, 3), (4, 3))  # (jump, field_cnt): LF and CRLF records


def serve_case(words: np.ndarray, jump: int, field_cnt: int, n: int,
               seed: int = 0, cut: bool = False) -> tuple:
    """A serve on `words`: (bytes, record_cnt, records, fields). The
    bytes hold a comma at every set bit and a letter elsewhere, through
    the last set bit only where `cut` (so that reads clamp at their end).
    The queries: n valid ones at random, every field of the first and of
    the last valid record, the longest field, the last record
    (record_cnt - 1, invalid), negative records, fields below 0 and at
    field_cnt, and the int32 extremes."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(np.ascontiguousarray(words).reshape(-1)
                         .view("<u4").view(np.uint8), bitorder="little")
    data = rng.integers(ord("a"), ord("z") + 1, bits.size).astype(np.uint8)
    data[bits == 1] = ord(",")
    hits = np.flatnonzero(bits)
    if cut:
        data = data[: int(hits[-1]) + 1 if hits.size else 1]
    record_cnt = hits.size // jump
    last = max(record_cnt - 2, 0)
    # the longest valid field
    slots = ((np.arange(last + 1)[:, None] + 1) * jump
             + np.arange(field_cnt)[None, :])
    longest = np.unravel_index(np.argmax(hits[slots] - hits[slots - 1]),
                               slots.shape)
    recs = np.r_[rng.integers(0, last + 1, n), [0] * field_cnt,
                 [last] * field_cnt, longest[0], [record_cnt - 1] * 2, -1,
                 -7, 0, 0, 0, -2**31, 2**31 - 2]
    flds = np.r_[rng.integers(0, field_cnt, n), np.arange(field_cnt),
                 np.arange(field_cnt), longest[1], 0, field_cnt - 1, 0, 1,
                 -1, field_cnt, 2**31 - 1, 0, 0]
    return (data, record_cnt, recs.astype(np.int32), flds.astype(np.int32))


def serve_reckoning(data: np.ndarray, words: np.ndarray, records, fields,
                    jump: int, field_cnt: int, record_cnt: int,
                    max_len: int) -> tuple:
    """(bytes (N, max_len) uint8, lengths (N,) int32, valid (N,) bool) of
    the queries from the unpacked bits: a valid query's field runs from
    the set bit of rank slot - 1, plus one, to that of rank slot, slot =
    (record + 1) * jump + field."""
    records = np.asarray(records, np.int64)
    fields = np.asarray(fields, np.int64)
    valid = ((records >= 0) & (records + 1 < record_cnt) & (fields >= 0)
             & (fields < field_cnt))
    slots = np.where(valid, (records + 1) * jump + fields, 1)
    where = brute_positions(words)
    starts = np.where(valid, where[slots - 1] + 1, 0)
    ends = np.where(valid, where[np.minimum(slots, where.size - 1)], 0)
    lengths = (ends - starts).astype(np.int32)
    cols = np.arange(max_len)[None, :]
    keep = cols < lengths[:, None]
    at = np.minimum(starts[:, None] + cols, data.size - 1)
    out = np.where(keep, data[at], 0).astype(np.uint8)
    return out, lengths, valid
