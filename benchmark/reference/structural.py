"""The plain reference of the structural index and of the served fields,
in NumPy, from the file's bytes alone.

A byte is structural when it is the delimiter, LF or CR and no quote is
open before it: the quote parity is the count of quote bytes up to it,
mod 2. The index is the offset 0 followed by the structural offsets in
order. A table of `jump` slots a record (the header's field count, one
more for CRLF) serves record r's field f as the bytes from just after
index[(r + 1) * jump + f] up to index[(r + 1) * jump + f + 1], header
row excluded.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

DELIM, QUOTE, LF, CR = 0x2C, 0x22, 0x0A, 0x0D
_CHUNK = 1 << 25
_STRUCT = np.zeros(256, bool)
_STRUCT[[DELIM, LF, CR]] = True


def _chunk_index(b: np.ndarray, lo: int, parity: int,
                 quote_aware: bool) -> np.ndarray:
    s = _STRUCT[b]
    if quote_aware:
        q = b == QUOTE
        if parity or q.any():
            # a uint8 running sum keeps the parity of the quote count
            inq = (np.cumsum(q, dtype=np.uint8) + parity) & 1
            s &= inq == 0
    return np.flatnonzero(s).astype(np.int64) + lo


def structural_index(data: np.ndarray, quote_aware: bool = True,
                     chunk: int = _CHUNK, threads: int = 8) -> np.ndarray:
    """int64 [0] + offsets of the structural bytes of `data` (uint8).
    quote_aware=False counts quoted delimiters and line breaks too. The
    chunks run on `threads` threads, each starting from the parity of the
    quotes before it."""
    los = list(range(0, data.size, chunk))
    chunks = [np.asarray(data[lo: lo + chunk]) for lo in los]
    with ThreadPoolExecutor(threads) as pool:
        quotes = list(pool.map(lambda b: int(np.count_nonzero(b == QUOTE)),
                               chunks))
        starts = np.concatenate([[0], np.cumsum(quotes)[:-1]]) & 1
        parts = list(pool.map(
            lambda a: _chunk_index(a[0], a[1], int(a[2]), quote_aware),
            zip(chunks, los, starts)))
    return np.concatenate([np.zeros(1, np.int64)] + parts)


def header_layout(data: np.ndarray) -> tuple:
    """(field count, jump) from the header row: its delimiters outside
    quotes, and CRLF when LF follows the first line break."""
    end = int(np.flatnonzero((np.asarray(data[:1 << 20]) == LF)
                             | (np.asarray(data[:1 << 20]) == CR))[0])
    head = np.asarray(data[:end])
    outside = (np.cumsum(head == QUOTE) & 1) == 0
    fields = int(((head == DELIM) & outside).sum()) + 1
    crlf = data[end] == CR and end + 1 < data.size and data[end + 1] == LF
    return fields, fields + int(crlf)


def serve(data: np.ndarray, index: np.ndarray, records: np.ndarray,
          fields: np.ndarray, jump: int, n_fields: int, max_len: int):
    """The fields (records[i], fields[i]) as (bytes (n, max_len) uint8,
    zero past the field and cut at max_len; true lengths int64; valid)."""
    records = np.asarray(records, np.int64)
    fields = np.asarray(fields, np.int64)
    n_records = (index.size - 1) // jump - 1
    valid = ((records >= 0) & (records < n_records) & (fields >= 0)
             & (fields < n_fields))
    slot = np.where(valid, (records + 1) * jump + fields, 0)
    start = index[slot] + 1
    end = index[slot + 1]
    length = np.where(valid, end - start, 0)
    pos = start[:, None] + np.arange(max_len)[None, :]
    keep = np.arange(max_len)[None, :] < length[:, None]
    out = np.where(keep, np.asarray(data)[np.minimum(pos, data.size - 1)], 0)
    return out.astype(np.uint8), length, valid


def column_windows(data: np.ndarray, index: np.ndarray, field: int,
                   jump: int) -> tuple:
    """Every data record's field `field` as ((n, its widest length) uint8,
    zero past the field; lengths)."""
    n = (index.size - 1) // jump - 1
    slot = (np.arange(n, dtype=np.int64) + 1) * jump + field
    start = index[slot] + 1
    length = index[slot + 1] - start
    width = max(int(length.max()), 1) if length.size else 1
    cols = np.arange(width)[None, :]
    pos = np.minimum(start[:, None] + cols, data.size - 1)
    win = np.asarray(data)[pos]
    return np.where(cols < length[:, None], win, 0).astype(np.uint8), length
