"""A CSV that runs past a given byte with a quoted field straddling it,
and the checks of a PackedDeviceTape built from it against a plain NumPy
reckoning of its structural bytes. Shared by the card test of a tape past
2**31 bytes (tests/test_torch_gpu.py), its rehearsal at a small size on
the CPU (tests/test_torch_wide_tape.py) and chip_smoke.py. NumPy and torch
only: no JAX."""

import numpy as np
import torch

HEAD = b"id,q,v\n"
BLOCK_ROWS = 4096
FIELDS = 3
_QUOTE, _COMMA, _LF = 0x22, 0x2C, 0x0A


def block() -> bytes:
    """4,096 rows of three fields: an id, a quoted field that holds a
    comma, a line break and doubled quotes, and 7 x the id."""
    return b"".join(b'%d,"r%d, ""q""\n%s",%d\n' % (i, i, b"x" * (i % 23), 7 * i)
                    for i in range(BLOCK_ROWS))


class PastCsv:
    """HEAD, whole blocks up to a little before byte `at`, one row whose
    quoted field (commas, line breaks and doubled quotes, 5 bytes a
    repeat) runs from before `at` to at least 4 KiB past it, then
    `tail_blocks` blocks. Every row has three structural bytes, so record
    r's field f ends at the k-th of them, k = (r + 1) * 3 + f."""

    def __init__(self, at: int, tail_blocks: int = 2):
        blk = np.frombuffer(block(), np.uint8)
        self.n_blocks = max((at - len(HEAD) - 8192) // blk.size, 1)
        pre = len(HEAD) + self.n_blocks * blk.size
        straddler = (b'-1,"' + b',\n"" ' * ((max(at - pre, 0) + 4096) // 5 + 1)
                     + b'",-7\n')
        total = pre + len(straddler) + tail_blocks * blk.size
        data = np.empty(total, np.uint8)
        data[:len(HEAD)] = np.frombuffer(HEAD, np.uint8)
        data[len(HEAD):pre].reshape(self.n_blocks, blk.size)[:] = blk
        mid = pre + len(straddler)
        data[pre:mid] = np.frombuffer(straddler, np.uint8)
        data[mid:].reshape(tail_blocks, blk.size)[:] = blk
        self.data = data
        self.at = at
        self.straddle = (pre, mid)
        self.n_records = (self.n_blocks + tail_blocks) * BLOCK_ROWS + 1
        # the window the reference reckons: from the last whole block
        # before the straddler (a row start, outside quotes) to the end
        self.lo = pre - blk.size
        self.first = (self.n_blocks - 1) * BLOCK_ROWS

    def ends(self) -> np.ndarray:
        """(records of the window, 3) int64: the byte offsets of each
        record's three structural bytes, from the window's quote parity."""
        w = self.data[self.lo:]
        inside = (np.cumsum(w == _QUOTE) & 1).astype(bool)
        hits = np.flatnonzero(((w == _COMMA) | (w == _LF)) & ~inside)
        return (hits.astype(np.int64) + self.lo).reshape(-1, FIELDS)

    def records(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Record ids of the window: its first and last, the straddler and
        its neighbours, and n drawn at random."""
        last = self.n_records - 1
        s = self.n_blocks * BLOCK_ROWS
        fixed = [self.first, self.first + 1, s - 1, s, s + 1, last - 1, last]
        return np.unique(np.concatenate([
            fixed, rng.integers(self.first, last + 1, n)])).astype(np.int32)


def check_tape(tape, case: PastCsv, records: np.ndarray,
               max_len: int = 64) -> int:
    """Hold the tape's geometry, rank-select answers, served fields and
    two typed columns for `records` (ids of the window) against the
    reckoning; returns the largest byte position checked."""
    from csv_simd_tpu_torch.offsetfree import _kth_positions

    ends = case.ends()
    assert tape.num_data_records == case.n_records
    assert tape.field_cnt == tape.jump == FIELDS
    local = records.astype(np.int64) - case.first
    want_end = ends[local]  # (n, 3)
    prev_lf = np.where(local > 0, ends[np.maximum(local - 1, 0), 2],
                       case.lo - 1)
    want_start = np.concatenate([prev_lf[:, None], want_end[:, :2]], 1) + 1

    ks = ((records.astype(np.int64)[:, None] + 1) * FIELDS
          + np.arange(FIELDS)[None, :]).reshape(-1)
    pos = _kth_positions(tape.words, tape.cum_incl,
                         torch.from_numpy(ks.astype(np.int32)).to(
                             tape.device))
    wide = tape.words.numel() * 32 >= 2**31
    assert pos.dtype == (torch.int64 if wide else torch.int32)
    assert np.array_equal(pos.cpu().numpy().astype(np.int64),
                          want_end.reshape(-1))

    recs = np.repeat(records, FIELDS)
    fields = np.tile(np.arange(FIELDS, dtype=np.int32), records.size)
    out, lengths, valid = tape.gather_fields(recs, fields, max_len)
    out, lengths, valid = (out.cpu().numpy(), lengths.cpu().numpy(),
                           valid.cpu().numpy())
    assert lengths.dtype == np.int32 and valid.all()
    starts, stops = want_start.reshape(-1), want_end.reshape(-1)
    assert np.array_equal(lengths, stops - starts)
    cols = np.arange(max_len)[None, :]
    keep = cols < (stops - starts)[:, None]
    want = np.where(keep, case.data[np.minimum(starts[:, None] + cols,
                                               case.data.size - 1)], 0)
    assert np.array_equal(out, want)

    for field, scale in ((0, 1), (2, 7)):
        vals, ok = tape.column_int32(field, records=records)
        ids = np.array([int(bytes(case.data[a:b]))
                        for a, b in zip(want_start[:, 0], want_end[:, 0])])
        assert ok.cpu().numpy().all()
        assert np.array_equal(vals.cpu().numpy(), ids * scale)
    return int(want_end.max())
