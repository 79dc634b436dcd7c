"""Record/field serving over the structural index.

Host path: `seek_record`/`seek_field` replicate the reference's
RecordSource trait exactly (record_source.rs:68-147):

- record r, field f maps to index slot (r+1)*jump + f — the +1 skips the
  header row, which occupies stride slot 0;
- the value is bytes[index[slot] + 1 : index[slot+1]] — the +1 skips the
  preceding delimiter/newline; values keep leading whitespace and
  surrounding quotes (no trim/unquote/unescape, verified:
  seek_field(0, 2) on reader_test01.csv == b' "o"');
- out-of-range lookups return None: the reference's bounds check is
  `record_idx + 1 >= record_cnt` (record_source.rs:77-80, 112-118), i.e.
  record_cnt *includes* the header stride so the last data record is
  record_cnt - 2.

Device path: batched gathers — the thing the CPU reference cannot do.
`field_slices` vectorises slot arithmetic over arrays of (record, field)
pairs and `column` extracts a whole column's (start, length) pairs in one
gather, for downstream device-side decoding.

The port's own copy of csv_simd_tpu/serve.py;
it imports nothing of that package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _to_bytes(chunk) -> bytes:
    """Normalise a slice of the data buffer (bytes / memoryview / uint8
    array — the zero-copy mmap path) to bytes."""
    return chunk if isinstance(chunk, bytes) else bytes(chunk)


class RecordSourceMixin:
    """Serving methods over the getters a tape-like object provides:
    record_cnt, record_jump_size, field_cnt, index, data_bytes."""

    # -- scalar host serving (reference parity) --

    def seek_record(self, record_idx: int) -> Optional[bytes]:
        """Whole record r as raw bytes (record_source.rs:70-102)."""
        if record_idx < 0 or record_idx + 1 >= self.record_cnt:
            return None
        start_slot = (record_idx + 1) * self.record_jump_size
        mem_start = int(self.index[start_slot])
        mem_end = int(self.index[start_slot + self.field_cnt])
        return _to_bytes(self.data_bytes[mem_start + 1 : mem_end])

    def seek_field(self, record_idx: int, field_idx: int) -> Optional[bytes]:
        """Field f of record r as raw bytes (record_source.rs:104-140)."""
        if record_idx < 0 or record_idx + 1 >= self.record_cnt:
            return None
        if field_idx < 0 or field_idx >= self.field_cnt:
            return None
        slot = (record_idx + 1) * self.record_jump_size + field_idx
        mem_start = int(self.index[slot])
        mem_end = int(self.index[slot + 1])
        return _to_bytes(self.data_bytes[mem_start + 1 : mem_end])

    def seek_record_str(self, record_idx: int) -> Optional[str]:
        raw = self.seek_record(record_idx)
        return None if raw is None else raw.decode("utf-8", errors="surrogateescape")

    def seek_field_str(self, record_idx: int, field_idx: int) -> Optional[str]:
        raw = self.seek_field(record_idx, field_idx)
        return None if raw is None else raw.decode("utf-8", errors="surrogateescape")

    # -- batched serving (vectorised slot arithmetic; runs on host numpy
    #    or, with a device-resident index, as XLA gathers) --

    def field_slices(
        self, record_idx: np.ndarray, field_idx: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorised (start, end) byte ranges for (record, field) pairs.

        start is already past the leading delimiter. Callers must have
        validated 0 <= record < num_data_records and
        0 <= field < field_cnt themselves (seek_field does; an
        out-of-range field here silently reads into the adjacent
        stride slot)."""
        slots = (np.asarray(record_idx) + 1) * self.record_jump_size + np.asarray(
            field_idx
        )
        starts = self.index[slots] + 1
        ends = self.index[slots + 1]
        return starts, ends

    def column_slices(self, field_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) byte ranges of one field across every data record."""
        n = self.num_data_records
        recs = np.arange(n, dtype=np.int64)
        return self.field_slices(recs, np.full(n, field_idx, dtype=np.int64))

    def column(self, field_idx: int) -> list:
        """Materialise a whole column as a list of bytes values."""
        starts, ends = self.column_slices(field_idx)
        data = self.data_bytes
        return [_to_bytes(data[int(s) : int(e)]) for s, e in zip(starts, ends)]

    @property
    def num_data_records(self) -> int:
        """Count of servable data records (record_cnt minus the header
        stride — the reference's bound `record_idx + 1 < record_cnt`)."""
        return max(self.record_cnt - 1, 0)

    # -- iteration: the reference's Tape::as_records was `todo!()`
    #    (tape.rs:147-149) — finished here --

    def iter_records(self):
        """Yield every data record's raw bytes in order."""
        for r in range(self.num_data_records):
            yield self.seek_record(r)

    def iter_rows(self):
        """Yield every data record as a list of raw field slices."""
        for r in range(self.num_data_records):
            yield [self.seek_field(r, f) for f in range(self.field_cnt)]

    def __iter__(self):
        return self.iter_records()

    def __len__(self) -> int:
        return self.num_data_records
