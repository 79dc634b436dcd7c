"""Tape layer: header metadata, record geometry, and work partitioning.

Reimplements the reference's tape.rs semantics exactly (see SURVEY.md §8.3,
§8.4, §8.7):

- `Header` sniffs the header row, line-ending flavour and BOM
  (tape.rs:226-273);
- `Tape` holds bytes + structural index and derives `record_jump_size`
  (field_cnt, +1 under CRLF because CRLF contributes two index slots per
  row break) and `record_cnt = (len(index)-1) // jump`, enforcing the
  uniform-stride invariant (tape.rs:315-347);
- `boundaries`/`Chunk` split the record range into near-equal jobs
  (tape.rs:385-428, 95-140) — in this framework they feed the sharded
  device build rather than a (never-built) thread pool.

The serving methods (`seek_record`/`seek_field`) live in `serve.py` and are
mixed in here; `Tape` is a host-side metadata object — the index itself may
live on device for batched gather serving.

The port's own copy of csv_simd_tpu/tape.py;
it imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np

from .errors import InvalidCsvFormat, InvalidState
from .serve import RecordSourceMixin
from .utils import as_u8

_BOM_BYTES = (0xEF, 0xBB, 0xBF)


class NewLine(enum.Enum):
    """Line-ending flavour (reference: stage1.rs:472-502). Sniffed from the
    header row, never configured (tape.rs:234-238)."""

    LF = "lf"
    CRLF = "crlf"


@dataclasses.dataclass
class Header:
    """Parsed header row (reference: tape.rs:217-277).

    Semantics replicated from Header::new (tape.rs:226-273):
    - header end = first 0x0D or 0x0A byte (quote-unaware, a known gap in
      the reference we preserve for parity);
    - CRLF iff the byte *after* that terminator is 0x0A (tape.rs:235-238);
    - leading bytes drawn from {EF,BB,BF} are skipped as a BOM in any
      order/multiplicity, faithfully to the reference's take_while
      (tape.rs:241-249);
    - names split on the delimiter and trimmed (tape.rs:258-262). The
      reference hardcodes "," here even though `delimiter` is a field; we
      split on the configured delimiter (identical for the default dialect).

    OPT-IN (quote_aware=True / Dialect(header_quotes=True)): the header
    ends at the first newline OUTSIDE quotes, names split on unquoted
    delimiters, and a trimmed name wrapped in quotes is unquoted with
    RFC-4180 `""` unescaping — quoted header names may then contain
    delimiters and newlines. Default stays the reference's raw split.
    The structural INDEX was always quote-aware (the header row's quoted
    delimiters are masked like any row's), so the uniform stride already
    matches the quote-aware field count.
    """

    names: List[str]
    new_line: NewLine
    field_cnt: int
    delimiter: int
    record_offset: int  # byte offset of the header-terminating newline

    @classmethod
    def parse(cls, data, delimiter: int = 0x2C,
              quote_aware: bool = False, quote: int = 0x22) -> "Header":
        arr = as_u8(data)
        n = arr.size
        # find the first \r/\n without scanning the whole (possibly GiB)
        # buffer: widen the probe window geometrically
        end = n
        probe = 64 * 1024
        excl = None  # quote parity BEFORE each byte (quote-aware mode)
        while True:
            head = arr[: min(probe, n)]
            nl = (head == 0x0D) | (head == 0x0A)
            if quote_aware:
                incl = np.bitwise_xor.accumulate(
                    (head == quote).astype(np.uint8))
                excl = np.concatenate([np.zeros(1, np.uint8), incl[:-1]])
                nl = nl & (excl == 0)
            hits = np.flatnonzero(nl)
            if hits.size:
                end = int(hits[0])
                break
            if probe >= n:
                break
            probe *= 16
        # Reference reads data[end + 1] unconditionally (panics at EOF);
        # we treat truncation as LF.
        new_line = (
            NewLine.CRLF if end + 1 < n and arr[end + 1] == 0x0A else NewLine.LF
        )
        start = 0
        while start < n and arr[start] in _BOM_BYTES:
            start += 1
        if not quote_aware:
            raw = bytes(arr[start:end]).decode(
                "utf-8", errors="surrogateescape")
            names = [name.strip() for name in raw.split(chr(delimiter))]
        else:
            seg = arr[start:end]
            pq = (excl[start:end] == 0) if excl is not None \
                else np.ones(end - start, bool)
            cuts = np.flatnonzero((seg == delimiter) & pq).tolist()
            qc, qq = chr(quote), chr(quote) * 2
            names = []
            prev = 0
            for cut in cuts + [end - start]:
                name = bytes(seg[prev:cut]).decode(
                    "utf-8", errors="surrogateescape").strip()
                if len(name) >= 2 and name[0] == name[-1] == qc:
                    name = name[1:-1].replace(qq, qc)
                names.append(name)
                prev = cut + 1
        return cls(
            names=names,
            new_line=new_line,
            field_cnt=len(names),
            delimiter=delimiter,
            record_offset=end,
        )


@dataclasses.dataclass(frozen=True)
class Boundary:
    """Zero-indexed [start, start+len) job boundary (tape.rs:281-284)."""

    start: int
    len: int


def boundaries(task_size: int, job_count: int) -> Optional[List[Boundary]]:
    """Divide `task_size` units into `job_count` near-equal jobs.

    Matches the reference contract (tape.rs:385-428 incl. its doctest):
    returns None when either input is 0; returns a single all-covering job
    when task_size < job_count; otherwise the first `task_size % job_count`
    jobs carry one extra unit.
    """
    if task_size == 0 or job_count == 0:
        return None
    if task_size < job_count:
        return [Boundary(start=0, len=task_size)]
    job_size, remainder = divmod(task_size, job_count)
    out: List[Boundary] = []
    acc = 0
    for i in range(job_count):
        extra = 1 if i < remainder else 0
        out.append(Boundary(start=acc, len=job_size + extra))
        acc += job_size + extra
    return out


@dataclasses.dataclass
class Chunk:
    """A record-range slice of the tape for parallel work (tape.rs:13-40).

    `start`/`end` are *index-slot* positions (record boundaries scaled by
    the record jump size), exactly as Tape::chunks computes them."""

    id: int
    start: int
    end: int
    record_cnt: int


class Tape(RecordSourceMixin):
    """The sealed public tape: bytes + structural index + record geometry
    (reference: tape.rs:74-153, init at tape.rs:315-347)."""

    def __init__(self, data, index: np.ndarray, header: Header):
        # data: bytes or a uint8 array/memoryview (zero-copy mmap view)
        self._data = data
        self._index = np.asarray(index)
        self._header = header
        if header.new_line is NewLine.CRLF:
            self._jump = header.field_cnt + 1
        else:
            self._jump = header.field_cnt
        if self._jump == 0:
            raise InvalidState("zero fields in header")
        n_struct = len(self._index) - 1  # drop the 0 sentinel
        self._record_cnt, problem = divmod(n_struct, self._jump)
        if problem != 0:
            detail = self._diagnose_ragged()
            raise InvalidCsvFormat(
                f"non-uniform record stride: {n_struct} structural entries "
                f"not divisible by jump {self._jump}{detail}"
            )

    def _diagnose_ragged(self) -> str:
        """Locate the first row whose field count deviates — better than
        the reference's bare InvalidCsvFormat (tape.rs:342-344). Walks
        newline entries in the index and counts delimiters between them."""
        data = (
            np.frombuffer(self._data, dtype=np.uint8)
            if isinstance(self._data, (bytes, bytearray, memoryview))
            else np.asarray(self._data, dtype=np.uint8)
        )
        offs = self._index[1:]
        if offs.size == 0:
            return ""
        kinds = data[offs]  # byte at each structural offset
        is_nl = (kinds == 0x0A) | (kinds == 0x0D)
        row_no = 0
        fields = 1
        prev_was_cr = False
        for off, nl in zip(offs, is_nl):
            if nl:
                if prev_was_cr and data[off] == 0x0A:
                    prev_was_cr = False
                    continue  # LF of a CRLF pair, same row break
                prev_was_cr = data[off] == 0x0D
                if fields != self._header.field_cnt:
                    return (
                        f" (row {row_no} has {fields} fields, "
                        f"expected {self._header.field_cnt}, "
                        f"row ends at byte {int(off)})"
                    )
                row_no += 1
                fields = 1
            else:
                prev_was_cr = False
                fields += 1
        if fields != 1:
            return f" (unterminated final row {row_no} with {fields} fields)"
        return ""

    # -- RecordSource required getters (record_source.rs:141-146) --
    @property
    def record_cnt(self) -> int:
        return self._record_cnt

    @property
    def record_jump_size(self) -> int:
        return self._jump

    @property
    def field_cnt(self) -> int:
        return self._header.field_cnt

    @property
    def new_line(self) -> NewLine:
        return self._header.new_line

    @property
    def index(self) -> np.ndarray:
        return self._index

    @property
    def data_bytes(self) -> bytes:
        return self._data

    @property
    def header(self) -> Header:
        return self._header

    def header_names(self) -> Sequence[str]:
        return self._header.names

    def chunks(self, num: int) -> List[Chunk]:
        """Split records into `num` jobs (tape.rs:95-140): boundary jobs
        scaled by jump, with chunk 0 rebased past the header row."""
        bounds = boundaries(self._record_cnt, num)
        if bounds is None:
            raise InvalidState("cannot chunk an empty tape")
        chunks = [
            Chunk(
                id=i,
                start=b.start * self._jump,
                end=(b.start + b.len) * self._jump,
                record_cnt=b.len,
            )
            for i, b in enumerate(bounds)
        ]
        chunks[0] = Chunk(
            id=chunks[0].id,
            start=self._jump,
            end=chunks[0].end,
            record_cnt=chunks[0].record_cnt - 1,
        )
        return chunks

    def __repr__(self) -> str:
        return (
            f"Tape(records={self._record_cnt}, fields={self.field_cnt}, "
            f"jump={self._jump}, newline={self.new_line.value}, "
            f"index_len={len(self._index)}, bytes={len(self._data)})"
        )
