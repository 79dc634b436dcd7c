"""Corpus API: many CSV files as one logical table
(csv_simd_tpu/corpus_api.py, the port's own copy).

In production the unit of sharding is usually a file (or file range),
not one giant buffer. `CsvCorpus` builds a tape per file (in parallel
threads — each build may itself use the device or native backend) and
exposes global record addressing over the concatenated corpus:

    corpus = CsvCorpus(paths)           # schema-checked union
    corpus.num_records                  # total data records
    corpus.seek_field(global_r, f)      # routed to the owning file
    corpus.column(f)                    # concatenated across files

Files must share a header schema (same field names after trim); the
per-file record counts form the routing table (an exclusive-sum, the
same construction as the shard offset rebasing). Each file's tape is
built, and served, on the corpus's `device` ("cuda" by default).
"""

from __future__ import annotations

import bisect
import concurrent.futures
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .api import create
from .config import DEFAULT_DIALECT, Dialect
from .device import resolve_device
from .device_tape import TypedColumnsMixin, _host
from .errors import InvalidState


class CsvCorpus:
    def __init__(
        self,
        paths: Sequence[str | os.PathLike],
        dialect: Optional[Dialect] = None,
        backend: str = "auto",
        max_workers: int = 4,
        require_same_schema: bool = True,
        validate_utf8: bool = False,
        device="cuda",
    ):
        if not paths:
            raise InvalidState("empty corpus")
        self._paths = [str(p) for p in paths]
        self.device = resolve_device(device)
        dialect = dialect or DEFAULT_DIALECT
        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
            self._tapes = list(
                ex.map(
                    lambda p: create(p, dialect=dialect, backend=backend,
                                     validate_utf8=validate_utf8,
                                     device=self.device),
                    self._paths,
                )
            )
        names0 = self._tapes[0].header_names()
        if require_same_schema:
            for p, t in zip(self._paths[1:], self._tapes[1:]):
                if list(t.header_names()) != list(names0):
                    raise InvalidState(
                        f"schema mismatch: {p} has {t.header_names()}, "
                        f"expected {names0}"
                    )
        self._names = list(names0)
        counts = np.array([t.num_data_records for t in self._tapes], np.int64)
        self._starts = np.concatenate([[0], np.cumsum(counts)])

    @property
    def num_records(self) -> int:
        return int(self._starts[-1])

    @property
    def field_cnt(self) -> int:
        return self._tapes[0].field_cnt

    def header_names(self) -> List[str]:
        return self._names

    @property
    def tapes(self):
        return self._tapes

    def _route(self, global_r: int):
        if global_r < 0 or global_r >= self.num_records:
            return None, None
        i = bisect.bisect_right(self._starts, global_r) - 1
        return i, global_r - int(self._starts[i])

    def seek_field(self, global_r: int, f: int) -> Optional[bytes]:
        i, local = self._route(global_r)
        return None if i is None else self._tapes[i].seek_field(local, f)

    def seek_record(self, global_r: int) -> Optional[bytes]:
        i, local = self._route(global_r)
        return None if i is None else self._tapes[i].seek_record(local)

    def column(self, f: int) -> list:
        out: list = []
        for t in self._tapes:
            out.extend(t.column(f))
        return out

    def owner(self, global_r: int) -> Optional[str]:
        """Which file serves this record (debug/observability)."""
        i, _ = self._route(global_r)
        return None if i is None else self._paths[i]

    def __len__(self) -> int:
        return self.num_records

    def serving_tape(self) -> "CorpusTape":
        """The corpus as ONE serving tape (TypedColumnsMixin contract):
        batched gathers route per file, everything typed/relational
        derives. Cached."""
        if getattr(self, "_serving", None) is None:
            self._serving = CorpusTape(self)
        return self._serving

    def device_tapes(self):
        """The cached per-file DeviceTapes (one upload per file per
        corpus lifetime — the per-file map-reduce paths in query.py and
        frame.py route through these, never re-uploading bytes)."""
        return self.serving_tape()._dev

    def __repr__(self) -> str:
        return (
            f"CsvCorpus(files={len(self._paths)}, records={self.num_records}, "
            f"fields={self.field_cnt})"
        )


class CorpusTape(TypedColumnsMixin):
    """A whole CsvCorpus behind the one serving-tape contract
    (`gather_fields` + record_cnt/field_cnt — see
    device_tape.TypedColumnsMixin): batched (record, field) lookups
    route each global record id to the file that owns it, gather on
    device per file, and reassemble in request order on the device.
    Joins, ORDER BY, predicate pushdown and typed columns then run over
    the corpus through exactly the code paths a single tape uses."""

    def __init__(self, corpus: CsvCorpus):
        from .device_tape import DeviceTape

        self._corpus = corpus
        self.device = corpus.device
        self._dev = [DeviceTape.from_tape(t, self.device)
                     for t in corpus.tapes]
        self._starts = corpus._starts
        self.header = corpus.tapes[0].header
        self.field_cnt = corpus.field_cnt
        self.num_data_records = corpus.num_records
        self.record_cnt = corpus.num_records + 1  # mixin convention

    def gather_fields(self, records, fields, max_len: int = 64):
        """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE
        lengths (N,) int32, valid (N,) bool) tensors on the corpus's
        device. The routing is host work on the ids; each file's gather
        runs on the device and is scattered into the output there."""
        recs = _host(records).astype(np.int64)
        flds = _host(fields).astype(np.int32)
        n = recs.shape[0]
        dev = self.device
        out = torch.zeros((n, max_len), dtype=torch.uint8, device=dev)
        lengths = torch.zeros(n, dtype=torch.int32, device=dev)
        valid = torch.zeros(n, dtype=torch.bool, device=dev)
        for i, dt in enumerate(self._dev):
            s, e = int(self._starts[i]), int(self._starts[i + 1])
            m = (recs >= s) & (recs < e)
            if not m.any():
                continue
            o, ln, v = dt.gather_fields(
                (recs[m] - s).astype(np.int32), flds[m], max_len)
            at = torch.from_numpy(np.flatnonzero(m)).to(dev)
            out[at] = o
            lengths[at] = ln
            valid[at] = v
        return out, lengths, valid

    def __repr__(self) -> str:
        return f"CorpusTape({self._corpus!r})"
