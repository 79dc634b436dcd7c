"""The cells' closed loops, one kind a traffic file names in "loop":

    ingest   a step builds a tape from the file ("tape": "packed" is
             create_packed; "offsets" is create, then DeviceTape.from_tape;
             "streaming" is create_streaming in the traffic's
             "chunk_bytes", then DeviceTape.from_tape), serves one batch
             of records x every field through gather_fields and copies it
             to the host; the last tape is dropped before the next build
    lookup   the tape is built in set-up; a step serves one batch of
             records x every field, keys from benchmark/traffic.py
    sql      the tape is built in set-up; a step runs the traffic's
             statements in turn through csv_simd_tpu_torch.sql.sql

Every build passes the traffic's "validate_utf8" to the program. Where
it is true, set-up first builds once from the file itself with one byte,
drawn from the seed in the file's last quarter, set to 0xFF in place,
records whether the program refused it, and puts the byte back.

Each loop keeps what its steps produced for the check after the window:
the served batches (all of an ingest window's, a seeded sample of a
lookup window's), the index's record count and the positions of sampled
records, every statement's result, and the planted build's refusal.
`outputs()` hands them over as host arrays and frees the program's state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic
from .reference.structural import CR, DELIM, LF, QUOTE

_SAMPLE_RECORDS = 4096  # records whose index positions are checked
_BLOCK = 1 << 26  # bytes a pass over the file reads at once


def _span(name: str):
    return torch.profiler.record_function(name)


def _sample_records(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.choice(n, min(_SAMPLE_RECORDS, n), replace=False)


def plant_offset(data: np.ndarray, seed: int) -> int:
    """The byte that a validated build's set-up sets to 0xFF: the first
    byte of the first field (inside its quotes, if quoted) of the first
    record with a non-empty first field that starts at or after a point
    drawn from `seed` in the file's last quarter (its first eighth).
    `data` is the whole file, a memmap will do. Only a field byte
    changes, so the planted file's structure is the file's and its one
    fault is its UTF-8."""
    n = data.size
    rng = np.random.default_rng((seed % (1 << 64), 0xFF))
    start = int(rng.integers(n * 3 // 4, max(n * 7 // 8, n * 3 // 4 + 1)))
    quotes = 0
    for i in range(0, start, _BLOCK):
        quotes += int(np.count_nonzero(
            np.asarray(data[i:min(i + _BLOCK, start)]) == QUOTE))
    tail = np.asarray(data[start:start + (1 << 20)])
    ends = np.flatnonzero((tail == LF)
                          & (((np.cumsum(tail == QUOTE) + quotes) & 1) == 0))
    for e in ends.tolist():
        at = start + e + 1
        at += int(at < n and data[at] == QUOTE)
        if at < n and data[at] not in (DELIM, QUOTE, LF, CR):
            return at
    raise ValueError(f"no record with a non-empty first field within "
                     f"{tail.size} bytes of byte {start}")


class _Tapes:
    """Builds the traffic's tape from the file, with the traffic's
    "validate_utf8"; with it true, `utf8_refused` records whether the
    program refused the file with its planted byte."""

    def __init__(self, ctx):
        wl = ctx.workload
        kind = wl["tape"]
        if kind not in ("packed", "offsets", "streaming"):
            raise ValueError(f"unknown tape {kind!r}")
        self.validate = wl["validate_utf8"]
        if not isinstance(self.validate, bool):
            raise ValueError(f"validate_utf8 {self.validate!r}: true or false")
        if kind == "streaming" and self.validate:
            raise ValueError(
                '"tape": "streaming" with "validate_utf8": true: '
                "create_streaming takes no validate_utf8")
        self.chunk_bytes = (int(wl["chunk_bytes"]) if kind == "streaming"
                            else None)
        self.kind, self.path, self.device = kind, ctx.path, ctx.device
        self.host = None  # the host Tape of the offsets and streaming routes
        self.utf8_refused = (self._refuses_planted(ctx.seed) if self.validate
                             else None)

    def build(self):
        import csv_simd_tpu_torch as prog

        path = self.path
        if self.kind == "packed":
            with _span("build.create_packed"):
                return prog.create_packed(path, validate_utf8=self.validate,
                                          device=self.device)
        from csv_simd_tpu_torch.device_tape import DeviceTape

        if self.kind == "streaming":
            with _span("build.create_streaming"):
                self.host = prog.create_streaming(
                    path, chunk_bytes=self.chunk_bytes, device=self.device)
        else:
            with _span("build.create"):
                self.host = prog.create(path, validate_utf8=self.validate,
                                        device=self.device)
        with _span("build.from_tape"):
            return DeviceTape.from_tape(self.host, device=self.device)

    def _refuses_planted(self, seed: int) -> bool:
        """Build once, through the timed path at the timed size, from the
        file with the byte at plant_offset set to 0xFF: whether the
        program raised InvalidCsvFormat. The byte is put back after."""
        from csv_simd_tpu_torch import InvalidCsvFormat

        at = plant_offset(np.memmap(self.path, dtype=np.uint8, mode="r"),
                          seed)
        with open(self.path, "r+b") as f:
            f.seek(at)
            was = f.read(1)
            f.seek(at)
            f.write(b"\xff")
        try:
            self.build()
        except InvalidCsvFormat:
            return True
        finally:
            self.host = None
            with open(self.path, "r+b") as f:
                f.seek(at)
                f.write(was)
        return False


def index_view(tape, host_tape, records: np.ndarray) -> dict:
    """The index as the program holds it: its data record and field counts
    and the structural positions of every slot of `records` (the index's entry
    (r + 1) * jump + f, f = 0..jump, the leading 0 counted)."""
    jump = int(tape.jump)
    slots = ((records.astype(np.int64)[:, None] + 1) * jump
             + np.arange(jump + 1)[None, :]).reshape(-1)
    if hasattr(tape, "index"):
        pos = tape.index[torch.from_numpy(slots).to(tape.device)]
        n = int(tape.record_cnt) - 1
    else:
        from csv_simd_tpu_torch.offsetfree import _kth_positions

        ks = torch.from_numpy(slots - 1).to(device=tape.device,
                                            dtype=torch.int32)
        pos = _kth_positions(tape.words, tape.cum_incl, ks)
        n = int(tape.num_data_records)
    out = {"n_records": n, "n_fields": int(tape.field_cnt), "jump": jump,
           "slots": slots,
           "positions": pos.cpu().numpy().astype(np.int64)}
    if host_tape is not None:
        out["full_index"] = np.asarray(host_tape.index)
        out["full_n_records"] = int(host_tape.record_cnt) - 1
    return out


class _Serving:
    """Batches of records x every field: keys on the device, answers
    copied to the host. Each call serves the pool's next batch, so the
    window's first batch is not one that set-up served."""

    def __init__(self, ctx, n_fields: int, pool_batches: int):
        wl = ctx.workload
        self.batch = int(wl["batch_records"])
        self.max_len = int(wl["max_len"])
        self.n_fields = n_fields
        self.pool = traffic.keys(wl["keys"], ctx.n_records,
                                 pool_batches * self.batch, ctx.traffic_gen,
                                 ctx.device).view(pool_batches, self.batch)
        self.fields = torch.arange(n_fields, dtype=torch.int32,
                                   device=ctx.device).repeat(self.batch)
        self.kept = []  # (records, bytes, lengths, valid) on the host
        self.calls = 0

    def serve(self, tape, keep: bool) -> int:
        recs = self.pool[self.calls % self.pool.shape[0]]
        self.calls += 1
        with _span("serve.gather_fields"):
            out, lengths, valid = tape.gather_fields(
                recs.repeat_interleave(self.n_fields), self.fields,
                self.max_len)
        with _span("serve.to_host"):
            host = (out.cpu().numpy(), lengths.cpu().numpy(),
                    valid.cpu().numpy())
        if keep:
            self.kept.append((recs.cpu().numpy(),) + host)
        return self.batch * self.n_fields


class _ServingLoop:
    def outputs(self, rng: np.random.Generator) -> dict:
        recs = _sample_records(rng, self.ctx.n_records)
        out = {"served": self.serving.kept,
               "index": index_view(self.tape, self.tapes.host, recs),
               "utf8_refused": self.tapes.utf8_refused}
        self.tape = self.tapes.host = None
        return out


class IngestLoop(_ServingLoop):
    def __init__(self, ctx):
        self.ctx = ctx
        self.tapes = _Tapes(ctx)
        self.serving = _Serving(ctx, ctx.n_fields, 1024)
        self.tape = None

    def step(self, i: int, keep: bool = True) -> float:
        self.tape = None
        self.tape = self.tapes.build()
        self.serving.serve(self.tape, keep)
        return float(self.ctx.n_bytes)


class LookupLoop(_ServingLoop):
    def __init__(self, ctx):
        self.ctx = ctx
        wl = ctx.workload
        self.tapes = _Tapes(ctx)
        self.tape = self.tapes.build()
        self.serving = _Serving(ctx, ctx.n_fields, int(wl["pool_batches"]))
        # the window's first batch and a seeded share of the others are
        # kept for the check
        self.keep = np.random.default_rng(ctx.seed % (1 << 64)).random(
            1 << 20) < float(wl["check_share"])

    def step(self, i: int, keep: bool = True) -> float:
        keep = keep and (i == 0 or bool(self.keep[i % self.keep.size]))
        return float(self.serving.serve(self.tape, keep))


class SqlLoop:
    """A step is one round of the traffic's statements in order, so every
    step holds the same mix of work."""

    def __init__(self, ctx):
        self.ctx = ctx
        wl = ctx.workload
        self.tapes = _Tapes(ctx)
        self.tape = self.tapes.build()
        self.tapes.host = None
        self.statements = wl["statements"]
        self.results = []  # (statement name, {column: host array})

    def step(self, i: int, keep: bool = True) -> float:
        from csv_simd_tpu_torch.sql import sql

        for st in self.statements:
            with _span(f"sql.{st['name']}"):
                res = sql(st["sql"], self.tape,
                          schema=self.ctx.workload["schema"],
                          device=self.ctx.device)
            if keep:
                self.results.append(
                    (st["name"], {k: np.asarray(res[k]) for k in res.keys()}))
        return float(len(self.statements))

    def outputs(self, rng: np.random.Generator) -> dict:
        self.tape = None
        return {"results": self.results,
                "utf8_refused": self.tapes.utf8_refused}


LOOPS = {"ingest": IngestLoop, "lookup": LookupLoop, "sql": SqlLoop}
