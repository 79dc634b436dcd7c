"""The cells' closed loops, one kind a traffic file names in "loop":

    ingest   a step builds a tape from the file ("tape": "packed" is
             create_packed; "offsets" is create, then DeviceTape.from_tape),
             serves one batch of records x every field through
             gather_fields and copies it to the host; the last tape is
             dropped before the next build
    lookup   the tape is built in set-up; a step serves one batch of
             records x every field, keys from benchmark/traffic.py
    sql      the tape is built in set-up; a step runs the traffic's
             statements in turn through csv_simd_tpu_torch.sql.sql

Each loop keeps what its steps produced for the check after the window:
the served batches (all of an ingest window's, a seeded sample of a
lookup window's), the index's record count and the positions of sampled
records, and every statement's result. `outputs()` hands them over as
host arrays and frees the program's state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic

_SAMPLE_RECORDS = 4096  # records whose index positions are checked


def _span(name: str):
    return torch.profiler.record_function(name)


def _sample_records(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.choice(n, min(_SAMPLE_RECORDS, n), replace=False)


class _Tapes:
    """Builds the traffic's tape from the file."""

    def __init__(self, kind: str, path: str, device):
        if kind not in ("packed", "offsets"):
            raise ValueError(f"unknown tape {kind!r}")
        self.kind, self.path, self.device = kind, path, device
        self.host = None  # the host Tape of the offsets route

    def build(self):
        import csv_simd_tpu_torch as prog

        if self.kind == "packed":
            with _span("build.create_packed"):
                return prog.create_packed(self.path, device=self.device)
        from csv_simd_tpu_torch.device_tape import DeviceTape

        with _span("build.create"):
            self.host = prog.create(self.path, device=self.device)
        with _span("build.from_tape"):
            return DeviceTape.from_tape(self.host, device=self.device)


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
    copied to the host."""

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

    def serve(self, tape, i: int, keep: bool) -> int:
        recs = self.pool[i % self.pool.shape[0]]
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
               "index": index_view(self.tape, self.tapes.host, recs)}
        self.tape = self.tapes.host = None
        return out


class IngestLoop(_ServingLoop):
    def __init__(self, ctx):
        self.ctx = ctx
        self.tapes = _Tapes(ctx.workload["tape"], ctx.path, ctx.device)
        self.serving = _Serving(ctx, ctx.n_fields, 1024)
        self.tape = None

    def step(self, i: int, keep: bool = True) -> float:
        self.tape = None
        self.tape = self.tapes.build()
        self.serving.serve(self.tape, i, keep)
        return float(self.ctx.n_bytes)


class LookupLoop(_ServingLoop):
    def __init__(self, ctx):
        self.ctx = ctx
        wl = ctx.workload
        self.tapes = _Tapes(wl["tape"], ctx.path, ctx.device)
        self.tape = self.tapes.build()
        self.serving = _Serving(ctx, ctx.n_fields, int(wl["pool_batches"]))
        # the window's first batch and a seeded share of the others are
        # kept for the check
        self.keep = np.random.default_rng(ctx.seed % (1 << 64)).random(
            1 << 20) < float(wl["check_share"])

    def step(self, i: int, keep: bool = True) -> float:
        keep = keep and (i == 0 or bool(self.keep[i % self.keep.size]))
        return float(self.serving.serve(self.tape, i, keep))


class SqlLoop:
    """A step is one round of the traffic's statements in order, so every
    step holds the same mix of work."""

    def __init__(self, ctx):
        self.ctx = ctx
        wl = ctx.workload
        self.tapes = _Tapes(wl["tape"], ctx.path, ctx.device)
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
        return {"results": self.results}


LOOPS = {"ingest": IngestLoop, "lookup": LookupLoop, "sql": SqlLoop}
