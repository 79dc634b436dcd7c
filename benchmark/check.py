"""The comparison that decides `correct`: what the timed path produced,
held against the plain reference worked out from the file's bytes.

    index_mismatch   the data record and field counts, and the position of
                     every slot of 4,096 seeded records (and, where the
                     route leaves a host index, every entry of it): the
                     number that differ
    served_mismatch  the (record, field) answers of the checked batches
                     whose bytes, true length or validity differ
    sql_mismatch     the statements' exact cells (group keys, counts, row
                     counts) that differ
    rel_err.<statement>.<column>
                     the widest relative gap of one float column of one
                     statement from the reference's float64 value, over
                     every run of the statement in the window
    utf8_unrefused   only where the traffic sets "validate_utf8": 1 if the
                     program built a tape from the file with its planted
                     byte (loops.plant_offset, 0xFF) instead of refusing
                     it, else 0

Every reading has the limit that the traffic file gives it; a run is
correct when no reading passes its limit and no step failed.
"""

from __future__ import annotations

import importlib

import numpy as np

from .reference import structural
from .reference.columns import Columns


class Reference:
    """The reference's view of the generated file."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.index = structural.structural_index(data)
        self.n_fields, self.jump = structural.header_layout(data)
        self.n_records = (self.index.size - 1) // self.jump - 1
        end = int(np.flatnonzero(np.asarray(data[:1 << 20]) == 0x0A)[0])
        self.names = bytes(data[:end]).decode().split(",")
        self.columns = Columns(data, self.index, self.jump, self.names)

    def serve(self, records: np.ndarray, max_len: int):
        recs = np.repeat(records.astype(np.int64), self.n_fields)
        fields = np.tile(np.arange(self.n_fields), records.size)
        return structural.serve(self.data, self.index, recs, fields,
                                self.jump, self.n_fields, max_len)

    def statement(self, st: dict, dtype: str = "float64") -> dict:
        mod, fn = st["reference"].rsplit(".", 1)
        f = getattr(importlib.import_module(f"benchmark.reference.{mod}"), fn)
        return f(self.columns, st.get("params", {}), dtype)


def served_mismatch(ref: Reference, served: list) -> tuple:
    """(answers that differ, batches with any)."""
    bad = bad_batches = 0
    for recs, out, lengths, valid in served:
        want, wlen, wvalid = ref.serve(recs, out.shape[1])
        row_bad = ((out != want).any(axis=1) | (lengths != wlen)
                   | (valid != wvalid))
        bad += int(row_bad.sum())
        bad_batches += int(row_bad.any())
    return bad, bad_batches


def index_mismatch(ref: Reference, index: dict) -> int:
    bad = int(index["n_records"] != ref.n_records)
    bad += int(index["n_fields"] != ref.n_fields)
    bad += int(index["jump"] != ref.jump)
    slots = index["slots"]
    want = ref.index[np.minimum(slots, ref.index.size - 1)]
    bad += int((index["positions"] != want).sum())
    if "full_index" in index:
        got = index["full_index"]
        bad += int(index["full_n_records"] != ref.n_records)
        if got.shape != ref.index.shape:
            bad += abs(got.size - ref.index.size) + 1
        else:
            bad += int((got != ref.index).sum())
    return bad


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.finfo(np.float64).tiny)
    return float(np.max(np.abs(got - want) / scale)) if want.size else 0.0


def compare_result(got: dict, want: dict) -> tuple:
    """(exact cells that differ, {float column: widest relative gap}) of
    one statement's result against the reference's."""
    bad, gaps = 0, {}
    for name, w in want.items():
        is_float = np.asarray(w).dtype.kind == "f"
        g = np.asarray(got[name]) if name in got else None
        if g is None or g.shape != np.shape(w):
            bad += len(w) if g is None else max(len(w), g.size)
        elif is_float:
            gaps[name] = _rel_err(g.astype(np.float64), w)
        else:
            bad += int(sum(a != b for a, b in zip(g.tolist(),
                                                  np.asarray(w).tolist())))
    return bad, gaps


def sql_readings(ref: Reference, statements: list, results: list) -> tuple:
    """({sql_mismatch, rel_err.<statement>.<column>: widest gap over the
    statement's runs}, statement runs whose result is wrong)."""
    by_name = {st["name"]: st for st in statements}
    want = {}
    values = {"sql_mismatch": 0}
    failed = 0
    for name, got in results:
        if name not in want:
            want[name] = ref.statement(by_name[name])
        b, gaps = compare_result(got, want[name])
        values["sql_mismatch"] += b
        failed += int(b > 0)
        for col, e in gaps.items():
            key = f"rel_err.{name}.{col}"
            values[key] = max(values.get(key, 0.0), e)
    return values, failed


def readings(ref: Reference, workload: dict, outputs: dict) -> tuple:
    """({reading: value}, operations found wrong) for a loop's outputs."""
    if "results" in outputs:
        values, wrong = sql_readings(ref, workload["statements"],
                                     outputs["results"])
    else:
        served, bad_batches = served_mismatch(ref, outputs["served"])
        idx = index_mismatch(ref, outputs["index"])
        values = {"index_mismatch": idx, "served_mismatch": served}
        wrong = bad_batches + int(idx > 0)
    if workload["validate_utf8"]:
        values["utf8_unrefused"] = int(not outputs["utf8_refused"])
        wrong += values["utf8_unrefused"]
    return values, wrong


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): a reading passes when it is
    at most its limit, and a limit with no reading fails."""
    missing = set(values) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    checks = {k: {"value": values[k], "limit": limits[k]} for k in values}
    return (all(c["value"] <= c["limit"] for c in checks.values())
            and set(values) == set(limits)), checks
