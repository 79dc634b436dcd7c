"""The check against the timed path broken underneath, and against each
cell's control: `correct` has to come out false.

The faults are planted in the program's serving and SQL entry points
while the harness drives the rest of a run on the CPU: a step that hands
back its previous answer unchanged, half of the batch left out, and one
answer altered where it is produced. No cell runs across chips, so the
fault of a missing exchange between chips does not arise."""

import importlib

import numpy as np
import pytest
import torch

from benchmark import control, run
from csv_simd_tpu_torch.device_tape import DeviceTape
from csv_simd_tpu_torch.offsetfree import PackedDeviceTape

from .conftest import SEED, small_run, small_traffic

# the module: the package's `sql` attribute is the function
prog_sql = importlib.import_module("csv_simd_tpu_torch.sql")
SERVING = ["taxi-ingest-packed", "taxi-lookup", "lineitem-ingest-offsets",
           "taxi-ingest-streaming"]


def _stale(fn):
    """Each call hands back the answer of the call before it (of the same
    shape), so even a window of one step after the warm-up is stale."""
    last = {}

    def wrapped(*a, **k):
        out = fn(*a, **k)
        key = fn.__qualname__
        prev = last.get(key)
        last[key] = out
        if prev is not None and prev[0].shape == out[0].shape:
            return prev
        return out
    return wrapped


def _half(fn):
    def wrapped(self, records, fields, max_len=64):
        out, lengths, valid = fn(self, records, fields, max_len)
        n = valid.shape[0] // 2
        keep = torch.arange(valid.shape[0]) < n
        return (torch.where(keep[:, None], out, 0),
                torch.where(keep, lengths, 0), valid & keep)
    return wrapped


def _altered(fn):
    def wrapped(*a, **k):
        out, lengths, valid = fn(*a, **k)
        out = out.clone()
        out[0, 0] ^= 1
        return out, lengths, valid
    return wrapped


FAULTS = {"stale": _stale, "half": _half, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", SERVING)
def test_a_broken_serve_is_not_correct(spec, monkeypatch, cell, fault):
    for cls in (PackedDeviceTape, DeviceTape):
        monkeypatch.setattr(cls, "gather_fields",
                            FAULTS[fault](cls.gather_fields))
    res = small_run(spec, cell, monkeypatch,
                    traffic={"check_share": 1.0})["result"]
    assert res["correct"] is False
    assert res["checks"]["served_mismatch"]["value"] > 0


def _sql_stale(fn):
    last = []

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if last:
            out, last[0] = last[0], out
        else:
            last.append(out)
        return out
    return wrapped


def _sql_altered(fn):
    def wrapped(*a, **k):
        res = fn(*a, **k)
        name = next(n for n in res.keys()
                    if np.asarray(res[n]).dtype.kind in "fO"
                    and n not in ("l_returnflag", "l_linestatus"))
        col = np.asarray(res[name], np.float64).copy()
        col[0] *= 1.05
        res._columns[name] = col
        return res
    return wrapped


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_broken_statement_is_not_correct(spec, monkeypatch, fault):
    if fault == "half":
        # half of each column's rows left out of the parse: the
        # aggregates then run over the rest
        monkeypatch.setattr(DeviceTape, "gather_fields",
                            _half(DeviceTape.gather_fields))
    else:
        wrap = _sql_stale if fault == "stale" else _sql_altered
        monkeypatch.setattr(prog_sql, "sql", wrap(prog_sql.sql))
    res = small_run(spec, "lineitem-sql", monkeypatch, seconds=0.5)["result"]
    assert res["correct"] is False


@pytest.mark.parametrize("cell", SERVING + ["lineitem-sql"])
def test_the_control_is_not_correct(spec, cell, monkeypatch):
    # Q6 keeps a few dozen of 3,000 rows, too few for bfloat16 storage's
    # bias to stand clear of its rounding on every seed
    rows = 20000 if cell == "lineitem-sql" else 3000
    small_traffic(monkeypatch)  # chunk_local at the table's small size
    outs = control.run_control(spec, cell, SEED, "cpu", rows=rows, batches=4)
    assert len(outs) == len(run.load_json(
        "traffic", next(w["traffic"] for w in spec["workloads"]
                        if w["name"] == cell))["controls"])
    for out in outs:
        assert out["correct"] is False
        assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_bfloat16_storage_fails_q6_alone(spec):
    """Column values held in bfloat16 with exact arithmetic: Q6's revenue
    leaves its limit; Q1's limits, which make room for the program's
    float32 group sums, cannot see it."""
    outs = control.run_control(spec, "lineitem-sql", SEED, "cpu", rows=20000)
    stored = next(o for o in outs
                  if o["control"]["dtype"] == "bfloat16_values")
    over = {k for k, c in stored["checks"].items() if c["value"] > c["limit"]}
    assert over == {"rel_err.q6.revenue"}
