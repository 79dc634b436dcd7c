"""The relational layer and SQL over the port's sharded tapes, through
both packages: the nine checks of tests/test_sharded_query.py, each run
on the port's ShardedPackedTape and ShardedTape (8 CPU shards) and on the
JAX package's over the 8-device virtual CPU mesh, and held equal, and to
the port's single-device DeviceTape. Tolerance: exact, except float32
sums within rtol 1e-5 (the port adds in another order than XLA; the
frames and SQL results compare as tests/torch_sql_diff.py does)."""

import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu.setops as jsetops
import csv_simd_tpu.window as jwindow
import csv_simd_tpu_torch as pt
import csv_simd_tpu_torch.setops as psetops
import csv_simd_tpu_torch.window as pwindow
from csv_simd_tpu.parallel import serving as jserving
from csv_simd_tpu.parallel.sharded import make_mesh as jmake_mesh
from csv_simd_tpu_torch.parallel.serving import ShardedPackedTape, ShardedTape
from csv_simd_tpu_torch.parallel.sharded import make_mesh

from test_sharded_query import _mk_csv
from test_torch_query import FLOAT_RTOL, same
from torch_sql_diff import same_result


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup():
    """(port device tape, port packed, port offsets, JAX packed, JAX
    offsets): the sharded tapes on 8 shards."""
    data = _mk_csv()
    ptape = pt.create_from_bytes(data, backend="golden")
    jtape = jx.create_from_bytes(data, backend="golden")
    mesh, jmesh = make_mesh(8, device="cpu"), jmake_mesh(8)
    return (pt.DeviceTape.from_tape(ptape, device="cpu"),
            ShardedPackedTape(data, mesh), ShardedTape.from_tape(ptape, mesh),
            jserving.ShardedPackedTape(data, jmesh),
            jserving.ShardedTape.from_tape(jtape, jmesh))


def _same_port(got, want):
    """Two of the port's Frames or SqlResults: names, length, every
    column's values and ok mask, exact (the same code on the same
    bytes)."""
    assert got.names == want.names and len(got) == len(want)
    for n in want.names:
        assert np.asarray(got[n]).tolist() == np.asarray(want[n]).tolist(), n
        gm, wm = got.ok(n), want.ok(n)
        assert (gm is None) == (wm is None), n
        if wm is not None:
            np.testing.assert_array_equal(np.asarray(gm), np.asarray(wm))


def _both(setup, which: str = "packed"):
    """(port sharded tape, JAX sharded tape, port device tape)."""
    dev, ppk, pst, jpk, jst = setup
    return (ppk, jpk, dev) if which == "packed" else (pst, jst, dev)


@pytest.mark.parametrize("which", ["packed", "offsets"])
def test_read_typed_sharded_matches_jax(setup, which):
    p, j, dev = _both(setup, which)
    got = pt.read_typed(p)
    same_result(got, jx.read_typed(j))
    _same_port(got, pt.read_typed(dev))


def test_predicate_pushdown_sharded(setup):
    p, j, dev = _both(setup)
    where = [("qty", ">", 1000), ("sym", "==", "GOOG")]
    got = pt.select_records(p, where)
    same(got, jx.select_records(j, where))
    same(got, pt.select_records(dev, where))
    assert len(got) > 0


def test_column_stats_sharded(setup):
    p, j, dev = _both(setup)
    for column, spec in (("qty", None), ("price", "decimal:2"),
                         ("price", "float32")):
        got = pt.column_stats(p, column, spec)
        same(got, jx.column_stats(j, column, spec), FLOAT_RTOL)
        same(got, pt.column_stats(dev, column, spec))
    assert got.sum is not None


def test_groupby_sharded(setup):
    p, j, dev = _both(setup)
    got = pt.groupby_typed(p, "sym", "qty")
    same(got, jx.groupby_typed(j, "sym", "qty"), FLOAT_RTOL)
    same(got, pt.groupby_typed(dev, "sym", "qty"))
    assert "GOOG" in list(got["keys"])


def test_order_and_counts_sharded(setup):
    p, j, dev = _both(setup)
    got = pt.order_records(p, "qty", descending=True, limit=25)
    same(got, jx.order_records(j, "qty", descending=True, limit=25))
    same(got, pt.order_records(dev, "qty", descending=True, limit=25))
    got = pt.value_counts(p, "sym")
    same(got, jx.value_counts(j, "sym"))
    same(got, pt.value_counts(dev, "sym"))


def test_join_sharded_left_side(setup):
    p, j, dev = _both(setup)
    dim = b"sym,sector\nAAPL,tech\nGOOG,ads\nMSFT,tech\nTSLA,cars\n"
    cols = ["id", "sym", "qty"]
    got = pt.join_typed(p, dim, "sym", columns=cols, device="cpu")
    same_result(got, jx.join_typed(j, dim, "sym", columns=cols))
    _same_port(got, pt.join_typed(dev, dim, "sym", columns=cols,
                                  device="cpu"))
    assert "sector" in got.names


def test_sql_over_sharded_tapes(setup):
    dev, ppk, pst, jpk, jst = setup
    q = ("SELECT sym, COUNT(*), SUM(qty) AS tot FROM t "
         "WHERE qty > 0 GROUP BY sym HAVING COUNT(*) >= 5 "
         "ORDER BY tot DESC")
    want = jx.sql(q, jpk)
    for p, j in ((ppk, jpk), (pst, jst)):
        got = pt.sql(q, p, device="cpu")
        same_result(got, jx.sql(q, j))
        same_result(got, want)
        _same_port(got, pt.sql(q, dev, device="cpu"))
    q = "SELECT id, qty FROM t WHERE sym = 'TSLA' ORDER BY qty DESC LIMIT 7"
    same_result(pt.sql(q, ppk, device="cpu"), jx.sql(q, jpk))


def test_sql_window_and_setops_over_sharded_tape(setup, monkeypatch):
    """Window functions and set operations through sql() over the sharded
    offsets-free tape, on the device executors in both packages."""
    dev, ppk, _pst, jpk, _jst = setup
    for mod in (jwindow, pwindow):
        monkeypatch.setattr(mod, "DEVICE_WINDOW_MIN_ROWS", 1)
    for mod in (jsetops, psetops):
        monkeypatch.setattr(mod, "DEVICE_SETOP_MIN_ROWS", 1)
    sch = {"id": "int32", "qty": "int32"}
    for q in ("SELECT id, SUM(qty) OVER (PARTITION BY sym ORDER BY qty) "
              "AS s, ROW_NUMBER() OVER (PARTITION BY sym ORDER BY qty) AS rn"
              " FROM t",
              "SELECT id, qty FROM t WHERE qty > 100 "
              "EXCEPT SELECT id, qty FROM t WHERE qty > 2000"):
        got = pt.sql(q, ppk, schema=sch, device="cpu")
        same_result(got, jx.sql(q, jpk, schema=sch))
        _same_port(got, pt.sql(q, dev, schema=sch, device="cpu"))
        assert len(got) > 0
