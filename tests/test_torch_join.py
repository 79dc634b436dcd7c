"""The port's join.py against the JAX package's, on the CPU.

Two seeded tables (relational_csv, tests/test_torch_gpu.py) join on int,
float, date, decimal and text keys and on composite keys, with every join
kind, through `join_records` on the tapes of both engines and through
`join_typed` on the bytes, the port's with device="cpu".

Tolerance: exact. The pairs come back in the order the JAX semantics
give (grouped by left row in left-record order, right matches in
right-key sort order), and the joined Frames' columns are equal, float
columns bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt
from csv_simd_tpu import frame as jf
from csv_simd_tpu import join as jj
from csv_simd_tpu_torch import frame as pf
from csv_simd_tpu_torch import join as pj

from test_torch_frame import same_frame
from test_torch_gpu import relational_csv
from test_torch_query import DATA, SCHEMA, same

ENGINES = ("offsets", "packed")
RIGHT = relational_csv(29, 120)
KINDS = ("inner", "left", "right", "outer", "semi", "anti", "cross")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_query.py)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_TAPES = {}


def tapes(engine: str):
    """((JAX left, JAX right), (port left, port right)), built once."""
    if engine not in _TAPES:
        _TAPES[engine] = (
            tuple(jf._resolve_tape(d, None, "auto", engine, False)[0]
                  for d in (DATA, RIGHT)),
            tuple(pf._resolve_tape(d, None, "auto", engine, False, "cpu")[0]
                  for d in (DATA, RIGHT)))
    return _TAPES[engine]


KEYS = [("k", "int32"), ("t", "str"), ("s", "str"), ("s", "bytes"),
        ("day", "date"), ("d", "decimal:2"), ("f", "float32"),
        (["t", "k"], ["str", "int32"]), (["s", "day"], ["str", "date"])]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("how", KINDS)
@pytest.mark.parametrize("on,spec", KEYS)
def test_join_records_matches_jax(engine, how, on, spec):
    """The (left, right) id pairs of every join kind and key type, in the
    JAX order: exact."""
    (jl, jr), (pl, pr) = tapes(engine)
    kw = dict(how=how, left_spec=spec, right_spec=spec)
    same(pt.join_records(pl, pr, on, **kw), jx.join_records(jl, jr, on, **kw))


@pytest.mark.parametrize("engine", ENGINES)
def test_join_records_restricted_and_renamed(engine):
    """left_records/right_records, right_on and inferred key specs:
    exact."""
    (jl, jr), (pl, pr) = tapes(engine)
    lrec = np.arange(0, 300, 3, dtype=np.int32)
    rrec = np.arange(5, 120, 2, dtype=np.int32)
    for how in ("inner", "left", "anti"):
        kw = dict(how=how, right_on="k", left_records=lrec,
                  right_records=rrec, left_spec="int32", right_spec="int32")
        same(pt.join_records(pl, pr, "id", **kw),
             jx.join_records(jl, jr, "id", **kw))
    same(pt.join_records(pl, pr, "t"), jx.join_records(jl, jr, "t"))


def test_merge_device_matches_jax():
    """The device sort-merge alone on int32 and float32 keys, invalid
    rows, the int32 max as a legit key and -0.0 beside 0.0: exact."""
    rng = np.random.default_rng(4)
    for dtype in (np.int32, np.float32):
        lk = rng.integers(-20, 20, 500).astype(dtype)
        rk = rng.integers(-20, 20, 300).astype(dtype)
        if dtype == np.int32:
            lk[:5] = rk[:5] = 2**31 - 1
        else:
            lk[:5], rk[:5] = -0.0, 0.0
        lo, ro = rng.random(500) > 0.1, rng.random(300) > 0.1
        got = pj._merge_device(*(torch.from_numpy(a)
                                 for a in (lk, lo, rk, ro)))
        want = jj._merge_device(*(jnp.asarray(a) for a in (lk, lo, rk, ro)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


JOINS = [
    dict(on="k", how="inner", schema=SCHEMA, right_schema=SCHEMA),
    dict(on="t", how="left", columns=["id", "v", "t"],
         right_columns=["id", "s", "f"]),
    dict(on=["t", "k"], how="outer", schema=SCHEMA, right_schema=SCHEMA,
         columns=["id", "d"], right_columns=["ts", "x"]),
    dict(on="s", how="right", schema=SCHEMA, right_schema=SCHEMA,
         columns=["id"], right_columns=["id", "day"], suffix="_r"),
    dict(on="k", how="semi", schema=SCHEMA, where=("v", ">", 0),
         right_where=("t", "==", "a"), right_schema=SCHEMA),
    dict(on="k", how="anti", schema=SCHEMA, right_schema=SCHEMA),
    dict(on="day", right_on="day", how="inner", schema=SCHEMA,
         right_schema=SCHEMA, columns=["day", "v"]),
    dict(on=None, how="cross", columns=["id"], right_columns=["t"],
         where=("id", "<", 5), right_where=("id", "<", 4),
         schema=SCHEMA, right_schema=SCHEMA),
]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("i", range(len(JOINS)))
def test_join_typed_matches_jax(engine, i):
    """The joined Frame: names, records and every column exact."""
    kw = dict(JOINS[i])
    on = kw.pop("on")
    same_frame(pt.join_typed(DATA, RIGHT, on, engine=engine, device="cpu",
                             **kw),
               jx.join_typed(DATA, RIGHT, on, engine=engine, **kw))


def test_join_typed_rejects_mismatched_key_types():
    for mod, kw in ((jx, {}), (pt, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.join_typed(DATA, RIGHT, "k", schema={"k": "int32"},
                           right_schema={"k": "decimal:2"}, **kw)
