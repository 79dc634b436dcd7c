"""GROUP BY ... ORDER BY <count> LIMIT k chosen on the device
(query.groupby_topk, through sql.sql) on the CPU, on both engines.

Each statement is held against the benchmark's plain reference of the
ClickBench statements (benchmark/reference/clickbench.py, which works
from the file's bytes with Python ints and `bytes`) through the
benchmark's own comparison, and against the general executor that
grouped every key on the host before this path (`_device_topk_plan`
made to decline): the same rows, values and dtypes. The tables are
seeded and small; they hold int64 keys of 19 digits of either sign and
at +-(2**63 - 1), ties at rank k, empty phrases, text keys longer than 7
and than 255 bytes, NULLs under COUNT(DISTINCT), and a composite key
space past 2**31."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from csv_simd_tpu_torch import query as pq
from csv_simd_tpu_torch.device_tape import _parse_int64
from csv_simd_tpu_torch.frame import _resolve_tape
from csv_simd_tpu_torch.utils.metrics import GLOBAL

psql = importlib.import_module("csv_simd_tpu_torch.sql")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.check import Reference, compare_result  # noqa: E402

ENGINES = ("offsets", "packed")
SCHEMA = {"UserID": "int64", "RegionID": "int32", "SearchPhrase": "str",
          "URL": "str"}
I64 = 2**63 - 1
Q = {  # (statement, its reference function)
    "q9": ("SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits GROUP BY "
           "RegionID ORDER BY u DESC, RegionID LIMIT {k}", "clickbench.q9"),
    "q13": ("SELECT SearchPhrase, COUNT(*) AS c FROM hits WHERE SearchPhrase"
            " <> '' GROUP BY SearchPhrase ORDER BY c DESC, SearchPhrase "
            "LIMIT {k}", "clickbench.q13"),
    "q16": ("SELECT UserID, COUNT(*) AS c FROM hits GROUP BY UserID ORDER BY"
            " c DESC, UserID LIMIT {k}", "clickbench.q16"),
    "q34": ("SELECT URL, COUNT(*) AS c FROM hits GROUP BY URL ORDER BY c "
            "DESC, URL LIMIT {k}", "clickbench.q34"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _csv_text(v: str) -> str:
    if any(c in v for c in ',"\n'):
        return '"' + v.replace('"', '""') + '"'
    return v


def hits_csv(seed: int, n: int = 600, phrases: bool = True) -> bytes:
    """A seeded hits-like table. UserID: the 14 ids of TIED 20 times each,
    more than any other (a tie across rank 10), 19-digit ids of both
    signs, +-(2**63 - 1), and empty (NULL) fields; RegionID: 12 regions, some
    empty; SearchPhrase: mostly empty, else 1-40 bytes, some with commas
    and quotes; URL: 1-300 bytes from a few hundred prefixes, so keys pass
    7 and 255 bytes and share long prefixes."""
    rng = np.random.default_rng(seed)
    users = [u for u in TIED for _ in range(20)]
    users += [I64, -I64, I64, -I64, -(2**63)]
    pool = [int(x) * (1 if rng.integers(2) else -1)
            for x in rng.integers(10**18, I64, 200)]
    while len(users) < n:
        users.append(None if rng.random() < 0.05
                     else pool[rng.integers(len(pool))])
    rng.shuffle(users)
    words = ["google", "yandex", "a,b", 'say "hi"', "x" * 40, "ru", "news"]
    base = "http://example.com/" + "p" * 240
    rows = ["RegionID,UserID,SearchPhrase,URL"]
    for i, u in enumerate(users):
        region = "" if rng.random() < 0.04 else str(int(rng.integers(1, 13)))
        phrase = ""
        if phrases and rng.random() < 0.3:
            phrase = " ".join(words[j] for j in rng.integers(
                0, len(words), rng.integers(1, 3)))[:40]
        cut = int(rng.integers(1, 300))
        url = (base + str(int(rng.integers(0, 150))) + "/q")[:cut] \
            if rng.random() < 0.7 else "u" + str(int(rng.integers(0, 50)))
        rows.append(f"{region},{'' if u is None else u},"
                    f"{_csv_text(phrase)},{_csv_text(url)}")
    return ("\n".join(rows) + "\n").encode()


TIED = [(-1) ** i * (10**18 + 7_777_777_777_777_777 * i) for i in range(14)]
DATA = hits_csv(11)
NO_PHRASES = hits_csv(12, 200, phrases=False)


@pytest.fixture(scope="module", params=ENGINES)
def tapes(request):
    return {name: _resolve_tape(data, None, "auto", request.param, False,
                                "cpu")[0]
            for name, data in (("data", DATA), ("none", NO_PHRASES))}


def _run(stmt: str, tape) -> dict:
    res = psql.sql(stmt, tape, schema=SCHEMA, device="cpu")
    return {k: np.asarray(res[k]) for k in res.keys()}


def _host_grouped(stmt: str, tape, monkeypatch) -> dict:
    """The statement through the general executor, which sorted every
    group on the host."""
    with monkeypatch.context() as m:
        m.setattr(psql, "_device_topk_plan", lambda *a: None)
        return _run(stmt, tape)


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tolist() == b[k].tolist(), k


@pytest.mark.parametrize("name", list(Q))
@pytest.mark.parametrize("k", [10, 1000])
def test_topk_statements_match_the_reference_and_the_host_path(
        tapes, monkeypatch, name, k):
    """LIMIT 10 cuts inside ties; LIMIT 1000 is more than G."""
    stmt, ref = Q[name][0].format(k=k), Q[name][1]
    calls = GLOBAL.stages.get("query.group_topk")
    before = calls.calls if calls else 0
    got = _run(stmt, tapes["data"])
    assert GLOBAL.stages["query.group_topk"].calls == before + 1
    want = Reference(np.frombuffer(DATA, np.uint8)).statement(
        {"reference": ref, "params": {"limit": k}})
    assert compare_result(got, want) == (0, {})
    _same(got, _host_grouped(stmt, tapes["data"], monkeypatch))
    n_groups = len(next(iter(want.values())))
    assert n_groups < k if k == 1000 else n_groups == k


def test_ties_at_rank_k_are_broken_by_the_key(tapes):
    got = _run(Q["q16"][0].format(k=10), tapes["data"])
    assert got["c"].tolist() == [20] * 10
    assert got["UserID"].tolist() == sorted(TIED)[:10]


def test_int64_keys_keep_the_extremes_and_19_digits(tapes):
    got = _run("SELECT UserID, COUNT(*) AS c FROM hits GROUP BY UserID "
               "ORDER BY UserID LIMIT 2", tapes["data"])
    assert got["UserID"].dtype == np.int64
    assert got["UserID"].tolist() == [-(2**63), -I64]
    assert got["c"].tolist() == [1, 2]
    top = _run("SELECT UserID, COUNT(*) AS c FROM hits GROUP BY UserID "
               "ORDER BY UserID DESC LIMIT 1", tapes["data"])
    assert top["UserID"].tolist() == [I64] and top["c"].tolist() == [2]


def test_an_empty_group_set_and_empty_phrases(tapes, monkeypatch):
    stmt = Q["q13"][0].format(k=10)
    got = _run(stmt, tapes["none"])
    want = Reference(np.frombuffer(NO_PHRASES, np.uint8)).statement(
        {"reference": "clickbench.q13", "params": {"limit": 10}})
    assert compare_result(got, want) == (0, {})
    assert got["c"].size == 0 and got["SearchPhrase"].size == 0
    _same(got, _host_grouped(stmt, tapes["none"], monkeypatch))


def test_count_distinct_skips_nulls_and_keeps_null_only_groups(tapes,
                                                                monkeypatch):
    stmt = ("SELECT RegionID, COUNT(DISTINCT UserID) AS u, COUNT(*) AS c, "
            "COUNT(UserID) AS n FROM hits WHERE URL LIKE 'u%' GROUP BY "
            "RegionID ORDER BY u, RegionID")
    got = _run(stmt, tapes["data"])
    _same(got, _host_grouped(stmt, tapes["data"], monkeypatch))
    assert (got["u"] <= got["n"]).all() and (got["n"] <= got["c"]).all()


@pytest.mark.parametrize("order", ["c DESC, URL, UserID, RegionID",
                                   "RegionID DESC, UserID, c"])
def test_a_composite_key_space_past_int32(order, monkeypatch):
    rng = np.random.default_rng(3)
    n = 1400
    a, b, c = (rng.permutation(n) for _ in range(3))
    rows = ["RegionID,UserID,SearchPhrase,URL"] + [
        f"{a[i]},{(int(b[i]) - 700) * 6_000_000_000_000_000},,"
        f"{'y' * 20}{c[i] % 1350:05d}" for i in range(n)]
    data = ("\n".join(rows) + "\n").encode()
    stmt = ("SELECT RegionID, UserID, URL, COUNT(*) AS c FROM hits GROUP BY "
            f"RegionID, UserID, URL ORDER BY {order} LIMIT 7")
    for engine in ENGINES:
        tape = _resolve_tape(data, None, "auto", engine, False, "cpu")[0]
        kind, codes, _, _ = pq._prepare_group_keys(
            tape, ["RegionID", "UserID", "SearchPhrase", "URL"],
            ["RegionID", "UserID", "URL"], ["int32", "int64", "str"], None,
            None, 256)
        assert kind == "device" and codes.dtype == torch.int64
        got = _run(stmt, tape)
        _same(got, _host_grouped(stmt, tape, monkeypatch))
        assert len(got["c"]) == 7


def test_only_the_kept_keys_are_read_back(tapes):
    """q34's URLs and q16's ids: the 10 winners cross, not the G groups."""
    for name in ("q34", "q16", "q13"):
        before = GLOBAL.stages.get("query.group_keys_read")
        n0 = before.calls if before else 0
        g0 = GLOBAL.stages["query.groups"].calls \
            if "query.groups" in GLOBAL.stages else 0
        _run(Q[name][0].format(k=10), tapes["data"])
        assert GLOBAL.stages["query.group_keys_read"].calls - n0 == 10
        assert GLOBAL.stages["query.groups"].calls - g0 > 10


@pytest.mark.parametrize("text, want", [
    (b"9223372036854775807", I64), (b"-9223372036854775808", -(2**63)),
    (b"-9223372036854775807", -I64), (b"1000000000000000000", 10**18),
    (b"  -42", -42), (b"+7", 7), (b"000000000000000000000000009", 9),
    (b"9223372036854775808", None), (b"-9223372036854775809", None),
    (b"99999999999999999999", None), (b"", None), (b"-", None),
    (b"12 ", None), (b"1e5", None)])
def test_int64_parse_is_exact_at_the_edges(text, want):
    width = 32
    out = torch.zeros((1, width), dtype=torch.uint8)
    out[0, :len(text)] = torch.tensor(list(text), dtype=torch.uint8)
    v, ok = _parse_int64(out, torch.tensor([len(text)], dtype=torch.int32),
                         torch.ones(1, dtype=torch.bool))
    assert bool(ok[0]) == (want is not None)
    assert int(v[0]) == (0 if want is None else want)
