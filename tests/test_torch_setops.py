"""The port's device set operations (csv_simd_tpu_torch/setops.py)
against the JAX package's (csv_simd_tpu/setops.py), on the CPU.

Frames of 8,192 rows and more (the device threshold, left at its
default) with int and float columns holding NULLs, many duplicate rows
and rows shared between the two sides. The kept row ids are exact; an
object column is ineligible and gives None in both packages."""

import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt
from csv_simd_tpu import setops as js
from csv_simd_tpu_torch import setops as ps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def frames(n: int, seed: int, with_text: bool = False):
    """(JAX Frame, port Frame) over the same seeded columns: a and b
    int32 with NULLs (ok masks), f float64 of few distinct values with
    NaN-free NULLs, and optionally an object text column."""
    rng = np.random.default_rng(seed)
    cols = {
        "a": rng.integers(0, 12, n).astype(np.int32),
        "b": rng.integers(-3, 3, n).astype(np.int64),
        "f": rng.integers(0, 5, n) / 4.0,
    }
    ok = {"a": rng.random(n) > 0.05, "b": None, "f": rng.random(n) > 0.1}
    spec = {"a": "int32", "b": "int32", "f": "float"}
    if with_text:
        cols["s"] = rng.choice(np.array(["x", "y"], object), n)
        ok["s"] = None
        spec["s"] = "str"
    names = list(cols)
    return tuple(
        lib.Frame(names, dict(cols), dict(ok),
                  {k: lib.Col(v) for k, v in spec.items()}, n)
        for lib in (jx, pt))


@pytest.mark.parametrize("n", [8192, 8193, 20000])
@pytest.mark.parametrize("seed", [0, 1])
def test_dedupe_keep_matches_jax(n, seed):
    jf, pf = frames(n, seed)
    want = js.dedupe_keep(jf)
    got = ps.dedupe_keep(pf, device="cpu")
    assert want is not None and 0 < len(want) < n
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["except", "intersect"])
@pytest.mark.parametrize("na,nb", [(8192, 1), (5000, 3192), (3, 9000),
                                   (12000, 12000)])
def test_setop_keep_matches_jax(op, na, nb):
    """Both forms: the two frames, and their concatenation (acc first)."""
    ja, pa = frames(na, 2)
    jb, pb = frames(nb, 3)
    want = js.setop_keep(ja, jb, op)
    got = ps.setop_keep(pa, pb, op, device="cpu")
    assert want is not None
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    jboth, pboth = frames(na + nb, 4)
    want = js.setop_keep_concat(jboth, na, op)
    got = ps.setop_keep_concat(pboth, na, op, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_object_columns_and_small_frames_are_ineligible():
    jf, pf = frames(9000, 5, with_text=True)
    assert js.dedupe_keep(jf) is None and ps.dedupe_keep(pf, "cpu") is None
    assert js.setop_keep(jf, jf, "except") is None
    assert ps.setop_keep(pf, pf, "except", device="cpu") is None
    assert js.setop_keep_concat(jf, 10, "intersect") is None
    assert ps.setop_keep_concat(pf, 10, "intersect", device="cpu") is None
    js_small, ps_small = frames(8191, 6)
    assert js.dedupe_keep(js_small) is None
    assert ps.dedupe_keep(ps_small, device="cpu") is None


def test_columns_codes_match_jax():
    ja, pa = frames(9000, 7)
    jb, pb = frames(100, 8)
    want = js._columns_codes([ja, jb])
    got = ps._columns_codes([pa, pb])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_argument_is_resolved(monkeypatch):
    """device="cuda" without a card raises, as every entry point does,
    rather than running on the CPU."""
    _jf, pf = frames(9000, 9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ps.dedupe_keep(pf)
    with pytest.raises(RuntimeError, match="cuda"):
        ps.setop_keep(pf, pf, "except")
