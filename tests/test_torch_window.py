"""The port's device window functions (csv_simd_tpu_torch/window.py)
against the JAX package's (csv_simd_tpu/window.py), on the CPU.

The same numpy inputs, made from a seed, go through each JAX function
and its torch counterpart. Tolerance 0 throughout: codes, permutations,
counts, ranks, source row ids and integer sums exact, float32 results
(the double-f32 window sums included) bit for bit. Index outputs are
int64 in the port (torch's index type) and int32 in the JAX package, so
they are compared as int64 values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import window as jw
from csv_simd_tpu.query import SortDir as JSortDir
from csv_simd_tpu_torch import window as pw
from csv_simd_tpu_torch.query import SortDir as PSortDir


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want, path="result"):
    """Port tensor (or numpy array) == JAX array: equal values, float32
    compared as its bits, index dtypes compared as int64."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype == np.float32:
        assert g.dtype == np.float32, (path, g.dtype)
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=path)
    elif w.dtype.kind in "iub" and g.dtype.kind in "iub":
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=path)
    else:
        assert g.dtype == w.dtype, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def cancelling_floats(n: int, seed: int) -> np.ndarray:
    """float32 values of mixed magnitude that cancel: runs of +-1e6
    beside small ones, where the double-f32 low words carry bits."""
    rng = np.random.default_rng(seed)
    big = rng.choice([1e6, -1e6, 3e7, -3e7], n) * rng.integers(0, 2, n)
    small = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 3, n)
    return (big + small).astype(np.float32)


def boundaries(n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = np.zeros(n, bool)
    b[rng.choice(n, k, replace=False)] = True
    b[0] = True
    return b


# ------------------------------------------------------------ key codes

@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
@pytest.mark.parametrize("ok_kind", ["mask", "none", "all_null"])
def test_factorize_key_device_matches_jax(desc, nulls_first, ok_kind):
    """Codes bit for bit, and the bound as the reference gives it (one
    larger than the codes need)."""
    rng = np.random.default_rng(1)
    v = rng.integers(-5000, 5000, 3000).astype(np.int32)
    ok = {"mask": rng.random(3000) > 0.1, "none": None,
          "all_null": np.zeros(3000, bool)}[ok_kind]
    want = jw.factorize_key_device(
        jnp.asarray(v), None if ok is None else jnp.asarray(ok),
        desc=desc, nulls_first=nulls_first)
    got = pw.factorize_key_device(t(v), None if ok is None else t(ok),
                                  desc=desc, nulls_first=nulls_first)
    same(got[0], want[0])
    assert got[0].dtype == torch.int32
    assert got[1] == want[1]
    host = pw.factorize_key(v, ok, desc=desc, nulls_first=nulls_first)
    np.testing.assert_array_equal(got[0].numpy(), host)


def test_factorize_key_device_ineligible():
    """A span past int32 and a float column go to the host path (None)."""
    span = np.array([-(2**31), 2**31 - 1], np.int32)
    assert jw.factorize_key_device(jnp.asarray(span), None) is None
    assert pw.factorize_key_device(t(span), None) is None
    f = np.ones(4, np.float32)
    assert jw.factorize_key_device(jnp.asarray(f), None) is None
    assert pw.factorize_key_device(t(f), None) is None


@pytest.mark.parametrize("vals", [
    np.array(["b", "a", "c", "a"], object),
    np.array([b"x", b"", b"x", b"y"], object),
    np.array([3.5, -1.0, 3.5, 0.0]),
    np.array([7, 2**40, -3, 7], np.int64),
    np.array([1, "a", 2.0, None], object),
])
@pytest.mark.parametrize("desc", [False, True])
def test_factorize_key_host_matches_jax(vals, desc):
    ok = np.array([True, True, False, True])
    for nf in (False, True):
        want = jw.factorize_key(vals, ok, desc=desc, nulls_first=nf)
        got = pw.factorize_key(vals, ok, desc=desc, nulls_first=nf)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_radix_combine_and_lex_sort_match_jax():
    """Host and device codes pack into the same int32 chunks (a bound
    product past 2**31 starts a new chunk), and the stable lexicographic
    sort gives the same permutation."""
    rng = np.random.default_rng(2)
    n = 2000
    bounds = [5, 70000, 40000, 3, 2**20]
    codes = [rng.integers(0, b, n).astype(np.int32) for b in bounds]
    jcodes = [c if i % 2 else jnp.asarray(c) for i, c in enumerate(codes)]
    pcodes = [c if i % 2 else t(c) for i, c in enumerate(codes)]
    want = jw._radix_combine(jcodes, bounds, n)
    got = pw._radix_combine(pcodes, bounds, n, "cpu")
    assert got.dtype == torch.int32 and got.shape[0] == 3
    same(got, want)
    same(pw._lex_sort(got), jw._lex_sort(want))
    same(pw._radix_combine([], [], n, "cpu"), jw._radix_combine([], [], n))
    same(pw._lex_sort(pw._radix_combine([], [], n, "cpu")),
         jw._lex_sort(jw._radix_combine([], [], n)))


@pytest.mark.parametrize("k", [0, 1, 3])
def test_changes_ends_and_max_partition_run_match_jax(k):
    rng = np.random.default_rng(3)
    n = 1500
    keys = rng.integers(0, 4, (k, n)).astype(np.int32)
    jperm = jw._lex_sort(jnp.asarray(keys)) if k else jnp.arange(n)
    pperm = pw._lex_sort(t(keys)) if k else torch.arange(n)
    same(pperm, jperm)
    jch = jw._changes(jnp.asarray(keys)[:, jperm])
    pch = pw._changes(t(keys)[:, pperm])
    same(pch, jch)
    same(pw._ends(pch, torch.arange(n), n),
         jw._ends(jch, jnp.arange(n, dtype=jnp.int32), n))
    same(pw._max_partition_run(t(keys), pperm),
         jw._max_partition_run(jnp.asarray(keys), jperm.astype(jnp.int32)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("levels", [1, 3, 12])
@pytest.mark.parametrize("op", ["min", "max"])
def test_rmq_table_matches_jax(dtype, levels, op):
    """Sparse-table levels, including a level shift past the array end."""
    rng = np.random.default_rng(4)
    m = rng.integers(-1000, 1000, 700).astype(dtype)
    want = jw._rmq_table(jnp.asarray(m),
                         jnp.minimum if op == "min" else jnp.maximum,
                         levels)
    got = pw._rmq_table(t(m), torch.minimum if op == "min"
                        else torch.maximum, levels)
    same(got, want)


# ------------------------------------------------------------------ scans

# the JAX scans as _window_device runs them: inside a jit
_JAX_SEG_SCAN = jax.jit(jw._seg_scan, static_argnums=2)
_JAX_SEG_SCAN_DF = jax.jit(jw._seg_scan_df)
_COMBINE = {"add": (jnp.add, torch.add),
            "min": (jnp.minimum, torch.minimum),
            "max": (jnp.maximum, torch.maximum)}


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("n", [1, 2, 3, 1000, 4097])
def test_seg_scan_matches_jax(op, n):
    """int32 add wraps as XLA's; min and max over int32 and float32."""
    rng = np.random.default_rng(5 + n)
    b = boundaries(n, max(1, n // 50), n)
    dtypes = (np.int32,) if op == "add" else (np.int32, np.float32)
    for dt in dtypes:
        v = (rng.integers(-2**31, 2**31 - 1, n) if dt == np.int32
             else rng.standard_normal(n)).astype(dt)
        want = _JAX_SEG_SCAN(jnp.asarray(v), jnp.asarray(b),
                             _COMBINE[op][0])
        got = pw._seg_scan(t(v), t(b), _COMBINE[op][1])
        assert got.dtype == torch.from_numpy(v).dtype
        same(got, want)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _sequential_df_lo(v, b) -> np.ndarray:
    """The lo words of the double-f32 segmented sum combined in row order:
    window._df_add(h, lo, x, 0) on float32 scalars, row after row."""
    zero = np.float32(0)
    h = low = zero
    out = np.zeros_like(v)
    for i, x in enumerate(v):
        if b[i]:
            h, low = x, zero
        else:
            sh, se = _two_sum(h, x)
            h, low = _two_sum(sh, se + (low + zero))
        out[i] = low
    return out


@pytest.mark.parametrize("n", [5000, 4097, 2])
def test_seg_scan_df_bit_for_bit(n):
    """The compensated float sum combines in jax.lax.associative_scan's
    tree, so hi and lo words equal the JAX package's. On this input a
    scan in row order gives other lo words, so the test tells the two
    orders apart."""
    v = cancelling_floats(n, 6)
    b = boundaries(n, max(1, n // 125), 7)
    jh, jl = _JAX_SEG_SCAN_DF(jnp.asarray(v), jnp.asarray(b))
    ph, pl = pw._seg_scan_df(t(v), t(b))
    same(ph, jh, "hi")
    same(pl, jl, "lo")
    if n == 5000:
        seq = _sequential_df_lo(v, b)
        assert not np.array_equal(seq.view(np.int32),
                                  np.asarray(jl).view(np.int32))


@pytest.mark.parametrize("n", [1, 2, 5, 64, 999])
def test_associative_scan_combines_in_jax_order(n):
    """float32 addition of mixed magnitudes is associative only up to
    rounding, so equal bits at every position need jax.lax.
    associative_scan's pairing of elements; the row-order sum (cumsum)
    gives other bits."""
    from jax import lax

    v = cancelling_floats(n, 13)
    want = jax.jit(lambda x: lax.associative_scan(jnp.add, x))(
        jnp.asarray(v))
    got, = pw._associative_scan(lambda a, b: [a[0] + b[0]], (t(v),))
    same(got, want)
    if n == 999:
        seq = np.cumsum(v, dtype=np.float32)
        assert not np.array_equal(seq.view(np.int32),
                                  np.asarray(want).view(np.int32))


# ----------------------------------------------------------- _window_device

N = 900
# the default RANGE frame, ROWS frames unbounded on one side, doubly
# bounded ones (one wholly ahead of the row, one wider than the data)
FRAMES = [None, ("rows", None, 0), ("rows", -2, None), ("rows", -3, 2),
          ("rows", 1, 4), ("rows", -2000, 1500)]
RANKING = ["row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
           "lag", "lead", "ntile"]


def _window_inputs(has_part: bool, has_order: bool):
    rng = np.random.default_rng(8)
    pk = rng.integers(0, 6, (2 if has_part else 0, N)).astype(np.int32)
    ok_ = rng.integers(0, 40, (1 if has_order else 0, N)).astype(np.int32)
    sort_k = np.concatenate([pk, ok_]) if (has_part or has_order) \
        else np.zeros((0, N), np.int32)
    vok = rng.random(N) > 0.15
    vi = rng.integers(-2**31, 2**31 - 1, N).astype(np.int32)
    vf = cancelling_floats(N, 9)
    return pk, ok_, sort_k, vok, vi, vf


def _run_window(fn, frame, has_part=True, has_order=True, dtype="int",
                offset=1):
    pk, okk, sort_k, vok, vi, vf = _window_inputs(has_part, has_order)
    vals = vi if dtype == "int" else vf
    jperm = jw._lex_sort(jnp.asarray(sort_k))
    pperm = pw._lex_sort(t(sort_k))
    want = jw._window_device(jperm, jnp.asarray(pk), jnp.asarray(okk),
                             jnp.asarray(vals), jnp.asarray(vok), fn=fn,
                             offset=offset, has_order=has_order,
                             frame=frame)
    got = pw._window_device(pperm, t(pk), t(okk), t(vals), t(vok), fn=fn,
                            offset=offset, has_order=has_order,
                            frame=frame)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        same(g, w, f"{fn} {frame} output {i}")


@pytest.mark.parametrize("fn", RANKING)
@pytest.mark.parametrize("keys", ["part+order", "part", "order"])
def test_window_device_ranking_matches_jax(fn, keys):
    offset = {"lag": 2, "lead": 3, "ntile": 7}.get(fn, 1)
    _run_window(fn, None, has_part="part" in keys,
                has_order="order" in keys, offset=offset)


@pytest.mark.parametrize("fn", ["first_value", "last_value", "nth_value"])
@pytest.mark.parametrize("frame", FRAMES)
def test_window_device_value_fns_match_jax(fn, frame):
    _run_window(fn, frame, offset=3 if fn == "nth_value" else 1)


@pytest.mark.parametrize("fn,dtype", [
    ("sum", "int"), ("sum", "float"), ("min", "int"), ("min", "float"),
    ("max", "int"), ("max", "float")])
@pytest.mark.parametrize("frame", FRAMES)
def test_window_device_aggregates_match_jax(fn, dtype, frame):
    """Int digit sums exact; float32 sums (the double-f32 pairs) and
    min/max bit for bit; frames wider than the data too."""
    _run_window(fn, frame, dtype=dtype)


@pytest.mark.parametrize("fn,dtype", [
    ("count", "int"), ("mean", "int"), ("mean", "float")])
@pytest.mark.parametrize("frame", [FRAMES[0], FRAMES[3], FRAMES[5]])
def test_window_device_count_and_mean_match_jax(fn, dtype, frame):
    """COUNT reads only the ok mask, and MEAN's device outputs are SUM's
    (the host divides), so they run over fewer frames: the default, a
    doubly bounded one and one wider than the data."""
    _run_window(fn, frame, dtype=dtype)


def test_window_device_whole_table_no_keys():
    """No PARTITION BY and no ORDER BY: one segment over every row."""
    _run_window("sum", None, has_part=False, has_order=False,
                dtype="float")
    _run_window("row_number", None, has_part=False, has_order=False)


# ------------------------------------------------------------ window_column

def _both_window_column(fn, n, part, order, vals=None, vok=None, **kw):
    """window_column in both packages; part/order hold host keys, with
    device entries (JAX arrays, torch tensors) made where asked."""
    def keys(lib, entries, is_order):
        out = []
        for e in entries:
            v, ok = e[0], e[1]
            desc = e[2] if is_order else None
            if is_order:
                d = (JSortDir if lib == "jax" else PSortDir)(
                    bool(desc), getattr(desc, "nulls_first", False)) \
                    if desc is not None else False
                base = (v, ok, d)
            else:
                base = (v, ok)
            if e[-1] == "dev":
                dv = jnp.asarray(v) if lib == "jax" else t(v)
                dok = None if ok is None else (
                    jnp.asarray(ok) if lib == "jax" else t(ok))
                base = base + ((dv, dok),)
            out.append(base)
        return out

    want = jw.window_column(fn, n, keys("jax", part, False),
                            keys("jax", order, True), vals, vok, **kw)
    got = pw.window_column(fn, n, keys("torch", part, False),
                           keys("torch", order, True), vals, vok,
                           device="cpu", **kw)
    assert (got is None) == (want is None)
    if want is None:
        return None
    assert got[0] == want[0]
    gp, wp = got[1], want[1]
    if isinstance(wp, tuple):
        for g, w in zip(gp, wp):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    else:
        assert gp.dtype == wp.dtype
        np.testing.assert_array_equal(gp, wp)
    return got


@pytest.fixture
def low_thresholds(monkeypatch):
    for m in (jw, pw):
        monkeypatch.setattr(m, "DEVICE_WINDOW_MIN_ROWS", 1)


def _keys(seed, n=1200):
    rng = np.random.default_rng(seed)
    part_i = rng.integers(0, 9, n).astype(np.int32)
    part_ok = rng.random(n) > 0.1
    part_s = rng.choice(np.array(["x", "yy", "z"], object), n)
    order_i = rng.integers(-50, 50, n).astype(np.int32)
    order_ok = rng.random(n) > 0.2
    return part_i, part_ok, part_s, order_i, order_ok


FNS = ["row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
       "lag", "lead", "ntile", "first_value", "last_value", "nth_value",
       "count", "sum", "mean", "min", "max"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("nulls_first", [False, True])
def test_window_column_matches_jax(low_thresholds, fn, nulls_first):
    """Host and device-resident keys, NULL keys sorted last or (NULLS
    FIRST) first, int and float values; payloads exact."""
    n = 1200
    part_i, part_ok, part_s, order_i, order_ok = _keys(10)
    rng = np.random.default_rng(11)
    vi = rng.integers(-10**6, 10**6, n).astype(np.int64)
    vf = rng.integers(-400, 400, n) / 8.0
    vok = rng.random(n) > 0.1
    desc_nf = PSortDir(True, nulls_first)
    part = [(part_i, part_ok, "dev"), (part_s, None, "host")]
    order = [(order_i, order_ok, desc_nf, "dev")]
    offset = {"lag": 2, "lead": 1, "ntile": 5, "nth_value": 2}.get(fn, 1)
    value_fn = fn in ("count", "sum", "mean", "min", "max")
    for vals, is_int in ((vi, True), (vf, False)):
        for frame in ([None, ("rows", -3, 2)] if fn not in RANKING
                      else [None]):
            _both_window_column(
                fn, n, part, order, vals if value_fn else None,
                vok if value_fn else None, offset=offset, is_int=is_int,
                frame=frame)
        if not value_fn:
            break


def test_window_column_all_null_and_no_keys(low_thresholds):
    n = 300
    z = np.zeros(n, np.int32)
    none_ok = np.zeros(n, bool)
    vals = np.arange(n, dtype=np.int32)
    for fn in ("sum", "rank", "count"):
        _both_window_column(fn, n, [(z, none_ok, "dev")],
                            [(vals, none_ok, False, "dev")],
                            vals if fn != "rank" else None, None,
                            is_int=True)
    _both_window_column("row_number", n, [], [])
    _both_window_column("count", n, [], [], None, None)


def test_window_column_partition_guard(monkeypatch):
    """A partition at _MAX_EXACT_PARTITION rows sends int SUM/AVG to the
    host (None) in both packages; float sums and counts stay on the
    device."""
    for m in (jw, pw):
        monkeypatch.setattr(m, "DEVICE_WINDOW_MIN_ROWS", 1)
        monkeypatch.setattr(m, "_MAX_EXACT_PARTITION", 256)
    n = 300
    part = [(np.zeros(n, np.int32), None, "host")]
    ints = np.ones(n, np.int32)
    assert _both_window_column("sum", n, part, [], ints, None,
                               is_int=True) is None
    assert _both_window_column("mean", n, part, [], ints, None,
                               is_int=True) is None
    assert _both_window_column("sum", n, part, [], ints / 2, None,
                               is_int=False) is not None
    assert _both_window_column("count", n, part, [], ints, None,
                               is_int=True) is not None
    small = [(np.arange(n, dtype=np.int32) % 3, None, "dev")]
    assert _both_window_column("sum", n, small, [], ints, None,
                               is_int=True) is not None


def test_window_column_ineligible_returns(low_thresholds):
    n = 64
    part = [(np.zeros(n, np.int32), None, "host")]
    mixed = [(np.array([1, "a"] * 32, object), None, "host")]
    cases = [
        ("sum", part, np.full(n, 0.1), False),        # not float32-exact
        ("sum", part, np.full(n, 2**40), True),       # past int32
        ("min", part, np.array(["a"] * n, object), False),  # text values
        ("sum", part, None, True),                    # no values
        ("sum", part, np.arange(n, dtype=np.float64), True),  # int sum
        ("row_number", mixed, None, False),           # keys don't sort
    ]
    for fn, keys, vals, is_int in cases:
        assert _both_window_column(fn, n, keys, [], vals, None,
                                   is_int=is_int) is None, (fn, vals)


def test_window_column_below_threshold_is_none():
    n = 100
    assert pw.window_column("row_number", n, [], [], device="cpu") is None
    assert jw.window_column("row_number", n, [], []) is None


def test_window_column_cache_shares_the_sort(low_thresholds):
    """Items of one OVER clause share the key prep and the sort; an
    ineligible clause is remembered."""
    n = 500
    part_i, part_ok, _s, order_i, order_ok = _keys(12, n)
    cache = {}
    part = [(part_i, part_ok, (t(part_i), t(part_ok)))]
    order = [(order_i, order_ok, False)]
    a = pw.window_column("rank", n, part, order, cache=cache, device="cpu")
    perm = cache["prep"][4]
    b = pw.window_column("row_number", n, part, order, cache=cache,
                         device="cpu")
    assert cache["prep"][4] is perm and a[0] == b[0] == "int"
    bad = {}
    mixed = [(np.array([1, "a"] * (n // 2), object), None)]
    assert pw.window_column("rank", n, mixed, [], cache=bad,
                            device="cpu") is None
    assert bad == {"ineligible": True}
