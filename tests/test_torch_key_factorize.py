"""Text GROUP BY keys factorized on the device
(query._factorize_text_device) against object-dtype np.unique over the
same Python `bytes`, and GROUP BY over text keys against the JAX
package, on the CPU.

The helper packs each key's bytes big-endian into int64 words with the
length last, so its code order has to be Python `bytes` order: embedded
NULs, bytes >= 0x80, the empty key and true prefixes (b"a" < b"a\\x00" <
b"ab") are where a packed order could differ, and lengths 0-17 put keys
on both sides of each 7-byte word. Group keys, their order, counts and
sums are exact against the JAX package."""

import numpy as np
import pytest
import torch

import csv_simd_tpu as jx
import csv_simd_tpu_torch as pt
from csv_simd_tpu_torch import device_tape as pdt
from csv_simd_tpu_torch import query as pq
from csv_simd_tpu_torch.query import _factorize_text_device, _gather_text_key

from test_torch_gpu import KEY_CASES, key_batch, lineitem_flags, relational_csv
from test_torch_query import FLOAT_RTOL, same


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _object_unique(keys, valid):
    """What the host path computed: np.unique over the valid rows' bytes."""
    arr = np.empty(len(keys), object)
    arr[:] = list(keys)
    return np.unique(arr[np.asarray(valid, bool)], return_inverse=True)


def _check(out, lengths, valid, keys):
    """The helper's codes, validity and distinct keys against
    _object_unique over `keys` (the valid rows' bytes)."""
    codes, ok, table = _factorize_text_device(out, lengths, valid)
    uniq = table[np.arange(len(table))]
    v = valid.numpy()
    want_uniq, want_inv = _object_unique(keys, v)
    assert uniq.dtype == object and list(uniq) == list(want_uniq)
    assert all(type(k) is bytes for k in uniq)
    assert codes.dtype == torch.int32 and torch.equal(ok, valid)
    np.testing.assert_array_equal(codes.numpy()[v], want_inv)
    assert not codes.numpy()[~v].any()


@pytest.mark.parametrize("length", [0, 1, 6, 7, 8, 9, 15, 16, 17])
def test_keys_on_both_sides_of_a_word_boundary(length):
    """Keys of `length` bytes beside their prefixes and NUL, 0xFF and
    one-less extensions, in a window as wide as the longest key and in
    one wider."""
    base = b"k" * length
    keys = [base, base[:-1], base + b"\x00", base + b"\xff", base[:-1] + b"j",
            b"\x00" * length, b"\xff" * length, base[:1], b""]
    keys = keys * 3
    valid = [i % 7 != 3 for i in range(len(keys))]
    longest = max(len(k) for k in keys)
    for width in (longest, longest + 9):
        _check(*key_batch(keys, valid, width, seed=length), keys)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("width", [17, 32])
def test_adversarial_keys_match_object_unique(seed, width):
    rng = np.random.default_rng(seed)
    keys = [KEY_CASES[i] for i in rng.integers(0, len(KEY_CASES), 400)]
    _check(*key_batch(keys, rng.random(400) > 0.15, width, seed), keys)


def test_true_prefixes_sort_before_their_extensions():
    keys = [b"ab", b"a\x00", b"a", b"", b"a\x00", b"\x00", b"b"]
    out, ln, v = key_batch(keys, [True] * len(keys), 8)
    codes, _, table = _factorize_text_device(out, ln, v)
    uniq = table[np.arange(len(table))]
    assert list(uniq) == [b"", b"\x00", b"a", b"a\x00", b"ab", b"b"]
    assert codes.tolist() == [4, 3, 2, 0, 3, 1, 5]


@pytest.mark.parametrize("keys,valid", [
    ([], []), ([b"x"], [True]), ([b"x"], [False]), ([b""], [True]),
    ([b"a", b"b", b"c"], [False, False, False])])
def test_no_rows_one_row_and_no_valid_row(keys, valid):
    _check(*key_batch(keys, valid, 16), keys)


def test_lineitem_flag_columns_match_object_unique():
    for out, ln, v in lineitem_flags(5000, 3):
        keys = [bytes(r[:1]) for r in out.numpy()]
        _check(out, ln, v, keys)


TEXT_CSV = (b'id,s,n\n'
            + b"".join(f"{i},{s},{i % 5}\n".encode() for i, s in enumerate(
                ['"a""b"', '  pad  ', '"  q  "', '', '"x,y"', 'a', ' a',
                 'a ', '""', '"a"', 'café', '"say ""hi"""', '\t a\t',
                 'a\\b', '"multi\nline"', 'abcdefghijklmnopq', 'abcdefgh',
                 'abcdefg'] * 4)))


@pytest.mark.parametrize("engine", ["offsets", "packed"])
@pytest.mark.parametrize("trim", [True, False])
def test_decoded_tape_keys_match_object_unique(engine, trim):
    """Quoted fields with `""`, trimmed and untrimmed spaces, a quoted
    newline, and invalid rows (record ids out of range), gathered from a
    tape of each engine."""
    tape, names = pt.frame._resolve_tape(TEXT_CSV, None, "auto", engine,
                                         False, "cpu")
    n = pq._data_records(tape)
    records = np.concatenate([np.arange(n), [-1, n, n + 7, 3, 0]])
    col = pt.Col("str", trim=trim)
    out, ln, v = _gather_text_key(tape, 1, col, None, records)
    keys = [b"" if k is None else k for k in tape.to_host_lists(out, ln, v)]
    _check(out, ln, v, keys)
    assert not v.numpy()[n:n + 3].any() and len(set(keys)) > 10


def _wide_keys_csv(n: int, seed: int) -> bytes:
    """Three columns with n distinct values each (two text, one int), in
    shuffled orders: their composite key space n**3 passes 2**31 - 1."""
    rng = np.random.default_rng(seed)
    a, b, c = (rng.permutation(n) for _ in range(3))
    rows = ["a,b,c,v"] + [f"x{a[i]},{b[i] * 7 - 300},yé{c[i]:05d},{i}"
                          for i in range(n)]
    return ("\n".join(rows) + "\n").encode()


WIDE = _wide_keys_csv(1400, 5)
DATA = relational_csv(23)
SCHEMA = {"id": "int32", "k": "int32", "v": "int32", "f": "float32",
          "day": "date", "s": "str", "t": "str", "a": "str", "b": "int32",
          "c": "str"}
GROUPS = [  # (source, key, key spec, value)
    ("data", "s", "str", "v"),
    ("data", "t", "bytes", "v"),
    ("data", ["t", "s"], ["str", "str"], "f"),
    ("data", ["s", "k"], ["str", "int32"], "v"),
    ("data", ["t", "day"], ["str", "date"], ["v", "f"]),
    ("data", ["k", "s"], ["int32", "bytes"], "id"),
    ("wide", ["a", "b", "c"], ["str", "int32", "str"], "v"),
]


@pytest.mark.parametrize("engine", ["offsets", "packed"])
@pytest.mark.parametrize("source,key,spec,value", GROUPS)
def test_text_key_group_by_matches_jax(engine, source, key, spec, value):
    """Keys, their order, counts and integer sums exact; float32 sums
    within rtol=1e-5. The last case's key space passes 2**31 - 1 and
    groups on the device as int64 codes."""
    csv = WIDE if source == "wide" else DATA
    vspec = ([SCHEMA[c] for c in value] if isinstance(value, list)
             else SCHEMA[value])
    kw = dict(key_spec=spec, value_spec=vspec, schema=SCHEMA, engine=engine)
    same(pt.groupby_typed(csv, key, value, device="cpu", **kw),
         jx.groupby_typed(csv, key, value, **kw), FLOAT_RTOL)
    if source == "wide":
        tape, names = pt.frame._resolve_tape(csv, None, "auto", engine,
                                             False, "cpu")
        kind, codes, ok, _ = pq._prepare_group_keys(
            tape, names, key, spec, None, None, 256)
        assert kind == "device" and codes.dtype == torch.int64
        assert int(codes.max()) >= 2**31 - 1


@pytest.mark.parametrize("key,spec", [("t", "str"), (["t", "s"],
                                                     ["str", "str"])])
def test_text_group_by_reads_back_only_the_distinct_keys(monkeypatch, key,
                                                         spec):
    """The text key columns cross to the host as their G distinct keys:
    _to_host_lists receives G rows a column, never the table's N."""
    seen = []
    real = pdt._to_host_lists

    def counted(out, *a, **k):
        seen.append(out.shape[0])
        return real(out, *a, **k)

    monkeypatch.setattr(pdt, "_to_host_lists", counted)
    r = pt.groupby_typed(DATA, key, "id", key_spec=spec, value_spec="int32",
                         device="cpu")
    keys = r["keys"] if isinstance(key, list) else [r["keys"]]
    n = len(DATA.splitlines()) - 1
    assert seen == [len(set(k)) for k in keys]
    assert max(seen) * 10 < n
