"""Plain references of the ClickBench statements the hits cell runs, in
NumPy and Python over the file's bytes and the reference's own structural
index (reference/columns.py): text fields are decoded as RFC 4180 says,
integers parsed into exact Python ints, and each statement's full result
is given in its ORDER BY, the group key breaking ties.

The control dtype="bfloat16" holds every count in bfloat16, added one
row after another as torch's index_add_ does on the CPU, so a program
that counted in bfloat16 is called wrong (a bfloat16 count stops at 256).

Each statement function takes (columns, params, dtype) and returns
{output column: array}, rows in the statement's ORDER BY.
"""

from __future__ import annotations

import re

import numpy as np

_QUOTE = b'"'
_INT = re.compile(rb"[+-]?[0-9]+")


def _check_dtype(dtype: str) -> bool:
    if dtype not in ("float64", "bfloat16"):
        raise ValueError(f"unknown precision {dtype!r}")
    return dtype == "bfloat16"


def _fields(cols, name: str) -> list:
    """Every data record's field `name` as raw bytes, from the index."""
    def parse(field):
        raw = cols._cache.get(("bytes", None))
        if raw is None:
            raw = cols._cache[("bytes", None)] = cols.data.tobytes()
        jump = cols.jump
        n = (cols.index.size - 1) // jump - 1
        slot = (np.arange(n, dtype=np.int64) + 1) * jump + field
        start = (cols.index[slot] + 1).tolist()
        end = cols.index[slot + 1].tolist()
        return [raw[a:b] for a, b in zip(start, end)]
    return cols._get("raw", name, parse)


def _decode(v: bytes) -> bytes:
    """A field as the str type reads it: spaces and tabs around it
    stripped, then one pair of enclosing quotes removed with each
    doubled quote inside made single."""
    v = v.strip(b" \t")
    if len(v) >= 2 and v[:1] == _QUOTE and v[-1:] == _QUOTE:
        v = v[1:-1].replace(_QUOTE + _QUOTE, _QUOTE)
    return v


def text(cols, name: str) -> list:
    """The decoded text of every record's field `name`, as bytes."""
    return cols._get("text", name,
                     lambda f: [_decode(v) for v in _fields(cols, name)])


def integers(cols, name: str, bits: int) -> tuple:
    """(values int64, ok bool) of a `bits`-bit signed integer column:
    leading spaces, an optional sign and digits to the end of the field;
    anything else, or a value outside the range, is NULL (ok False)."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1

    def parse(field):
        vals, ok = [], []
        for v in _fields(cols, name):
            v = v.lstrip(b" ")
            x = int(v) if _INT.fullmatch(v) else None
            good = x is not None and lo <= x <= hi
            vals.append(x if good else 0)
            ok.append(good)
        return np.array(vals, np.int64), np.array(ok, bool)
    return cols._get(f"int{bits}", name, parse)


def _counts(inv: np.ndarray, groups: int, bf16: bool) -> np.ndarray:
    """Rows a group, int64; under bfloat16 added up in bfloat16."""
    if not bf16:
        return np.bincount(inv, minlength=groups).astype(np.int64)
    import torch

    out = torch.zeros(groups, dtype=torch.bfloat16).index_add_(
        0, torch.from_numpy(inv.astype(np.int64)),
        torch.ones(inv.size, dtype=torch.bfloat16))
    return out.float().numpy().astype(np.int64)


def _top(count: np.ndarray, key_order: np.ndarray, limit: int) -> np.ndarray:
    """The `limit` groups first by count descending, then by the group
    key ascending (key_order: each group's rank in key order)."""
    return np.lexsort((key_order, -count))[:limit]


def _top_text(values: list, keep, params: dict, key: str,
              bf16: bool) -> dict:
    """GROUP BY a text key, COUNT(*) AS c, ORDER BY c DESC, key LIMIT k."""
    kept = [v for v, k in zip(values, keep) if k]
    uniq = sorted(set(kept))  # bytes order, the key's order
    code = {v: i for i, v in enumerate(uniq)}
    inv = np.array([code[v] for v in kept], np.int64)
    count = _counts(inv, len(uniq), bf16)
    top = _top(count, np.arange(len(uniq)), int(params["limit"]))
    return {key: np.array([uniq[i].decode("utf-8", "replace") for i in top],
                          object),
            "c": count[top]}


def q9(cols, params: dict, dtype: str = "float64") -> dict:
    """SELECT RegionID, COUNT(DISTINCT UserID) AS u FROM hits GROUP BY
    RegionID ORDER BY u DESC, RegionID LIMIT k: a NULL UserID is not
    counted, and a region whose users are all NULL counts 0."""
    bf16 = _check_dtype(dtype)
    region, rok = integers(cols, "RegionID", 32)
    user, uok = integers(cols, "UserID", 64)
    regions, rinv = np.unique(region[rok], return_inverse=True)
    pairs = np.unique(np.stack([rinv, user[rok]], 1)[uok[rok]], axis=0)
    u = _counts(pairs[:, 0], regions.size, bf16)
    top = _top(u, np.arange(regions.size), int(params["limit"]))
    return {"RegionID": regions[top], "u": u[top]}


def q13(cols, params: dict, dtype: str = "float64") -> dict:
    """SELECT SearchPhrase, COUNT(*) AS c FROM hits WHERE SearchPhrase
    <> '' GROUP BY SearchPhrase ORDER BY c DESC, SearchPhrase LIMIT k."""
    bf16 = _check_dtype(dtype)
    phrase = text(cols, "SearchPhrase")
    return _top_text(phrase, [v != b"" for v in phrase], params,
                     "SearchPhrase", bf16)


def q16(cols, params: dict, dtype: str = "float64") -> dict:
    """SELECT UserID, COUNT(*) AS c FROM hits GROUP BY UserID ORDER BY c
    DESC, UserID LIMIT k."""
    bf16 = _check_dtype(dtype)
    user, ok = integers(cols, "UserID", 64)
    users, inv = np.unique(user[ok], return_inverse=True)
    c = _counts(inv, users.size, bf16)
    top = _top(c, np.arange(users.size), int(params["limit"]))
    return {"UserID": users[top], "c": c[top]}


def q21(cols, params: dict, dtype: str = "float64") -> dict:
    """SELECT COUNT(*) FROM hits WHERE URL LIKE '%<contains>%'."""
    bf16 = _check_dtype(dtype)
    needle = params["contains"].encode()
    hit = np.array([needle in v for v in text(cols, "URL")], bool)
    n = _counts(np.zeros(int(hit.sum()), np.int64), 1, bf16)
    return {"count": n}


def q34(cols, params: dict, dtype: str = "float64") -> dict:
    """SELECT URL, COUNT(*) AS c FROM hits GROUP BY URL ORDER BY c DESC,
    URL LIMIT k."""
    bf16 = _check_dtype(dtype)
    url = text(cols, "URL")
    return _top_text(url, [True] * len(url), params, "URL", bf16)
