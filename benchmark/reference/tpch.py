"""Plain references of the TPC-H statements the SQL cells run, in NumPy
over the reference's own columns (reference/columns.py): each computes
the statement's result in float64 from the exact decimals. The controls
compute it lower: dtype="bfloat16" holds every value, product and sum in
bfloat16; dtype="bfloat16_values" rounds only the column values to
bfloat16 (a column stored in bfloat16) and computes the rest in float64.

Each statement function takes (columns, params, dtype) and returns
{output column: array}, rows in the statement's ORDER BY.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

_EPOCH = _dt.date(1970, 1, 1)


def _day(s: str) -> int:
    return (_dt.date.fromisoformat(s) - _EPOCH).days


class _Arith:
    """float64 NumPy arithmetic, or bfloat16 through torch on the CPU with
    every result rounded to bfloat16 (sums accumulate in bfloat16, one
    row after another), or float64 arithmetic on values rounded to
    bfloat16."""

    def __init__(self, dtype: str):
        if dtype not in ("float64", "bfloat16", "bfloat16_values"):
            raise ValueError(f"unknown precision {dtype!r}")
        self.bf16 = dtype == "bfloat16"
        self.round_values = dtype == "bfloat16_values"

    def value(self, x: np.ndarray):
        if not (self.bf16 or self.round_values):
            return x
        import torch

        v = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return v if self.bf16 else v.double().numpy()

    def sums(self, x, inv: np.ndarray, groups: int) -> np.ndarray:
        if not self.bf16:
            return np.bincount(inv, weights=x, minlength=groups)
        import torch

        # index_add_ on the CPU adds one row after another into bfloat16
        out = torch.zeros(groups, dtype=torch.bfloat16).index_add_(
            0, torch.from_numpy(inv), x)
        return out.double().numpy()

    def rows(self, x, rows: np.ndarray):
        if not self.bf16:
            return x[rows]
        import torch

        return x[torch.from_numpy(rows)]

    def mean(self, total: np.ndarray, count: np.ndarray) -> np.ndarray:
        m = total / count
        if not self.bf16:
            return m
        import torch

        return torch.from_numpy(m).to(torch.bfloat16).double().numpy()


def q1(cols, params: dict, dtype: str = "float64") -> dict:
    """TPC-H Q1: per (l_returnflag, l_linestatus) over l_shipdate <=
    params["shipdate_le"], the sums, means and count, by flag and
    status."""
    a = _Arith(dtype)
    keep = cols.date_days("l_shipdate") <= _day(params["shipdate_le"])
    key = (cols.code("l_returnflag").astype(np.int64) * 256
           + cols.code("l_linestatus"))
    groups, inv = np.unique(key[keep], return_inverse=True)
    rows = np.flatnonzero(keep)
    g = groups.size

    def dec(name):
        return a.value(cols.decimal(name))

    qty, price = dec("l_quantity"), dec("l_extendedprice")
    disc, tax = dec("l_discount"), dec("l_tax")
    one = a.value(np.ones(1))
    disc_price = price * (one - disc)
    charge = disc_price * (one + tax)

    def gsum(x):
        return a.sums(a.rows(x, rows), inv, g)

    count = np.bincount(inv, minlength=g)
    out = {
        "l_returnflag": np.array([chr(k >> 8) for k in groups], object),
        "l_linestatus": np.array([chr(k & 0xFF) for k in groups], object),
        "sum_qty": gsum(qty),
        "sum_base_price": gsum(price),
        "sum_disc_price": gsum(disc_price),
        "sum_charge": gsum(charge),
        "count_order": count,
    }
    out["avg_qty"] = a.mean(out["sum_qty"], count)
    out["avg_price"] = a.mean(out["sum_base_price"], count)
    out["avg_disc"] = a.mean(gsum(disc), count)
    return out


def q6(cols, params: dict, dtype: str = "float64") -> dict:
    """TPC-H Q6: the sum of l_extendedprice * l_discount over a year of
    ship dates, a discount band (inclusive) and quantity below a bound."""
    a = _Arith(dtype)
    ship = cols.date_days("l_shipdate")
    disc = cols.decimal("l_discount")
    qty = cols.decimal("l_quantity")
    dlo, dhi = params["discount_between"]
    # the values are whole cents, so a nano-unit margin makes BETWEEN's
    # bounds inclusive on the exact decimals
    keep = ((ship >= _day(params["shipdate_ge"]))
            & (ship < _day(params["shipdate_lt"]))
            & (disc >= dlo - 1e-9) & (disc <= dhi + 1e-9)
            & (qty < params["quantity_lt"]))
    rev = a.value(cols.decimal("l_extendedprice")) * a.value(disc)
    rows = np.flatnonzero(keep)
    return {"revenue": a.sums(a.rows(rev, rows),
                              np.zeros(rows.size, np.int64), 1)}
