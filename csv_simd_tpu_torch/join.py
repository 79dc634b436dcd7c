"""Device equi-join between two CSV tapes (csv_simd_tpu/join.py, in
PyTorch).

The reference serves one file at a time (record_source.rs); relating
two files is entirely the caller's problem. Here the match runs where
the parsed keys live: both key columns parse on device
(device_tape.py), the right side sorts once (two stable sorts), and
every left key finds its matching right-row range with two
`torch.searchsorted` probes — a sort-merge join whose per-row work is
O(log n), on the right keys' device. Only three (N,) integer vectors
(match starts, counts, and the sort permutation) ever reach the host,
where the variable-length pair expansion (the one step that cannot have
a static shape) is two `np.repeat`s.

Text keys factorize jointly on host (one np.unique over both sides'
decoded values) and merge on the dense codes, so `"AAPL"` joins
`'"AAPL"'`-quoted fields. Rows whose key fails its typed parse never
match (SQL NULL semantics). The full join family is one sort-merge:
`how` = inner | left | right (sides swapped) | outer (both unmatched
sets kept) | semi / anti (existence filters over left rows).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .device_tape import _host
from .frame import Col, parse_spec
from .query import (
    _INT32_MAX,
    _field_index,
    _host_key_column,
    _parse_column,
    _to_dev,
    infer_col,
    select_records,
)


def _merge_device(l_keys, l_ok, r_keys, r_ok):
    """Left keys vs right keys -> (starts, counts, right sort order).
    Invalid right rows take the max sentinel and a validity-second
    stable sort, so they form the array's tail: clamping the upper
    bound to the valid count excludes them even when legit keys equal
    the sentinel. Both key tensors share one dtype (int32 or float32)
    and the right keys' device."""
    sent = torch.inf if r_keys.dtype == torch.float32 else _INT32_MAX
    rk = torch.where(r_ok, r_keys, sent)
    order = torch.sort(rk, stable=True).indices
    order = order[torch.sort((~r_ok).to(torch.int32)[order],
                             stable=True).indices]
    sk = rk[order]
    n_valid = r_ok.sum(dtype=torch.int32)
    lo = torch.searchsorted(sk, l_keys, side="left").to(torch.int32)
    hi = torch.searchsorted(sk, l_keys, side="right").to(torch.int32)
    hi = torch.minimum(hi, n_valid)
    counts = torch.where(l_ok, torch.clamp(hi - lo, min=0), 0)
    return lo, counts, order


def _expand_pairs(l_ids, starts, counts, sorted_right_ids, how: str):
    """Host pair expansion: left row i matches sorted right positions
    [starts[i], starts[i]+counts[i])."""
    counts = counts.astype(np.int64)
    if how in ("semi", "anti"):
        # existence joins: each qualifying left row exactly once.
        # semi pairs the row with its FIRST match (in right key-sort
        # order); anti keeps rows with no match, right id -1.
        m = counts > 0 if how == "semi" else counts == 0
        out_l = l_ids[m]
        if how == "semi":
            out_r = sorted_right_ids[starts.astype(np.int64)[m]]
        else:
            out_r = np.full(out_l.shape[0], -1, np.int32)
        return out_l.astype(np.int32), np.asarray(out_r, np.int32)
    l_rep = np.repeat(np.arange(l_ids.shape[0]), counts)
    grp = np.repeat(starts.astype(np.int64), counts)
    offs = (np.arange(counts.sum(), dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
    out_l = l_ids[l_rep]
    out_r = sorted_right_ids[grp + offs]
    if how in ("left", "outer"):
        # append unmatched left rows (right id -1), then restore left
        # row order by each pair's left position (stable: matched
        # pairs keep their within-group order)
        miss = counts == 0
        pos = np.concatenate([l_rep, np.flatnonzero(miss)])
        out_l = np.concatenate([out_l, l_ids[miss]])
        out_r = np.concatenate(
            [out_r, np.full(int(miss.sum()), -1, out_r.dtype)]
        )
        ord2 = np.argsort(pos, kind="stable")
        out_l, out_r = out_l[ord2], out_r[ord2]
    if how == "outer":
        # then unmatched RIGHT rows (left id -1), in right-record order
        hit = np.zeros(sorted_right_ids.shape[0], bool)
        hit[grp + offs] = True
        extra_r = np.sort(sorted_right_ids[~hit])
        out_l = np.concatenate(
            [out_l, np.full(extra_r.shape[0], -1, np.int32)]
        )
        out_r = np.concatenate([out_r, extra_r])
    return out_l.astype(np.int32), out_r.astype(np.int32)


def _join_domain(col):
    """The value domain a key column's host values live in. Joint
    factorization compares raw host values, so both sides of a key
    pair must share a domain: decimals are scale-shifted int64,
    datetimes are unit-scaled epochs, dates are epoch days — none of
    which compare meaningfully against face-value ints/floats."""
    if col.type in ("str", "bytes"):
        return ("text",)
    if col.type == "decimal":
        return ("decimal", col.scale)
    if col.type == "datetime":
        return ("datetime", col.unit)
    if col.type == "date":
        return ("date",)
    return ("number",)  # int32 / float32 / float: face-value compare


def _composite_join_keys(left_tape, right_tape, ln, rn, lfs, rfs,
                         lcols, rcols, left_records, right_records,
                         dialect, sample: int):
    """Composite equi-join keys: factorize each key-column PAIR jointly
    across both sides (equal value <=> equal code, any type mix per
    column), then mixed-radix combine into one int64 code per row.
    Returns (l_codes, l_ok, r_codes, r_ok) as host arrays."""
    l_combo = r_combo = None
    l_ok = r_ok = None
    space = 1  # exact Python-int key-space size (no int64 wraparound)
    for lf, rf, lcol, rcol in zip(lfs, rfs, lcols, rcols):
        if _join_domain(lcol) != _join_domain(rcol):
            raise ValueError(
                f"join key types disagree on column pair "
                f"({ln[lf]!r}, {rn[rf]!r}): {lcol.type!r} vs "
                f"{rcol.type!r}"
            )
        lv, lo, _ = _host_key_column(left_tape, ln, lf, lcol, dialect,
                                     left_records, sample)
        rv, ro, _ = _host_key_column(right_tape, rn, rf, rcol, dialect,
                                     right_records, sample)
        uniq, inv = np.unique(np.concatenate([lv, rv]),
                              return_inverse=True)
        inv = inv.astype(np.int64)
        li, ri = inv[: lv.shape[0]], inv[lv.shape[0]:]
        l_ok = lo if l_ok is None else (l_ok & lo)
        r_ok = ro if r_ok is None else (r_ok & ro)
        space *= max(len(uniq), 1)
        if space >= 2**62:
            raise ValueError(
                "composite join-key space too large to radix-combine"
            )
        if l_combo is None:
            l_combo, r_combo = li, ri
        else:
            l_combo = l_combo * len(uniq) + li
            r_combo = r_combo * len(uniq) + ri
    return l_combo, l_ok, r_combo, r_ok


def join_records(
    left_tape, right_tape, on, *, right_on=None, how: str = "inner",
    left_names=None, right_names=None, left_spec=None, right_spec=None,
    left_records=None, right_records=None, dialect=None,
    sample: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Matched (left_ids, right_ids) record-id pairs for an equi-join.

    `on` — key column of the left tape (name or index), or a LIST of
    columns (composite equi-join: per-column joint factorization,
    mixed-radix codes, same sort-merge); `right_on`
    defaults to the same name(s). Pairs come back grouped by left row in
    left-record order, right matches in right-key sort order within a
    group. `how`:

    - "inner"              — matched pairs only
    - "left" / "right"     — plus unmatched left (right) rows, the
                             absent side's id -1; "right" runs the same
                             sort-merge with the sides swapped, so its
                             pairs group by RIGHT row in right-record
                             order
    - "outer"              — "left" plus unmatched right rows appended
                             (left id -1) in right-record order
    - "semi" / "anti"      — existence filter: each left row with >= 1
                             match (resp. no match) appears exactly
                             once; semi pairs it with its first match
                             in key order, anti with -1. Rows whose key
                             fails its typed parse count as matchless,
                             so they qualify for "anti" (set
                             complement, like the `not` predicate).

    - "cross"              — every (left, right) pair (Cartesian
                             product; `on`/`right_on` are ignored and
                             may be None), grouped by left row in
                             left-record order

    `left_records`/`right_records` restrict either side (e.g. from
    select_records pushdown)."""
    if how not in ("inner", "left", "right", "outer", "semi", "anti",
                   "cross"):
        raise ValueError(
            "how must be inner|left|right|outer|semi|anti|cross, "
            f"got {how!r}"
        )
    if how == "cross":
        l_ids = (_host(left_records).astype(np.int32)
                 if left_records is not None
                 else np.arange(_n(left_tape), dtype=np.int32))
        r_ids = (_host(right_records).astype(np.int32)
                 if right_records is not None
                 else np.arange(_n(right_tape), dtype=np.int32))
        return (np.repeat(l_ids, r_ids.size),
                np.tile(r_ids, l_ids.size))
    if how == "right":
        r_ids, l_ids = join_records(
            right_tape, left_tape,
            (right_on if right_on is not None else on), right_on=on,
            how="left", left_names=right_names, right_names=left_names,
            left_spec=right_spec, right_spec=left_spec,
            left_records=right_records, right_records=left_records,
            dialect=dialect, sample=sample,
        )
        return l_ids, r_ids

    def _names(tape, names):
        if names is not None:
            return names
        hdr = getattr(tape, "header", None)
        names = getattr(hdr, "names", None)
        if names is None:
            names = [f"c{i}" for i in range(int(tape.field_cnt))]
        return names

    ln = _names(left_tape, left_names)
    rn = _names(right_tape, right_names)
    l_ids = (_host(left_records).astype(np.int32)
             if left_records is not None
             else np.arange(_n(left_tape), dtype=np.int32))
    r_ids = (_host(right_records).astype(np.int32)
             if right_records is not None
             else np.arange(_n(right_tape), dtype=np.int32))
    if isinstance(on, (list, tuple)):
        # composite join key: per-column joint factorization ->
        # mixed-radix codes -> the same single-key sort-merge
        ron = (list(right_on) if right_on is not None else list(on))
        if len(ron) != len(on):
            raise ValueError(
                f"right_on has {len(ron)} columns for {len(on)} left "
                "key columns"
            )
        lfs = [_field_index(ln, k) for k in on]
        rfs = [_field_index(rn, k) for k in ron]
        lspecs = (list(left_spec) if left_spec is not None
                  else [None] * len(on))
        rspecs = (list(right_spec) if right_spec is not None
                  else [None] * len(on))
        lcols = [parse_spec(s) if s is not None
                 else infer_col(left_tape, ln, f, sample)
                 for s, f in zip(lspecs, lfs)]
        rcols = [parse_spec(s) if s is not None
                 else infer_col(right_tape, rn, f, sample)
                 for s, f in zip(rspecs, rfs)]
        lc, lok, rc, rok = _composite_join_keys(
            left_tape, right_tape, ln, rn, lfs, rfs, lcols, rcols,
            left_records, right_records, dialect, sample,
        )
        return _join_host_i64(lc, np.asarray(lok, bool),
                              rc, np.asarray(rok, bool),
                              l_ids, r_ids, how)
    lf = _field_index(ln, on)
    rf = _field_index(rn, right_on if right_on is not None else on)
    lcol = (parse_spec(left_spec) if left_spec is not None
            else infer_col(left_tape, ln, lf, sample))
    rcol = (parse_spec(right_spec) if right_spec is not None
            else infer_col(right_tape, rn, rf, sample))

    if _join_domain(lcol) != _join_domain(rcol):
        raise ValueError(
            "join key types disagree: "
            f"left {lcol.type!r} vs right {rcol.type!r}"
        )
    text = lcol.type in ("str", "bytes")
    if text:
        lv, lok, _ = _host_key_column(left_tape, ln, lf, lcol, dialect,
                                      left_records, sample)
        rv, rok, _ = _host_key_column(right_tape, rn, rf, rcol, dialect,
                                      right_records, sample)
        # joint factorization: equal text <=> equal code
        uniq, inv = np.unique(np.concatenate([lv, rv]),
                              return_inverse=True)
        if len(uniq) >= 2**31 - 1:  # pragma: no cover - absurd corpus
            raise ValueError("too many distinct join keys")
        dev = right_tape.device
        lk = _to_dev(inv[: lv.shape[0]].astype(np.int32), dev, torch.int32)
        rk = _to_dev(inv[lv.shape[0]:].astype(np.int32), dev, torch.int32)
        lokj, rokj = (_to_dev(lok, dev, torch.bool),
                      _to_dev(rok, dev, torch.bool))
    else:
        lv, lok, lkind = _parse_column(left_tape, lf, lcol, dialect,
                                       records=left_records)
        rv, rok, rkind = _parse_column(right_tape, rf, rcol, dialect,
                                       records=right_records)
        if lkind == "i64host" or rkind == "i64host":
            return _join_host_i64(_host(lv), _host(lok).astype(bool),
                                  _host(rv), _host(rok).astype(bool),
                                  l_ids, r_ids, how)
        if lv.dtype != rv.dtype:
            raise ValueError(
                "join key dtypes disagree: "
                f"left {lcol.type!r} vs right {rcol.type!r}"
            )
        # the merge runs where the right keys live; a left side on
        # another device moves its keys there
        dev = rv.device
        lk, rk = _to_dev(lv, dev, rv.dtype), rv
        lokj, rokj = (_to_dev(lok, dev, torch.bool),
                      _to_dev(rok, dev, torch.bool))
    starts, counts, order = _merge_device(lk, lokj, rk, rokj)
    return _expand_pairs(
        l_ids, _host(starts), _host(counts), r_ids[_host(order)], how,
    )


def _n(tape) -> int:
    return int(getattr(tape, "num_data_records",
                       int(tape.record_cnt) - 1))


def _join_host_i64(lv, lok, rv, rok, l_ids, r_ids, how: str):
    """decimal/datetime keys: their values exist as host int64; same
    sort-merge construction in NumPy."""
    order = np.argsort(np.where(rok, rv, np.int64(2**63 - 1)),
                       kind="stable")
    order = order[np.argsort((~rok)[order], kind="stable")]
    sk = rv[order]
    n_valid = int(rok.sum())
    sk_valid = sk[:n_valid]
    lo = np.searchsorted(sk_valid, lv, side="left")
    hi = np.searchsorted(sk_valid, lv, side="right")
    counts = np.where(lok, np.maximum(hi - lo, 0), 0)
    return _expand_pairs(l_ids, lo.astype(np.int32),
                         counts.astype(np.int32), r_ids[order], how)


def join_typed(
    left_source, right_source, on, *, right_on=None, how: str = "inner",
    columns=None, right_columns=None, schema=None, right_schema=None,
    where=None, right_where=None, suffix: str = "_right", dialect=None,
    backend: str = "auto", engine: str = "offsets", sample: int = 256,
    device="cuda",
):
    """Equi-join two CSVs into one typed Frame.

    Columns from both sides materialize only for the matched pairs
    (gather by the joined record ids — the join's predicate pushdown).
    `columns`/`right_columns` restrict each side (default: all);
    colliding right names get `suffix`. `schema`/`right_schema`
    override inferred column types per side ({column: spec}) — they
    also type `where`/`right_where` predicates and the join key.
    `where`/`right_where` filter each side BEFORE the join.

    `how` accepts every join_records mode. Columns from a side absent
    in a row (right side of an unmatched "left"/"outer" row, left side
    of an unmatched "right"/"outer" row) flag not-ok / empty text
    (missing data). "semi"/"anti" produce LEFT columns only — an
    existence filter, one output row per qualifying left row.
    `frame.records` holds the left record ids (-1 for right-only
    "outer" rows). Paths and bytes are indexed on `device`; tapes and
    corpora keep their own."""
    from .frame import Frame, _materialize, _resolve_tape, infer_schema

    lt, ln = _resolve_tape(left_source, dialect, backend, engine, False,
                           device)
    rt, rn = _resolve_tape(right_source, dialect, backend, engine, False,
                           device)
    l_records = (select_records(lt, where, names=ln, schema=schema,
                                dialect=dialect, sample=sample)
                 if where is not None else None)
    r_records = (select_records(rt, right_where, names=rn,
                                schema=right_schema, dialect=dialect,
                                sample=sample)
                 if right_where is not None else None)

    def _override(names, overrides, field):
        if not overrides:
            return None
        for k, v in overrides.items():
            if names[_field_index(names, k)] == names[field]:
                return parse_spec(v)
        return None

    if how == "cross":
        l_spec = r_spec = None  # no join key to type
    elif isinstance(on, (list, tuple)):
        ron = list(right_on) if right_on is not None else list(on)
        l_spec = [_override(ln, schema, _field_index(ln, k))
                  for k in on]
        r_spec = [_override(rn, right_schema, _field_index(rn, k))
                  for k in ron]
    else:
        l_spec = _override(ln, schema, _field_index(ln, on))
        r_spec = _override(
            rn, right_schema,
            _field_index(rn, right_on if right_on is not None else on),
        )
    l_ids, r_ids = join_records(
        lt, rt, on, right_on=right_on, how=how, left_names=ln,
        right_names=rn, left_spec=l_spec, right_spec=r_spec,
        left_records=l_records, right_records=r_records,
        dialect=dialect, sample=sample,
    )

    def _side_schema(tape, names, cols, overrides) -> Dict[str, Col]:
        sel = (list(range(len(names))) if cols is None
               else [_field_index(names, c) for c in cols])
        todo = [f for f in sel if _override(names, overrides, f) is None]
        inferred = (infer_schema(tape, names, columns=todo,
                                 sample=sample) if todo else {})
        return {
            names[f]: (_override(names, overrides, f)
                       or inferred[names[f]])
            for f in sel
        }

    lsch = _side_schema(lt, ln, columns, schema)
    rsch = ({} if how in ("semi", "anti")
            else _side_schema(rt, rn, right_columns, right_schema))

    names_out: List[str] = []
    cols_out: Dict[str, np.ndarray] = {}
    oks_out: Dict[str, Optional[np.ndarray]] = {}
    schema_out: Dict[str, Col] = {}
    def _absent_flag(vals, okm, col, miss):
        """Mark rows whose side has no record (id -1) missing."""
        if not miss.any():
            return vals, okm
        if okm is None:
            vals = vals.copy()
            vals[miss] = ("" if col.type == "str" else b"")
            return vals, ~miss
        return vals, okm & ~miss

    lmiss = l_ids < 0
    l_safe = np.where(lmiss, 0, l_ids).astype(np.int32)
    for name, col in lsch.items():
        vals, okm, _dev = _materialize(lt, ln.index(name), col, dialect,
                                 False, name, records=l_safe)
        vals, okm = _absent_flag(vals, okm, col, lmiss)
        names_out.append(name)
        cols_out[name] = vals
        oks_out[name] = okm
        schema_out[name] = col
    if how not in ("semi", "anti"):
        miss = r_ids < 0
        r_safe = np.where(miss, 0, r_ids).astype(np.int32)
        for name, col in rsch.items():
            out_name = name + suffix if name in cols_out else name
            vals, okm, _dev = _materialize(rt, rn.index(name), col, dialect,
                                     False, out_name, records=r_safe)
            vals, okm = _absent_flag(vals, okm, col, miss)
            names_out.append(out_name)
            cols_out[out_name] = vals
            oks_out[out_name] = okm
            schema_out[out_name] = col
    fr = Frame(names_out, cols_out, oks_out, schema_out,
               int(l_ids.shape[0]))
    fr.records = l_ids
    return fr
