"""Device-side relational ops over typed CSV columns
(csv_simd_tpu/query.py, in PyTorch).

The reference stops at serving field text (record_source.rs:104-140);
anything relational — filters, aggregates, group-bys — happens in
whatever the caller writes on the host. Here those ops run where the
parsed values already live: in device memory, as tensors on the tape's
device produced by the device parsers (device_tape.py). The JAX
package's jitted functions are torch ops here, on `tape.device`; what is
host NumPy there is host NumPy here. Every device -> host read goes
through `device_tape._host`, and every host -> device move names its
device and dtype (`_to_dev`), writing int32 where the JAX package's
64-bit-off canonicalisation made int64 int32. Three layers:

- predicates: `select_records(tape, where, ...)` evaluates comparisons
  against typed columns on device and returns matching record ids;
  `frame.read_typed(..., where=...)` uses it as predicate pushdown, so
  non-matching rows are never gathered, parsed, or shipped to host.
- aggregates: `column_stats` computes count/sum/min/max/mean over a
  column without materializing the values on host. Integer sums are
  EXACT int64: the int32 values are split into 16-bit halves whose
  per-chunk partial sums provably fit int32, and the handful of chunk
  partials combine on host as Python ints. Float sums reduce per-chunk
  in float32 and combine on host in float64.
- group-by: `group_aggregate` sorts the key column on device (stable
  sort), derives segment ids from key-change flags, and reduces values
  with segment ops (`index_add_`, `scatter_reduce`); only the per-group
  results leave the device. Integer group sums use a 3-component digit
  split (exact for groups up to ~1M rows, checked). Text GROUP BY keys
  factorize on the device as well (`_factorize_text_device`; host
  NumPy in the JAX package), and so do the typed columns of a composite
  key (`_factorize_values_device`; int64 codes where the key space
  passes int32): only the distinct keys read back leave it.
  `groupby_topk` also orders the groups on the device by their counts
  and keys and reads back only the first k (SQL's ORDER BY COUNT(...)
  LIMIT k), with COUNT(DISTINCT) counted there per group.

Predicate grammar (the `where` argument): a single predicate or a list
(AND semantics). Each predicate is `(column, op, value)` with op one of
`== != < <= > >= between in startswith endswith contains isnull
notnull`; `between` takes `(lo, hi)` inclusive, `in` a list of values,
`isnull`/`notnull` test typed-parse failure (value ignored — text
columns are never null). Predicates compose
into boolean trees with `("and", [exprs])`, `("or", [exprs])` and
`("not", expr)`; `not` is a pure set complement, so rows excluded by a
leaf because their column failed its typed parse ARE selected by the
negation (unlike SQL's three-valued NOT — add an explicit validity
predicate if parse failures must stay excluded).
startswith/endswith/contains match str/bytes columns on device (all
window alignments compare in one gathered tensor). String predicates
compare against the stage-2 DECODED field (trim/unquote/unescape), so
`("sym", "==", "AAPL")` matches `"AAPL"`-quoted fields too. Rows whose predicate column fails
its typed parse are excluded (they cannot satisfy a typed comparison).
"""

from __future__ import annotations

import dataclasses
import operator as _op
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .device_tape import _ftz, _host
from .frame import Col, parse_spec
from .utils.metrics import GLOBAL

_CHUNK = 8192  # 16-bit half sums: 8192 * 65535 < 2**31 — int32-exact
_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)

_OPS = ("==", "!=", "<", "<=", ">", ">=", "between", "in",
        "startswith", "endswith", "contains", "like", "isnull", "notnull")
_STR_OPS = ("startswith", "endswith", "contains")

_PY_OPS = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
           ">": _op.gt, ">=": _op.ge}


# ----------------------------------------------------------------- stats

@dataclasses.dataclass(frozen=True)
class Stats:
    """Column aggregate result. `count` is the number of rows examined,
    `ok_count` how many passed the typed parse (aggregates cover only
    those). sum/min/max/mean are None when the type has no numeric
    aggregate (str/bytes) or ok_count == 0. Integer sums are exact.
    `sum_sq` (when computed) is the sum of squared values in float64 —
    squares accumulate in f32 chunks on device, so var/std carry ~1e-7
    relative error (the values themselves stay exact)."""

    count: int
    ok_count: int
    sum: Optional[Union[int, float]]
    min: Optional[Union[int, float]]
    max: Optional[Union[int, float]]
    # compare=False: f32 chunk sums are not bit-stable across different
    # partitionings, and exact-field equality is the API contract
    sum_sq: Optional[float] = dataclasses.field(default=None,
                                                compare=False)

    @property
    def mean(self) -> Optional[float]:
        if self.sum is None or self.ok_count == 0:
            return None
        return self.sum / self.ok_count

    @property
    def var(self) -> Optional[float]:
        """Population variance (ddof=0); None without sum_sq."""
        if self.sum_sq is None or self.sum is None or self.ok_count == 0:
            return None
        m = float(self.sum) / self.ok_count
        return max(self.sum_sq / self.ok_count - m * m, 0.0)

    @property
    def std(self) -> Optional[float]:
        v = self.var
        return None if v is None else float(np.sqrt(v))


_NP_DTYPE = {torch.int32: np.int32, torch.float32: np.float32,
             torch.bool: np.bool_, torch.uint8: np.uint8,
             torch.int64: np.int64}


def _to_dev(x, device, dtype: torch.dtype) -> torch.Tensor:
    """Host array, scalar or tensor -> tensor of `dtype` on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, dtype=_NP_DTYPE[dtype]))).to(device)


def _as_column(x, device) -> torch.Tensor:
    """A key or value column on `device` as the JAX package converts it
    with 64-bit types off: int64 becomes int32 and float64 float32, on
    the host or in a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype={
            torch.int64: torch.int32,
            torch.float64: torch.float32}.get(x.dtype, x.dtype))
    a = np.asarray(x)
    a = a.astype({np.dtype(np.int64): np.int32,
                  np.dtype(np.float64): np.float32}.get(a.dtype, a.dtype))
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pad_chunks(x: torch.Tensor, fill) -> torch.Tensor:
    n = x.shape[0]
    pad = (-n) % _CHUNK
    if pad:
        x = torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(-1, _CHUNK)


def _stats_int_device(vals: torch.Tensor, ok: torch.Tensor):
    """(N,) int32 + ok -> per-chunk partial sums of the 16-bit halves
    (both int32-exact by construction), masked min/max, ok count, plus
    f32 per-chunk square sums (for var/std)."""
    v = torch.where(ok, vals, 0)
    lo = _pad_chunks(v & 0xFFFF, 0).sum(dim=1, dtype=torch.int32)
    hi = _pad_chunks(v >> 16, 0).sum(dim=1, dtype=torch.int32)
    mn = torch.where(ok, vals, _INT32_MAX).amin()
    mx = torch.where(ok, vals, _INT32_MIN).amax()
    cnt = ok.sum(dtype=torch.int32)
    vf = v.to(torch.float32)
    sq = _pad_chunks(vf * vf, 0.0).sum(dim=1, dtype=torch.float32)
    return lo, hi, mn, mx, cnt, sq


def _stats_float_device(vals: torch.Tensor, ok: torch.Tensor):
    v = torch.where(ok, vals, 0.0)
    part = _pad_chunks(v, 0.0).sum(dim=1, dtype=torch.float32)
    mn = torch.where(ok, vals, torch.inf).amin()
    mx = torch.where(ok, vals, -torch.inf).amax()
    cnt = ok.sum(dtype=torch.int32)
    sq = _pad_chunks(v * v, 0.0).sum(dim=1, dtype=torch.float32)
    return part, mn, mx, cnt, sq


def stats_int(vals: torch.Tensor, ok) -> Stats:
    """Exact Stats over an int32 device column + ok mask."""
    if vals.shape[0] == 0:
        return Stats(0, 0, None, None, None)
    lo, hi, mn, mx, cnt, sq = _stats_int_device(
        vals, _to_dev(ok, vals.device, torch.bool))
    n_ok = int(cnt)
    if n_ok == 0:
        return Stats(int(vals.shape[0]), 0, None, None, None)
    total = sum(int(x) for x in _host(hi)) * 65536 + sum(
        int(x) for x in _host(lo)
    )
    sum_sq = float(np.sum(_host(sq), dtype=np.float64))
    return Stats(int(vals.shape[0]), n_ok, total, int(mn), int(mx),
                 sum_sq)


def stats_float(vals: torch.Tensor, ok) -> Stats:
    """Stats over a float32 device column (chunked f32 partial sums,
    combined on host in f64)."""
    if vals.shape[0] == 0:
        return Stats(0, 0, None, None, None)
    part, mn, mx, cnt, sq = _stats_float_device(
        vals, _to_dev(ok, vals.device, torch.bool))
    n_ok = int(cnt)
    if n_ok == 0:
        return Stats(int(vals.shape[0]), 0, None, None, None)
    total = float(np.sum(_host(part), dtype=np.float64))
    sum_sq = float(np.sum(_host(sq), dtype=np.float64))
    return Stats(int(vals.shape[0]), n_ok, total, float(mn), float(mx),
                 sum_sq)


def _stats_host_i64(vals: np.ndarray, ok: np.ndarray) -> Stats:
    """Host fallback for columns whose values only exist as int64 on
    host (decimal limbs / datetime epochs combine host-side)."""
    sel = _host(vals)[_host(ok).astype(bool)]
    if sel.size == 0:
        return Stats(int(len(vals)), 0, None, None, None)
    total = int(np.sum(sel.astype(object)))  # Python ints: no overflow
    sum_sq = float(np.sum(sel.astype(np.float64) ** 2))
    return Stats(int(len(vals)), int(sel.size), total,
                 int(sel.min()), int(sel.max()), sum_sq)


@GLOBAL.span("query.parse_column")
def _parse_column(tape, field: int, col: Col, dialect, records=None,
                  device_i64: bool = False):
    """-> (vals, ok, kind) with kind in {int, float, i64host}. Gather
    windows auto-size like frame._materialize. An int64 column is parsed
    on the device and, like decimals, handed over as host values
    ("i64host", exact host arithmetic) unless `device_i64` asks for the
    device tensors (kind "i64"), as a GROUP BY key takes them."""
    from .frame import _TYPE_MIN_LEN, _true_window

    window = col.max_len or _true_window(tape, field,
                                         _TYPE_MIN_LEN[col.type])
    if col.type == "int32":
        v, ok = tape.column_int32(field, max_len=window, records=records)
        return v, ok, "int"
    if col.type == "int64":
        v, ok = tape.column_int64(field, max_len=window, records=records)
        if device_i64:
            return v, ok, "i64"
        return _host(v), _host(ok).astype(bool), "i64host"
    if col.type == "float32":
        v, ok = tape.column_float32(field, max_len=window, records=records)
        return v, ok, "float"
    if col.type == "float":
        v, ok = tape.column_float32_exp(field, max_len=window,
                                        records=records)
        return v, ok, "float"
    if col.type == "date":
        v, ok = tape.column_date_days(field, max_len=window,
                                      records=records)
        return v, ok, "int"
    if col.type == "datetime":
        v, ok = tape.column_datetime64(field, unit=col.unit,
                                       max_len=window, records=records)
        return v, ok, "i64host"
    if col.type == "decimal":
        v, ok = tape.column_decimal64(field, scale=col.scale,
                                      max_len=window, records=records)
        return v, ok, "i64host"
    raise ValueError(
        f"column type {col.type!r} has no typed comparison/aggregate"
    )


def _combine_stats(parts: List[Stats]) -> Stats:
    """Associative Stats combine (the per-file/per-shard reduce of a
    corpus aggregate): counts add, sums add, min/max fold."""
    count = sum(p.count for p in parts)
    ok_count = sum(p.ok_count for p in parts)
    sums = [p.sum for p in parts if p.sum is not None]
    mins = [p.min for p in parts if p.min is not None]
    maxs = [p.max for p in parts if p.max is not None]
    sqs = [p.sum_sq for p in parts if p.sum_sq is not None]
    return Stats(
        count, ok_count,
        sum(sums) if sums else None,
        min(mins) if mins else None,
        max(maxs) if maxs else None,
        sum(sqs) if sqs else None,
    )


def _merge_groups(parts: List[Dict], composite: bool) -> Dict:
    """Associative merge of per-file group results: sums and counts
    add, min/max fold, groups re-sorted ascending (lexicographic for
    composite keys). Handles both the single-value shape
    ({sum,min,max,count}) and the multi-value shape ({count, aggs:
    {name: {sum,min,max,count}}}). The corpus-level GROUP BY reduce."""
    multi = "aggs" in parts[0]
    vnames = list(parts[0]["aggs"]) if multi else None
    acc: Dict = {}
    for p in parts:
        if composite:
            keys_iter = list(zip(*[list(a) for a in p["keys"]]))
        else:
            keys_iter = list(p["keys"])
        for i, k in enumerate(keys_iter):
            if multi:
                entry = acc.get(k)
                if entry is None:
                    entry = acc[k] = {
                        "count": 0,
                        "aggs": {n: [0, np.inf, -np.inf, 0]
                                 for n in vnames},
                    }
                entry["count"] += int(p["count"][i])
                for n in vnames:
                    a = p["aggs"][n]
                    e = entry["aggs"][n]
                    e[0] += a["sum"][i]
                    e[1] = min(e[1], a["min"][i])
                    e[2] = max(e[2], a["max"][i])
                    e[3] += int(a["count"][i])
                continue
            s, mn, mx, c = (p["sum"][i], p["min"][i], p["max"][i],
                            int(p["count"][i]))
            if k in acc:
                e = acc[k]
                e[0] += s
                e[1] = min(e[1], mn)
                e[2] = max(e[2], mx)
                e[3] += c
            else:
                acc[k] = [s, mn, mx, c]
    ks = sorted(acc)
    n_cols = len(parts[0]["keys"]) if composite else 1

    def _key_arr(i):
        src = parts[0]["keys"][i] if composite else parts[0]["keys"]
        vals = [k[i] for k in ks] if composite else ks
        return np.array(vals, dtype=src.dtype)

    out_keys = ([_key_arr(i) for i in range(n_cols)] if composite
                else _key_arr(0))
    if multi:
        return {
            "keys": out_keys,
            "count": np.array([acc[k]["count"] for k in ks], np.int64),
            "aggs": {
                n: {
                    "sum": np.array(
                        [acc[k]["aggs"][n][0] for k in ks]),
                    "min": np.array(
                        [acc[k]["aggs"][n][1] for k in ks]),
                    "max": np.array(
                        [acc[k]["aggs"][n][2] for k in ks]),
                    "count": np.array(
                        [acc[k]["aggs"][n][3] for k in ks], np.int64),
                }
                for n in vnames
            },
        }
    sums = np.array([acc[k][0] for k in ks])
    return {
        "keys": out_keys,
        "sum": sums,
        "min": np.array([acc[k][1] for k in ks]),
        "max": np.array([acc[k][2] for k in ks]),
        "count": np.array([acc[k][3] for k in ks], np.int64),
    }


def infer_corpus_col(corpus, field: int, sample: int) -> Col:
    """Infer one column type from a sample drawn across EVERY corpus
    file (strided within each): a type locked from a single member file
    could misclassify values that only later files contain (e.g. int32
    where another file holds decimals — then a decimal predicate
    literal would truncate and match the wrong rows)."""
    from .frame import _classify_values, _true_window

    devs = corpus.device_tapes()
    per = max(8, sample // max(len(devs), 1))
    vals: list = []
    for dt, t in zip(devs, corpus.tapes):
        n = int(t.num_data_records)
        if n == 0:
            continue
        take = min(n, per)
        recs = np.unique(
            (np.arange(take, dtype=np.int64) * max(n // take, 1))
            .clip(0, n - 1)
        ).astype(np.int32)
        w = _true_window(dt, field, 8)
        out, ln, v = dt.gather_fields(
            recs, np.full(recs.shape, field, np.int32), max_len=w
        )
        vals.extend(dt.to_host_lists(out, ln, v))
    return _classify_values(vals) if vals else Col("str")


def _lock_corpus_spec(corpus, column, spec, sample: int):
    """Resolve one column spec corpus-wide (explicit spec, or inference
    over a cross-file sample) so every member file aggregates under the
    same type — results must not depend on file boundaries."""
    names = corpus.header_names()
    field = _field_index(names, column)
    if spec is not None:
        return parse_spec(spec)
    return infer_corpus_col(corpus, field, sample)


def _lock_where_schema(corpus, where, schema, sample: int):
    """Corpus-wide column specs for every predicate column of `where`
    (plus any user-provided entries): without this, each file would
    infer predicate types independently and file boundaries could
    change which rows match (or crash on a header-only part)."""
    out = dict(schema) if schema else {}
    if where is None:
        return out or None
    names = corpus.header_names()
    covered = {names[_field_index(names, k)] for k in out}
    for pred in _where_leaves(where):
        if isinstance(pred[0], VExpr):
            refs = pred[0].columns()
            if isinstance(pred[2], VExpr):
                refs += pred[2].columns()
        elif isinstance(pred[0], TextFold):
            refs = pred[0].columns()
        elif isinstance(pred[0], tuple):  # composite in_rows key
            refs = list(pred[0])
        else:
            refs = [pred[0]]
        for r in refs:
            name = names[_field_index(names, r)]
            if name not in covered:
                out[name] = _lock_corpus_spec(corpus, name, None, sample)
                covered.add(name)
    return out or None


def column_stats(source, column, spec=None, *, where=None, schema=None,
                 dialect=None, backend: str = "auto",
                 engine: str = "offsets", sample: int = 256,
                 device="cuda") -> Stats:
    """Aggregate one column of a CSV without materializing it on host.

    source — path, bytes, Tape, or any serving tape (same resolution
    as frame.read_typed), or a
    CsvCorpus (per-file aggregation, associative combine — the
    map-reduce over corpus shards). `spec` is the column type (string
    spec or Col); None infers it from a row sample (first file for a
    corpus). `where` filters rows first (see module docstring).
    str/bytes columns return count/ok_count only. A path or bytes is
    indexed on `device`; a tape or corpus keeps its own.
    """
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape, infer_schema

    if isinstance(source, CsvCorpus):
        if isinstance(column, VExpr):
            # lock every referenced column so per-file inference cannot
            # change the expression's value domain across files
            col = {
                r: _lock_corpus_spec(source, r, (spec or {}).get(r)
                                     if isinstance(spec, dict) else None,
                                     sample)
                for r in column.columns()
            }
        else:
            col = _lock_corpus_spec(source, column, spec, sample)
        wsch = _lock_where_schema(source, where, schema, sample)
        return _combine_stats([
            column_stats(t, column, col, where=where, schema=wsch,
                         dialect=dialect, sample=sample)
            for t in source.device_tapes()
        ])
    tape, names = _resolve_tape(source, dialect, backend, engine, False,
                                device)
    if isinstance(column, VExpr):
        # aggregate of an arithmetic expression: evaluate on device,
        # then the usual exact reduces
        records = None
        if where is not None:
            records = select_records(tape, where, names=names,
                                     schema=schema, dialect=dialect,
                                     sample=sample)
        col_specs = {}
        if isinstance(spec, dict):
            for kk, ss in spec.items():
                if ss is not None:
                    col_specs[kk] = (ss if hasattr(ss, "type")
                                     else parse_spec(ss))
        vals, ok, isf = _eval_vexpr(tape, names, column.tree, col_specs,
                                    dialect, sample, records=records)
        return stats_float(vals, ok) if isf else stats_int(vals, ok)
    field = _field_index(names, column)
    if spec is None:
        inferred = infer_schema(tape, names, columns=[field],
                                sample=sample)
        col = inferred[names[field]]
    else:
        col = parse_spec(spec)
    records = None
    if where is not None:
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    if col.type in ("str", "bytes"):
        n = (len(records) if records is not None
             else int(tape.record_cnt) - 1)
        return Stats(n, n, None, None, None)
    vals, ok, kind = _parse_column(tape, field, col, dialect,
                                   records=records)
    if kind == "int":
        return stats_int(vals, ok)
    if kind == "float":
        return stats_float(vals, ok)
    return _stats_host_i64(vals, ok)


def _sorted_valid(vals: torch.Tensor, ok: torch.Tensor):
    """Ascending sort with invalid rows pushed past the valid count
    under the max sentinel; quantile reads then index [0, n_ok)."""
    big = torch.inf if vals.dtype == torch.float32 else _INT32_MAX
    return (torch.sort(torch.where(ok, vals, big)).values,
            ok.sum(dtype=torch.int32))


def _quantiles_from_sorted(srt: torch.Tensor, n_ok: int, qs) -> np.ndarray:
    """np.quantile(method="linear") over an ascending device array.
    All quantile neighbors gather on device and leave in ONE readback
    (2*len(qs) elements)."""
    pos = np.asarray([float(q) * (n_ok - 1) for q in qs], np.float64)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_ok - 1)
    frac = pos - i0
    taken = _host(
        srt[_to_dev(np.concatenate([i0, i1]), srt.device, torch.int64)]
    ).astype(np.float64)
    v0, v1 = taken[: len(pos)], taken[len(pos):]
    return v0 + (v1 - v0) * frac


def _f32_order_keys(vals: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys whose SIGNED order equals the float order
    (IEEE trick: flip the low 31 bits of negatives; `>>` on int32 is
    arithmetic). Self-inverse."""
    b = vals.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _keys_from_order(keys: np.ndarray, is_float: bool) -> np.ndarray:
    """Inverse of _f32_order_keys on host (identity for ints)."""
    if not is_float:
        return keys.astype(np.float64)
    k = keys.astype(np.int32)
    b = k ^ ((k >> 31) & np.int32(0x7FFFFFFF))
    return b.view(np.float32).astype(np.float64)


def _count_le(keys: torch.Tensor, ok: torch.Tensor,
              mids: torch.Tensor) -> torch.Tensor:
    """(R,) counts of ok values with key <= mids[r] — the whole probe
    batch in one device pass (N x R compare matrix, R is tiny)."""
    return ((keys[:, None] <= mids[None, :]) & ok[:, None]).sum(
        dim=0, dtype=torch.int32)


def _select_ranks_device(parts, ranks: np.ndarray) -> np.ndarray:
    """EXACT order statistics over values that stay per device buffer:
    for each rank r, the smallest key v with count(x <= v) >= r+1, by a
    batched 32-step binary search on the int32 key domain. Host traffic
    per buffer per step is R scalars — independent of N (order
    statistics are not associative, but rank counts ARE)."""
    ranks = np.asarray(ranks, np.int64)
    lo = np.full(ranks.shape, -(2**31), np.int64)
    hi = np.full(ranks.shape, 2**31 - 1, np.int64)
    while (lo < hi).any():
        mid = (lo + hi) // 2
        cnt = np.zeros(ranks.shape, np.int64)
        for keys, ok in parts:
            midd = _to_dev(mid.astype(np.int32), keys.device, torch.int32)
            cnt += _host(_count_le(keys, ok, midd)).astype(np.int64)
        ge = cnt >= ranks + 1
        hi = np.where(ge, mid, hi)
        lo = np.where(ge, lo, mid + 1)
    return lo.astype(np.int32)


def _quantiles_multi_device(parts, qs, is_float: bool) -> np.ndarray:
    """np.quantile("linear") over values living in several device
    buffers (corpus member tapes), without pooling them on host:
    exact rank selection via _select_ranks_device, then the same
    host-side interpolation as _quantiles_from_sorted.

    parts: [(vals_dev, ok_dev)] with int32 or float32 vals."""
    keyed = []
    n_ok = 0
    for vals, ok in parts:
        okd = _to_dev(ok, vals.device, torch.bool)
        keys = _f32_order_keys(vals) if is_float else vals
        keyed.append((keys, okd))
        n_ok += int(okd.sum(dtype=torch.int32))
    if n_ok == 0:
        return np.full(len(qs), np.nan)
    pos = np.asarray([float(q) * (n_ok - 1) for q in qs], np.float64)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_ok - 1)
    frac = pos - i0
    sel = _select_ranks_device(keyed, np.concatenate([i0, i1]))
    v = _keys_from_order(sel, is_float)
    v0, v1 = v[: len(pos)], v[len(pos):]
    return v0 + (v1 - v0) * frac


def column_quantiles(source, column, qs=(0.25, 0.5, 0.75), spec=None, *,
                     where=None, schema=None, dialect=None,
                     backend: str = "auto", engine: str = "offsets",
                     sample: int = 256, device="cuda") -> np.ndarray:
    """Quantiles of a typed column (np.quantile "linear" semantics over
    the parse-ok values). int32/float/date columns sort on device and
    only the two neighbors of each quantile position leave the device;
    decimal/datetime values sort as host int64 (decimal results are in
    SCALED units, like every decimal aggregate). Returns (len(qs),)
    float64; NaNs when no value parses. A CsvCorpus keeps each file's
    parsed values ON DEVICE and selects the exact ranks by a batched
    bisect over rank counts (_quantiles_multi_device) — order
    statistics are not associative, but rank counts are; host traffic
    per file is a few scalars per step, independent of file size. A
    path or bytes is indexed on `device`; a tape or corpus keeps its
    own."""
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape

    if isinstance(source, CsvCorpus):
        col = _lock_corpus_spec(source, column, spec, sample)
        if col.type in ("str", "bytes"):
            raise ValueError(f"column {column!r} is {col.type}: "
                             "quantiles need a numeric column")
        wsch = _lock_where_schema(source, where, schema, sample)
        names = source.header_names()
        field = _field_index(names, column)
        parts, host_v, host_ok = [], [], []
        kind = None
        for dt in source.device_tapes():
            recs = (select_records(dt, where, names=names, schema=wsch,
                                   dialect=dialect, sample=sample)
                    if where is not None else None)
            v, ok, kind = _parse_column(dt, field, col, dialect,
                                        records=recs)
            if kind == "i64host":
                host_v.append(_host(v))
                host_ok.append(_host(ok).astype(bool))
            else:
                parts.append((v, ok))
        if kind is None:
            return np.full(len(qs), np.nan)
        if kind == "i64host":
            # decimal/datetime values only exist as host int64
            sel = np.concatenate(host_v)[np.concatenate(host_ok)]
            if sel.size == 0:
                return np.full(len(qs), np.nan)
            return np.quantile(sel.astype(np.float64), list(qs))
        # values stay on device per member tape; exact rank selection
        # reads back R scalars per file per bisect step — host traffic
        # independent of corpus size
        return _quantiles_multi_device(parts, qs, kind == "float")
    tape, names = _resolve_tape(source, dialect, backend, engine, False,
                                device)
    field = _field_index(names, column)
    col = (parse_spec(spec) if spec is not None
           else infer_col(tape, names, field, sample))
    records = None
    if where is not None:
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    if col.type in ("str", "bytes"):
        raise ValueError(f"column {column!r} is {col.type}: quantiles "
                         "need a numeric column")
    vals, ok, kind = _parse_column(tape, field, col, dialect,
                                   records=records)
    if kind == "i64host":
        sel = _host(vals)[_host(ok).astype(bool)]
        if sel.size == 0:
            return np.full(len(qs), np.nan)
        return np.quantile(sel.astype(np.float64), list(qs))
    srt, n_ok = _sorted_valid(vals, _to_dev(ok, vals.device, torch.bool))
    n_ok = int(n_ok)
    if n_ok == 0:
        return np.full(len(qs), np.nan)
    return _quantiles_from_sorted(srt, n_ok, qs)


def describe(source, columns=None, qs=(0.25, 0.5, 0.75), *, where=None,
             schema=None, dialect=None, backend: str = "auto",
             engine: str = "offsets", sample: int = 256,
             device="cuda") -> Dict:
    """Per-column summary of a CSV (or corpus): for numeric columns a
    Stats (count/ok/sum/min/max/mean/std) plus `qs` quantiles; for
    str/bytes columns count and distinct-value count. Returns
    {name: {"type": spec-type, "stats": Stats, "quantiles": (Q,) f64}}
    (quantiles/stats-extras absent for text columns). A path or bytes
    is indexed on `device`; a tape or corpus keeps its own."""
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape

    if isinstance(source, CsvCorpus):
        names = source.header_names()
        resolve = lambda f: _lock_corpus_spec(source, f, None, sample)
        wsch = _lock_where_schema(source, where, schema, sample)
        tapes = list(source.device_tapes())
        src_obj = source
    else:
        tape, names = _resolve_tape(source, dialect, backend, engine,
                                    False, device)
        resolve = lambda f: infer_col(tape, names, f, sample)
        wsch = schema
        tapes = [tape]
        src_obj = tape
    # the where pushdown evaluates ONCE per member tape; every column's
    # stats/quantiles below share the resulting record set
    recs = [
        (select_records(t, where, names=names, schema=wsch,
                        dialect=dialect, sample=sample)
         if where is not None else None)
        for t in tapes
    ]
    sel = (list(range(len(names))) if columns is None
           else [_field_index(names, c) for c in columns])
    # user schema entries type the described columns too, not just the
    # where predicates
    override = {names[_field_index(names, k)]: parse_spec(v)
                for k, v in (schema or {}).items()}
    out: Dict = {}
    for f in sel:
        name = names[f]
        col = override.get(name) or resolve(f)
        entry: Dict = {"type": col.type}
        if col.type in ("str", "bytes"):
            # reuse the precomputed record sets: value_counts(where=)
            # would re-run the pushdown per text column per tape
            vc = _merge_value_counts([
                value_counts(t, f, col, records=r, dialect=dialect,
                             sample=sample)
                for t, r in zip(tapes, recs)
            ])
            n = int(np.sum(vc["count"]))
            entry["stats"] = Stats(n, n, None, None, None)
            entry["distinct"] = int(len(vc["keys"]))
        else:
            # one typed parse per (column, tape) feeds BOTH the stats
            # and the quantiles — column_stats + column_quantiles
            # would parse (and push the where down) twice
            parts, col_v, col_ok = [], [], []
            kind = None
            for t, r in zip(tapes, recs):
                vals, ok, kind = _parse_column(t, f, col, dialect,
                                               records=r)
                if kind == "int":
                    parts.append(stats_int(vals, ok))
                elif kind == "float":
                    parts.append(stats_float(vals, ok))
                else:
                    parts.append(_stats_host_i64(vals, ok))
                col_v.append(vals)
                col_ok.append(ok)
            entry["stats"] = (parts[0] if len(parts) == 1
                              else _combine_stats(parts))
            if len(tapes) == 1 and kind not in (None, "i64host"):
                srt, n_ok = _sorted_valid(
                    col_v[0], _to_dev(col_ok[0], col_v[0].device,
                                      torch.bool))
                n_ok = int(n_ok)
                entry["quantiles"] = (
                    np.full(len(qs), np.nan) if n_ok == 0
                    else _quantiles_from_sorted(srt, n_ok, qs))
            elif kind in ("int", "float"):
                # corpus: values stay on device per member tape — exact
                # rank selection, host traffic independent of N
                entry["quantiles"] = _quantiles_multi_device(
                    list(zip(col_v, col_ok)), qs, kind == "float")
            else:
                # host-i64 values (decimal/datetime): pool on host
                allv = (np.concatenate([_host(v) for v in col_v])
                        if col_v else np.zeros(0))
                allok = (np.concatenate(
                    [_host(o).astype(bool) for o in col_ok])
                    if col_ok else np.zeros(0, bool))
                pool = allv[allok]
                entry["quantiles"] = (
                    np.full(len(qs), np.nan) if pool.size == 0
                    else np.quantile(pool.astype(np.float64), list(qs)))
        out[name] = entry
    return out


# ------------------------------------------------------------ predicates

def _field_index(names: List[str], key) -> int:
    if isinstance(key, (int, np.integer)):
        if not 0 <= int(key) < len(names):
            raise KeyError(f"column index {key} out of range")
        return int(key)
    try:
        return names.index(key)
    except ValueError:
        raise KeyError(f"no column {key!r}; header names: {names}") from None


def _cmp_mask(vals, ok, lit, op: str):
    if op == "==":
        m = vals == lit
    elif op == "!=":
        m = vals != lit
    elif op == "<":
        m = vals < lit
    elif op == "<=":
        m = vals <= lit
    elif op == ">":
        m = vals > lit
    else:
        m = vals >= lit
    return ok & m


def _between_mask(vals, ok, lo, hi):
    return ok & (vals >= lo) & (vals <= hi)


def _data_records(tape) -> int:
    return int(getattr(tape, "num_data_records",
                       int(tape.record_cnt) - 1))


def _record_ids(tape, records) -> np.ndarray:
    """`records` as host int32 ids, or every data record's id."""
    if records is not None:
        return _host(records).astype(np.int32)
    return np.arange(_data_records(tape), dtype=np.int32)


def _whole_column(tape, field: int):
    """(record ids, field ids) int32 tensors on the tape's device that
    address every data record's `field`."""
    n = _data_records(tape)
    return (torch.arange(n, dtype=torch.int32, device=tape.device),
            torch.full((n,), field, dtype=torch.int32, device=tape.device))


def _text_literal(value) -> bytes:
    """Predicate literal -> bytes for text-column compares. Non-string
    literals compare by their text form (WHERE zip = 12345 on a str
    column means the text "12345" — bytes(int) would have built an
    int-sized NUL buffer instead)."""
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    return str(value).encode()


class TextFold:
    """A case-folded text-column reference for predicates:
    UPPER(col) / LOWER(col). The fold runs ON DEVICE over the one
    decoded gather the text predicate already does (ASCII A-Z/a-z
    only, like SQL engines' default C collation); the literal/pattern
    folds on host. Usable as the key of ==/!=/IN/LIKE/startswith/
    endswith/contains predicate leaves."""

    __slots__ = ("fn", "col")

    def __init__(self, fn: str, col: str):
        if fn not in ("upper", "lower"):
            raise ValueError(f"TextFold fn must be upper/lower, got {fn!r}")
        self.fn = fn
        self.col = col

    def columns(self):
        return [self.col]

    def __str__(self):
        return f"{self.fn.upper()}({self.col})"

    def __repr__(self):
        return f"TextFold({self.fn!r}, {self.col!r})"


def _fold_device(out: torch.Tensor, fold: Optional[str]) -> torch.Tensor:
    """ASCII-case-fold a gathered (N, W) uint8 window on device."""
    if fold is None:
        return out
    lo, hi, delta = ((97, 122, -32) if fold == "upper" else (65, 90, 32))
    o = out.to(torch.int32)
    return torch.where((o >= lo) & (o <= hi), o + delta, o).to(torch.uint8)


def _fold_host(b: bytes, fold: Optional[str]) -> bytes:
    """ASCII-case-fold a literal on host (bytes.upper/lower are
    ASCII-only by definition — matching the device fold)."""
    if fold is None:
        return b
    return b.upper() if fold == "upper" else b.lower()


def _decoded_eq_mask(tape, field: int, value, dialect, window: int,
                     fold=None):
    """Device mask: stage-2 decoded field == value (bytes compare)."""
    from .device_tape import _filter_equals

    value = _fold_host(_text_literal(value), fold)
    out, lengths, valid = tape.gather_decoded(
        *_whole_column(tape, field), max_len=window, dialect=dialect,
    )
    out = _fold_device(out, fold)
    needle = np.zeros(window, np.uint8)
    raw = np.frombuffer(value, np.uint8)[:window]
    needle[: raw.size] = raw
    return _filter_equals(out, lengths, valid,
                          _to_dev(needle, out.device, torch.uint8),
                          len(value))


def _substr_mask(out, lengths, valid, needle, k: int, mode: str):
    """Device substring predicates over decoded fields.

    out (N, W) uint8, lengths true decoded lengths, needle (W,) uint8
    zero-padded, k the needle length. mode:
    - "startswith": bytes [0, k) equal the needle;
    - "endswith": bytes [len-k, len) equal the needle;
    - "contains": ANY alignment s with s + k <= len matches; the k
      needle bytes each compare against a shifted (N, W-k+1) slice of
      the window, so memory stays O(N*W) regardless of needle size."""
    n, w = out.shape
    o32 = out.to(torch.int32)
    nd = needle[:k].to(torch.int32)[None, :]
    if mode == "startswith":
        m = torch.all(o32[:, :k] == nd, dim=1) & (lengths >= k)
    elif mode == "endswith":
        tail = _tail(o32, lengths, k)
        m = torch.all(tail == nd, dim=1) & (lengths >= k)
    else:  # contains
        n_starts = w - k + 1
        hit = torch.ones((n, n_starts), dtype=torch.bool, device=out.device)
        for j in range(k):
            hit = hit & (o32[:, j:j + n_starts] == nd[0, j])
        starts = torch.arange(n_starts, dtype=torch.int32,
                              device=out.device)
        in_range = starts[None, :] + k <= lengths[:, None]
        m = torch.any(hit & in_range, dim=1)
    return valid & m


def _tail(o32: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """The last k bytes of each row's field, (N, k), read at clamped
    positions (jnp.take_along_axis's clamp)."""
    w = o32.shape[1]
    start = torch.clamp(lengths - k, min=0)
    idx = start[:, None] + torch.arange(k, dtype=torch.int32,
                                        device=o32.device)[None, :]
    return torch.gather(o32, 1, torch.clamp(idx, max=w - 1).long())


def _decoded_match_mask(tape, field: int, value, dialect, window: int,
                        mode: str, fold=None):
    """Device mask for startswith/endswith/contains over the stage-2
    DECODED field text."""
    value = _fold_host(_text_literal(value), fold)
    k = len(value)
    if k == 0:
        # every valid row contains/starts/ends with the empty string
        out, lengths, valid = tape.gather_decoded(
            *_whole_column(tape, field), max_len=window, dialect=dialect,
        )
        return _host(valid)
    window = max(window, k)
    out, lengths, valid = tape.gather_decoded(
        *_whole_column(tape, field), max_len=window, dialect=dialect,
    )
    out = _fold_device(out, fold)
    needle = np.zeros(window, np.uint8)
    needle[:k] = np.frombuffer(value, np.uint8)
    return _host(
        _substr_mask(out, lengths, valid,
                     _to_dev(needle, out.device, torch.uint8), k, mode)
    )


def _compile_like(pat: str, escape=None):
    """SQL LIKE pattern -> (anchor_start, anchor_end, segments) with
    segments as (utf8 bytes, per-byte wildcard flags).

    The pattern splits on unescaped `%` into literal segments (each may
    contain `_` per-byte wildcards); anchor_start/anchor_end record
    whether the first/last segment is pinned to the field's start/end.
    Empty middle segments (`%%`) are no-ops and dropped. An ESCAPE
    character makes the following character literal (incl. `%`, `_` and
    the escape itself). Matching is byte-wise (`_` = one byte),
    consistent with the byte-oriented serving layer. No backtracking is
    needed for EXISTENCE: greedy earliest-match per middle segment is
    complete."""
    toks = []  # (char, is_escaped_literal)
    i = 0
    while i < len(pat):
        c = pat[i]
        if escape is not None and c == escape:
            if i + 1 >= len(pat):
                raise ValueError(
                    "LIKE pattern ends with the escape character")
            toks.append((pat[i + 1], True))
            i += 2
        else:
            toks.append((c, False))
            i += 1
    anchor_start = not (toks and toks[0] == ("%", False))
    anchor_end = not (toks and toks[-1] == ("%", False))
    parts = [[]]
    for c, lit in toks:
        if c == "%" and not lit:
            parts.append([])
        else:
            parts[-1].append((c, lit))
    kept = []
    for i, seg in enumerate(parts):
        keep = seg or (anchor_start and i == 0) \
            or (anchor_end and i == len(parts) - 1)
        if keep:
            kept.append(seg)
    if not kept:
        kept = [[]]  # pure '%'/'%%': one empty unanchored segment
        anchor_start = anchor_end = False
    segs = []
    for seg in kept:
        bs = bytearray()
        wild = []
        for c, lit in seg:
            b = c.encode()
            bs += b
            if c == "_" and not lit:
                wild.append(True)
            else:
                wild.extend([False] * len(b))
        segs.append((bytes(bs), wild))
    return anchor_start, anchor_end, segs


def _wild_mask(out, lengths, valid, needle, wild, k: int, mode: str):
    """Device LIKE predicates with `_` wildcards over decoded fields.

    Same shapes/convention as _substr_mask, plus wild (W,) bool marking
    per-position wildcards in the needle and an extra mode "exact"
    (whole-field match: lengths == k). A wildcard position accepts any
    byte — `(byte == needle) | wild` per position."""
    n, w = out.shape
    o32 = out.to(torch.int32)
    nd = needle[:k].to(torch.int32)[None, :]
    wc = wild[:k][None, :]
    if mode == "exact":
        m = torch.all((o32[:, :k] == nd) | wc, dim=1) & (lengths == k)
    elif mode == "startswith":
        m = torch.all((o32[:, :k] == nd) | wc, dim=1) & (lengths >= k)
    elif mode == "endswith":
        tail = _tail(o32, lengths, k)
        m = torch.all((tail == nd) | wc, dim=1) & (lengths >= k)
    else:  # contains: any alignment s with s + k <= len matches
        n_starts = w - k + 1
        hit = torch.ones((n, n_starts), dtype=torch.bool, device=out.device)
        for j in range(k):
            hit = hit & ((o32[:, j:j + n_starts] == nd[0, j]) | wc[0, j])
        starts = torch.arange(n_starts, dtype=torch.int32,
                              device=out.device)
        in_range = starts[None, :] + k <= lengths[:, None]
        m = torch.any(hit & in_range, dim=1)
    return valid & m


def _seg_hits(o32, needles, wilds, s: int, k: int, w: int):
    """(N, w-k+1) bool: does segment s match at each alignment?"""
    n_starts = w - k + 1
    hit = torch.ones((o32.shape[0], n_starts), dtype=torch.bool,
                     device=o32.device)
    for j in range(k):
        hit = hit & ((o32[:, j:j + n_starts] == needles[s, j])
                     | wilds[s, j])
    return hit


def _like_general_mask(out, lengths, valid, needles, wilds, ks: tuple,
                       anchor_start: bool, anchor_end: bool):
    """Multi-segment LIKE (mid-pattern `%`) on device: greedy in-order
    matching. The anchored head matches at 0, each middle segment takes
    its EARLIEST alignment past the cursor (greedy is complete for
    existence), the anchored tail must start at len-k past the cursor.
    needles/wilds are (S, W); ks the per-segment byte lengths."""
    n, w = out.shape
    o32 = out.to(torch.int32)
    needles = needles.to(torch.int32)
    ok = valid
    cursor = torch.zeros(n, dtype=torch.int32, device=out.device)
    segs = list(ks)
    start_i = 0
    if anchor_start:
        k0 = segs[0]
        if k0:
            m = _seg_hits(o32, needles, wilds, 0, k0, w)
            ok = ok & (lengths >= k0) & m[:, 0]
        cursor = torch.full((n,), k0, dtype=torch.int32, device=out.device)
        start_i = 1
    end_i = len(segs) - (1 if anchor_end else 0)
    for s in range(start_i, end_i):
        k = segs[s]
        if k == 0:
            continue
        m = _seg_hits(o32, needles, wilds, s, k, w)
        starts = torch.arange(w - k + 1, dtype=torch.int32,
                              device=out.device)[None, :]
        pos_ok = m & (starts >= cursor[:, None]) \
            & (starts + k <= lengths[:, None])
        exists = torch.any(pos_ok, dim=1)
        # the earliest matching alignment (jnp.argmax of the mask)
        first = torch.where(pos_ok, starts, w).amin(dim=1)
        ok = ok & exists
        cursor = torch.where(exists, first + k, cursor)
    if anchor_end:
        k = segs[-1]
        if k:
            m = _seg_hits(o32, needles, wilds, len(segs) - 1, k, w)
            start = lengths - k
            idx = torch.clamp(start, 0, w - k)[:, None]
            tail = torch.gather(m, 1, idx.long())[:, 0]
            ok = ok & (start >= cursor) & tail
        else:
            ok = ok & (cursor <= lengths)
    return ok


def _like_pattern_mask(tape, field: int, pat, dialect, window: int,
                       fold=None):
    """Device mask for a full LIKE pattern (`%` runs anywhere, `_`
    per-byte wildcards, optional ESCAPE) over the stage-2 DECODED
    field text. `pat` is the pattern string or (pattern, escape_char).
    Single-segment patterns take the specialized exact/startswith/
    endswith/contains compares (_wild_mask); multi-segment patterns run
    the greedy in-order matcher (_like_general_mask). `fold` case-folds
    the gathered text on device and the SEGMENT literals on host (after
    escape compilation, so a case-letter ESCAPE char is unaffected)."""
    escape = None
    if isinstance(pat, tuple):
        pat, escape = pat
    a_start, a_end, segs = _compile_like(
        pat if isinstance(pat, str) else bytes(pat).decode(), escape
    )
    if fold is not None:
        segs = [(_fold_host(b, fold), wl) for b, wl in segs]
    kmax = max((len(b) for b, _w in segs), default=0)
    window = max(window, kmax, 1)
    out, lengths, valid = tape.gather_decoded(
        *_whole_column(tape, field), max_len=window, dialect=dialect,
    )
    out = _fold_device(out, fold)
    dev = out.device
    if len(segs) == 1:
        b, wl = segs[0]
        k = len(b)
        mode = {(True, True): "exact", (True, False): "startswith",
                (False, True): "endswith",
                (False, False): "contains"}[(a_start, a_end)]
        if k == 0:
            # '' matches only empty fields; '%' degenerates match all
            if mode == "exact":
                return _host(valid & (lengths == 0))
            return _host(valid)
        needle = np.zeros(window, np.uint8)
        needle[:k] = np.frombuffer(b, np.uint8)
        wild = np.zeros(window, bool)
        wild[:k] = wl
        return _host(
            _wild_mask(out, lengths, valid,
                       _to_dev(needle, dev, torch.uint8),
                       _to_dev(wild, dev, torch.bool), k, mode)
        )
    needles = np.zeros((len(segs), window), np.uint8)
    wilds = np.zeros((len(segs), window), bool)
    for i, (b, wl) in enumerate(segs):
        needles[i, : len(b)] = np.frombuffer(b, np.uint8)
        wilds[i, : len(b)] = wl
    return _host(
        _like_general_mask(out, lengths, valid,
                           _to_dev(needles, dev, torch.uint8),
                           _to_dev(wilds, dev, torch.bool),
                           tuple(len(b) for b, _w in segs),
                           a_start, a_end)
    )


def _vexpr_text(t) -> str:
    k = t[0]
    if k == "col":
        return t[1]
    if k == "lit":
        return repr(t[1])
    if k == "len":
        return f"LENGTH({t[1]})"
    if k == "neg":
        return f"(- {_vexpr_text(t[1])})"
    if k in ("abs", "floor", "ceil"):
        return f"{k.upper()}({_vexpr_text(t[1])})"
    if k == "round":
        return f"ROUND({_vexpr_text(t[1])}, {t[2][1]})"
    if k == "cast":
        to = "INTEGER" if t[2] == "int" else "FLOAT"
        return f"CAST({_vexpr_text(t[1])} AS {to})"
    if k == "%":
        return f"MOD({_vexpr_text(t[1])}, {_vexpr_text(t[2])})"
    return f"({_vexpr_text(t[1])} {k} {_vexpr_text(t[2])})"


class VExpr:
    """A numeric VALUE expression over columns, as a tree:
    ("col", name) | ("lit", number) | ("neg", a) | (op, a, b) with op
    in "+-*/". Wrapping the tree in a class lets the predicate/SELECT
    machinery tell an expression from a plain column-name string.

    Semantics (documented, kernel-consistent): integer arithmetic runs
    in int32 (two's-complement wrap, like the device layer); any float
    operand or any division promotes the whole tree to float32;
    x / 0 makes the row NOT-ok (SQL-NULL-ish, the layer's
    parse-failure convention); a row is ok iff EVERY referenced column
    parsed ok. decimal/datetime columns are rejected (scale algebra);
    date columns participate as their day numbers.

    ("len", name) is the LENGTH(col) leaf: the DECODED byte length of
    the field (stage-2 semantics — trimmed/unquoted/unescaped), an
    int32 computed on device from the gathered window's true lengths.
    str/bytes columns only (on a parsed numeric column the host twin
    could not reproduce the original text's length).

    Scalar numeric functions: ("abs", a) keeps the operand's type
    (ABS(int32 min) wraps, two's complement); ("floor", a)/("ceil", a)
    are the identity on ints and floor/ceil on floats (still
    float32); ("round", a, ("lit", d)) rounds to d decimal places —
    identity on ints with d >= 0, else float32 scale-round-unscale
    with round-half-to-even (the IEEE default — both twins use it);
    ("%", a, b) is TRUNCATED remainder (C semantics, sign of the
    dividend, torch.fmod / np.fmod), b == 0 makes the row NOT-ok exactly
    like division; ("cast", a, "int"|"float") converts — float -> int32
    truncates toward zero (SQL) saturating at the int32 limits,
    int -> float32."""

    __slots__ = ("tree",)

    def __init__(self, tree):
        self.tree = tree

    def columns(self):
        def walk(t):
            if t[0] in ("col", "len"):
                yield t[1]
            elif t[0] in ("neg", "abs", "floor", "ceil"):
                yield from walk(t[1])
            elif t[0] in ("round", "cast"):
                yield from walk(t[1])
            elif t[0] in ("+", "-", "*", "/", "%"):
                yield from walk(t[1])
                yield from walk(t[2])
        return list(walk(self.tree))

    def __str__(self):
        return _vexpr_text(self.tree)

    def __repr__(self):
        return f"VExpr({_vexpr_text(self.tree)})"


def _cast_int32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: truncation toward zero,
    saturating at the int32 limits, NaN -> 0 (torch's own cast is
    undefined outside the int32 range)."""
    big = v >= 2147483648.0
    small = v <= -2147483648.0
    mid = torch.where(big | small | torch.isnan(v), 0.0, v).to(torch.int32)
    return torch.where(big, _INT32_MAX, torch.where(small, _INT32_MIN, mid))


def _wrap_int32(v: int) -> int:
    """A Python int as int32 wraps it (jnp.full's conversion)."""
    return (int(v) + 2**31) % 2**32 - 2**31


def _eval_vexpr(tape, names, tree, col_specs, dialect, sample: int,
                records=None):
    """Evaluate a VExpr tree on device -> (vals, ok, is_float).

    Columns parse through the usual typed device path (_parse_column);
    the arithmetic is torch ops over the parsed tensors, so the whole
    expression evaluates where the values live before any readback.
    float32 results below 2**-126 flush to zero, as XLA's do."""
    from .frame import infer_schema

    k = tree[0]
    if k == "lit":
        v = tree[1]
        isf = isinstance(v, float)
        n = _data_records(tape)
        n = n if records is None else int(_host(records).shape[0])
        if isf:
            return (torch.full((n,), v, dtype=torch.float32,
                               device=tape.device),
                    torch.ones(n, dtype=torch.bool, device=tape.device), isf)
        return (torch.full((n,), _wrap_int32(v), dtype=torch.int32,
                           device=tape.device),
                torch.ones(n, dtype=torch.bool, device=tape.device), isf)
    if k == "col":
        name = tree[1]
        field = _field_index(names, name)
        cname = names[field]
        col = col_specs.get(cname)
        if col is None:
            col = infer_schema(tape, names, columns=[field],
                               sample=sample)[cname]
            col_specs[cname] = col
        if col.type in ("str", "bytes"):
            raise ValueError(
                f"column {cname!r} is {col.type}: arithmetic needs a "
                "numeric column (give an explicit schema to type it)"
            )
        vals, ok, kind = _parse_column(tape, field, col, dialect,
                                       records=records)
        if kind == "i64host":
            raise ValueError(
                f"column {cname!r} is {col.type}: decimal/datetime "
                "columns are not supported in arithmetic expressions "
                "(their values are scaled host ints)"
            )
        return vals, ok, kind == "float"
    if k == "len":
        from .frame import _true_window, infer_schema

        name = tree[1]
        field = _field_index(names, name)
        cname = names[field]
        col = col_specs.get(cname)
        if col is None:
            col = infer_schema(tape, names, columns=[field],
                               sample=sample)[cname]
            col_specs[cname] = col
        if col.type not in ("str", "bytes"):
            raise ValueError(
                f"LENGTH needs a str/bytes column; {cname!r} is "
                f"{col.type} (give an explicit schema to keep it text)"
            )
        window = col.max_len or _true_window(tape, field, 16)
        if records is None:
            recs, flds = _whole_column(tape, field)
        else:
            recs = _to_dev(records, tape.device, torch.int32)
            flds = torch.full(recs.shape, field, dtype=torch.int32,
                              device=tape.device)
        _, lengths, valid = tape.gather_decoded(
            recs, flds, max_len=window, dialect=dialect,
        )
        return lengths.to(torch.int32), valid, False
    if k == "neg":
        v, ok, isf = _eval_vexpr(tape, names, tree[1], col_specs,
                                 dialect, sample, records)
        return -v, ok, isf
    if k == "abs":
        v, ok, isf = _eval_vexpr(tape, names, tree[1], col_specs,
                                 dialect, sample, records)
        return torch.abs(v), ok, isf
    if k in ("floor", "ceil"):
        v, ok, isf = _eval_vexpr(tape, names, tree[1], col_specs,
                                 dialect, sample, records)
        if not isf:
            return v, ok, isf
        f = torch.floor if k == "floor" else torch.ceil
        return f(v), ok, isf
    if k == "cast":
        # CAST(e AS INTEGER/FLOAT): float -> int32 truncates toward
        # zero (SQL) and saturates at the int32 limits (XLA convert
        # semantics, _cast_int32; the host twin clips to match);
        # int -> float32
        v, ok, isf = _eval_vexpr(tape, names, tree[1], col_specs,
                                 dialect, sample, records)
        to_f = tree[2] == "float"
        if to_f == isf:
            return v, ok, isf
        if to_f:
            return v.to(torch.float32), ok, True
        return _cast_int32(v), ok, False
    if k == "round":
        v, ok, isf = _eval_vexpr(tape, names, tree[1], col_specs,
                                 dialect, sample, records)
        d = int(tree[2][1])
        if not isf and d >= 0:
            return v, ok, isf
        s = _to_dev(np.float32(10.0 ** d), v.device, torch.float32)
        return _ftz(torch.round(_ftz(v.to(torch.float32) * s)) / s), ok, True
    va, oa, fa = _eval_vexpr(tape, names, tree[1], col_specs, dialect,
                             sample, records)
    vb, ob, fb = _eval_vexpr(tape, names, tree[2], col_specs, dialect,
                             sample, records)
    ok = oa & ob
    if k == "%":
        # truncated remainder (C semantics); b == 0 -> row not-ok
        isf = fa or fb
        if isf:
            va, vb = va.to(torch.float32), vb.to(torch.float32)
            ok = ok & (vb != 0)
            return _ftz(torch.fmod(va, torch.where(vb == 0, 1.0, vb))), \
                ok, isf
        ok = ok & (vb != 0)
        # x % -1 is 0; the int32 division behind fmod would trap on
        # INT32_MIN % -1, where XLA gives 0 too
        minus1 = vb == -1
        safe = torch.where((vb == 0) | minus1, 1, vb)
        return torch.where(minus1, 0, torch.fmod(va, safe)), ok, isf
    isf = fa or fb or k == "/"
    if isf:
        va, vb = va.to(torch.float32), vb.to(torch.float32)
    if k == "+":
        out = va + vb
    elif k == "-":
        out = va - vb
    elif k == "*":
        out = va * vb
    else:
        # division: float32 always; /0 -> row not-ok (SQL-NULL-ish)
        ok = ok & (vb != 0)
        out = va / torch.where(vb == 0, 1.0, vb)
    return (_ftz(out) if isf else out), ok, isf


def _vexpr_cmp_mask(tape, names, lhs: VExpr, op: str, rhs,
                    col_specs, dialect, sample: int) -> np.ndarray:
    """Device mask for an arithmetic comparison leaf: expr op expr."""
    rtree = rhs.tree if isinstance(rhs, VExpr) else ("lit", rhs)
    va, oa, fa = _eval_vexpr(tape, names, lhs.tree, col_specs, dialect,
                             sample)
    vb, ob, fb = _eval_vexpr(tape, names, rtree, col_specs, dialect,
                             sample)
    if fa != fb:
        va = va.to(torch.float32) if not fa else va
        vb = vb.to(torch.float32) if not fb else vb
    m = {"==": va == vb, "!=": va != vb, "<": va < vb,
         "<=": va <= vb, ">": va > vb, ">=": va >= vb}[op]
    return _host(oa & ob & m)


def _typed_literal(col: Col, value):
    """Host conversion of a predicate literal to the column's device
    value domain (days / epoch units / scaled decimal)."""
    if col.type == "int32":
        if isinstance(value, float) and not value.is_integer():
            raise ValueError(
                f"literal {value!r} is not an integer: comparisons "
                "against an int32 column need integral literals (type "
                "the column as float to compare fractions)"
            )
        return int(value)
    if col.type == "int64":
        if isinstance(value, float) and not value.is_integer():
            raise ValueError(
                f"literal {value!r} is not an integer: comparisons "
                "against an int64 column need integral literals"
            )
        return int(value)
    if col.type in ("float32", "float"):
        return np.float32(value)
    if col.type == "date":
        return int(np.datetime64(value, "D").astype(np.int64))
    if col.type == "datetime":
        return int(np.datetime64(value, col.unit).astype(np.int64))
    if col.type == "decimal":
        from decimal import Decimal

        d = Decimal(str(value)).scaleb(col.scale)
        if d != d.to_integral_value():
            raise ValueError(
                f"literal {value!r} has more than {col.scale} decimal "
                "digits (column scale)"
            )
        return int(d)
    raise ValueError(col.type)


def _where_leaves(where):
    """Yield every (column, op, value) leaf of a where expression tree
    (a leaf, a list = AND, or ("and"/"or", [exprs]) / ("not", expr))."""
    if where is None:
        return
    if isinstance(where, tuple):
        if len(where) == 3 and isinstance(where[1], str):
            yield where
            return
        if len(where) == 2 and where[0] in ("and", "or"):
            for e in where[1]:
                yield from _where_leaves(e)
            return
        if len(where) == 2 and where[0] == "not":
            yield from _where_leaves(where[1])
            return
        if len(where) == 2 and where[0] == "exists":
            # unresolved EXISTS subquery (sql layer): no column leaves
            # of its own — its references live in its inner statement
            return
    elif isinstance(where, list):
        for e in where:
            yield from _where_leaves(e)
        return
    raise ValueError(f"bad where expression: {where!r}")


def _where_mask(tape, names, expr, col_specs, dialect, sample):
    """Evaluate a where expression tree to a host bool mask over data
    records (None = no constraint). Leaves run on device via
    _predicate_mask; combinators fold on host (the masks are one bit
    per record — tiny next to the gathers the leaves already did)."""
    if expr is None:
        return None
    if isinstance(expr, tuple):
        if len(expr) == 3 and isinstance(expr[1], str):
            return np.asarray(
                _predicate_mask(tape, names, expr, col_specs, dialect,
                                sample), bool)
        if len(expr) == 2 and expr[0] in ("and", "or"):
            combine = np.logical_and if expr[0] == "and" else np.logical_or
            mask = None
            for e in expr[1]:
                m = _where_mask(tape, names, e, col_specs, dialect,
                                sample)
                mask = m if mask is None else combine(mask, m)
            if mask is None:
                raise ValueError(f"empty {expr[0]!r} where expression")
            return mask
        if len(expr) == 2 and expr[0] == "not":
            inner = _where_mask(tape, names, expr[1], col_specs,
                                dialect, sample)
            if inner is None:
                raise ValueError("empty 'not' where expression")
            return ~inner
    elif isinstance(expr, list):
        mask = None
        for e in expr:
            m = _where_mask(tape, names, e, col_specs, dialect, sample)
            mask = m if mask is None else (mask & m)
        return mask
    raise ValueError(f"bad where expression: {expr!r}")


def _norm_row_key(v):
    """Normalize one composite-IN key element for cross-type equality:
    bytes decode to str, numpy scalars unwrap to Python values."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    if isinstance(v, np.generic):
        return v.item()
    return v


def rows_in_mask(col_arrays, ok_arrays, tuples) -> np.ndarray:
    """(n,) bool: row i True iff (col_arrays[0][i], ..) is a member of
    `tuples` and every key is non-NULL (SQL: a NULL key compares
    UNKNOWN, never matching). Fast path: per-column shared-code
    factorization over column values + tuple elements, radix-combined
    to one int64 code, membership via np.isin; columns whose values
    and literals don't co-sort (mixed types) fall back to a tuple-set
    scan."""
    n = col_arrays[0].shape[0]
    ok = np.ones(n, bool)
    for o in ok_arrays:
        if o is not None:
            ok &= np.asarray(o, bool)
    if not tuples:
        return np.zeros(n, bool)
    lits = [tuple(_norm_row_key(x) for x in t) for t in tuples]
    try:
        combined = None
        lit_combined = None
        for j, col in enumerate(col_arrays):
            if col.dtype != object:
                # typed columns: no per-element Python boxing — numpy
                # promotes the literal array to a common dtype
                # (int + float -> float64, exact for int32 values)
                vals = col
                lj = np.array([t[j] for t in lits])
                if lj.dtype == object or lj.dtype.kind not in "iufb" \
                        or col.dtype.kind not in "iufb":
                    raise TypeError("mixed literal/column types")
            else:
                vals = np.array([_norm_row_key(v) for v in col], object)
                lj = np.array([t[j] for t in lits], object)
            cat = np.concatenate([vals, lj])
            _u, inv = np.unique(cat, return_inverse=True)
            inv = inv.astype(np.int64)
            g = int(inv.max(initial=0)) + 1
            cv, clit = inv[:n], inv[n:]
            if combined is None:
                combined, lit_combined = cv, clit
            else:
                if g and combined.size and (
                        int(combined.max(initial=0)) + 1) * g >= 2**62:
                    raise TypeError("code space overflow")
                combined = combined * g + cv
                lit_combined = lit_combined * g + clit
        return ok & np.isin(combined, lit_combined)
    except TypeError:
        lset = set(lits)
        return ok & np.array(
            [tuple(_norm_row_key(col[i]) for col in col_arrays) in lset
             for i in range(n)], bool)


def _in_rows_mask(tape, names, cols, tuples, col_specs, dialect,
                  sample: int) -> np.ndarray:
    """Composite-key IN over a tape: (col_a, col_b, ...) IN
    {(v_a, v_b, ...)}. The multi-key correlated EXISTS/IN rewrite
    (sql._resolve_exists) compiles to this leaf; typed key columns
    parse on device, text keys decode via the stage-2 gather, and the
    membership itself is the vectorized shared-code host pass above."""
    from .frame import _true_window, infer_schema

    col_arrays, ok_arrays = [], []
    for key in cols:
        field = _field_index(names, key)
        name = names[field]
        col = col_specs.get(name)
        if col is None:
            col = infer_schema(tape, names, columns=[field],
                               sample=sample)[name]
            col_specs[name] = col
        if col.type in ("str", "bytes"):
            window = col.max_len or _true_window(tape, field, 16)
            ids = _record_ids(tape, None)
            out, ln, v = tape.gather_decoded(
                ids, np.full(ids.shape, field, np.int32),
                max_len=window, dialect=dialect, trim=col.trim)
            raw = tape.to_host_lists(out, ln, v)
            okm = np.array([b is not None for b in raw], bool)
            vals = np.array(
                [b"" if b is None else b for b in raw], object)
            col_arrays.append(vals)
            ok_arrays.append(okm)
        else:
            vals, okm, kind = _parse_column(tape, field, col, dialect)
            col_arrays.append(_host(vals))
            ok_arrays.append(None if okm is None
                             else _host(okm).astype(bool))
    return rows_in_mask(col_arrays, ok_arrays, tuples)


def _predicate_mask(tape, names, pred, col_specs, dialect,
                    sample: int) -> np.ndarray:
    from .frame import _true_window, infer_schema

    if not (isinstance(pred, (tuple, list)) and len(pred) == 3):
        raise ValueError(
            f"predicate must be (column, op, value), got {pred!r}"
        )
    key, op, value = pred
    if op == "in_rows":
        return _in_rows_mask(tape, names, key, value, col_specs,
                             dialect, sample)
    if isinstance(key, VExpr):
        if op not in ("==", "!=", "<", "<=", ">", ">="):
            raise ValueError(
                f"op {op!r} needs a plain column, not an arithmetic "
                "expression"
            )
        return _vexpr_cmp_mask(tape, names, key, op, value, col_specs,
                               dialect, sample)
    fold = None
    if isinstance(key, TextFold):
        fold, key = key.fn, key.col
        if op not in ("==", "!=", "in", "like", *_STR_OPS):
            raise ValueError(
                f"op {op!r} does not apply to UPPER()/LOWER(): case "
                "folding is for text compares (=, !=, IN, LIKE, "
                "startswith/endswith/contains)"
            )
    if op not in _OPS:
        raise ValueError(f"unknown predicate op {op!r}; one of {_OPS}")
    field = _field_index(names, key)
    name = names[field]
    col = col_specs.get(name)
    if col is None:
        col = infer_schema(tape, names, columns=[field],
                           sample=sample)[name]
        col_specs[name] = col

    if op in ("isnull", "notnull"):
        # NULL-ness = typed-parse failure (the layer's missing-data
        # notion; the predicate's `value` is ignored). Text columns
        # always materialize, so nothing is null there.
        n = _data_records(tape)
        if col.type in ("str", "bytes"):
            full = np.zeros(n, bool)
            return full if op == "isnull" else ~full
        _, ok, _ = _parse_column(tape, field, col, dialect)
        ok = _host(ok).astype(bool)
        return ~ok if op == "isnull" else ok

    if fold is not None and col.type not in ("str", "bytes"):
        raise ValueError(
            f"UPPER()/LOWER() fold decoded text; {name!r} is "
            f"{col.type} (give an explicit str/bytes schema)"
        )
    if col.type in ("str", "bytes"):
        if op == "in":
            from .device_tape import _filter_equals

            lits = [_fold_host(_text_literal(v), fold) for v in value]
            window = col.max_len or _true_window(tape, field, 16)
            window = max(window,
                         max((len(b) for b in lits), default=1))
            n = _data_records(tape)
            if not lits:
                return np.zeros(n, bool)
            # ONE decoded gather; each list element is then a cheap
            # device compare over the same gathered tensor (per-value
            # gathers would re-read the column once per element)
            out, lengths, valid = tape.gather_decoded(
                *_whole_column(tape, field), max_len=window,
                dialect=dialect,
            )
            out = _fold_device(out, fold)
            m = None
            for b in lits:
                needle = np.zeros(window, np.uint8)
                needle[: len(b)] = np.frombuffer(b, np.uint8)
                mv = _host(_filter_equals(
                    out, lengths, valid,
                    _to_dev(needle, out.device, torch.uint8), len(b)
                ))
                m = mv if m is None else (m | mv)
            return m
        if op in _STR_OPS:
            window = col.max_len or _true_window(tape, field, 16)
            return _decoded_match_mask(tape, field, value, dialect,
                                       window, op, fold=fold)
        if op == "like":
            window = col.max_len or _true_window(tape, field, 16)
            return _like_pattern_mask(tape, field, value, dialect, window,
                                      fold=fold)
        if op not in ("==", "!="):
            raise ValueError(
                f"op {op!r} needs a typed column; {name!r} is "
                f"{col.type} (give an explicit schema to order on text)"
            )
        lit = _text_literal(value)
        window = col.max_len or _true_window(tape, field, 16)
        window = max(window, len(lit), 1)
        m = _host(_decoded_eq_mask(tape, field, value, dialect,
                                   window, fold=fold))
        return ~m if op == "!=" else m

    if op in _STR_OPS or op == "like":
        raise ValueError(
            f"op {op!r} matches decoded text; {name!r} is {col.type} "
            "(give an explicit str/bytes schema for this column)"
        )
    vals, ok, kind = _parse_column(tape, field, col, dialect)
    if kind == "i64host":
        vals = _host(vals)
        ok = _host(ok).astype(bool)
        if op == "between":
            lo = _typed_literal(col, value[0])
            hi = _typed_literal(col, value[1])
            return ok & (vals >= lo) & (vals <= hi)
        if op == "in":
            lits = np.array([_typed_literal(col, v) for v in value],
                            np.int64)
            return ok & np.isin(vals, lits)
        lit = _typed_literal(col, value)
        return ok & _PY_OPS[op](vals, lit)
    if op == "between":
        lo = _to_dev(_typed_literal(col, value[0]), vals.device, vals.dtype)
        hi = _to_dev(_typed_literal(col, value[1]), vals.device, vals.dtype)
        return _host(_between_mask(vals, ok, lo, hi))
    if op == "in":
        m = None
        for v in value:
            lit = _to_dev(_typed_literal(col, v), vals.device, vals.dtype)
            mv = _cmp_mask(vals, ok, lit, "==")
            m = mv if m is None else (m | mv)
        return (_host(m) if m is not None
                else np.zeros(vals.shape[0], bool))
    lit = _to_dev(_typed_literal(col, value), vals.device, vals.dtype)
    return _host(_cmp_mask(vals, ok, lit, op))


def select_records(tape, where, *, names=None, schema=None, dialect=None,
                   sample: int = 256) -> np.ndarray:
    """Evaluate `where` (predicate or list, AND) against a serving tape
    and return matching record ids as (K,) int32. `schema` supplies
    column types for predicate columns (name -> spec); unlisted columns
    are inferred. Rows failing a predicate column's typed parse never
    match.

    A CsvCorpus evaluates per file and returns GLOBAL record ids
    (int64, rebased by the corpus routing table — the ids
    corpus.seek_field/seek_record accept)."""
    from .corpus_api import CsvCorpus

    if isinstance(tape, CsvCorpus):
        nm = tape.header_names()
        wsch = _lock_where_schema(tape, where, schema, sample)
        parts = []
        for st, start in zip(tape.device_tapes(), tape._starts[:-1]):
            ids = select_records(st, where, names=nm, schema=wsch,
                                 dialect=dialect, sample=sample)
            parts.append(ids.astype(np.int64) + int(start))
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)
    if names is None:
        hdr = getattr(tape, "header", None)
        names = getattr(hdr, "names", None)
        if names is None:
            names = [f"c{i}" for i in range(int(tape.field_cnt))]
    col_specs: Dict[str, Col] = {}
    if schema:
        for k, v in schema.items():
            col_specs[names[_field_index(names, k)]] = parse_spec(v)
    mask = _where_mask(tape, names, where, col_specs, dialect, sample)
    if mask is None:
        return _record_ids(tape, None)
    return np.flatnonzero(mask).astype(np.int32)


# -------------------------------------------------------------- ordering

class SortDir(int):
    """An ORDER BY direction that still reads as a plain bool
    (`descending` truthiness) everywhere, but can carry the NULLS
    FIRST modifier. NULLS LAST is the layer's default in BOTH
    directions (the layer's convention); an explicit NULLS FIRST flips
    only the placement of parse-failure rows, never the key order.
    Equality/hash include the modifier so sort-prep caches keyed on
    order specs never conflate `DESC` with `DESC NULLS FIRST`."""

    def __new__(cls, desc, nulls_first: bool = False):
        self = super().__new__(cls, 1 if desc else 0)
        self.nulls_first = bool(nulls_first)
        return self

    def __repr__(self):
        return (f"SortDir({bool(int(self))}"
                f"{', nulls_first=True' if self.nulls_first else ''})")

    def __eq__(self, other):
        return (int(self), self.nulls_first) == (
            int(other) if isinstance(other, (int, bool)) else other,
            getattr(other, "nulls_first", False))

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((int(self), self.nulls_first))


def _nulls_first(direction) -> bool:
    return getattr(direction, "nulls_first", False)


def _order_device(vals, ok, descending: bool, nulls_first: bool = False):
    """Permutation ordering rows by (valid-first, key, original id).
    Two stable sorts: secondary key first, then the validity flag —
    invalid rows land at the end (or the start, under NULLS FIRST)
    under either direction without key sentinels (so a legit INT32_MAX
    row never interleaves with them). Descending int32 flips via
    bitwise NOT (monotone decreasing, no INT32_MIN negation overflow);
    float via negation (invalid rows' NaNs are ranked by the validity
    pass, not the key pass)."""
    k = vals
    if descending:
        k = ~k if k.dtype == torch.int32 else -k
    if k.dtype == torch.float32:
        # NaNs sort unpredictably; their rows are invalid (ok False)
        # but must not perturb the stable secondary order of valid rows
        k = torch.where(ok, k, torch.inf)
    order = torch.sort(k, stable=True).indices
    flag = ok if nulls_first else ~ok
    order2 = torch.sort(flag.to(torch.int32)[order], stable=True).indices
    return order[order2]


def _host_order_perm(vals, ok, descending: bool) -> np.ndarray:
    """Host ORDER BY permutation shared by every non-device sort path
    (str/bytes keys, host int64 values, materialized corpus frames):
    parse-failures last under either direction (first when
    `descending` is a SortDir carrying NULLS FIRST), ties stable in
    input order. Handles object, datetime64, integer and float key
    arrays."""
    nf = _nulls_first(descending)
    vals = _host(vals)
    ok = (np.ones(vals.shape[0], bool) if ok is None
          else _host(ok).astype(bool))
    ok_ids = np.flatnonzero(ok)
    keys = vals[ok_ids]
    if keys.dtype == object:
        if descending:
            # reversing an ascending sort would also reverse equal-key
            # runs (breaking stability); stable-sort the negated
            # distinct-value rank instead
            _, inv = np.unique(keys, return_inverse=True)
            sub = np.argsort(-inv.astype(np.int64), kind="stable")
        else:
            sub = np.argsort(keys, kind="stable")
    else:
        k = keys
        if k.dtype.kind in "Mmi":
            # datetime64 has no unary negation; int32 negation of
            # INT32_MIN overflows — sort the int64 view
            k = k.astype(np.int64)
        sub = np.argsort(-k if descending else k, kind="stable")
    parts = [ok_ids[sub], np.flatnonzero(~ok)]
    return np.concatenate(parts[::-1] if nf else parts)


def _host_multi_order_perm(n: int, col_fn, order) -> np.ndarray:
    """Lexicographic multi-key host ordering: stable single-key sorts
    composed from the LAST key to the first. `col_fn(key) -> (vals,
    ok-or-None)`; `order` is [(key, descending)]. Shared by the corpus
    read path and the SQL join path."""
    perm = np.arange(n, dtype=np.int64)
    for key, desc in reversed(list(order)):
        vals, okm = col_fn(key)
        sub = _host_order_perm(
            _host(vals)[perm],
            None if okm is None else _host(okm)[perm], desc)
        perm = perm[sub]
    return perm


def order_records(tape, by, *, names=None, schema=None, where=None,
                  records=None, descending: bool = False,
                  limit: Optional[int] = None, dialect=None,
                  sample: int = 256) -> np.ndarray:
    """Record ids ordered by a column's typed values (ORDER BY).

    Typed columns sort on device (stable argsort; ties keep record
    order); str/bytes sort by the stage-2 DECODED text on host;
    decimal/datetime sort their host int64 values. Rows failing the
    typed parse always sort LAST (both directions). `where` filters
    first; `records` restricts to explicit ids (mutually exclusive with
    `where`); `limit` truncates after ordering.

    `by` may be a LIST of columns (lexicographic multi-key ORDER BY:
    stable sorts applied from the last key to the first); `descending`
    then takes either one bool for all keys or a per-key list. Rows
    failing the FIRST key's parse sort last; a later key's parse
    failures sort last only within ties of the earlier keys."""
    if isinstance(by, (list, tuple)):
        keys = list(by)
        if not keys:
            raise ValueError("empty order-by key list")
        descs = (list(descending)
                 if isinstance(descending, (list, tuple))
                 else [descending] * len(keys))  # keep SortDir intact
        if len(descs) != len(keys):
            raise ValueError(
                f"descending has {len(descs)} entries for {len(keys)} "
                "order-by keys"
            )
        ids = None
        for k, d in reversed(list(zip(keys, descs))):
            ids = order_records(
                tape, k, names=names, schema=schema,
                where=(where if ids is None else None),
                records=(records if ids is None else ids),
                descending=d, dialect=dialect, sample=sample,
            )
        return ids[:limit] if limit is not None else ids
    if names is None:
        hdr = getattr(tape, "header", None)
        names = getattr(hdr, "names", None)
        if names is None:
            names = [f"c{i}" for i in range(int(tape.field_cnt))]
    if where is not None:
        if records is not None:
            raise ValueError("pass either where= or records=, not both")
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    field = _field_index(names, by)
    name = names[field]
    col = None
    if schema:
        for k, v in schema.items():
            if names[_field_index(names, k)] == name:
                col = parse_spec(v)
                break
    if col is None:
        col = infer_col(tape, names, field, sample)
    ids = _record_ids(tape, records)
    if col.type in ("str", "bytes"):
        from .frame import _true_window

        window = col.max_len or _true_window(tape, field, 16)
        out, ln, v = tape.gather_decoded(
            ids, np.full(ids.shape, field, np.int32), max_len=window,
            dialect=dialect, trim=col.trim,
        )
        raw = tape.to_host_lists(out, ln, v)
        okm = np.array([b is not None for b in raw], bool)
        keys = np.array([b"" if b is None else b for b in raw],
                        dtype=object)
        out_ids = ids[_host_order_perm(keys, okm, descending)]
        return out_ids[:limit] if limit is not None else out_ids
    vals, ok, kind = _parse_column(tape, field, col, dialect,
                                   records=records)
    if kind == "i64host":
        out_ids = ids[_host_order_perm(vals, ok, descending)]
        return out_ids[:limit] if limit is not None else out_ids
    perm = _host(_order_device(vals, _to_dev(ok, vals.device, torch.bool),
                               bool(descending),
                               nulls_first=_nulls_first(descending)))
    out_ids = ids[perm]
    return out_ids[:limit] if limit is not None else out_ids


def infer_col(tape, names, field: int, sample: int) -> Col:
    """Single-column type inference (shared by order/stat/count paths)."""
    from .frame import infer_schema

    return infer_schema(tape, names, columns=[field],
                        sample=sample)[names[field]]


def _merge_value_counts(parts: List[Dict]) -> Dict:
    """Associative combine of per-tape value_counts results."""
    acc: Dict = {}
    for p in parts:
        for k, c in zip(list(p["keys"]), list(p["count"])):
            acc[k] = acc.get(k, 0) + int(c)
    ks = sorted(acc)
    dtype = parts[0]["keys"].dtype if parts else object
    return {"keys": np.array(ks, dtype=dtype),
            "count": np.array([acc[k] for k in ks], np.int64)}


def value_counts(source, column, spec=None, *, where=None, records=None,
                 schema=None, dialect=None, backend: str = "auto",
                 engine: str = "offsets", sample: int = 256,
                 device="cuda") -> Dict:
    """Distinct values of a column with their row counts.

    Typed columns count on device (segment grouping); str/bytes
    factorize the decoded text. Returns {"keys": (G,) array ascending,
    "count": (G,) int64}; rows failing the typed parse are excluded.
    `records` restricts to explicit ids (mutually exclusive with
    `where`, single tape only — callers that already pushed a filter
    down, like describe, pass it to avoid re-evaluating the where).
    A CsvCorpus counts per file and merges (associative combine). A
    path or bytes is indexed on `device`; a tape or corpus keeps its
    own."""
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape, _true_window

    if isinstance(source, CsvCorpus):
        if records is not None:
            raise ValueError("records= over a corpus is ambiguous; "
                             "pass where= instead")
        col = _lock_corpus_spec(source, column, spec, sample)
        wsch = _lock_where_schema(source, where, schema, sample)
        parts = [
            value_counts(t, column, col, where=where, schema=wsch,
                         dialect=dialect, sample=sample)
            for t in source.device_tapes()
        ]
        return _merge_value_counts(parts)
    tape, names = _resolve_tape(source, dialect, backend, engine, False,
                                device)
    field = _field_index(names, column)
    col = parse_spec(spec) if spec is not None else infer_col(
        tape, names, field, sample)
    if where is not None:
        if records is not None:
            raise ValueError("pass either where= or records=, not both")
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    if col.type in ("str", "bytes"):
        window = col.max_len or _true_window(tape, field, 16)
        ids = _record_ids(tape, records)
        out, ln, v = tape.gather_decoded(
            ids, np.full(ids.shape, field, np.int32), max_len=window,
            dialect=dialect, trim=col.trim,
        )
        raw = tape.to_host_lists(out, ln, v)
        keys_b = np.array([b for b in raw if b is not None], dtype=object)
        uniq, counts = np.unique(keys_b, return_counts=True)
        if col.type == "str":
            uniq = np.array(
                [b.decode("utf-8", "replace") for b in uniq], dtype=object
            )
        return {"keys": uniq, "count": counts.astype(np.int64)}
    vals, ok, kind = _parse_column(tape, field, col, dialect,
                                   records=records)
    if kind == "i64host":
        sel = _host(vals)[_host(ok).astype(bool)]
        uniq, counts = np.unique(sel, return_counts=True)
        return {"keys": uniq, "count": counts.astype(np.int64)}
    if vals.shape[0] == 0:
        return {"keys": np.zeros(0, _host(vals).dtype),
                "count": np.zeros(0, np.int64)}
    # _group_order directly: counts have no exactness ceiling, so the
    # group_aggregate 2**20 sum-exactness check must not apply here
    _o, _s, _sok, gk, counts, n_groups = _group_order(
        vals, _to_dev(ok, vals.device, torch.bool))
    g = int(n_groups)
    return {"keys": _host(gk[:g]),
            "count": _host(counts[:g]).astype(np.int64)}


def distinct(source, column, spec=None, **kw) -> np.ndarray:
    """Distinct values of a column (ascending; see value_counts)."""
    return value_counts(source, column, spec, **kw)["keys"]


# -------------------------------------------------------------- group-by

# int32 -> two unsigned 10-bit digits + a signed high part (v >> 20,
# range ±2^11): per-digit int32 segment sums stay exact for groups up to
# 2^20 rows (the binding term is the high part: 2^11 * 2^20 = 2^31)
_GROUP_SPLIT = (20, 10)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int):
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def _segment_reduce(x: torch.Tensor, seg: torch.Tensor, n: int,
                    reduce: str, empty):
    """Per-segment amin/amax of x over segments 0..n-1; a segment with no
    row holds `empty` (jax.ops.segment_min/max's identity)."""
    return torch.full((n,), empty, dtype=x.dtype,
                      device=x.device).scatter_reduce_(
        0, seg, x, reduce, include_self=False)


def _group_order(keys: torch.Tensor, ok: torch.Tensor):
    """Grouping phase shared by every aggregate: stable-sort by key
    (invalid rows to the tail under the max sentinel), segment by key
    change. Returns (order, seg, sorted-ok, group keys, per-group
    ok-row counts, valid-group count) — value columns then reduce
    against (order, seg) without re-sorting (multi-aggregate GROUP BY
    pays for ONE sort). Keys are int32, int64 or float32 (invalid rows
    sort under the dtype's largest value; a valid row holding it shares
    their segment, and the ok counts keep them apart). `seg` is int64,
    the index type of the segment reduces."""
    n = keys.shape[0]
    is_float = keys.dtype == torch.float32
    hi, lo = ((torch.inf, -torch.inf) if is_float
              else (torch.iinfo(keys.dtype).max, torch.iinfo(keys.dtype).min))
    k = torch.where(ok, keys, hi)
    sk, order = torch.sort(k, stable=True)
    sok = ok[order]
    change = torch.cat([torch.zeros(1, dtype=torch.bool, device=k.device),
                        sk[1:] != sk[:-1]])
    seg = torch.cumsum(change.to(torch.int32), 0, dtype=torch.int32).long()
    counts = _segment_sum(sok.to(torch.int32), seg, n)
    n_groups = torch.where(sok, seg, -1).amax() + 1
    # every row of a segment holds the same key, so any segment reduce
    # recovers it
    gkeys = _segment_reduce(sk, seg, n, "amax", lo)
    return order, seg, sok, gkeys, counts, n_groups


@GLOBAL.span("query.group_reduce")
def _group_reduce(vals, vok, order, seg, is_float: bool):
    """Per-segment reduce of one value column against a precomputed
    group order: exact digit-split int sums (see _GROUP_SPLIT) or f32
    sums, masked min/max, ok-value counts."""
    n = vals.shape[0]
    sv = vals[order]
    sok = vok[order]
    zero = torch.where(sok, sv, 0)
    if is_float:
        sums = (_segment_sum(zero, seg, n),)
    else:
        sums = tuple(
            _segment_sum(
                (zero >> s) & ((1 << w) - 1) if s + w <= 31
                else zero >> s,
                seg, n,
            )
            for s, w in ((0, _GROUP_SPLIT[1]),
                         (_GROUP_SPLIT[1], _GROUP_SPLIT[1]),
                         (_GROUP_SPLIT[0], 31))
        )
    hi, lo = ((torch.inf, -torch.inf) if is_float
              else (_INT32_MAX, _INT32_MIN))
    mns = _segment_reduce(torch.where(sok, sv, hi), seg, n, "amin", hi)
    mxs = _segment_reduce(torch.where(sok, sv, lo), seg, n, "amax", lo)
    cnt = _segment_sum(sok.to(torch.int32), seg, n)
    return sums, mns, mxs, cnt


def _combine_digit_sums(sums, g: int, is_float: bool):
    """Host recombination of _group_reduce's partial sums -> exact
    per-group totals (int64 for ints, float64 for floats). Only the g
    valid groups leave the device."""
    if is_float:
        return _host(sums[0][:g]).astype(np.float64)
    d0, d1, d2 = (_host(s[:g]).astype(np.int64) for s in sums)
    w = _GROUP_SPLIT[1]
    # d2 carries the sign bits (arithmetic >> 20 keeps them); d0/d1
    # are unsigned digit fields, so the recomposition is exact
    return d0 + (d1 << w) + (d2 << _GROUP_SPLIT[0])


def group_aggregate(keys, vals, key_ok=None, val_ok=None):
    """Group `vals` by `keys` entirely on device; ship only per-group
    results to host.

    keys — (N,) int32 or float32 tensor (e.g. a parsed column), or a
    host array (int64 becomes int32 and float64 float32, as the JAX
    package's 64-bit-off conversion makes them); vals — (N,) int32 or
    float32; key_ok/val_ok — parse-ok masks (rows failing either are
    excluded). The work runs on the device of the first tensor among
    keys and vals, else on "cuda". Returns a dict with host arrays
    `keys` (G,), `sum`, `min`, `max`, `count` — groups in ascending key
    order. Integer sums are exact for groups up to 2**20 rows
    (digit-split segment sums; larger groups raise)."""
    dev = next((x.device for x in (keys, vals)
                if isinstance(x, torch.Tensor)), None) or resolve_device()
    keys = _as_column(keys, dev)
    vals = _as_column(vals, dev)
    n = keys.shape[0]
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    if key_ok is not None:
        ok = ok & _to_dev(key_ok, dev, torch.bool)
    if val_ok is not None:
        ok = ok & _to_dev(val_ok, dev, torch.bool)
    if n == 0:
        empty_k = np.zeros(0, _host(keys).dtype)
        z = np.zeros(0, np.int64)
        return {"keys": empty_k, "sum": z, "min": z, "max": z,
                "count": np.zeros(0, np.int64)}
    is_float = vals.dtype == torch.float32
    order, seg, _sok, gk, counts, n_groups = _group_order(keys, ok)
    sums, mns, mxs, _cnt = _group_reduce(vals, ok, order, seg, is_float)
    g = int(n_groups)
    GLOBAL.count("query.groups", g)
    counts = _host(counts[:g]).astype(np.int64)
    if not is_float and counts.max(initial=0) >= 2**20:
        # the ceiling protects integer digit-split exactness only;
        # float sums have no such cliff (and a bare assert would
        # vanish under python -O)
        raise ValueError(
            "group larger than 2**20 rows: integer digit-split sum "
            "would not be exact — aggregate per file (CsvCorpus) or "
            "shard the input first"
        )
    return {
        "keys": _host(gk[:g]),
        "sum": _combine_digit_sums(sums, g, is_float),
        "min": _host(mns[:g]),
        "max": _host(mxs[:g]),
        "count": counts,
    }


@GLOBAL.span("query.group_keys")
def _prepare_group_keys(tape, names, key, key_spec, records, dialect,
                        sample: int):
    """Unified GROUP BY key preparation for every key shape.

    Returns (kind, keys, kok, decode):
    - kind "device": keys (N,) int32/int64/float32 codes or values +
      bool validity, tensors on the tape's device — segment-groupable
      there;
    - kind "host": keys (N,) int64 np + np bool (a single decimal or
      datetime key, whose values the host put together);
    - decode maps the ascending per-group key values back to the
      user-facing representation (text through the factorization's key
      table, composite radix codes back to per-column arrays, typed
      values as they are), reading back only the keys it is given
      (the counter `query.group_keys_read`). A composite key's decode
      also carries `radix`, each column's distinct-key count.

    Text keys factorize on the device (_factorize_text_device), and so do
    the columns of a composite key of any type (_factorize_values_device):
    only the distinct keys asked for reach the host. A composite code
    space past int32 stays on the device as int64 codes.
    """
    GLOBAL.count("query.host_key_rows", 0)
    GLOBAL.count("query.host_typed_key_rows", 0)
    if isinstance(key, (list, tuple)):
        # composite: factorize each column to dense codes, combine into
        # one mixed-radix code on the device; each factorization is
        # sorted, so the combined order is lexicographic (col0, col1, ...)
        specs = (list(key_spec) if key_spec is not None
                 else [None] * len(key))
        if len(specs) != len(key):
            raise ValueError(
                f"key_spec has {len(specs)} entries for {len(key)} key "
                "columns"
            )
        uniqs, cols_meta = [], []
        combo = None
        ok_all = None
        space = 1  # exact Python-int key-space size (no i64 wrap)
        for k, spec in zip(key, specs):
            f = _field_index(names, k)
            col = (parse_spec(spec) if spec is not None
                   else infer_col(tape, names, f, sample))
            inv, ok, uniq = _factorize_key_column(tape, f, col, dialect,
                                                  records)
            inv = inv.to(torch.int64)
            ok_all = ok if ok_all is None else (ok_all & ok)
            uniqs.append(uniq)
            cols_meta.append(col)
            space *= max(len(uniq), 1)
            if space >= 2**62:
                raise ValueError(
                    "composite key space too large to radix-combine"
                )
            combo = inv if combo is None else combo * len(uniq) + inv

        def decode(codes):
            idxs = []
            rem = np.asarray(codes, np.int64)
            for uniq in reversed(uniqs):
                rem, idx = np.divmod(rem, max(len(uniq), 1))
                idxs.append(idx)
            idxs.reverse()
            return [
                _decode_key_array(uniq[idx], col)
                for uniq, idx, col in zip(uniqs, idxs, cols_meta)
            ]

        decode.radix = [len(u) for u in uniqs]
        if combo is None or not combo.shape[0]:
            return ("host", np.zeros(0, np.int64), np.zeros(0, bool),
                    decode)
        if space <= 2**31 - 1:
            return ("device", combo.to(torch.int32), ok_all, decode)
        return ("device", combo, ok_all, decode)

    kf = _field_index(names, key)
    kcol = (parse_spec(key_spec) if key_spec is not None
            else infer_col(tape, names, kf, sample))
    if kcol.type in ("str", "bytes"):
        # categorical key: dense int32 codes in key order, then the
        # device segment grouping runs on the codes
        codes, kok, uniq = _factorize_text_device(
            *_gather_text_key(tape, kf, kcol, dialect, records))

        def decode(code_vals):
            return _decode_key_array(uniq[code_vals], kcol)

        return ("device", codes, kok, decode)
    kv, kok, kkind = _parse_column(tape, kf, kcol, dialect,
                                   records=records, device_i64=True)
    if kkind == "i64host":
        return ("host", _host(kv), _host(kok).astype(bool), _keys_read)
    return ("device", kv, _to_dev(kok, kv.device, torch.bool), _keys_read)


def _keys_read(vals):
    """decode of keys that are their own values: counts them as read."""
    GLOBAL.count("query.group_keys_read", int(np.shape(vals)[0]))
    return vals


class _KeyTable:
    """The G distinct keys of a column factorized on the device, in code
    order, left there: indexing it with host codes reads back only the
    keys asked for, each once (the counter `query.group_keys_read`)."""

    def __init__(self, n: int, fetch):
        self.n, self._fetch = n, fetch

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, codes) -> np.ndarray:
        want, inv = np.unique(np.asarray(codes, np.int64).reshape(-1),
                              return_inverse=True)
        GLOBAL.count("query.group_keys_read", int(want.size))
        return self._fetch(want)[inv.reshape(-1)]


def _factorize_key_column(tape, field: int, col: Col, dialect, records):
    """One column of a composite key -> (codes (N,), ok (N,) bool, key
    table), all on the tape's device: text through its decoded bytes,
    typed columns through their parsed values (decimal and datetime
    values, which the host puts together, go back up first)."""
    if col.type in ("str", "bytes"):
        return _factorize_text_device(
            *_gather_text_key(tape, field, col, dialect, records))
    vals, ok, kind = _parse_column(tape, field, col, dialect,
                                   records=records, device_i64=True)
    if kind == "i64host":
        vals = _to_dev(np.asarray(vals, np.int64), tape.device, torch.int64)
    return _factorize_values_device(vals, _to_dev(ok, tape.device,
                                                  torch.bool))


@GLOBAL.span("query.key_factorize_int")
def _factorize_values_device(vals, ok):
    """Typed key values (N,) on the device -> (codes (N,) int64, 0 where
    not ok; ok; key table of the G distinct valid values, ascending):
    one sort of the valid rows, a mark where each run starts, a cumsum."""
    idx = torch.nonzero(ok).squeeze(1)
    sv, o = torch.sort(vals[idx])
    first = torch.ones_like(sv, dtype=torch.bool)
    first[1:] = sv[1:] != sv[:-1]
    codes = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
    codes[idx[o]] = torch.cumsum(first, 0) - 1
    uniq = sv[first]

    def fetch(want):
        return _host(uniq[_to_dev(want, uniq.device, torch.int64)])

    return codes, ok, _KeyTable(int(uniq.shape[0]), fetch)


def _gather_text_key(tape, field: int, col: Col, dialect, records):
    """A str/bytes key column decoded on the tape's device: (out (N, W)
    uint8, lengths, valid), W the column's longest field, bucketed."""
    from .frame import _true_window

    window = col.max_len or _true_window(tape, field, 16)
    ids = _record_ids(tape, records)
    return tape.gather_decoded(
        ids, np.full(ids.shape, field, np.int32), max_len=window,
        dialect=dialect, trim=col.trim,
    )


@GLOBAL.span("query.key_factorize")
def _factorize_text_device(out, lengths, valid):
    """Decoded text keys (out (N, W) uint8, lengths, valid) -> (codes
    (N,) int32, 0 where invalid; valid (N,) bool; key table of the G
    distinct valid keys), codes and validity on the keys' device. Code
    order is Python `bytes` order. The table keeps each key's first row
    of the sorted runs on the device and reads back only the keys asked
    for.

    Bytes [0, L) (L the longest valid key, one scalar readback), masked
    to each row's length, pack big-endian 7 to a non-negative int64
    word, with the length as the last key: zero padding ties only a true
    prefix with its extension by NULs, and the length breaks that tie.
    At L <= 7 bytes and length share one word, and one sort groups the
    rows; longer keys take a stable sort a word. Invalid rows key -1 in
    every word."""
    from . import device_tape
    from .window import _changes, _lex_sort

    n = out.shape[0]
    dev = out.device
    GLOBAL.count("query.device_key_rows", n)
    valid = valid.to(torch.bool)
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev), valid,
                _KeyTable(0, lambda want: np.zeros(0, object)))
    ln = torch.where(valid, lengths.to(torch.int64), 0)
    longest = int(ln.max())  # <= W: gather_decoded refuses a cut field
    b = torch.where(torch.arange(longest, device=dev) < ln[:, None],
                    out[:, :longest], 0)

    def be_word(cols):  # (N, k <= 7) bytes -> (N,) int64, big-endian
        shifts = 8 * torch.arange(cols.shape[1] - 1, -1, -1, device=dev)
        return (cols.to(torch.int64) << shifts).sum(1)

    if longest <= 7:
        words = [(be_word(b) << longest.bit_length()) | ln]
    else:
        words = [be_word(b[:, i:i + 7]) for i in range(0, longest, 7)]
        words.append(ln)
    keys = torch.stack([torch.where(valid, k, -1) for k in words])
    perm = _lex_sort(keys)
    vs = valid[perm]
    first = _changes(keys[:, perm]) & vs
    codes = torch.zeros(n, dtype=torch.int32, device=dev)
    codes[perm] = torch.where(vs, torch.cumsum(first, 0) - 1,
                              0).to(torch.int32)
    reps = perm[first]
    body = out[:, :longest]

    def fetch(want):
        rows = reps[_to_dev(want, dev, torch.int64)]
        raw = device_tape._to_host_lists(
            body[rows], lengths[rows],
            torch.ones(rows.shape[0], dtype=torch.bool, device=dev))
        arr = np.empty(len(raw), object)
        arr[:] = raw
        return arr

    return codes, valid, _KeyTable(int(reps.shape[0]), fetch)


def _host_key_column(tape, names, field: int, col: Col, dialect,
                     records, sample: int):
    """One join key column as host-factorizable values + ok mask. Typed
    columns parse on device and ship the (N,) values once; str/bytes
    ship the decoded text."""
    if col.type in ("str", "bytes"):
        out, ln, v = _gather_text_key(tape, field, col, dialect, records)
        with GLOBAL.span("query.key_to_host"):
            raw = tape.to_host_lists(out, ln, v)
            ok = np.array([b is not None for b in raw], bool)
            vals = np.array([b"" if b is None else b for b in raw],
                            dtype=object)
        return vals, ok, True
    vals, ok, _ = _parse_column(tape, field, col, dialect,
                                records=records)
    return _host(vals), _host(ok).astype(bool), col.type == "str"


def _decode_key_array(uniq: np.ndarray, col: Col):
    if col.type == "str":
        return np.array([b.decode("utf-8", "replace") for b in uniq],
                        dtype=object)
    return uniq


def _empty_keys(decode):
    """decode of zero groups — yields correctly-typed empty key
    arrays (or list of arrays for composite keys)."""
    return decode(np.zeros(0, np.int64))


def _host_reduce(n_groups: int, inv, sel, is_float: bool):
    """Host per-group sum/min/max. Integer values reduce in object
    arrays (Python ints — EXACT at any magnitude, incl. 18-digit
    decimals past float64's 2**53); floats in float64."""
    if is_float:
        sums = np.zeros(n_groups, np.float64)
        np.add.at(sums, inv, sel.astype(np.float64))
        mins = np.full(n_groups, np.inf)
        maxs = np.full(n_groups, -np.inf)
        np.minimum.at(mins, inv, sel.astype(np.float64))
        np.maximum.at(maxs, inv, sel.astype(np.float64))
        return sums, mins, maxs
    sums = np.zeros(n_groups, object)
    mins = np.full(n_groups, np.inf, object)
    maxs = np.full(n_groups, -np.inf, object)
    selo = sel.astype(object)
    np.add.at(sums, inv, selo)
    np.minimum.at(mins, inv, selo)
    np.maximum.at(maxs, inv, selo)
    return sums, mins, maxs


def _group_single(kind, kv, kok, decode, vv, vok, is_float) -> Dict:
    """One value column against prepared keys (device or host). int64
    keys with an integer value group on the host, whose exact sums have
    no 2**20-row ceiling."""
    if kind == "device" and kv.dtype == torch.int64 and not is_float:
        kind, kv, kok = "host", _host(kv), _host(kok).astype(bool)
    if kind == "device":
        g = group_aggregate(kv, vv, kok, vok)
        g["keys"] = decode(g["keys"])
        return g
    okh = kok & _host(vok).astype(bool)
    vh = _host(vv)
    GLOBAL.count("query.host_typed_key_rows", int(okh.shape[0]))
    uk, inv = np.unique(_host(kv)[okh], return_inverse=True)
    sel = vh[okh]
    sums, mins, maxs = _host_reduce(uk.shape[0], inv, sel, is_float)
    cnts = np.bincount(inv, minlength=uk.shape[0]).astype(np.int64)
    return {"keys": decode(uk), "sum": sums, "min": mins, "max": maxs,
            "count": cnts}


def _group_multi(kind, kv, kok, decode, values: Dict) -> Dict:
    """Several value columns against prepared keys — ONE key sort, one
    segment reduce per value. `values` is an ordered
    {name: (vals, ok, is_float)}. Result: {"keys", "count" (rows with
    valid key), "aggs": {name: {"sum","min","max","count"}}} where each
    per-value count tallies rows whose value parsed ok (SQL
    COUNT(col)); min/max of a group with count 0 are sentinels —
    check the count."""
    n = int(kv.shape[0])  # metadata: no device readback
    if n == 0:
        return {
            "keys": _empty_keys(decode),
            "count": np.zeros(0, np.int64),
            "aggs": {
                name: {"sum": np.zeros(0, np.int64),
                       "min": np.zeros(0, np.int64),
                       "max": np.zeros(0, np.int64),
                       "count": np.zeros(0, np.int64)}
                for name in values
            },
        }
    if kind == "device":
        order, seg, _sok, gk, counts, n_groups = _group_order(kv, kok)
        g = int(n_groups)
        GLOBAL.count("query.groups", g)
        counts_h = _host(counts[:g]).astype(np.int64)
        if (any(not isf for _, _, isf in values.values())
                and counts_h.max(initial=0) >= 2**20):
            if kv.dtype == torch.int64:
                # int64 values or wide composite codes, which grouped on
                # the host before they could stay on the device: their
                # exact host sums have no ceiling
                return _group_multi("host", _host(kv),
                                    _host(kok).astype(bool), decode,
                                    values)
            raise ValueError(
                "group larger than 2**20 rows: integer digit-split "
                "sum would not be exact — aggregate per file "
                "(CsvCorpus) or shard the input first"
            )
        aggs = {}
        for name, (vv, vok, isf) in values.items():
            vok2 = _to_dev(vok, kv.device, torch.bool) & kok
            sums, mns, mxs, cnt = _group_reduce(
                _as_column(vv, kv.device), vok2, order, seg, isf
            )
            aggs[name] = {
                "sum": _combine_digit_sums(sums, g, isf),
                "min": _host(mns[:g]),
                "max": _host(mxs[:g]),
                "count": _host(cnt[:g]).astype(np.int64),
            }
        return {"keys": decode(_host(gk[:g])), "count": counts_h,
                "aggs": aggs}
    okh = _host(kok).astype(bool)
    GLOBAL.count("query.host_typed_key_rows", int(okh.shape[0]))
    uk, inv = np.unique(_host(kv)[okh], return_inverse=True)
    counts_h = np.bincount(inv, minlength=uk.shape[0]).astype(np.int64)
    aggs = {}
    for name, (vv, vok, isf) in values.items():
        vh = _host(vv)[okh]
        vo = _host(vok).astype(bool)[okh]
        sums, mins, maxs = _host_reduce(uk.shape[0], inv[vo], vh[vo],
                                        isf)
        aggs[name] = {
            "sum": sums, "min": mins, "max": maxs,
            "count": np.bincount(
                inv[vo], minlength=uk.shape[0]).astype(np.int64),
        }
    return {"keys": decode(uk), "count": counts_h, "aggs": aggs}


def _having_series(g: Dict, target):
    """Resolve a having target to (values, valid) over the groups.
    Targets: "count" (rows with a valid key), "sum"/"min"/"max"/"mean"
    (single-value group-by), or "col.agg" with agg in
    sum/min/max/mean/count (multi-value: the column's aggregate).
    `valid` masks out groups where the aggregate is a sentinel
    (per-value count 0) — those never satisfy a having leaf."""
    multi = "aggs" in g
    col = None
    t = target
    if isinstance(t, str) and "." in t:
        col, t = t.rsplit(".", 1)
    if t == "count" and col is None:
        return np.asarray(g["count"]), None
    if t not in ("sum", "min", "max", "mean", "count"):
        raise ValueError(
            f"bad having target {target!r}: expected count, "
            "sum|min|max|mean (single value column) or col.agg"
        )
    if multi:
        if col is None:
            raise ValueError(
                f"having target {target!r} needs a column prefix "
                "(e.g. 'qty.sum') with several value columns"
            )
        if col not in g["aggs"]:
            raise ValueError(
                f"having target column {col!r} is not an aggregated "
                f"value column {list(g['aggs'])}"
            )
        src = g["aggs"][col]
    else:
        if col is not None:
            raise ValueError(
                f"having target {target!r}: single-value group-by "
                "aggregates are unprefixed (count/sum/min/max/mean)"
            )
        src = g
    cnt = np.asarray(src["count"] if multi else g["count"])
    valid = cnt > 0
    if t == "count":
        return cnt, None
    if t == "mean":
        vals = np.array([
            float(s) / int(c) if c else 0.0
            for s, c in zip(src["sum"], cnt)
        ])
        return vals, valid
    return np.asarray(src[t]), valid


_HAVING_OPS = {
    "==": np.equal, "!=": np.not_equal, "<": np.less,
    "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}


def _having_literal(v):
    """CLI strings coerce to numbers; numbers pass through."""
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            return float(v)
    return v


def _having_mask(g: Dict, expr) -> np.ndarray:
    """Evaluate a having expression tree (same shapes as `where`:
    a leaf, list = AND, ("and"/"or", [exprs]), ("not", expr)) to a
    bool mask over groups."""
    if isinstance(expr, tuple):
        if len(expr) == 3 and isinstance(expr[1], str):
            target, op, lit = expr
            vals, valid = _having_series(g, target)
            if op == "between":
                lo, hi = (_having_literal(lit[0]),
                          _having_literal(lit[1]))
                m = (vals >= lo) & (vals <= hi)
            elif op == "in":
                # Python equality: exact for object-int sums
                lits = [_having_literal(x) for x in lit]
                m = np.array([any(v == x for x in lits)
                              for v in vals.tolist()], bool)
            elif op in _HAVING_OPS:
                m = _HAVING_OPS[op](vals, _having_literal(lit))
            else:
                raise ValueError(f"bad having op {op!r}")
            m = np.asarray(m, bool)
            return m if valid is None else (m & valid)
        if len(expr) == 2 and expr[0] in ("and", "or"):
            if not expr[1]:
                raise ValueError(f"empty {expr[0]!r} having expression")
            combine = (np.logical_and if expr[0] == "and"
                       else np.logical_or)
            mask = None
            for e in expr[1]:
                m = _having_mask(g, e)
                mask = m if mask is None else combine(mask, m)
            return mask
        if len(expr) == 2 and expr[0] == "not":
            return ~_having_mask(g, expr[1])
    elif isinstance(expr, list):
        mask = None
        for e in expr:
            m = _having_mask(g, e)
            mask = m if mask is None else (mask & m)
        if mask is None:
            raise ValueError("empty having expression list")
        return mask
    raise ValueError(f"bad having expression: {expr!r}")


def _filter_groups(g: Dict, mask: np.ndarray) -> Dict:
    """Keep only the groups where mask is True (HAVING)."""
    out: Dict = {}
    keys = g["keys"]
    out["keys"] = ([np.asarray(a)[mask] for a in keys]
                   if isinstance(keys, list) else np.asarray(keys)[mask])
    out["count"] = np.asarray(g["count"])[mask]
    if "aggs" in g:
        out["aggs"] = {
            name: {k: np.asarray(v)[mask] for k, v in a.items()}
            for name, a in g["aggs"].items()
        }
    else:
        for k in ("sum", "min", "max"):
            out[k] = np.asarray(g[k])[mask]
    return out


def groupby_typed(source, key, value, *, key_spec=None, value_spec=None,
                  where=None, having=None, schema=None, dialect=None,
                  backend: str = "auto", engine: str = "offsets",
                  sample: int = 256, device="cuda") -> Dict:
    """End-to-end device group-by over a CSV: parse `key` and `value`
    columns on device, filter with `where`, group-aggregate, return a
    per-group host dict. Value columns may be any typed column —
    int32/float/float32/date reduce on device; decimal/datetime values
    group on host with EXACT object-int arithmetic (sums and extrema
    never round, even past float64's 2**53). Group keys may additionally be str/bytes
    (factorized to dense codes, device-grouped, groups keyed by the
    decoded text) or decimal/datetime (host grouping).

    `key` may be a LIST of columns (composite GROUP BY): each key
    column factorizes independently, the dense codes combine into one
    int32 code (device-grouped when the distinct-combination space
    fits), and `keys` in the result becomes a list of per-column
    arrays, groups in lexicographic key order. `key_spec`, when given
    for a composite key, is a matching list of specs.

    `value` may ALSO be a list of columns: the key sorts ONCE and each
    value column segment-reduces against the shared order. The result
    is then {"keys", "count" (rows with a valid key), "aggs":
    {column: {"sum","min","max","count"}}} — per-value counts tally
    rows whose value parsed ok (SQL COUNT(col)); a group's min/max are
    sentinels when its count is 0. `value_spec` is a matching list.

    `having` filters GROUPS by their aggregates (SQL HAVING), after
    the reduce (and, for a corpus, after the cross-file merge). Same
    expression shapes as `where` — a leaf, a list (AND), or
    ("and"/"or"/"not", ...) trees — with leaf targets "count",
    "sum"/"min"/"max"/"mean" (single value column) or "col.agg"
    (several), e.g. ("count", ">=", 10) or ("qty.mean", ">", 2.5).
    Groups whose per-value count is 0 never satisfy a
    sum/min/max/mean leaf (their aggregates are sentinels). "mean"
    compares in float64; string literals coerce to numbers (CLI).

    A CsvCorpus source groups per file under one corpus-locked schema
    and merges the per-file results (sums/counts add, min/max fold) —
    the associative reduce also lifts the per-group 2**20-row sum
    exactness ceiling to per-file granularity. A path or bytes is
    indexed on `device`; a tape or corpus keeps its own."""
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape

    multi = isinstance(value, (list, tuple))
    if isinstance(source, CsvCorpus):
        composite = isinstance(key, (list, tuple))
        if composite:
            ks = list(key)
            kspecs = (list(key_spec) if key_spec is not None
                      else [None] * len(ks))
            locked_k = [_lock_corpus_spec(source, k, s, sample)
                        for k, s in zip(ks, kspecs)]
        else:
            locked_k = _lock_corpus_spec(source, key, key_spec, sample)
        def _lock_value(v, s):
            if isinstance(v, VExpr):
                # lock every column the expression references so the
                # value domain cannot drift across member files; the
                # caller's dict spec (user schema entries) wins
                sd = s if isinstance(s, dict) else {}
                return {r: _lock_corpus_spec(source, r, sd.get(r),
                                             sample)
                        for r in v.columns()}
            return _lock_corpus_spec(source, v, s, sample)

        if multi:
            vspecs = (list(value_spec) if value_spec is not None
                      else [None] * len(value))
            locked_v = [_lock_value(v, s)
                        for v, s in zip(value, vspecs)]
        else:
            locked_v = _lock_value(value, value_spec)
        wsch = _lock_where_schema(source, where, schema, sample)
        parts = [
            groupby_typed(t, key, value, key_spec=locked_k,
                          value_spec=locked_v, where=where, schema=wsch,
                          dialect=dialect, sample=sample)
            for t in source.device_tapes()
        ]
        # HAVING filters AFTER the associative merge — per-file
        # aggregates are partial, so filtering parts would make the
        # result depend on where the file boundaries fall
        g = _merge_groups(parts, composite)
        return (_filter_groups(g, _having_mask(g, having))
                if having is not None else g)
    tape, names = _resolve_tape(source, dialect, backend, engine, False,
                                device)
    records = None
    if where is not None:
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    kind, kv, kok, decode = _prepare_group_keys(
        tape, names, key, key_spec, records, dialect, sample
    )

    def _parse_value(v, spec):
        if isinstance(v, VExpr):
            # aggregate over an arithmetic expression: evaluate on
            # device (spec, when a dict, locks the referenced columns;
            # entries may be spec strings or Col objects)
            specs = {}
            if isinstance(spec, dict):
                for kk, ss in spec.items():
                    if ss is not None:
                        specs[kk] = (ss if hasattr(ss, "type")
                                     else parse_spec(ss))
            vv, vok, isf = _eval_vexpr(tape, names, v.tree, specs,
                                       dialect, sample, records=records)
            return vv, vok, ("float" if isf else "int")
        vf = _field_index(names, v)
        vcol = (parse_spec(spec) if spec is not None
                else infer_col(tape, names, vf, sample))
        vv, vok, vkind = _parse_column(tape, vf, vcol, dialect,
                                       records=records)
        return vv, vok, vkind

    def _to_host_keys():
        return "host", _host(kv), _host(kok).astype(bool)

    if multi:
        vspecs = (list(value_spec) if value_spec is not None
                  else [None] * len(value))
        if len(vspecs) != len(value):
            raise ValueError(
                f"value_spec has {len(vspecs)} entries for "
                f"{len(value)} value columns"
            )
        parsed = {
            (str(v) if isinstance(v, VExpr)
             else names[_field_index(names, v)]): _parse_value(v, s)
            for v, s in zip(value, vspecs)
        }
        if any(k == "i64host" for _, _, k in parsed.values()):
            # decimal/datetime values exist only as host int64: group
            # on host (object arithmetic keeps the sums/extrema exact)
            kind, kv, kok = _to_host_keys()
        vals = {
            name: (vv, vok, vkind == "float")
            for name, (vv, vok, vkind) in parsed.items()
        }
        g = _group_multi(kind, kv, kok, decode, vals)
        return (_filter_groups(g, _having_mask(g, having))
                if having is not None else g)
    n = int(kv.shape[0])  # metadata: no device readback
    if n == 0:
        g = {"keys": _empty_keys(decode),
             "sum": np.zeros(0, np.int64),
             "min": np.zeros(0, np.int64),
             "max": np.zeros(0, np.int64),
             "count": np.zeros(0, np.int64)}
    else:
        vv, vok, vkind = _parse_value(value, value_spec)
        if vkind == "i64host":
            kind, kv, kok = _to_host_keys()
        g = _group_single(kind, kv, kok, decode, vv, vok,
                          vkind == "float")
    return (_filter_groups(g, _having_mask(g, having))
            if having is not None else g)


def _distinct_counts(sv, sok, seg, n: int) -> torch.Tensor:
    """Distinct values a segment: sv (n,) int64 values in group order,
    sok their validity, seg each row's segment (ascending) -> (n,) int64
    counts. Two stable sorts put the valid (segment, value) pairs in
    order; the first row of each distinct pair counts one."""
    from .window import _lex_sort

    idx = torch.nonzero(sok).squeeze(1)
    pairs = torch.stack([seg[idx], sv[idx]])
    pairs = pairs[:, _lex_sort(pairs)]
    first = torch.ones(pairs.shape[1], dtype=torch.int64, device=sv.device)
    first[1:] = (pairs[:, 1:] != pairs[:, :-1]).any(0).to(torch.int64)
    return _segment_sum(first, pairs[0], n)


def _distinct_key(tape, names, col, spec, dialect, records, sample: int):
    """A COUNT(DISTINCT) column as (int64 keys whose equality is the
    value's, ok) on the tape's device: text as its factorization's
    codes, floats as order keys, other types as their values."""
    f = _field_index(names, col)
    c = parse_spec(spec) if spec is not None else infer_col(
        tape, names, f, sample)
    if c.type in ("str", "bytes"):
        codes, ok, _ = _factorize_text_device(
            *_gather_text_key(tape, f, c, dialect, records))
        return codes.to(torch.int64), ok
    vals, ok, kind = _parse_column(tape, f, c, dialect, records=records,
                                   device_i64=True)
    if kind == "i64host":
        vals = _to_dev(np.asarray(vals, np.int64), tape.device, torch.int64)
    elif vals.dtype == torch.float32:
        vals = _f32_order_keys(vals)
    return vals.to(torch.int64), _to_dev(ok, tape.device, torch.bool)


def groupby_topk(source, key, *, key_spec=None, values=(),
                 value_specs=None, distinct=(), distinct_specs=None,
                 order=(), limit=None, where=None, schema=None,
                 dialect=None, backend: str = "auto",
                 engine: str = "offsets", sample: int = 256,
                 device="cuda") -> Dict:
    """GROUP BY on the device that hands the host only the groups it
    keeps: the first `limit` (all without one) in `order`, each an
    (item, descending) pair over "count" (rows a group), ("count", col)
    (rows whose `col` parsed), ("distinct", col) (COUNT(DISTINCT col))
    or ("key", i) (the i-th key column's value). Ties keep key order.

    The key prepares as for groupby_typed; the aggregates reduce per
    group on the device (`values`: int32/float32/float/date columns,
    their sums, extrema and counts; `distinct`: columns of any type,
    NULLs not counted); the order's keys sort the G groups there (span
    `query.group_topk`), and only the kept groups' aggregates and keys
    are read back. Returns {"keys", "count", "aggs": {col: {"sum",
    "min", "max", "count"}}, "distinct": {col: counts}}, the groups in
    `order`."""
    from .frame import _resolve_tape
    from .window import _lex_sort

    tape, names = _resolve_tape(source, dialect, backend, engine, False,
                                device)
    records = None
    if where is not None:
        records = select_records(tape, where, names=names, schema=schema,
                                 dialect=dialect, sample=sample)
    kind, kv, kok, decode = _prepare_group_keys(
        tape, names, key, key_spec, records, dialect, sample)
    if kind == "host":
        kv = _to_dev(np.asarray(kv, np.int64), tape.device, torch.int64)
        kok = _to_dev(kok, tape.device, torch.bool)
    vspecs = list(value_specs or [None] * len(values))
    dspecs = list(distinct_specs or [None] * len(distinct))
    n = int(kv.shape[0])
    if n == 0:
        z = np.zeros(0, np.int64)
        return {"keys": _empty_keys(decode), "count": z,
                "aggs": {v: {"sum": z, "min": z, "max": z, "count": z}
                         for v in values},
                "distinct": {c: z for c in distinct}}
    perm, seg, sok, gk, counts, n_groups = _group_order(kv, kok)
    g = int(n_groups)
    GLOBAL.count("query.groups", g)
    reduced = {}
    for v, spec in zip(values, vspecs):
        f = _field_index(names, v)
        col = parse_spec(spec) if spec is not None else infer_col(
            tape, names, f, sample)
        vv, vok, vkind = _parse_column(tape, f, col, dialect,
                                       records=records)
        if vkind not in ("int", "float"):
            raise ValueError(f"groupby_topk: {v!r} is {col.type}, not a "
                             "device value column")
        vok = _to_dev(vok, tape.device, torch.bool) & kok
        reduced[v] = (_group_reduce(_as_column(vv, tape.device), vok, perm,
                                    seg, vkind == "float"),
                      vkind == "float")
    if any(not isf for _, isf in reduced.values()) and \
            int(counts[:g].max()) >= 2**20:
        raise ValueError(
            "group larger than 2**20 rows: integer digit-split sum would "
            "not be exact — aggregate per file (CsvCorpus) or shard the "
            "input first")
    dcounts = {}
    for c, spec in zip(distinct, dspecs):
        dv, dok = _distinct_key(tape, names, c, spec, dialect, records,
                                sample)
        dcounts[c] = _distinct_counts(dv[perm], dok[perm] & sok, seg, n)

    with GLOBAL.span("query.group_topk"):
        items = list(order)
        # the groups are numbered in key order, and the sorts are stable:
        # a last ascending sort by a lone key changes nothing
        while items and items[-1][0] == ("key", 0) and not items[-1][1] \
                and not isinstance(key, (list, tuple)):
            items.pop()
        sort_keys = []
        for what, desc in items:
            if what == "count":
                k = counts[:g].to(torch.int64)
            elif what[0] == "count":
                k = reduced[what[1]][0][3][:g].to(torch.int64)
            elif what[0] == "distinct":
                k = dcounts[what[1]][:g]
            elif isinstance(key, (list, tuple)):
                below = int(np.prod(decode.radix[what[1] + 1:]))
                k = (gk[:g].to(torch.int64) // below) \
                    % max(decode.radix[what[1]], 1)
            else:
                k = torch.arange(g, device=gk.device)
            sort_keys.append(-k if desc else k)
        top = (_lex_sort(torch.stack(sort_keys)) if sort_keys
               else torch.arange(g, device=gk.device))
        if limit is not None:
            top = top[:limit]
    kept = int(top.shape[0])
    aggs = {}
    for v, ((sums, mns, mxs, cnt), isf) in reduced.items():
        aggs[v] = {
            "sum": _combine_digit_sums(tuple(x[top] for x in sums), kept,
                                       isf),
            "min": _host(mns[top]),
            "max": _host(mxs[top]),
            "count": _host(cnt[top]).astype(np.int64),
        }
    return {"keys": decode(_host(gk[top])),
            "count": _host(counts[top]).astype(np.int64),
            "aggs": aggs,
            "distinct": {c: _host(d[top]).astype(np.int64)
                         for c, d in dcounts.items()}}
