"""Device window functions (csv_simd_tpu/window.py, in PyTorch): sort,
segment and scan on the device, O(n) host.

The host window executor (sql._window_column) loops Python tuples per
row: correct, but unusable at the row counts this framework targets.
This module runs the whole window pipeline as torch ops on one device:
ONE lexicographic device sort (a chain of stable argsorts over int32
key codes), partition/peer boundary detection by neighbor-compare,
segmented prefix scans (`_associative_scan` with a reset flag), and
RANGE-frame peer sharing via a suffix-min gather of peer-group end
positions. Sort keys factorize to int32 codes ON DEVICE for
device-resident int columns (factorize_key_device: min/max +
arithmetic codes, O(1) scalars moved) and on host otherwise (np.unique,
vectorized); host work beyond that is scattering results back to row
order. Every device -> host read goes through `device_tape._host`, and
every host -> device move names its device and dtype (`query._to_dev`).

Semantics match the host executor exactly (it stays as the
oracle/fallback):
- rows keep their original order; the window orders internally by
  PARTITION keys then the OVER ORDER BY keys, stable, NULLs LAST in
  both directions (each key factorizes to codes with NULL = G, its own
  equality class, so a NULL never peers with a real value);
- aggregates with ORDER BY use SQL's default RANGE UNBOUNDED PRECEDING
  frame: peer rows (equal order keys) share the value at their peer
  group's last row; without ORDER BY the frame is the whole partition;
- COUNT/SUM/AVG/MIN/MAX skip NULL values; SUM/AVG over ints use the
  digit-split segmented scans of query._GROUP_SPLIT so int sums stay
  EXACT (guarded: partitions must stay under 2**20 rows, else the host
  path runs); SUM/AVG over floats use a compensated double-f32 scan;
- LAG/LEAD step over ROWS within the partition; the device computes
  source row indices and the host gathers values (so they work for
  every column type, including text).

Float sums are bit-identical to the JAX package's because
`_associative_scan` combines in the same odd/even tree as
`jax.lax.associative_scan`: the double-f32 pair addition is not
associative bit for bit, so a scan in any other order gives other low
words. Index arithmetic runs in int64 (torch's index type); the values
JAX computes in int32 (counts, digit sums, codes) stay int32 here.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .device import resolve_device
from .device_tape import _host
from .query import _to_dev

# below this, the host executor's constant factors win; tests lower it
# to force the device path on small frames
DEVICE_WINDOW_MIN_ROWS = 8192

# partitions at/above this row count would overflow the 10-bit digit
# cumsum exactness bound (see query._GROUP_SPLIT)
_MAX_EXACT_PARTITION = 2**20

_SPLIT = (20, 10)  # (high shift, digit width) — mirrors query._GROUP_SPLIT

_INT32_MAX = 2**31 - 1
_INT32_MIN = -(2**31)


def factorize_key(vals, ok, desc: bool = False,
                  nulls_first: bool = False) -> Optional[np.ndarray]:
    """Any host column -> dense int32 sort codes. Ascending codes follow
    np.unique order (== Python < for uniform str/bytes/numeric);
    `desc` reverses real values; NULL rows get the LARGEST code (sort
    last both directions, never equal to a real value) — or code 0 with
    real codes shifted +1 under `nulls_first` (an explicit NULLS FIRST
    modifier, query.SortDir). Returns None when values don't factorize
    (mixed incomparable objects)."""
    vals = np.asarray(vals)
    n = vals.shape[0]
    okm = np.ones(n, bool) if ok is None else np.asarray(ok, bool)
    shift = 1 if nulls_first else 0
    codes = np.zeros(n, np.int64)
    g = 0
    if okm.any():
        sel = vals[okm]
        if vals.dtype.kind in "iub":
            # integer keys: O(n) arithmetic codes (value - min), no
            # np.unique sort needed; codes are sparse but order- and
            # equality-faithful, which is all the device sort uses
            s64 = sel.astype(np.int64)
            lo, hi = int(s64.min()), int(s64.max())
            span = hi - lo + 1
            if span + shift < 2**31 - 1:
                codes[okm] = ((hi - s64) if desc else (s64 - lo)) + shift
                codes[~okm] = 0 if nulls_first else span
                return codes.astype(np.int32)
        try:
            uniq, inv = np.unique(sel, return_inverse=True)
        except TypeError:
            return None
        g = len(uniq)
        codes[okm] = ((g - 1 - inv) if desc else inv) + shift
    codes[~okm] = 0 if nulls_first else g
    if g + shift >= 2**31 - 1:
        return None
    return codes.astype(np.int32)


def _codes_device(v, ok, lo: int, hi: int, *, desc: bool,
                  nulls_first: bool):
    """Arithmetic sort codes ON DEVICE, matching factorize_key's int
    path bit-for-bit: real values -> (hi-v | v-lo) + shift, NULL ->
    0 (nulls_first) or span. Caller guarantees span+shift < 2**31 so
    every intermediate fits int32."""
    shift = 1 if nulls_first else 0
    c = (hi - v) if desc else (v - lo)
    null_code = 0 if nulls_first else hi - lo + 1
    return torch.where(ok, c + shift, null_code)


def _minmax_ok(v, ok):
    """(lo, hi, any_ok) of the valid rows in ONE readback."""
    lo = torch.where(ok, v, _INT32_MAX).min()
    hi = torch.where(ok, v, _INT32_MIN).max()
    return torch.stack([lo, hi, ok.any().to(torch.int32)])


def factorize_key_device(dev_vals, dev_ok, desc: bool = False,
                         nulls_first: bool = False):
    """Device-resident int32 column -> (device codes, code bound)
    WITHOUT shipping the column to host. Only O(1) scalars move: one
    (3,) min/max/any readback. Codes are bit-identical to
    factorize_key's integer arithmetic path; the bound is span + shift
    + 1, one more than the codes need, as the JAX package has it.
    Returns None when the value span needs the host np.unique path
    (>= 2**31) or the dtype is not int32."""
    if getattr(dev_vals, "dtype", None) != torch.int32:
        return None
    dev = dev_vals.device
    ok = (torch.ones(dev_vals.shape, dtype=torch.bool, device=dev)
          if dev_ok is None else _to_dev(dev_ok, dev, torch.bool))
    lo, hi, any_ok = (int(x) for x in _host(_minmax_ok(dev_vals, ok)))
    if not any_ok:
        # all NULL: one equality class, code 0 (matches factorize_key)
        return torch.zeros(dev_vals.shape, dtype=torch.int32,
                           device=dev), 1
    span = hi - lo + 1
    shift = 1 if nulls_first else 0
    if span + shift >= 2**31 - 1:
        return None
    codes = _codes_device(dev_vals, ok, lo, hi, desc=desc,
                          nulls_first=nulls_first)
    return codes, span + shift + 1


def _radix_combine(code_list: List, bounds: List[int], n: int, device):
    """Pack a list of int32 code arrays (host np OR device tensors) into
    as FEW int32 sort chunks as their key spaces (`bounds` = exclusive
    code upper bounds) allow — usually one; each chunk saved is one
    full device argsort saved in the lexicographic chain. Runs on
    `device` (host codes ship once here; device codes never touch
    host). Packing keeps space*g < 2**31, so int32 arithmetic is
    exact."""
    if not code_list:
        return torch.zeros((0, n), dtype=torch.int32, device=device)
    out = []
    cur = None
    space = 1
    for c, g in zip(code_list, bounds):
        c = _to_dev(c, device, torch.int32)
        if cur is None:
            cur, space = c, g
        elif space * g < 2**31:
            cur = cur * g + c
            space *= g
        else:
            out.append(cur)
            cur, space = c, g
    out.append(cur)
    return torch.stack(out)


def _max_partition_run(pk, perm):
    """Largest partition size (a 0-d tensor), computed ON DEVICE from
    the already-built sort permutation."""
    n = perm.shape[0]
    if pk.shape[0] == 0:
        return torch.tensor(n, device=perm.device)
    change = _changes(pk[:, perm])
    idx = torch.arange(n, device=perm.device)
    seg_start = torch.cummax(torch.where(change, idx, 0), 0).values
    return (idx - seg_start + 1).max()


def _changes(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(K, n) sorted key codes -> (n,) bool, True where ANY key differs
    from the previous row (row 0 always True)."""
    n = sorted_keys.shape[1]
    dev = sorted_keys.device
    if sorted_keys.shape[0] == 0:
        c = torch.zeros(n, dtype=torch.bool, device=dev)
        c[:1] = True
        return c
    d = (sorted_keys[:, 1:] != sorted_keys[:, :-1]).any(dim=0)
    return torch.cat([torch.ones(1, dtype=torch.bool, device=dev), d])


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... with len(a) - len(b) in {0, 1}."""
    out = torch.empty(a.shape[0] + b.shape[0], dtype=a.dtype,
                      device=a.device)
    out[0::2] = a
    out[1::2] = b
    return out


def _associative_scan(fn, elems):
    """Inclusive scan of the tuple of 1-D tensors `elems` with the
    associative `fn(a, b)` (tuples in, a tuple out), combining in the
    order jax.lax.associative_scan does: adjacent pairs are reduced,
    the half-length scan recurses, and the even positions combine the
    odd results with the next element. An operator that is associative
    only up to rounding (the double-f32 sum) then gives the JAX
    package's bits."""
    n = elems[0].shape[0]
    if n < 2:
        return list(elems)
    reduced = fn([e[0:n - 1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = fn(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _seg_scan(v, boundary, combine):
    """Inclusive segmented prefix scan: `boundary[i]` True resets the
    scan at i. Standard flagged-pair associative operator."""

    def op(a, b):
        f1, v1 = a
        f2, v2 = b
        return f1 | f2, torch.where(f2, v2, combine(v1, v2))

    _f, s = _associative_scan(op, (boundary, v))
    return s


def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b EXACTLY (no branch, fma-safe)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(ah, al, bh, bl):
    """double-f32 (compensated pair) addition: ~2**-48 relative error,
    the float sibling of the int digit-split."""
    sh, se = _two_sum(ah, bh)
    se = se + (al + bl)
    h, e = _two_sum(sh, se)
    return h, e


def _seg_scan_df(v, boundary):
    """Inclusive segmented prefix SUM of float32 `v` in double-f32
    pairs. Returns (hi, lo) tensors; hi+lo read in float64 carries
    ~48 bits of mantissa."""

    def op(a, b):
        f1, h1, l1 = a
        f2, h2, l2 = b
        h, low = _df_add(h1, l1, h2, l2)
        return (f1 | f2, torch.where(f2, h2, h),
                torch.where(f2, l2, low))

    _f, h, low = _associative_scan(op, (boundary, v, torch.zeros_like(v)))
    return h, low


def _rmq_table(m, combine, levels: int):
    """Sparse-table range-extreme levels: T[k][i] = combine over
    m[i : i + 2**k] (sentinel-padded past the end). O(n log W) build,
    O(1) per query — the two-level block extrema for doubly-bounded
    ROWS frames."""
    rows = [m]
    cur = m
    n = m.shape[0]
    for k in range(1, levels):
        sh = 1 << (k - 1)
        # a level shift past the array end pads entirely (frames wider
        # than the data happen: ROWS BETWEEN 100 PRECEDING ... over a
        # 3-row frame)
        pad = min(sh, n)
        shifted = torch.cat([cur[sh:], torch.full(
            (pad,), _ident(cur.dtype, combine), dtype=cur.dtype,
            device=cur.device)])
        cur = combine(cur, shifted)
        rows.append(cur)
    return torch.stack(rows)


def _ident(dtype, combine):
    """Identity element for min/max at `dtype` (the sentinel used for
    padding and NULL rows)."""
    if combine is torch.minimum:
        return torch.inf if dtype.is_floating_point else _INT32_MAX
    return -torch.inf if dtype.is_floating_point else _INT32_MIN


def _ends(change, idx, n):
    """Last index of each run delimited by `change` (True = run start):
    suffix-min of next run starts, minus one."""
    starts_after = torch.cat(
        [torch.where(change, idx, n)[1:],
         torch.full((1,), n, dtype=idx.dtype, device=idx.device)])
    nxt = torch.flip(torch.cummin(torch.flip(starts_after, (0,)), 0).values,
                     (0,))
    return nxt - 1


def _lex_sort(sort_k):
    """(S, n) int32 radix-combined lexicographic chunks -> stable sort
    permutation (int64). Kept apart from the window compute so multiple
    window items over the SAME OVER clause share one device sort (sql
    passes a per-clause cache)."""
    n = sort_k.shape[1]
    perm = torch.arange(n, device=sort_k.device)
    for i in range(sort_k.shape[0] - 1, -1, -1):
        perm = perm[torch.argsort(sort_k[i][perm], stable=True)]
    return perm


def _floor_log2(w):
    """floor(log2(w)) of int64 w >= 1, exactly (31 - clz(w) for int32):
    frexp's exponent of a float64 that holds w exactly."""
    return torch.frexp(w.double()).exponent.to(w.dtype) - 1


def _window_device(perm, part_k, order_k, vals, vok, *, fn: str,
                   offset: int, has_order: bool, frame=None):
    """Sorted-space window compute. perm = _lex_sort of the combined
    part+order keys; part_k (P, n) / order_k (O, n) int32 codes for
    boundary detection; vals (n,) int32/float32 (zeros when unused),
    vok (n,) bool. Returns (perm, outputs...) — all in sorted space;
    callers scatter back with perm."""
    n = perm.shape[0]
    dev = perm.device
    sp = part_k[:, perm]
    part_change = _changes(sp)
    if has_order:
        peer_change = part_change | _changes(order_k[:, perm])
    else:
        peer_change = part_change
    idx = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(part_change, idx, 0), 0).values

    def cummax_starts(change):
        return torch.cummax(torch.where(change, idx, 0), 0).values

    if fn == "row_number":
        return perm, idx - seg_start + 1
    if fn == "rank":
        return perm, cummax_starts(peer_change) - seg_start + 1
    if fn == "dense_rank":
        return perm, _seg_scan(peer_change.to(torch.int32), part_change,
                               torch.add)
    if fn in ("percent_rank", "cume_dist"):
        # returned as INT (numerator, denominator) pairs — the host
        # divides in float64 so both executors agree bit-for-bit
        part_end = _ends(part_change, idx, n)
        size = part_end - seg_start + 1
        if fn == "percent_rank":
            return (perm, cummax_starts(peer_change) - seg_start,
                    torch.clamp(size - 1, min=1))
        peer_end = _ends(peer_change, idx, n)
        return perm, peer_end - seg_start + 1, size
    if fn in ("lag", "lead"):
        part_end = _ends(part_change, idx, n)
        j = idx + offset if fn == "lead" else idx - offset
        valid = ((j >= seg_start) & (j <= part_end)
                 & (j >= 0) & (j < n))
        src = torch.where(valid, perm[torch.clamp(j, 0, n - 1)], -1)
        return perm, src
    if fn == "ntile":
        part_end = _ends(part_change, idx, n)
        size = part_end - seg_start + 1
        p = idx - seg_start
        small = size // offset
        rem = size - small * offset
        cut = rem * (small + 1)
        return perm, torch.where(
            p < cut, p // (small + 1),
            rem + (p - cut) // torch.clamp(small, min=1)) + 1
    if fn in ("first_value", "last_value", "nth_value"):
        # frame-position value: computed as a source ROW id gathered
        # host-side (works for every column type; NULLs NOT skipped)
        part_end = _ends(part_change, idx, n)
        if frame is None:
            lo_i = seg_start
            hi_i = _ends(peer_change, idx, n)
        else:
            _k, lo, hi = frame
            lo_i = seg_start if lo is None \
                else torch.maximum(seg_start, idx + lo)
            hi_i = part_end if hi is None \
                else torch.minimum(part_end, idx + hi)
        if fn == "first_value":
            pos = lo_i
        elif fn == "last_value":
            pos = hi_i
        else:
            pos = lo_i + (offset - 1)
        valid = (lo_i <= hi_i) & (pos >= lo_i) & (pos <= hi_i) \
            & (pos >= 0) & (pos < n)
        src = torch.where(valid, perm[torch.clamp(pos, 0, n - 1)], -1)
        return perm, src

    sv = vok[perm]
    if frame is None:
        # SQL's default RANGE UNBOUNDED PRECEDING: peers (equal order
        # keys) share the value at their peer group's LAST row, and the
        # frame always starts at the partition start
        gather_at = _ends(peer_change, idx, n)
        lo_i = None
        empty = None
    else:
        # explicit ROWS frame: offsets are row positions relative to
        # the current row, clamped to the partition; no peer sharing
        _kind, lo, hi = frame
        part_end = _ends(part_change, idx, n)
        gather_at = part_end if hi is None \
            else torch.minimum(part_end, idx + hi)
        lo_i = seg_start if lo is None \
            else torch.maximum(seg_start, idx + lo)
        empty = gather_at < lo_i
        gather_at = torch.clamp(gather_at, 0, n - 1)

    def _windowed(scan, is_sum: bool):
        """Frame value from an inclusive segmented scan: value at the
        frame end, minus (for +-decomposable scans) the prefix before
        the frame start."""
        at_end = scan[gather_at]
        if frame is None:
            return at_end
        if is_sum:
            prev = torch.where(
                lo_i > seg_start,
                scan[torch.clamp(lo_i - 1, 0, n - 1)], 0)
            at_end = at_end - prev
        return torch.where(empty, 0, at_end)

    cnt = _windowed(_seg_scan(sv.to(torch.int32), part_change,
                              torch.add), True)
    if fn == "count":
        return perm, cnt
    v = vals[perm]
    if fn in ("min", "max"):
        comb = torch.minimum if fn == "min" else torch.maximum
        sent = _ident(v.dtype, comb)
        m = torch.where(sv, v, sent)
        if frame is None or frame[1] is None:
            # prefix-shaped frames (frame None = peer end; lo
            # unbounded with any hi): gathers of the segmented
            # cummin/cummax, never a subtraction
            return perm, _windowed(_seg_scan(m, part_change, comb),
                                   False), cnt
        _kind, lo, hi = frame
        lo_c = torch.clamp(lo_i, 0, n - 1)
        if hi is None:
            # [idx+lo, partition end]: suffix scan, gathered at the
            # frame start (the boundary flips to segment ENDS)
            is_end = torch.cat([part_change[1:], torch.ones(
                1, dtype=torch.bool, device=dev)])
            suf = torch.flip(_seg_scan(torch.flip(m, (0,)),
                                       torch.flip(is_end, (0,)), comb),
                             (0,))
            res = suf[lo_c]
        else:
            # doubly-bounded ROWS frame: sparse-table range extrema —
            # levels cover the STATIC maximum width hi-lo+1, the query
            # is two overlapping power-of-two blocks
            width = hi - lo + 1
            levels = max(1, int(np.ceil(np.log2(width))) + 1)
            table = _rmq_table(m, comb, levels)
            w_i = torch.clamp(gather_at - lo_i + 1, min=1)
            k = torch.clamp(_floor_log2(w_i), 0, levels - 1)
            p2 = torch.clamp(gather_at - (1 << k) + 1, 0, n - 1)
            flat = table.reshape(-1)
            res = comb(flat[k * n + lo_c], flat[k * n + p2])
        return perm, torch.where(empty, sent, res), cnt
    if v.dtype.is_floating_point:
        # sum / mean over floats: compensated double-f32 segmented
        # scan (hi+lo carries ~48 mantissa bits — the float sibling of
        # the int digit split). ROWS frames defer the end-minus-prev
        # subtraction to float64 ON HOST (componentwise f32 pair
        # subtraction would reintroduce the cancellation the pairs
        # exist to avoid); four gathered arrays come back.
        zf = torch.where(sv, v, 0.0)
        h, low = _seg_scan_df(zf, part_change)
        he, le = h[gather_at], low[gather_at]
        if frame is None:
            hp = lp = torch.zeros_like(he)
        else:
            use_prev = (lo_i > seg_start) & ~empty
            prev = torch.clamp(lo_i - 1, 0, n - 1)
            hp = torch.where(use_prev, h[prev], 0.0)
            lp = torch.where(use_prev, low[prev], 0.0)
            he = torch.where(empty, 0.0, he)
            le = torch.where(empty, 0.0, le)
        return perm, he, le, hp, lp, cnt
    # sum / mean over ints: exact digit-split segmented cumsums
    zero = torch.where(sv, v, 0)
    w = _SPLIT[1]
    digs = []
    for s, width in ((0, w), (w, w), (_SPLIT[0], 31)):
        d = (zero >> s) & ((1 << width) - 1) if s + width <= 31 \
            else zero >> s
        digs.append(_windowed(_seg_scan(d, part_change, torch.add), True))
    return perm, digs[0], digs[1], digs[2], cnt


def window_column(
    fn: str,
    n: int,
    part_keys: List[tuple],   # (vals, ok[, (dev_vals, dev_ok)])
    order_keys: List[tuple],  # (vals, ok, desc[, (dev_vals, dev_ok)])
    vals=None,
    vok=None,
    *,
    offset: int = 1,
    is_int: bool = False,
    cache: Optional[dict] = None,
    frame=None,
    dev=None,
    device="cuda",
):
    """Device window evaluation on `device`, or None when ineligible
    (caller falls back to the host executor). Device-resident parses
    (`dev`, the key entries' third element) on another device are
    moved to `device`. Returns (kind, payload):

    - kind "int":  payload (n,) np.int64      (row_number/rank/
                   dense_rank/count)
    - kind "float": payload (n,) np.float64   (percent_rank/cume_dist
                   — int numerators divided in float64 on host)
    - kind "sum":  payload ((n,) np.int64 exact sums, (n,) bool ok)
    - kind "fsum": payload ((n,) np.float64 compensated-pair sums, ok)
    - kind "mean": payload ((n,) np.float64, ok)
    - kind "minmax": payload ((n,) np source-typed values, ok)
    - kind "src":  payload (n,) np.int64 source ROW ids (-1 = NULL) —
                   lag/lead; caller gathers values host-side
    """
    if n < DEVICE_WINDOW_MIN_ROWS or n == 0:
        return None
    device = resolve_device(device)

    # key prep + the device sort are shared across every window item of
    # the same OVER clause (sql passes one `cache` dict per clause)
    if cache is not None and cache.get("ineligible"):
        return None
    prep = cache.get("prep") if cache is not None else None
    if prep is not None:
        has_pcodes, has_ocodes, pk, okk, perm_dev = prep
    else:
        def _bail():
            if cache is not None:
                cache["ineligible"] = True
            return None

        def _fact(key, desc=False, nf=False):
            """One key -> (codes host-or-device, bound). Device-
            resident int32 parses (entry = (vals, ok[, (dev_vals,
            dev_ok)])) factorize ON DEVICE — O(1) scalars moved
            instead of the whole column."""
            v, ok, kdev = (key if len(key) == 3 else (*key, None))
            if kdev is not None and getattr(
                    kdev[0], "dtype", None) == torch.int32:
                c = factorize_key_device(
                    kdev[0].to(device),
                    None if kdev[1] is None
                    else _to_dev(kdev[1], device, torch.bool),
                    desc=desc, nulls_first=nf)
                if c is not None:
                    return c
            c = factorize_key(v, ok, desc=desc, nulls_first=nf)
            if c is None:
                return None
            return c, int(c.max(initial=0)) + 1

        pcodes, pbounds, ocodes, obounds = [], [], [], []
        for key in part_keys:
            cb = _fact(key)
            if cb is None:
                return _bail()
            pcodes.append(cb[0])
            pbounds.append(cb[1])
        for entry in order_keys:
            desc = entry[2]
            key = (entry[0], entry[1]) + tuple(entry[3:])
            cb = _fact(key, desc=bool(desc),
                       nf=getattr(desc, "nulls_first", False))
            if cb is None:
                return _bail()
            ocodes.append(cb[0])
            obounds.append(cb[1])

        def _stack(codes):
            if not codes:
                return torch.zeros((0, n), dtype=torch.int32,
                                   device=device)
            return torch.stack([_to_dev(c, device, torch.int32)
                                for c in codes])

        pk, okk = _stack(pcodes), _stack(ocodes)
        perm_dev = _lex_sort(_radix_combine(
            pcodes + ocodes, pbounds + obounds, n, device))
        has_pcodes, has_ocodes = bool(pcodes), bool(ocodes)
        if cache is not None:
            cache["prep"] = (has_pcodes, has_ocodes, pk, okk, perm_dev)

    dvals = torch.zeros(n, dtype=torch.int32, device=device)
    dok = torch.ones(n, dtype=torch.bool, device=device)
    src_dtype = None
    is_float_agg = False
    if fn in ("count", "sum", "mean", "min", "max"):
        if vals is not None:
            va = np.asarray(vals)
            src_dtype = va.dtype
            okm = (np.ones(n, bool) if vok is None
                   else np.asarray(vok, bool))
            if (fn in ("sum", "mean") and is_int) or (
                    fn in ("min", "max") and va.dtype.kind in "iu"):
                if va.dtype.kind not in "iu":
                    return None
                if va.dtype.itemsize > 4:
                    sel = va[okm]
                    if sel.size and (int(sel.max()) >= 2**31
                                     or int(sel.min()) < -(2**31)):
                        return None
                if dev is not None and getattr(
                        dev[0], "dtype", None) == torch.int32:
                    # the column's device-resident parse (read_typed
                    # keeps it in Frame._dev): skip the host->device
                    # round trip of data that is already on the card
                    dvals = dev[0].to(device)
                else:
                    dvals = _to_dev(va.astype(np.int32), device,
                                    torch.int32)
            elif fn in ("sum", "mean", "min", "max"):
                # float values: MIN/MAX, and SUM/AVG via the
                # compensated double-f32 scan
                if va.dtype.kind != "f":
                    return None
                is_float_agg = fn in ("sum", "mean")
                if dev is not None and getattr(
                        dev[0], "dtype", None) == torch.float32:
                    dvals = dev[0].to(device)
                else:
                    f32 = va.astype(np.float32)
                    sel = va[okm]
                    if sel.size and not np.array_equal(
                            f32.astype(va.dtype)[okm], sel,
                            equal_nan=True):
                        return None  # not exactly f32-representable
                    dvals = _to_dev(f32, device, torch.float32)
            dok = _to_dev(okm, device, torch.bool)
        elif fn != "count":
            return None
    if fn in ("sum", "mean") and not is_float_agg:
        # exactness guard: digit cumsums stay exact only under 2**20
        # rows per partition. The largest partition is a run-length
        # max over the ALREADY-built device sort — one scalar readback.
        # The verdict is shared across every SUM/AVG item of the clause
        # (cache).
        oversized = (cache or {}).get("oversized_partition")
        if oversized is None:
            oversized = bool(int(_host(_max_partition_run(pk, perm_dev)))
                             >= _MAX_EXACT_PARTITION)
            if cache is not None:
                cache["oversized_partition"] = oversized
        if oversized:
            return None

    out = _window_device(perm_dev, pk, okk, dvals, dok, fn=fn,
                         offset=offset, has_order=has_ocodes,
                         frame=frame)
    perm = _host(out[0])

    def scatter(a, dtype=None):
        a = _host(a)
        res = np.empty(n, a.dtype if dtype is None else dtype)
        res[perm] = a
        return res

    if fn in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return "int", scatter(out[1], np.int64)
    if fn in ("percent_rank", "cume_dist"):
        num = scatter(out[1], np.float64)
        den = scatter(out[2], np.float64)
        return "float", num / den
    if fn in ("lag", "lead", "first_value", "last_value", "nth_value"):
        return "src", scatter(out[1], np.int64)
    if fn in ("min", "max"):
        valsb = scatter(out[1])
        if src_dtype is not None:
            valsb = valsb.astype(src_dtype)
        okb = scatter(out[2], np.int64) > 0
        return "minmax", (valsb, okb)
    if is_float_agg:
        # compensated pairs recombine in float64 ON HOST: the ROWS-
        # frame end-minus-prev subtraction happens here, after the
        # widening, so no f32 cancellation
        he, le, hp, lp = (scatter(x, np.float64) for x in out[1:5])
        cnt = scatter(out[5], np.int64)
        sums = (he + le) - (hp + lp)
        okb = cnt > 0
        if fn == "sum":
            return "fsum", (sums, okb)
        with np.errstate(invalid="ignore", divide="ignore"):
            means = sums / np.maximum(cnt, 1)
        return "mean", (means, okb)
    d0, d1, d2, cnt = (scatter(x, np.int64) for x in out[1:5])
    w = _SPLIT[1]
    sums = d0 + (d1 << w) + (d2 << _SPLIT[0])
    okb = cnt > 0
    if fn == "sum":
        return "sum", (sums, okb)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = sums / np.maximum(cnt, 1)
    return "mean", (means.astype(np.float64), okb)
