"""Device set-operation execution (csv_simd_tpu/setops.py, in PyTorch):
UNION dedupe / EXCEPT / INTERSECT.

The host path (sql._dedupe_frame/_setop_frames) builds (rows, cols)
int64 row codes and runs np.unique(axis=0) + a Python row-tuple set —
exact, but axis=0 unique degrades to void-record comparisons and the
membership set is a Python dict at frame scale.

Here the same row-code semantics run as torch ops on one device:
per-column codes factorize on host over BOTH frames at once (shared
code space; NULL is its own code — NULLs equal NULLs, the set-op
convention), radix-combine into as few int32 chunks as the key spaces
allow, then ONE stable lexicographic device sort of the concatenated
rows. Because the sort is stable and `acc` rows precede `other` rows in
the input, the first row of every equal-row run is acc's first
occurrence when acc appears in the run at all; a segmented any-flag
marks runs containing `other` rows. EXCEPT/INTERSECT/dedupe all fall
out of those two bits.

Eligibility: every column must hold a non-object numpy dtype (typed
numeric/datetime columns). Mixed/text object columns keep the host
row-code path — which also remains the differential oracle.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .device import resolve_device
from .device_tape import _host
from .window import _changes, _lex_sort, _radix_combine, factorize_key

# below this total row count the host path's constant factors win
DEVICE_SETOP_MIN_ROWS = 8192


def _columns_codes(frames) -> Optional[List[np.ndarray]]:
    """Per-column shared-code-space int32 codes over the concatenation
    of `frames` (same column order everywhere), or None if any column
    is ineligible (object dtype)."""
    names0 = frames[0].names
    out = []
    for j, _nm in enumerate(names0):
        vals, oks = [], []
        for fr in frames:
            nm = fr.names[j]
            col = np.asarray(fr._columns[nm])
            if col.dtype == object:
                return None
            vals.append(col)
            ok = fr._ok[nm]
            oks.append(np.ones(len(fr), bool) if ok is None
                       else np.asarray(ok, bool))
        c = factorize_key(np.concatenate(vals), np.concatenate(oks))
        if c is None:
            return None
        out.append(c)
    return out


def _scatter_back(perm: torch.Tensor, sorted_mask: torch.Tensor):
    """A bool mask in sorted order -> the same mask in original order."""
    out = torch.zeros_like(sorted_mask)
    out[perm] = sorted_mask
    return out


def _dedupe_device(chunks: torch.Tensor):
    """(K, n) int32 -> (n,) bool keep-mask in ORIGINAL row order:
    True at the first occurrence of each distinct row."""
    perm = _lex_sort(chunks)
    return _scatter_back(perm, _changes(chunks[:, perm]))


def _setop_device(chunks: torch.Tensor, is_b: torch.Tensor):
    """(K, na+nb) int32 codes (acc rows first, stable order), is_b
    bool — returns (first_acc_mask, run_has_b_mask) in original row
    order: first_acc True at acc's first occurrence of each distinct
    row; run_has_b True where the row's equal-row run contains any
    `other` row."""
    n = chunks.shape[1]
    perm = _lex_sort(chunks)
    sb = is_b[perm]
    change = _changes(chunks[:, perm])
    seg = (torch.cumsum(change.to(torch.int32), 0, dtype=torch.int32)
           - 1).long()
    # segment max of the 0/1 flags (jax.ops.segment_max): a zero start
    # changes no run's max
    has_b = torch.zeros(n, dtype=torch.int32, device=chunks.device) \
        .scatter_reduce(0, seg, sb.to(torch.int32), "amax")[seg] > 0
    # stable sort put acc rows before b rows within a run, so a run's
    # first row is an acc row iff the run contains acc at all
    first_acc = change & ~sb
    return _scatter_back(perm, first_acc), _scatter_back(perm, has_b)


def _bounds(codes) -> List[int]:
    return [int(c.max(initial=0)) + 1 for c in codes]


def dedupe_keep(fr, device="cuda") -> Optional[np.ndarray]:
    """Device plan for plain-UNION dedupe on `device`: ascending row
    ids of first occurrences, or None (ineligible/small)."""
    n = len(fr)
    if n < DEVICE_SETOP_MIN_ROWS:
        return None
    codes = _columns_codes([fr])
    if codes is None:
        return None
    chunks = _radix_combine(codes, _bounds(codes), n,
                            resolve_device(device))
    return np.flatnonzero(_host(_dedupe_device(chunks)))


def _setop_from_codes(codes, n: int, na: int, op: str,
                      device) -> np.ndarray:
    device = resolve_device(device)
    chunks = _radix_combine(codes, _bounds(codes), n, device)
    is_b = torch.arange(n, device=device) >= na
    first_acc, has_b = (_host(x) for x in _setop_device(chunks, is_b))
    want_in = op == "intersect"
    return np.flatnonzero(first_acc[:na] & (has_b[:na] == want_in))


def setop_keep_concat(both, na: int, op: str,
                      device="cuda") -> Optional[np.ndarray]:
    """Device plan for EXCEPT/INTERSECT over the already-concatenated
    frame (acc rows first), on `device`: ascending acc row ids of
    distinct acc rows absent from / present in the other rows, or None
    when ineligible. Taking the concatenation directly avoids
    materializing per-side frame slices just to re-concatenate their
    values here."""
    n = len(both)
    if n < DEVICE_SETOP_MIN_ROWS:
        return None
    codes = _columns_codes([both])
    if codes is None:
        return None
    return _setop_from_codes(codes, n, na, op, device)


def setop_keep(acc, other, op: str, device="cuda") -> Optional[np.ndarray]:
    """Two-frame convenience form of setop_keep_concat (columns
    factorize over both frames at once for the shared code space)."""
    n = len(acc) + len(other)
    if n < DEVICE_SETOP_MIN_ROWS:
        return None
    codes = _columns_codes([acc, other])
    if codes is None:
        return None
    return _setop_from_codes(codes, n, len(acc), op, device)
