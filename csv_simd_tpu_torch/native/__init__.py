"""ctypes bindings to the native host engine (csvidx.cpp), the port's copy
of csv_simd_tpu/native.

Built at first use with g++ (no pip deps) through `_compiled` into the
package's git-ignored `_build/` directory, under a name keyed by a hash
of the source and the flags, so an edited source is rebuilt and nothing
is written beside the source. All entry points degrade gracefully:
`available()` is False if no compiler, and callers fall back to the
NumPy paths.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
from typing import Optional, Tuple

import numpy as np
from .. import _compiled
from ..utils import as_u8

_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread")
LIB = _compiled.Library("csvidx", pathlib.Path(__file__).resolve().parent,
                        "csvidx.cpp", "g++", _FLAGS)
i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p

_build_error: Optional[str] = None


def library_path() -> str:
    """Where the engine is built: _build/csvidx-<hash of source and
    flags>.so."""
    return str(LIB.path())


def _load() -> Optional[ctypes.CDLL]:
    """The engine, built at first use; None (and `build_error()` says
    why) when g++ is missing or refuses the source."""
    global _build_error
    if _build_error is not None:
        return None
    try:
        return LIB.handle()
    except _compiled.BuildError as e:
        _build_error = str(e)
        return None


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _engine() -> None:
    if _load() is None:
        raise RuntimeError(f"native engine unavailable: {_build_error}")


_host_stage1 = LIB.fn("host_stage1", [vp, i64, i32, i32, i32, i32, i32, i32,
                                      vp, i64, ctypes.POINTER(i32)], i64)


def host_stage1(
    data: bytes | np.ndarray,
    dialect=None,
    carry_in: int = 0,
    n_threads: int = 0,
    with_sentinel: bool = False,
) -> Tuple[np.ndarray, int]:
    """CPU stage-1: bytes -> (ascending int64 offsets, quote parity out).

    with_sentinel=True prepends the tape's 0 sentinel IN PLACE (the
    extractor writes past a preset slot 0), avoiding a full-index copy.
    Multithreaded two-phase parity stitch."""
    from ..config import DEFAULT_DIALECT

    _engine()
    d = dialect or DEFAULT_DIALECT
    nl0 = d.newlines[0]
    nl1 = d.newlines[1] if len(d.newlines) > 1 else d.newlines[0]
    arr = as_u8(data)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lead = 1 if with_sentinel else 0
    # density heuristic with growth-on-overflow: never allocate 8x the
    # input up front
    cap = max(arr.size // 4 + 4096, 4096)
    while True:
        out = np.empty(cap + lead, dtype=np.int64)
        if lead:
            out[0] = 0
        parity = ctypes.c_int(0)
        cnt = _host_stage1(
            arr.ctypes.data, arr.size, d.delimiter, d.quote, nl0, nl1,
            carry_in & 1, n_threads, out.ctypes.data + 8 * lead, cap,
            ctypes.byref(parity),
        )
        if cnt >= 0:
            return out[: cnt + lead], int(parity.value)
        cap = min(cap * 4, arr.size + 1)


_host_quote_parity = LIB.fn("host_quote_parity", [vp, i64, i32, i32])


def host_quote_parity(data: bytes | np.ndarray, quote: int = 0x22,
                      carry_in: int = 0) -> int:
    _engine()
    arr = as_u8(data)
    return _host_quote_parity(arr.ctypes.data, arr.size, quote, carry_in)


_extract_offsets_v3 = LIB.fn("extract_offsets_v3",
                             [vp, i64, i64, i64, i64, i64, vp], i64)


def extract_offsets_v3(
    packed: np.ndarray, tile: int, n_bytes: int, base: int = 0
) -> np.ndarray:
    """Decode the device kernel's fold-packed words straight to ascending
    absolute offsets (no byte-mask intermediate)."""
    _engine()
    p = np.ascontiguousarray(packed, dtype=np.int32)
    cap = int(min(n_bytes, p.size * 32)) + 1
    out = np.empty(cap, dtype=np.int64)
    cnt = _extract_offsets_v3(
        p.ctypes.data, p.shape[0], tile, n_bytes, base, cap,
        out.ctypes.data,
    )
    if cnt < 0:
        raise ValueError(
            "packed words contain more set bits than n_bytes allows — "
            "corrupted or foreign packed array"
        )
    return out[:cnt]
