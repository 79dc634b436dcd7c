"""Top-level factories (csv_simd_tpu/api.py): file path or bytes -> Tape
(`create`, `create_from_bytes`) or -> offsets-free device tape
(`create_packed`).

The index build takes a backend and a device: "cuda" (kernel B3 on the
card, then native extraction on the host), "torch" (its plain PyTorch
version on `device`), "native" (the C++ host engine), "golden" (the
NumPy oracle) and "auto" ("cuda" for a CUDA device, "torch" otherwise).
"""

from __future__ import annotations

import mmap as _mmap
import os

import numpy as np

from .config import DEFAULT_DIALECT
from .device import resolve_device
from .errors import InvalidCsvFormat, IoError
from .offsetfree import PackedDeviceTape
from .tape import Header, Tape
from .utils import as_u8


def _map(filename) -> np.ndarray:
    """The file's bytes as a read-only NumPy view of an mmap."""
    try:
        with open(filename, "rb") as f:
            mapped = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except ValueError as e:
        # mmap refuses zero-length files, like the reference's Io error
        raise IoError(f"{filename}: {e}") from e
    except OSError as e:
        raise IoError(str(e)) from e
    return np.frombuffer(mapped, dtype=np.uint8)


def _build_index(data, dialect, backend: str, device):
    from .utils.metrics import GLOBAL

    with GLOBAL.span(f"index_build[{backend}]", len(data)):
        if backend == "golden":
            from . import golden

            return golden.structural_index(data, dialect)
        from .index import build_index

        return build_index(data, dialect=dialect, backend=backend,
                           device=device)


def _check_utf8(data, device) -> None:
    """Raise InvalidCsvFormat unless `data` is valid UTF-8. On a CUDA
    device the bytes are uploaded and the validator kernel counts the
    errors (ops/utf8.py); otherwise the host check runs."""
    from .ops import utf8

    arr = as_u8(data)
    on_card = resolve_device(device).type == "cuda"
    ok = (utf8.validate_utf8_device(arr, device) if on_card and arr.size
          else utf8.validate_utf8(arr))
    if not ok:
        raise InvalidCsvFormat("input is not valid UTF-8")


def create_from_bytes(data, dialect=None, backend: str = "auto",
                      validate_utf8: bool = False, device="cuda") -> Tape:
    """Build a Tape from an in-memory byte buffer. validate_utf8=True
    gates the build on full UTF-8 validity, raising InvalidCsvFormat."""
    dialect = dialect or DEFAULT_DIALECT
    if validate_utf8:
        _check_utf8(data, device)
    header = Header.parse(data, delimiter=dialect.delimiter,
                          quote_aware=dialect.header_quotes,
                          quote=dialect.quote)
    index = _build_index(data, dialect, backend, device)
    return Tape(data, index, header)


def create_packed(filename: str | os.PathLike, dialect=None,
                  validate_utf8: bool = False,
                  device="cuda") -> PackedDeviceTape:
    """Build the offsets-free serving tape straight from a file: mmap,
    one padded copy into pinned memory and onto the device, kernel B1
    (build) and kernel B2 (row prefix). The index is the packed bitmask
    and the row popcount prefix, never an offsets array. `device="cpu"`
    runs the plain PyTorch versions instead of the kernels. With
    validate_utf8=True, input in which B1 counted a byte >= 0x80 is
    checked by the UTF-8 validator kernel on the bytes already on the
    card, and raises InvalidCsvFormat if it is not valid UTF-8."""
    return PackedDeviceTape(_map(filename), dialect or DEFAULT_DIALECT,
                            validate_utf8=validate_utf8, device=device)


def create(filename: str | os.PathLike, dialect=None, backend: str = "auto",
           validate_utf8: bool = False, device="cuda") -> Tape:
    """Build a Tape from a CSV file. The file is memory-mapped and the
    Tape serves a NumPy view of the mapping; with backend "cuda" the
    bytes go to the card once, kernel B3 packs the structural mask, and
    the words come back (1/8 of the input) for the host extractor."""
    return create_from_bytes(_map(filename), dialect=dialect,
                             backend=backend, validate_utf8=validate_utf8,
                             device=device)
