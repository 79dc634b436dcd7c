"""Index build (csv_simd_tpu/index.py): bytes -> structural index
("the tape").

The whole buffer goes to the device zero-padded (0x00 classifies to
nothing), one stage-1 pass emits packed bitmask words (1 bit per input
byte), and the offsets are extracted on the host (native fold decoder,
or NumPy) or compacted on the device (`build_index_device`).

Backends: "cuda" (the hand-written kernels; needs a CUDA device),
"torch" (their plain PyTorch versions on the given device), "native"
(the multithreaded C++ host engine), "golden" (the NumPy oracle) and
"auto" ("cuda" for a CUDA device, "torch" for the CPU, decided by the
`device` argument alone). The JAX package's "pallas" and "jnp" map to
"cuda" and "torch".
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_DIALECT, Dialect
from .device import resolve_device
from .ops.classify import classify_masks
from .ops.compact import extract_offsets_device
from .ops.scan import in_quote_parity, parity_out
from .ops.stage1_v2 import ROW_BYTES, padded_rows
from .utils import as_u8
from .utils.metrics import GLOBAL

LANES = 128
ROW_ALIGN = 32  # int8 sublane tile of the JAX layout
FOLD_TILE = 512  # the fold tile of build_index and the streaming build

_BACKENDS = ("auto", "cuda", "torch", "native", "golden")
_JAX_BACKENDS = {"pallas": "cuda", "jnp": "torch"}
_TWO_GIB_MSG = (
    "build_index_device uses int32 flat byte positions; inputs >= 2 GiB "
    "route through build_index (streamed int64 rebasing)"
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_grid(arr: np.ndarray, row_align: int = ROW_ALIGN) -> np.ndarray:
    """uint8 1-D -> zero-padded (rows, LANES) with rows % row_align == 0,
    rows bucketed to powers of two up to 8192 and to multiples of 8192
    above that."""
    n = arr.size
    rows = max(_cdiv(n, LANES), 1)
    rows = _cdiv(rows, row_align) * row_align
    if rows <= 8192:
        bucket = row_align
        while bucket < rows:
            bucket *= 2
        rows = bucket
    else:
        rows = _cdiv(rows, 8192) * 8192
    padded = np.zeros(rows * LANES, dtype=np.uint8)
    padded[:n] = arr
    return padded.reshape(rows, LANES)


def stage1_jnp(b2d: torch.Tensor, carry_in, dialect: Dialect = DEFAULT_DIALECT):
    """(rows, 128) uint8 + carry parity -> (sublane-major packed words
    (rows//32, 128) int32, parity_out): the plain v1 pipeline, B6's plain
    version without the count."""
    from .ops.stage1_pallas import _stage1_pallas_plain

    words, _count, parity = _stage1_pallas_plain(b2d, carry_in, dialect)
    return words, parity


def stage1_mask_jnp(b2d: torch.Tensor, carry_in,
                    dialect: Dialect = DEFAULT_DIALECT):
    """The same scan returning the unpacked 0/1 int32 mask."""
    struct, quote = classify_masks(b2d, dialect)
    inq = in_quote_parity(quote, carry_in)
    masked = struct & (inq == 0)
    return masked.to(torch.int32), parity_out(quote, carry_in)


def _resolve_backend(backend: str, device="cuda") -> str:
    """The backend to run for `device`: "auto" becomes "cuda" for a CUDA
    device and "torch" otherwise; "cuda" with another device raises."""
    if backend in _JAX_BACKENDS:
        raise ValueError(
            f"backend {backend!r} is the JAX package's; the port's "
            f"counterpart is {_JAX_BACKENDS[backend]!r}")
    if backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {_BACKENDS}")
    dev_type = torch.device(device).type
    if backend == "auto":
        return "cuda" if dev_type == "cuda" else "torch"
    if backend == "cuda" and dev_type != "cuda":
        raise ValueError(f"backend 'cuda' runs the CUDA kernels and needs a "
                         f"CUDA device, got {device!r}")
    return backend


def _upload_words(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """`arr` zero-padded to pad_to_words' rows, as (rows, 128) int32 byte
    quads on `device`."""
    from .offsetfree import _to_device

    rows = padded_rows(arr.size)
    return _to_device(arr, rows * ROW_BYTES, device).view(
        torch.int32).view(rows, LANES)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a NumPy array, through pinned memory from a
    card."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def stage1_words(data: bytes | np.ndarray, dialect: Dialect = DEFAULT_DIALECT,
                 backend: str = "auto", carry_in: int = 0, device="cuda"):
    """bytes -> (packed words int32 (rows//32, 128) sublane-major
    [ops/pack.pack_words layout] as NumPy, n_bytes, parity_out int) for
    the v1 pipeline (unpack with ops/pack.unpack_words_host). "cuda" runs
    kernel B6, "torch" the plain v1 pipeline on `device`."""
    arr = as_u8(data)
    b2d = pad_to_grid(arr)
    backend = _resolve_backend(backend, device)
    if backend not in ("cuda", "torch"):
        raise ValueError(
            f"stage1_words emits packed device words; backend {backend!r} "
            "does not (use build_index for native/golden)")
    t = torch.from_numpy(b2d).to(resolve_device(device))
    if backend == "cuda":
        from .ops.stage1_pallas import stage1_pallas

        words, _count, par = stage1_pallas(t, carry_in, dialect)
    else:
        words, par = stage1_jnp(t, carry_in, dialect)
    return _to_host(words), arr.size, int(par)


def extract_offsets_from_packed(packed_np: np.ndarray, tile: int,
                                n_bytes: int, base: int = 0) -> np.ndarray:
    """Fold-layout packed words -> ascending int64 ABSOLUTE structural
    offsets (no sentinel): the multithreaded native extractor when it
    builds (g++ at first use), NumPy unpack + flatnonzero otherwise."""
    from .ops.stage1_v3 import unpack_packed_host

    with GLOBAL.span("index.extract", n_bytes):
        try:
            from . import native

            if native.available():
                return native.extract_offsets_v3(packed_np, tile, n_bytes,
                                                 base=base)
        except (OSError, RuntimeError):
            pass  # no native build: fall through to the NumPy unpack
        mask = unpack_packed_host(packed_np, n_bytes, tile=tile)
        return np.flatnonzero(mask).astype(np.int64) + base


def build_index(data: bytes | np.ndarray, dialect: Dialect = DEFAULT_DIALECT,
                backend: str = "auto", device="cuda") -> np.ndarray:
    """Full structural index with the 0 sentinel, as int64 host offsets,
    bit-identical to golden.structural_index.

    "cuda" runs kernel B3 (fold layout) on `device`, "torch" its plain
    version there; both copy the words to the host and extract there.
    Inputs of 2 GiB or more go through the streamed build in 64 MiB
    chunks."""
    arr = as_u8(data)
    backend = _resolve_backend(backend, device)
    if arr.size >= 2**31 and backend in ("cuda", "torch"):
        # single-call device builds address bytes with int32: stream big
        # inputs (same kernel, 64 MiB chunks, int64 rebasing on the host)
        from .streaming import StreamingIndexBuilder

        b = StreamingIndexBuilder(dialect, backend, device=device)
        step = 1 << 26
        for lo in range(0, arr.size, step):
            b.feed(arr[lo: lo + step])
        return b.finish()
    if backend == "native":
        from . import native

        index, _par = native.host_stage1(arr, dialect, with_sentinel=True)
        return index
    if backend == "golden":
        from . import golden

        return golden.structural_index(arr, dialect)
    from .ops.stage1_v3 import stage1_fused, stage1_swar_xla

    w2d = _upload_words(arr, resolve_device(device))
    if backend == "cuda":
        packed, _par = stage1_fused(w2d, 0, dialect, row_tile=FOLD_TILE)
    else:
        packed, _par = stage1_swar_xla(w2d, 0, dialect, row_tile=FOLD_TILE)
    tile = min(FOLD_TILE, w2d.shape[0])
    with GLOBAL.span("index.words_to_host"):
        words = _to_host(packed)
    offsets = extract_offsets_from_packed(words, tile, arr.size)
    return np.concatenate([np.zeros(1, dtype=np.int64), offsets])


def _device_offsets_v3(w2d: torch.Tensor, carry_in, dialect: Dialect,
                       capacity: int):
    """v3 scan + device compaction: byte-quad words -> (offsets, count).

    The flag mask is expanded from SWAR 0x80 flags to a per-byte mask in
    flat order (word (r, lane) bytes b=0..3 -> flat (r*128 + lane)*4 + b)
    and compacted with a fixed-capacity nonzero, all on the device."""
    from .ops.stage1_v3 import _classify
    from .ops.swar import (
        swar_broadcast_flag,
        swar_prefix_xor_bytes,
        swar_word_parity,
    )

    rows, lanes = w2d.shape
    sf, qf = _classify(w2d, dialect)
    p_in = swar_prefix_xor_bytes(qf)
    wp = swar_word_parity(p_in)
    incl = torch.cumsum(wp, dim=1, dtype=torch.int32)
    lane_excl = incl - wp
    row_tot = incl[:, -1]
    row_excl = (torch.cumsum(row_tot, dim=0, dtype=torch.int32)
                - row_tot)[:, None]
    base = (lane_excl + row_excl + carry_in) & 1
    masked = sf & ~(p_in ^ swar_broadcast_flag(base))
    bits = torch.stack([(masked >> (8 * b + 7)) & 1 for b in range(4)],
                       dim=-1).reshape(rows, lanes * 4)
    return extract_offsets_device(bits, capacity)


def build_index_device(data: bytes | np.ndarray,
                       dialect: Dialect = DEFAULT_DIALECT,
                       density: float = 0.25, device="cuda"):
    """Device-resident index build (v3 scan + compaction as torch ops on
    `device`): returns (offsets int32 tensor with the leading 0 sentinel,
    count). The capacity starts from the density heuristic and grows
    until the compaction fits."""
    arr = as_u8(data)
    if arr.size >= 2**31:
        raise ValueError(_TWO_GIB_MSG)
    w2d = _upload_words(arr, resolve_device(device))
    cap = max(int(arr.size * density) + 64, 64)
    while True:
        offsets, count = _device_offsets_v3(w2d, 0, dialect, capacity=cap)
        count = int(count)
        if count <= cap:
            break
        cap = max(count, cap * 2)
    head = torch.zeros(1, dtype=torch.int32, device=offsets.device)
    with_sentinel = torch.cat([head, offsets[:count] if count < cap
                               else offsets])
    return with_sentinel, count
