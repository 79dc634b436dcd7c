"""Bind the hand-written CUDA kernels of the product's library.

Every `csrc/*.cu` is built at first use into one shared library with a
plain C interface (`_compiled`: nvcc for Hopper, sm_90a, one process per
source; `_build/libcsv_simd_kernels-<hash>.so`); `ctypes` loads it.
Pointers and the stream pass as `c_void_p`; each C entry point returns
`cudaGetLastError()` after its launches, and the wrappers raise when
that is not 0. Each entry point's C signature is declared beside the
wrapper that calls it. The measurement probes' kernels are another
library, `tools._lab_kernels`, which nothing here imports.

Each wrapper launches on `torch.cuda.current_stream()`, allocates its
outputs and scratch with `torch.empty`, checks device, dtype, contiguity
and shape before it passes a pointer, and adds one to its entry in
LAUNCHES after a launch, and nowhere else. A carry-in may be a Python int
or a 0-d integer tensor; a tensor is read by the kernel from device
memory, so chained calls need no host sync.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from . import _compiled

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# registers, shared memory and spills per kernel, in build(verbose=True)'s
# log
NVCC_VERBOSE = ("-Xptxas", "-v")
LIB = _compiled.Library("libcsv_simd_kernels", CSRC, "*.cu", "nvcc",
                        NVCC_FLAGS, verbose_flags=NVCC_VERBOSE)

vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# launches per kernel wrapper, for showing that a run went through them
LAUNCHES = {"stage1_v4": 0, "stage1_v4_emit": 0, "row_prefix": 0,
            "stage1_fold": 0, "stage1_v2": 0, "stage1_v1": 0,
            "fold_words": 0, "v1_words": 0, "utf8_errs": 0,
            "quote_parity": 0, "json_stage1": 0, "kth_positions": 0,
            "fold_offsets": 0, "serve_packed": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def library_path() -> pathlib.Path:
    return LIB.path()


def build(verbose: bool = False) -> dict:
    """Compile the kernels unless this source set is already built.
    Returns {"path", "seconds", "log"}; `verbose` adds `-Xptxas -v`
    (registers, shared memory and spills per kernel) to the log."""
    return LIB.build(verbose)


_c_error_string = LIB.fn("csv_cuda_error_string", [i32], ctypes.c_char_p)


def _check_words(t: torch.Tensor, what: str,
                 dtype: torch.dtype = torch.int32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected a 16-byte aligned buffer")


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _c_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def _structural(dialect, what: str) -> tuple:
    """The delimiter and newlines, padded to five with repeats."""
    newlines = tuple(dialect.newlines)
    if len(newlines) > 4:
        raise ValueError(f"{what} takes at most four newline bytes")
    structural = (dialect.delimiter,) + newlines
    return structural + (dialect.delimiter,) * (5 - len(structural))


def _carry(carry_in, dev: torch.device) -> tuple:
    """(device pointer or None, int, tensor to keep alive) for a carry-in
    given as a Python int or a 0-d integer tensor."""
    if isinstance(carry_in, torch.Tensor):
        if carry_in.numel() != 1 or carry_in.dtype.is_floating_point:
            raise ValueError("carry_in must be an int or a one-element "
                             f"integer tensor, got {carry_in.dtype} "
                             f"{tuple(carry_in.shape)}")
        t = carry_in.to(device=dev, dtype=torch.int32).reshape(1)
        return t.data_ptr(), 0, t
    return None, int(carry_in) & 1, None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_c_stage1_v4_chunks = LIB.fn("csv_stage1_v4_chunks", [ll], ll)
_c_stage1_v4 = LIB.fn("csv_stage1_v4", [vp, ll, vp, vp, vp, vp, vp, i32, i32,
                                        i32, i32, i32, i32, i32, i32, vp, vp,
                                        vp, vp])


def _one_pass(data: torch.Tensor, carry_in, dialect, what: str,
              scalars: torch.Tensor, count_nonascii: bool = False,
              counts=None, prefix=None, prefix_scratch=None) -> torch.Tensor:
    """B1's launch (csrc/stage1_v4.cu) over the bytes of `data`, on its
    device's current stream, inside `torch.cuda.device(data.device)` ->
    its sequential words (flat int32; bit m of word w covers byte 32w + m).
    The parity out goes to scalars[0], the non-ASCII count (-1: not
    counted) to scalars[1]; counts, prefix and prefix_scratch are B1n's
    outputs or None. Raises on a launch error; counts nothing."""
    n_bytes = data.numel() * data.element_size()
    structural = _structural(dialect, what)
    dev = data.device
    carry_ptr, carry_int, _keep = _carry(carry_in, dev)
    n_chunks = _c_stage1_v4_chunks(n_bytes)
    out = torch.empty(n_bytes // 32, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * n_chunks, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    err = _c_stage1_v4(
        data.data_ptr(), n_bytes, out.data_ptr(), scratch.data_ptr(),
        scalars.data_ptr(), counter.data_ptr(), carry_ptr, carry_int,
        int(bool(count_nonascii)), dialect.quote, *structural,
        _ptr(counts), _ptr(prefix), _ptr(prefix_scratch), _stream(dev))
    _raise_on(err, what)
    return out


_c_stage1_v4_prefix_scratch = LIB.fn("csv_stage1_v4_prefix_scratch", [ll],
                                     ll)


def stage1_v4(words: torch.Tensor, carry_in, dialect,
              count_nonascii: bool, emit_counts: bool = False,
              emit_prefix: bool = False):
    """Kernel B1 on CUDA int32 byte quads (a whole number of 32-byte
    words) -> (packed flat int32, parity 0-d int32, non-ASCII count 0-d
    int32 or -1 when not counted, row counts, row prefix). B1n: with
    emit_counts / emit_prefix (whole 512-byte rows) the last two are the
    (rows,) int32 structural count of each row and their inclusive
    prefix; otherwise None. A launch with either emit counts under
    "stage1_v4_emit", one without under "stage1_v4"."""
    _check_words(words, "stage1_v4")
    n_bytes = words.numel() * 4
    if n_bytes == 0 or n_bytes % 32:
        raise ValueError(f"stage1_v4: {n_bytes} bytes is not a positive "
                         "multiple of 32")
    emit = emit_counts or emit_prefix
    if emit and n_bytes % 512:
        raise ValueError(f"stage1_v4: row counts need whole 512-byte rows, "
                         f"got {n_bytes} bytes")
    dev = words.device
    rows = n_bytes // 512
    with torch.cuda.device(dev):
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        counts = prefix = prefix_scratch = None
        if emit_counts:
            counts = torch.empty(rows, dtype=torch.int32, device=dev)
        if emit_prefix:
            prefix = torch.empty(rows, dtype=torch.int32, device=dev)
            prefix_scratch = torch.empty(
                _c_stage1_v4_prefix_scratch(n_bytes),
                dtype=torch.int32, device=dev)
        out = _one_pass(words, carry_in, dialect, "stage1_v4", scalars,
                        count_nonascii, counts, prefix, prefix_scratch)
    LAUNCHES["stage1_v4_emit" if emit else "stage1_v4"] += 1
    return out, scalars[0], scalars[1], counts, prefix


def _check_stage1_bytes(data: torch.Tensor, what: str) -> int:
    """Raise unless data holds a positive multiple of 4 KiB; returns its
    byte count."""
    n_bytes = data.numel() * data.element_size()
    if n_bytes == 0 or n_bytes % 4096:
        raise ValueError(f"{what}: {n_bytes} bytes is not a positive "
                         "multiple of 4096")
    return n_bytes


def _check_fold_tile(rows: int, tile: int, what: str) -> None:
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"{what}: tile {tile} must be a positive multiple "
                         f"of 8 that divides the {rows} rows")


# bit orders of csrc/relayout.cu `fold_words`: B3's fold (sigma(j)) and the
# ablation probe's (bitrev3(j), each byte of B3's bit-reversed)
FOLD_ORDER_B3, FOLD_ORDER_BITREV = 0, 1
_c_fold_words = LIB.fn("csv_fold_words", [vp, ll, i32, i32, vp, i32, vp, vp])
_c_v1_words = LIB.fn("csv_v1_words", [vp, ll, ll, vp, vp, vp])


def _launch_fold_words(seq: torch.Tensor, rows: int, tile: int, what: str,
                       order: int = FOLD_ORDER_B3,
                       add: tuple = (None, 0)) -> torch.Tensor:
    """csrc/relayout.cu `fold_words` on B1's words of rows x 512 bytes ->
    (rows/8, 128) int32 fold-layout words in `order`, each adding the bit
    `add` gives as (device pointer or None, int), as `_carry` returns it.
    Counts nothing."""
    out = torch.empty((rows // 8, 128), dtype=torch.int32, device=seq.device)
    _raise_on(_c_fold_words(seq.data_ptr(), rows, tile, order, add[0],
                            add[1], out.data_ptr(), _stream(seq.device)),
              what)
    return out


def _launch_v1_words(seq: torch.Tensor, rows: int, count_from: int,
                     count: torch.Tensor, what: str) -> torch.Tensor:
    """csrc/relayout.cu `v1_words` on B1's words of rows x 128 bytes ->
    (rows/32, 128) int32 v1-layout words; count (a one-int view on the
    card) gets the structural count of the words from flat index
    count_from on. Counts nothing."""
    out = torch.empty((rows // 32, 128), dtype=torch.int32,
                      device=seq.device)
    _raise_on(_c_v1_words(seq.data_ptr(), rows, count_from, out.data_ptr(),
                          count.data_ptr(), _stream(seq.device)), what)
    return out


def stage1_fold(words: torch.Tensor, carry_in, dialect, tile: int):
    """Kernel B3 on CUDA (rows, 128) int32 byte quads -> (fold-layout
    packed (rows/8, 128) int32, parity 0-d int32): B1's one pass, then
    `fold_words` on its words. `tile` is the fold tile in rows: a
    multiple of 8 that divides rows (any size)."""
    _check_words(words, "stage1_fold")
    rows = _check_stage1_bytes(words, "stage1_fold") // 512
    _check_fold_tile(rows, tile, "stage1_fold")
    dev = words.device
    with torch.cuda.device(dev):
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        seq = _one_pass(words, carry_in, dialect, "stage1_fold", scalars)
        out = _launch_fold_words(seq, rows, tile, "stage1_fold")
    LAUNCHES["stage1_fold"] += 1
    return out, scalars[0]


def fold_words(seq: torch.Tensor, tile: int) -> torch.Tensor:
    """`fold_words` alone on CUDA: B1's sequential words of rows x 512
    bytes (rows * 16 int32, any shape) -> B3's fold-layout (rows/8, 128)
    int32 at `tile` rows (a multiple of 8 that divides rows)."""
    _check_words(seq, "fold_words")
    if seq.numel() == 0 or seq.numel() % 128:
        raise ValueError(f"fold_words: {seq.numel()} words is not a "
                         "positive multiple of 128 (8 rows of 16)")
    rows = seq.numel() // 16
    _check_fold_tile(rows, tile, "fold_words")
    with torch.cuda.device(seq.device):
        out = _launch_fold_words(seq, rows, tile, "fold_words")
    LAUNCHES["fold_words"] += 1
    return out


def _v1(b2d: torch.Tensor, carry_in, dialect, count_from, what: str):
    """B1's one pass over (rows, 128) uint8, then `v1_words` -> (words
    (rows/32, 128) int32, count 0-d int32 of the words from flat index
    count_from on, parity 0-d int32)."""
    rows = _check_stage1_bytes(b2d, what) // 128
    dev = b2d.device
    with torch.cuda.device(dev):
        scalars = torch.empty(3, dtype=torch.int32, device=dev)
        seq = _one_pass(b2d, carry_in, dialect, what, scalars)
        out = _launch_v1_words(seq, rows, count_from, scalars[2:], what)
    return out, scalars[2], scalars[0]


def stage1_v1(b2d: torch.Tensor, carry_in, dialect):
    """Kernel B6 on CUDA (rows, 128) uint8, rows % 32 == 0 -> (v1
    sublane-major packed (rows/32, 128) int32, count 0-d int32, parity
    0-d int32): B1's one pass, then `v1_words` on its words."""
    _check_words(b2d, "stage1_v1", torch.uint8)
    out = _v1(b2d, carry_in, dialect, 0, "stage1_v1")
    LAUNCHES["stage1_v1"] += 1
    return out


def v1_words(seq: torch.Tensor, count_from: int = 0):
    """`v1_words` alone on CUDA: B1's sequential words of rows x 128
    bytes (rows * 4 int32, rows % 32 == 0, any shape) -> (v1-layout
    words (rows/32, 128) int32, count 0-d int32: the structural count
    of the words from flat index count_from on)."""
    _check_words(seq, "v1_words")
    if seq.numel() == 0 or seq.numel() % 128:
        raise ValueError(f"v1_words: {seq.numel()} words is not a positive "
                         "multiple of 128 (32 rows of 4)")
    if count_from < 0:
        raise ValueError(f"v1_words: count_from {count_from} is negative")
    with torch.cuda.device(seq.device):
        count = torch.empty(1, dtype=torch.int32, device=seq.device)
        out = _launch_v1_words(seq, seq.numel() // 4, count_from, count,
                               "v1_words")
    LAUNCHES["v1_words"] += 1
    return out, count[0]


_c_stage1_v2 = LIB.fn("csv_stage1_v2", [vp, ll, vp, vp, vp, vp, i32, i32,
                                        i32, i32, i32, i32, i32, vp])


def stage1_v2(words: torch.Tensor, carry_in, dialect):
    """Kernel B5 on CUDA (rows, 128) int32 byte quads, rows % 8 == 0 ->
    (v2-layout packed (rows/8, 128) int32, count 0-d int32, parity 0-d
    int32): one launch of csrc/stage1_pack.cu `v2_pack`, B1's one pass
    with the v2 words written from its staged emit."""
    _check_words(words, "stage1_v2")
    n_bytes = _check_stage1_bytes(words, "stage1_v2")
    structural = _structural(dialect, "stage1_v2")
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty((n_bytes // 512 // 8, 128), dtype=torch.int32,
                          device=dev)
        scratch = torch.empty(_c_stage1_v4_chunks(n_bytes) + 1,
                              dtype=torch.int32, device=dev)
        scalars = torch.empty(3, dtype=torch.int32, device=dev)
        err = _c_stage1_v2(
            words.data_ptr(), n_bytes, out.data_ptr(), scratch.data_ptr(),
            scalars.data_ptr(), carry_ptr, carry_int, dialect.quote,
            *structural, _stream(dev))
    _raise_on(err, "stage1_v2")
    LAUNCHES["stage1_v2"] += 1
    return out, scalars[2], scalars[0]


_c_row_prefix_scratch = LIB.fn("csv_row_prefix_scratch", [ll], ll)
_c_row_prefix = LIB.fn("csv_row_prefix", [vp, ll, vp, vp, vp])


def row_prefix(packed: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on CUDA packed words (any shape, 16 words per row in
    row-major order) -> (rows,) int32 inclusive row popcount prefix."""
    _check_words(packed, "row_prefix")
    if packed.numel() == 0 or packed.numel() % 16:
        raise ValueError(f"row_prefix: {packed.numel()} words is not a "
                         "positive multiple of 16")
    rows = packed.numel() // 16
    dev = packed.device
    with torch.cuda.device(dev):
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        scratch = torch.empty(_c_row_prefix_scratch(rows),
                              dtype=torch.int32, device=dev)
        err = _c_row_prefix(packed.data_ptr(), rows, out.data_ptr(),
                            scratch.data_ptr(), _stream(dev))
    _raise_on(err, "row_prefix")
    LAUNCHES["row_prefix"] += 1
    return out


_c_fold_offsets_scratch = LIB.fn("csv_fold_offsets_scratch", [ll], ll)
_c_fold_offsets_count = LIB.fn("csv_fold_offsets_count",
                               [vp, ll, ll, ll, vp, vp, vp])
_c_fold_offsets_emit = LIB.fn("csv_fold_offsets_emit",
                              [vp, ll, ll, ll, vp, vp, vp, ll, vp])


def fold_offsets(packed: torch.Tensor, tile: int, n_bytes: int):
    """Kernel E1 (csrc/fold_offsets.cu) on B3's CUDA fold-layout words
    ((rows/8, 128) int32 at fold tile `tile`) -> (1 + count,) int32 on
    their device: 0, then the ascending structural byte offsets below
    n_bytes (< 2**31), bit for bit `native.extract_offsets_v3`'s. Two
    passes over the words and one host read of the count between them."""
    _check_words(packed, "fold_offsets")
    if packed.numel() == 0 or packed.numel() % 128:
        raise ValueError(f"fold_offsets: {packed.numel()} words is not a "
                         "positive multiple of 128 (8 rows of 16)")
    rows = packed.numel() // 16
    _check_fold_tile(rows, tile, "fold_offsets")
    if not 0 <= n_bytes < 2**31:
        raise ValueError(f"fold_offsets: n_bytes {n_bytes} is not in "
                         "[0, 2**31): the offsets are int32")
    steps = rows // tile
    dev = packed.device
    with torch.cuda.device(dev):
        counts = torch.empty(rows, dtype=torch.int32, device=dev)
        scratch = torch.empty(_c_fold_offsets_scratch(steps),
                              dtype=torch.int32, device=dev)
        _raise_on(_c_fold_offsets_count(
            packed.data_ptr(), rows // 8, tile, n_bytes, counts.data_ptr(),
            scratch.data_ptr(), _stream(dev)), "fold_offsets")
        total = int(scratch[-1])  # the one host sync: sizes the output
        out = torch.empty(total + 1, dtype=torch.int32, device=dev)
        _raise_on(_c_fold_offsets_emit(
            packed.data_ptr(), rows // 8, tile, n_bytes, counts.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), total, _stream(dev)),
            "fold_offsets")
    LAUNCHES["fold_offsets"] += 1
    return out


_c_utf8_errs = LIB.fn("csv_utf8_errs", [vp, ll, vp, vp])


def utf8_errs(data: torch.Tensor) -> torch.Tensor:
    """The UTF-8 validator (csrc/utf8.cu) on CUDA uint8 bytes (any shape,
    contiguous, 16-byte aligned, at least one byte) -> 0-d int64 count of
    the errors `ops.utf8._utf8_errs_plain` counts: 0 iff the bytes are
    valid UTF-8."""
    _check_words(data, "utf8_errs", torch.uint8)
    n = data.numel()
    if n == 0:
        raise ValueError("utf8_errs: no bytes")
    dev = data.device
    with torch.cuda.device(dev):
        count = torch.empty((), dtype=torch.int64, device=dev)
        err = _c_utf8_errs(data.data_ptr(), n, count.data_ptr(),
                           _stream(dev))
    _raise_on(err, "utf8_errs")
    LAUNCHES["utf8_errs"] += 1
    return count


_c_quote_parity = LIB.fn("csv_quote_parity", [vp, ll, i32, vp, vp])


def quote_parity(words: torch.Tensor, quote: int) -> torch.Tensor:
    """Kernel S1 (csrc/shard_parity.cu) on a shard's CUDA int32 byte quads
    (any shape, contiguous, 16-byte aligned, a positive multiple of 16
    bytes) -> 0-d int32 parity of its bytes equal to `quote`, on the
    words' device, with no host sync: the count
    `parallel.sharded._local_parity_plain` takes & 1."""
    _check_words(words, "quote_parity")
    n_bytes = words.numel() * 4
    if n_bytes == 0 or n_bytes % 16:
        raise ValueError(f"quote_parity: {n_bytes} bytes is not a positive "
                         "multiple of 16")
    dev = words.device
    with torch.cuda.device(dev):
        out = torch.empty((), dtype=torch.int32, device=dev)
        err = _c_quote_parity(words.data_ptr(), n_bytes, int(quote) & 0xFF,
                              out.data_ptr(), _stream(dev))
    _raise_on(err, "quote_parity")
    LAUNCHES["quote_parity"] += 1
    return out


_c_kth_positions = LIB.fn("csv_kth_positions",
                          [vp, vp, ll, vp, ll, vp, i32, vp])


def kth_positions(words: torch.Tensor, cum_incl: torch.Tensor,
                  ks: torch.Tensor) -> torch.Tensor:
    """Rank-select (csrc/rank_select.cu) on the card: the packed words
    (rows * 16 int32 in row-major order, the narrow or wide layout), their
    (rows,) int32 inclusive row prefix and (Q,) int32 ranks -> (Q,) flat
    byte positions of the k-th set bits, int32 or, where the words cover
    2**31 bytes or more, int64 (`device_tape._position_dtype`), bit for
    bit those of `offsetfree._kth_positions_plain` for 0 <= k < total
    (unspecified otherwise; the kernel reads only inside the index). One
    launch; none for Q = 0."""
    from .device_tape import _position_dtype

    _check_words(words, "kth_positions")
    for t, what in ((cum_incl, "kth_positions cum_incl"),
                    (ks, "kth_positions ks")):
        if t.device != words.device:
            raise ValueError(f"{what}: expected {words.device}, got "
                             f"{t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: expected torch.int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: expected a contiguous 1-D tensor, "
                             f"got {tuple(t.shape)}")
    rows = cum_incl.numel()
    if rows == 0 or rows * 16 != words.numel():
        raise ValueError(f"kth_positions: {words.numel()} words are not 16 "
                         f"for each of the prefix's {rows} rows")
    dev = words.device
    dtype = _position_dtype(words.numel() * 32)
    with torch.cuda.device(dev):
        out = torch.empty(ks.numel(), dtype=dtype, device=dev)
        if ks.numel() == 0:
            return out
        err = _c_kth_positions(
            words.data_ptr(), cum_incl.data_ptr(), rows, ks.data_ptr(),
            ks.numel(), out.data_ptr(), int(dtype == torch.int64),
            _stream(dev))
    _raise_on(err, "kth_positions")
    LAUNCHES["kth_positions"] += 1
    return out


_c_serve_packed = LIB.fn("csv_serve_packed",
                         [vp, vp, ll, vp, ll, vp, vp, ll, i32, i32, ll, i32,
                          vp, vp, vp, i32, vp])


def serve_packed(data: torch.Tensor, words: torch.Tensor,
                 cum_incl: torch.Tensor, records: torch.Tensor,
                 fields: torch.Tensor, jump: int, field_cnt: int,
                 record_cnt: int, max_len: int, wide: bool) -> tuple:
    """The packed tape's batched serve (csrc/rank_select.cu `serve_packed`)
    on the card: the flat bytes (n_bytes uint8, at least one), the packed
    words and their (rows,) int32 inclusive row prefix as `kth_positions`
    takes them, and (N,) int32 records and fields -> (bytes (N, max_len)
    uint8, TRUE lengths (N,) int32, valid (N,) bool) on their device, bit
    for bit `offsetfree._serve_plain`'s (but for a record of 2**31 - 1,
    which this takes as invalid). Byte positions are int64 where `wide`,
    which the caller sets where the words cover 2**31 bytes or more
    (`device_tape._position_dtype`, as `offsetfree._serve` decides it),
    and int32 otherwise. One launch; none for N = 0."""
    _check_words(words, "serve_packed")
    for t, what, dtype in ((data, "data", torch.uint8),
                           (cum_incl, "cum_incl", torch.int32),
                           (records, "records", torch.int32),
                           (fields, "fields", torch.int32)):
        if t.device != words.device:
            raise ValueError(f"serve_packed {what}: expected "
                             f"{words.device}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"serve_packed {what}: expected {dtype}, got "
                             f"{t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"serve_packed {what}: expected a contiguous "
                             f"1-D tensor, got {tuple(t.shape)}")
    rows = cum_incl.numel()
    if rows == 0 or rows * 16 != words.numel():
        raise ValueError(f"serve_packed: {words.numel()} words are not 16 "
                         f"for each of the prefix's {rows} rows")
    if records.numel() != fields.numel():
        raise ValueError(f"serve_packed: {records.numel()} records but "
                         f"{fields.numel()} fields")
    if data.numel() == 0:
        raise ValueError("serve_packed: no bytes")
    if not 0 <= max_len < 2**31 or jump < 1:
        raise ValueError(f"serve_packed: max_len {max_len} or jump {jump} "
                         "out of range")
    n = records.numel()
    dev = words.device
    with torch.cuda.device(dev):
        out = torch.empty((n, max_len), dtype=torch.uint8, device=dev)
        lengths = torch.empty(n, dtype=torch.int32, device=dev)
        valid = torch.empty(n, dtype=torch.bool, device=dev)
        if n == 0:
            return out, lengths, valid
        err = _c_serve_packed(
            words.data_ptr(), cum_incl.data_ptr(), rows, data.data_ptr(),
            data.numel(), records.data_ptr(), fields.data_ptr(), n, jump,
            field_cnt, record_cnt, max_len, out.data_ptr(),
            lengths.data_ptr(), valid.data_ptr(), int(wide), _stream(dev))
    _raise_on(err, "serve_packed")
    LAUNCHES["serve_packed"] += 1
    return out, lengths, valid


_c_json_stage1_segments = LIB.fn("csv_json_stage1_segments", [ll], ll)
_c_json_stage1 = LIB.fn("csv_json_stage1", [vp, ll, vp, vp, vp, vp, vp])


def json_stage1(data: torch.Tensor) -> tuple:
    """Kernel J1 (csrc/json_stage1.cu) on CUDA uint8 bytes (any shape,
    fewer than 2**31) -> (mask, depth), each (n,) int32 on the bytes'
    device: the structural mask outside strings and the nesting depth of
    `experiments.json_device._depths_plain`. Bytes that are not
    contiguous or not 16-byte aligned are copied first; no bytes launch
    nothing."""
    if data.device.type != "cuda":
        raise ValueError(f"json_stage1: expected a CUDA tensor, got "
                         f"{data.device}")
    if data.dtype != torch.uint8:
        raise ValueError(f"json_stage1: expected uint8, got {data.dtype}")
    flat = data.reshape(-1)
    n = flat.numel()
    if n >= 2**31:
        raise ValueError(f"json_stage1: {n} bytes; fewer than 2**31 only")
    dev = data.device
    with torch.cuda.device(dev):
        mask = torch.empty(n, dtype=torch.int32, device=dev)
        depth = torch.empty(n, dtype=torch.int32, device=dev)
        if n == 0:
            return mask, depth
        if not flat.is_contiguous() or flat.data_ptr() % 16:
            flat = flat.clone(memory_format=torch.contiguous_format)
        nseg = _c_json_stage1_segments(n)
        tables = torch.empty(3 * nseg, dtype=torch.int32, device=dev)
        carries = torch.empty(2 * nseg, dtype=torch.int32, device=dev)
        err = _c_json_stage1(flat.data_ptr(), n, tables.data_ptr(),
                             carries.data_ptr(), mask.data_ptr(),
                             depth.data_ptr(), _stream(dev))
    _raise_on(err, "json_stage1")
    LAUNCHES["json_stage1"] += 1
    return mask, depth
