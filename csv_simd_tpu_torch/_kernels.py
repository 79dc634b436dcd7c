"""Build and bind the hand-written CUDA kernels.

At first use, `nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a), one
process per source, all started together, and links the objects into one
shared library with a plain C interface under `_build/` (named by a hash
of the sources, so an edited source is rebuilt); `ctypes` loads it.
Pointers and the stream pass as `c_void_p`; each C entry point returns
`cudaGetLastError()` after its launches, and the wrappers raise when
that is not 0.

Each wrapper launches on `torch.cuda.current_stream()`, allocates its
outputs and scratch with `torch.empty`, checks device, dtype, contiguity
and shape before it passes a pointer, and adds one to its entry in
LAUNCHES after a launch, and nowhere else. A carry-in may be a Python int
or a 0-d integer tensor; a tensor is read by the kernel from device
memory, so chained calls need no host sync.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

from .config import DEFAULT_DIALECT

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# launches per kernel wrapper, for showing that a run went through them
LAUNCHES = {"stage1_v4": 0, "stage1_v4_emit": 0, "row_prefix": 0,
            "stage1_fold": 0, "stage1_v2": 0, "stage1_v1": 0,
            "fold_words": 0, "v1_words": 0,
            "probe_stream_write": 0, "probe_stream_read": 0, "probe_alu": 0,
            "probe_ablate": 0, "probe_ablate2": 0, "probe_kbench": 0,
            "probe_vnext": 0, "probe_ws_gather": 0, "probe_ws_lanesum": 0,
            "probe_ws_packmm": 0, "probe_mosaic_mm32": 0,
            "probe_mosaic_gather": 0, "probe_mosaic_cmp8": 0,
            "probe_mosaic_select8": 0, "probe_mosaic_shift_add": 0,
            "probe_mosaic_usum": 0, "probe_concat_mm": 0, "utf8_errs": 0,
            "quote_parity": 0, "json_stage1": 0, "kth_positions": 0}
_lib = None
_alu_op_counts = None
_alu_const_arrays = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(pathlib.Path(home) / "bin" / "nvcc")] if home else [])
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcsv_simd_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile the kernels unless this source set is already built.
    Returns {"path", "seconds", "log"}; `verbose` adds `-Xptxas -v`
    (registers, shared memory and spills per kernel) to the log."""
    out = library_path()
    if out.exists() and not verbose:
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        log.append(r.stdout + r.stderr)
        os.replace(lib, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "".join(log)}


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.csv_stage1_v4_chunks.argtypes = [ll]
        lib.csv_stage1_v4_chunks.restype = ll
        lib.csv_stage1_v4.argtypes = [vp, ll, vp, vp, vp, vp, vp, i, i,
                                      i, i, i, i, i, i, vp, vp, vp, vp]
        lib.csv_stage1_v4.restype = i
        lib.csv_stage1_v4_prefix_scratch.argtypes = [ll]
        lib.csv_stage1_v4_prefix_scratch.restype = ll
        lib.csv_fold_words.argtypes = [vp, ll, i, i, vp, i, vp, vp]
        lib.csv_fold_words.restype = i
        lib.csv_v1_words.argtypes = [vp, ll, ll, vp, vp, vp]
        lib.csv_v1_words.restype = i
        lib.csv_stage1_v2.argtypes = [vp, ll, vp, vp, vp, vp, i, i, i, i, i,
                                      i, i, vp]
        lib.csv_stage1_v2.restype = i
        lib.csv_row_prefix_scratch.argtypes = [ll]
        lib.csv_row_prefix_scratch.restype = ll
        lib.csv_row_prefix.argtypes = [vp, ll, vp, vp, vp]
        lib.csv_row_prefix.restype = i
        lib.csv_probe_stream_write.argtypes = [i, vp, ll, vp, i, vp, vp, vp]
        lib.csv_probe_stream_write.restype = i
        lib.csv_probe_stream_read.argtypes = [vp, ll, vp, i, vp, vp, vp]
        lib.csv_probe_stream_read.restype = i
        lib.csv_probe_alu_op_count.argtypes = [i]
        lib.csv_probe_alu_op_count.restype = i
        lib.csv_probe_alu.argtypes = [vp, ll, ctypes.POINTER(i), i, i, vp, i,
                                      vp, i, vp]
        lib.csv_probe_alu.restype = i
        lib.csv_probe_ablate_chunks.argtypes = [ll]
        lib.csv_probe_ablate_chunks.restype = ll
        lib.csv_probe_ablate_relayout.argtypes = [i, i]
        lib.csv_probe_ablate_relayout.restype = i
        lib.csv_probe_ablate.argtypes = [i, vp, ll, i, vp, i, vp, vp, vp, vp,
                                         vp]
        lib.csv_probe_ablate.restype = i
        lib.csv_probe_ablate2_chunks.argtypes = [ll]
        lib.csv_probe_ablate2_chunks.restype = ll
        lib.csv_probe_ablate2.argtypes = [i, vp, ll, i, vp, i, vp, vp, vp, vp,
                                          vp]
        lib.csv_probe_ablate2.restype = i
        lib.csv_probe_kbench.argtypes = [i, vp, ll, i, vp, i, vp, vp, vp]
        lib.csv_probe_kbench.restype = i
        lib.csv_probe_vnext_direct.argtypes = [i]
        lib.csv_probe_vnext_direct.restype = i
        lib.csv_probe_vnext_chunks.argtypes = [ll]
        lib.csv_probe_vnext_chunks.restype = ll
        lib.csv_probe_vnext.argtypes = [vp, ll, i, vp, i, vp, vp, vp, vp]
        lib.csv_probe_vnext.restype = i
        lib.csv_probe_ws_gather.argtypes = [vp, ll, vp, vp]
        lib.csv_probe_ws_gather.restype = i
        lib.csv_probe_ws_lanesum.argtypes = [vp, ll, vp, vp]
        lib.csv_probe_ws_lanesum.restype = i
        lib.csv_probe_ws_packmm.argtypes = [vp, ll, vp, vp, i, vp]
        lib.csv_probe_ws_packmm.restype = i
        for name in ("mm32", "cmp8", "select8", "shift_add"):
            fn = getattr(lib, f"csv_probe_mosaic_{name}")
            fn.argtypes = [vp, ll, vp, vp]
            fn.restype = i
        lib.csv_probe_mosaic_gather.argtypes = [vp, vp, ll, vp, vp]
        lib.csv_probe_mosaic_gather.restype = i
        lib.csv_probe_mosaic_usum.argtypes = [vp, ll, vp, i, vp]
        lib.csv_probe_mosaic_usum.restype = i
        lib.csv_probe_concat_mm.argtypes = [vp, ll, vp, vp, i, vp]
        lib.csv_probe_concat_mm.restype = i
        lib.csv_utf8_errs.argtypes = [vp, ll, vp, vp]
        lib.csv_utf8_errs.restype = i
        lib.csv_quote_parity.argtypes = [vp, ll, i, vp, vp]
        lib.csv_quote_parity.restype = i
        lib.csv_kth_positions.argtypes = [vp, vp, ll, vp, ll, vp, vp]
        lib.csv_kth_positions.restype = i
        lib.csv_json_stage1_segments.argtypes = [ll]
        lib.csv_json_stage1_segments.restype = ll
        lib.csv_json_stage1.argtypes = [vp, ll, vp, vp, vp, vp, vp]
        lib.csv_json_stage1.restype = i
        lib.csv_cuda_error_string.argtypes = [i]
        lib.csv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
        msg = _library().csv_cuda_error_string(err).decode()
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
    lib = _library()
    dev = data.device
    carry_ptr, carry_int, _keep = _carry(carry_in, dev)
    n_chunks = lib.csv_stage1_v4_chunks(n_bytes)
    out = torch.empty(n_bytes // 32, dtype=torch.int32, device=dev)
    scratch = torch.empty(2 * n_chunks, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int64, device=dev)
    err = lib.csv_stage1_v4(
        data.data_ptr(), n_bytes, out.data_ptr(), scratch.data_ptr(),
        scalars.data_ptr(), counter.data_ptr(), carry_ptr, carry_int,
        int(bool(count_nonascii)), dialect.quote, *structural,
        _ptr(counts), _ptr(prefix), _ptr(prefix_scratch), _stream(dev))
    _raise_on(err, what)
    return out


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
                _library().csv_stage1_v4_prefix_scratch(n_bytes),
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


def _launch_fold_words(seq: torch.Tensor, rows: int, tile: int, what: str,
                       order: int = FOLD_ORDER_B3,
                       add: tuple = (None, 0)) -> torch.Tensor:
    """csrc/relayout.cu `fold_words` on B1's words of rows x 512 bytes ->
    (rows/8, 128) int32 fold-layout words in `order`, each adding the bit
    `add` gives as (device pointer or None, int), as `_carry` returns it.
    Counts nothing."""
    out = torch.empty((rows // 8, 128), dtype=torch.int32, device=seq.device)
    _raise_on(_library().csv_fold_words(seq.data_ptr(), rows, tile, order,
                                        add[0], add[1], out.data_ptr(),
                                        _stream(seq.device)), what)
    return out


def _launch_v1_words(seq: torch.Tensor, rows: int, count_from: int,
                     count: torch.Tensor, what: str) -> torch.Tensor:
    """csrc/relayout.cu `v1_words` on B1's words of rows x 128 bytes ->
    (rows/32, 128) int32 v1-layout words; count (a one-int view on the
    card) gets the structural count of the words from flat index
    count_from on. Counts nothing."""
    out = torch.empty((rows // 32, 128), dtype=torch.int32,
                      device=seq.device)
    _raise_on(_library().csv_v1_words(seq.data_ptr(), rows, count_from,
                                      out.data_ptr(), count.data_ptr(),
                                      _stream(seq.device)), what)
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


def stage1_v2(words: torch.Tensor, carry_in, dialect):
    """Kernel B5 on CUDA (rows, 128) int32 byte quads, rows % 8 == 0 ->
    (v2-layout packed (rows/8, 128) int32, count 0-d int32, parity 0-d
    int32): one launch of csrc/stage1_pack.cu `v2_pack`, B1's one pass
    with the v2 words written from its staged emit."""
    _check_words(words, "stage1_v2")
    n_bytes = _check_stage1_bytes(words, "stage1_v2")
    structural = _structural(dialect, "stage1_v2")
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty((n_bytes // 512 // 8, 128), dtype=torch.int32,
                          device=dev)
        scratch = torch.empty(lib.csv_stage1_v4_chunks(n_bytes) + 1,
                              dtype=torch.int32, device=dev)
        scalars = torch.empty(3, dtype=torch.int32, device=dev)
        err = lib.csv_stage1_v2(
            words.data_ptr(), n_bytes, out.data_ptr(), scratch.data_ptr(),
            scalars.data_ptr(), carry_ptr, carry_int, dialect.quote,
            *structural, _stream(dev))
    _raise_on(err, "stage1_v2")
    LAUNCHES["stage1_v2"] += 1
    return out, scalars[2], scalars[0]


def row_prefix(packed: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on CUDA packed words (any shape, 16 words per row in
    row-major order) -> (rows,) int32 inclusive row popcount prefix."""
    _check_words(packed, "row_prefix")
    if packed.numel() == 0 or packed.numel() % 16:
        raise ValueError(f"row_prefix: {packed.numel()} words is not a "
                         "positive multiple of 16")
    rows = packed.numel() // 16
    lib = _library()
    dev = packed.device
    with torch.cuda.device(dev):
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        scratch = torch.empty(lib.csv_row_prefix_scratch(rows),
                              dtype=torch.int32, device=dev)
        err = lib.csv_row_prefix(
            packed.data_ptr(), rows, out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "row_prefix")
    LAUNCHES["row_prefix"] += 1
    return out


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
        err = _library().csv_utf8_errs(data.data_ptr(), n, count.data_ptr(),
                                       _stream(dev))
    _raise_on(err, "utf8_errs")
    LAUNCHES["utf8_errs"] += 1
    return count


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
        err = _library().csv_quote_parity(words.data_ptr(), n_bytes,
                                          int(quote) & 0xFF, out.data_ptr(),
                                          _stream(dev))
    _raise_on(err, "quote_parity")
    LAUNCHES["quote_parity"] += 1
    return out


def kth_positions(words: torch.Tensor, cum_incl: torch.Tensor,
                  ks: torch.Tensor) -> torch.Tensor:
    """Rank-select (csrc/rank_select.cu) on the card: the packed words
    (rows * 16 int32 in row-major order, the narrow or wide layout), their
    (rows,) int32 inclusive row prefix and (Q,) int32 ranks -> (Q,) int32
    flat byte positions of the k-th set bits, bit for bit those of
    `offsetfree._kth_positions_plain` for 0 <= k < total (unspecified
    otherwise; the kernel reads only inside the index). One launch; none
    for Q = 0."""
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
    with torch.cuda.device(dev):
        out = torch.empty(ks.numel(), dtype=torch.int32, device=dev)
        if ks.numel() == 0:
            return out
        err = _library().csv_kth_positions(
            words.data_ptr(), cum_incl.data_ptr(), rows, ks.data_ptr(),
            ks.numel(), out.data_ptr(), _stream(dev))
    _raise_on(err, "kth_positions")
    LAUNCHES["kth_positions"] += 1
    return out


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
        lib = _library()
        nseg = lib.csv_json_stage1_segments(n)
        tables = torch.empty(3 * nseg, dtype=torch.int32, device=dev)
        carries = torch.empty(2 * nseg, dtype=torch.int32, device=dev)
        err = lib.csv_json_stage1(flat.data_ptr(), n, tables.data_ptr(),
                                  carries.data_ptr(), mask.data_ptr(),
                                  depth.data_ptr(), _stream(dev))
    _raise_on(err, "json_stage1")
    LAUNCHES["json_stage1"] += 1
    return mask, depth


# modes of csrc/probe_stream.cu's write kernel and csrc/probe_ablate.cu
STREAM_WRITE_MODES = ("narrow", "tall2", "tall8", "wide")
ABLATE_MODES = ("dma_only", "classify_only", "inword", "noscan", "full",
                "v3", "v3_foldonly", "v3_mmonly")


def check_rows128(words: torch.Tensor, what: str, align: int) -> int:
    """Raise unless words is (rows, 128) int32 with rows a positive
    multiple of align, on any device (the probes' input); returns rows."""
    if words.dtype != torch.int32 or words.dim() != 2 or \
            words.shape[1] != 128:
        raise ValueError(f"{what}: expected (rows, 128) int32, got "
                         f"{words.dtype} {tuple(words.shape)}")
    rows = words.shape[0]
    if rows == 0 or rows % align:
        raise ValueError(f"{what}: rows must be a positive multiple of "
                         f"{align}, got {rows}")
    return rows


def _check_rows128(words: torch.Tensor, what: str, align: int) -> int:
    _check_words(words, what)
    return check_rows128(words, what, align)


def probe_stream_write(words: torch.Tensor, mode: str, carry_in):
    """csrc/probe_stream.cu's write kernel on CUDA (rows, 128) int32, rows
    % 512 == 0 -> (out (rows, 16) int32 for narrow/tall2/tall8, (rows/8,
    128) for wide; side (rows/512,) int32, the XOR of each 512-row
    block)."""
    rows = _check_rows128(words, "probe_stream_write", 512)
    if mode not in STREAM_WRITE_MODES:
        raise ValueError(f"probe_stream_write: mode must be one of "
                         f"{STREAM_WRITE_MODES}, got {mode!r}")
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        shape = (rows // 8, 128) if mode == "wide" else (rows, 16)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        side = torch.empty(rows // 512, dtype=torch.int32, device=dev)
        err = lib.csv_probe_stream_write(
            STREAM_WRITE_MODES.index(mode), words.data_ptr(), rows,
            carry_ptr, carry_int, out.data_ptr(), side.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_stream_write")
    LAUNCHES["probe_stream_write"] += 1
    return out, side


def probe_stream_read(words: torch.Tensor, carry_in):
    """csrc/probe_stream.cu's read kernel on CUDA (R, 128) int32, R % 64
    == 0 -> (0-d int32: the wrapping sum of the last (64, 128) block plus
    the carry; side (R/64,) int32, each block's wrapping sum)."""
    rows = _check_rows128(words, "probe_stream_read", 64)
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty(1, dtype=torch.int32, device=dev)
        side = torch.empty(rows // 64, dtype=torch.int32, device=dev)
        err = lib.csv_probe_stream_read(
            words.data_ptr(), rows, carry_ptr, carry_int, out.data_ptr(),
            side.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_stream_read")
    LAUNCHES["probe_stream_read"] += 1
    return out[0], side


def probe_alu_op_counts() -> tuple:
    """The op counts csrc/probe_alu.cu is built for (read once)."""
    global _alu_op_counts
    if _alu_op_counts is None:
        lib = _library()
        out, i = [], 0
        while (n := lib.csv_probe_alu_op_count(i)) > 0:
            out.append(n)
            i += 1
        _alu_op_counts = tuple(out)
    return _alu_op_counts


def _alu_consts(consts) -> ctypes.Array:
    """The 256 constants as a C int array, made once per set."""
    key = tuple(int(c) for c in consts)
    if key not in _alu_const_arrays:
        _alu_const_arrays[key] = (ctypes.c_int * len(key))(*key)
    return _alu_const_arrays[key]


def probe_alu(words: torch.Tensor, n_ops: int, mix_index: int, consts,
              s) -> torch.Tensor:
    """csrc/probe_alu.cu on CUDA (rows, 128) int32 -> (rows, 128) int32:
    n_ops chained int32 ops of mix `mix_index` (0 alu, 1 shift, 2 mul)
    with the 256 constants `consts`; s is an int or a 0-d int32 tensor on
    the card (its full value, not a bit)."""
    _check_rows128(words, "probe_alu", 1)
    counts = probe_alu_op_counts()
    if n_ops not in counts:
        raise ValueError(f"probe_alu: n_ops must be one of {counts}, got "
                         f"{n_ops}")
    if mix_index not in (0, 1, 2):
        raise ValueError(f"probe_alu: mix index {mix_index} is not 0, 1, 2")
    if len(consts) != 256:
        raise ValueError("probe_alu: expected 256 constants")
    lib = _library()
    dev = words.device
    k = _alu_consts(consts)
    with torch.cuda.device(dev):
        if isinstance(s, torch.Tensor):
            s_t = s.to(device=dev, dtype=torch.int32).reshape(1)
            s_ptr, s_int = s_t.data_ptr(), 0
        else:
            s_ptr, s_int = None, int(s)
        out = torch.empty_like(words)
        err = lib.csv_probe_alu(
            words.data_ptr(), words.numel(), k, mix_index, n_ops, s_ptr,
            s_int, out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_alu")
    LAUNCHES["probe_alu"] += 1
    return out


def probe_ablate(words: torch.Tensor, mode: str, tile: int, carry_in):
    """csrc/probe_ablate.cu on CUDA (rows, 128) int32 -> (out (rows/8,
    128) int32, side (rows/tile,) int32), the stage cut `mode` at `tile`
    rows (a multiple of 8 dividing rows); "v3i8" is "v3". The folds (v3,
    v3_foldonly) at a tile that does not divide 128 rows are the probe's
    pass writing B1's words, then `fold_words` in the probe's bit order."""
    rows = _check_rows128(words, "probe_ablate", 8)
    mode = "v3" if mode == "v3i8" else mode
    if mode not in ABLATE_MODES:
        raise ValueError(f"probe_ablate: mode must be one of {ABLATE_MODES} "
                         f"or 'v3i8', got {mode!r}")
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"probe_ablate: tile {tile} must be a positive "
                         f"multiple of 8 that divides the {rows} rows")
    lib = _library()
    index = ABLATE_MODES.index(mode)
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        relayout = lib.csv_probe_ablate_relayout(index, tile)
        out = torch.empty((rows // 8, 128), dtype=torch.int32, device=dev)
        side = torch.empty(rows // tile, dtype=torch.int32, device=dev)
        scratch = torch.empty(lib.csv_probe_ablate_chunks(rows) + 1,
                              dtype=torch.int32, device=dev)
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        first = torch.empty_like(out) if relayout else out
        err = lib.csv_probe_ablate(
            index, words.data_ptr(), rows, tile, carry_ptr, carry_int,
            first.data_ptr(), side.data_ptr(), scratch.data_ptr(),
            scalars.data_ptr(), _stream(dev))
        _raise_on(err, "probe_ablate")
        if relayout:
            add = (carry_ptr, carry_int) if mode == "v3_foldonly" else (None,
                                                                        0)
            out = _launch_fold_words(first, rows, tile, "probe_ablate",
                                     FOLD_ORDER_BITREV, add)
    LAUNCHES["probe_ablate"] += 1
    return out, side


# cuts of csrc/probe_ablate2.cu and variants of the kbench probe
ABLATE2_CUTS = ("cls22", "cls18", "prep", "mm1", "pack1", "pack2", "px",
                "lane", "v4full")
ABLATE2_SIDE = ("cls22", "cls18", "prep", "mm1")
KBENCH_VARIANTS = ("nopar", "lanescan", "full")


def probe_ablate2(words: torch.Tensor, cut: str, tile: int, carry_in):
    """csrc/probe_ablate2.cu on CUDA (rows, 128) int32 -> (out (rows, 16)
    int32, side int32: one word a 64 KiB chunk for the cuts in
    ABLATE2_SIDE, else empty), B1's pass B cut after stage `cut` ("pack1slice"
    is "pack1") at tile rows (a multiple of 8 dividing rows)."""
    rows = _check_rows128(words, "probe_ablate2", 8)
    cut = "pack1" if cut == "pack1slice" else cut
    if cut not in ABLATE2_CUTS:
        raise ValueError(f"probe_ablate2: cut must be one of {ABLATE2_CUTS} "
                         f"or 'pack1slice', got {cut!r}")
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"probe_ablate2: tile {tile} must be a positive "
                         f"multiple of 8 that divides the {rows} rows")
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        n_chunks = lib.csv_probe_ablate2_chunks(rows)
        out = torch.empty((rows, 16), dtype=torch.int32, device=dev)
        side = torch.empty(n_chunks if cut in ABLATE2_SIDE else 0,
                           dtype=torch.int32, device=dev)
        scratch = torch.empty(2 * n_chunks, dtype=torch.int32, device=dev)
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        err = lib.csv_probe_ablate2(
            ABLATE2_CUTS.index(cut), words.data_ptr(), rows, tile, carry_ptr,
            carry_int, out.data_ptr(), _ptr(side) if side.numel() else None,
            scratch.data_ptr(), scalars.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_ablate2")
    LAUNCHES["probe_ablate2"] += 1
    return out, side


def probe_kbench(b2d: torch.Tensor, variant: str, tile: int, carry_in):
    """The v1-layout variants on CUDA (rows, 128) uint8 -> (v1-layout words
    (rows/32, 128) int32, count 0-d int32: the structural count of the
    last `tile` rows, plus the carry-in for nopar and lanescan). nopar and
    lanescan launch csrc/probe_kbench.cu; full is B6's pair, B1's one pass
    and `v1_words`, with the count limited to the last tile."""
    _check_words(b2d, "probe_kbench", torch.uint8)
    if b2d.dim() != 2 or b2d.shape[1] != 128:
        raise ValueError(f"probe_kbench: expected (rows, 128) uint8, got "
                         f"{tuple(b2d.shape)}")
    rows = b2d.shape[0]
    if variant not in KBENCH_VARIANTS:
        raise ValueError(f"probe_kbench: variant must be one of "
                         f"{KBENCH_VARIANTS}, got {variant!r}")
    if tile <= 0 or tile % 32 or rows == 0 or rows % tile:
        raise ValueError(f"probe_kbench: tile {tile} must be a positive "
                         f"multiple of 32 that divides the {rows} rows")
    if variant == "full":
        out, count, _parity = _v1(b2d, carry_in, DEFAULT_DIALECT,
                                  (rows - tile) // 32 * 128, "probe_kbench")
        LAUNCHES["probe_kbench"] += 1
        return out, count
    lib = _library()
    dev = b2d.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty((rows // 32, 128), dtype=torch.int32, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.csv_probe_kbench(
            KBENCH_VARIANTS.index(variant), b2d.data_ptr(), rows, tile,
            carry_ptr, carry_int, out.data_ptr(), count.data_ptr(),
            _stream(dev))
    _raise_on(err, "probe_kbench")
    LAUNCHES["probe_kbench"] += 1
    return out, count[0]


def probe_vnext(words: torch.Tensor, tile: int, carry_in):
    """The direct fold pack on CUDA (rows, 128) int32 -> (B3's fold-layout
    words (rows/8, 128) int32, parity out 0-d int32) at tile rows (a
    multiple of 8 dividing rows): at a tile that divides 128 rows,
    csrc/probe_vnext.cu's one pass with the fold written from its emit;
    at any other, B3's pair (B1's one pass, then `fold_words`)."""
    rows = _check_rows128(words, "probe_vnext", 8)
    if tile <= 0 or tile % 8 or rows % tile:
        raise ValueError(f"probe_vnext: tile {tile} must be a positive "
                         f"multiple of 8 that divides the {rows} rows")
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        if lib.csv_probe_vnext_direct(tile):
            carry_ptr, carry_int, _keep = _carry(carry_in, dev)
            out = torch.empty((rows // 8, 128), dtype=torch.int32,
                              device=dev)
            scratch = torch.empty(lib.csv_probe_vnext_chunks(rows) + 1,
                                  dtype=torch.int32, device=dev)
            _raise_on(lib.csv_probe_vnext(
                words.data_ptr(), rows, tile, carry_ptr, carry_int,
                out.data_ptr(), scratch.data_ptr(), scalars.data_ptr(),
                _stream(dev)), "probe_vnext")
        else:
            seq = _one_pass(words, carry_in, DEFAULT_DIALECT, "probe_vnext",
                            scalars)
            out = _launch_fold_words(seq, rows, tile, "probe_vnext")
    LAUNCHES["probe_vnext"] += 1
    return out, scalars[0]


def check_wide(x: torch.Tensor, what: str) -> int:
    """Raise unless x is (M, 1024) int32 with M > 0, on any device (the
    wide-store probes' (rows/8, 1024) view); returns M."""
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != 1024:
        raise ValueError(f"{what}: expected (M, 1024) int32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.shape[0] == 0:
        raise ValueError(f"{what}: expected at least one row")
    return x.shape[0]


def check_pack_weights(w: torch.Tensor, x: torch.Tensor, what: str) -> None:
    """Raise unless w is (1024, 128) int8 on x's device."""
    if w.dtype != torch.int8 or tuple(w.shape) != (1024, 128):
        raise ValueError(f"{what}: expected (1024, 128) int8 weights, got "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: weights on {w.device}, input on "
                         f"{x.device}")


def probe_ws_gather(words: torch.Tensor) -> torch.Tensor:
    """csrc/probe_widestore.cu's gather on CUDA (rows, 128) int32, rows %
    8 == 0 -> (rows/8, 128) int32, out[r, 16s + j] = words[8r + s, j] for
    s < 8, j < 16."""
    rows = _check_rows128(words, "probe_ws_gather", 8)
    lib = _library()
    dev = words.device
    with torch.cuda.device(dev):
        out = torch.empty((rows // 8, 128), dtype=torch.int32, device=dev)
        err = lib.csv_probe_ws_gather(
            words.data_ptr(), rows, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_ws_gather")
    LAUNCHES["probe_ws_gather"] += 1
    return out


def probe_ws_lanesum(x: torch.Tensor) -> torch.Tensor:
    """csrc/probe_widestore.cu's lane sum on CUDA (M, 1024) int32 -> (M,
    128) int32, the wrapping sum of the 8 lane windows."""
    _check_words(x, "probe_ws_lanesum")
    m = check_wide(x, "probe_ws_lanesum")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = lib.csv_probe_ws_lanesum(
            x.data_ptr(), m, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_ws_lanesum")
    LAUNCHES["probe_ws_lanesum"] += 1
    return out


def probe_ws_packmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/probe_concatmm.cu's pack product on CUDA (M, 1024) int32 and
    (1024, 128) int8 -> (M, 128) int32: the OR over k < 8 of
    int8(x[:, 128k:128k+128]) @ w[128k:128k+128], in int32, on the int8
    tensor cores (mma.sync)."""
    _check_words(x, "probe_ws_packmm")
    m = check_wide(x, "probe_ws_packmm")
    _check_words(w, "probe_ws_packmm weights", torch.int8)
    check_pack_weights(w, x, "probe_ws_packmm")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = lib.csv_probe_ws_packmm(
            x.data_ptr(), m, w.data_ptr(), out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_ws_packmm")
    LAUNCHES["probe_ws_packmm"] += 1
    return out


def check_rows(t: torch.Tensor, dtype: torch.dtype, what: str) -> int:
    """Raise unless t is (rows, 128) of dtype with rows > 0, on any device
    (the Mosaic probes' arrays); returns rows."""
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != 128:
        raise ValueError(f"{what}: expected (rows, 128) {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.shape[0] == 0:
        raise ValueError(f"{what}: expected at least one row")
    return t.shape[0]


def _mosaic(name: str, counter: str, inputs: tuple, out_shape,
            out_dtype: torch.dtype, with_sms: bool = False) -> torch.Tensor:
    """One launch of csrc/probe_mosaic.cu's csv_probe_mosaic_<name> on
    inputs ((tensor, dtype), ...) of one row count -> a new tensor of
    out_shape(rows); with_sms passes the card's SM count."""
    rows = None
    for t, dtype in inputs:
        _check_words(t, counter, dtype)
        r = check_rows(t, dtype, counter)
        if rows is not None and r != rows:
            raise ValueError(f"{counter}: inputs of {rows} and {r} rows")
        rows = r
    dev = inputs[0][0].device
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty(out_shape(rows), dtype=out_dtype, device=dev)
        extra = ((torch.cuda.get_device_properties(dev).multi_processor_count,)
                 if with_sms else ())
        err = getattr(lib, f"csv_probe_mosaic_{name}")(
            *(t.data_ptr() for t, _ in inputs), rows, out.data_ptr(), *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    return out


def probe_mosaic_mm32(v: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's mm32_pack on CUDA (rows, 128) int32 ->
    (rows, 16) int32, word g = lo | (hi << 16), lo and hi the wrapping
    sums of v[:, 8g + l] << 4l and v[:, 8g + 4 + l] << 4l over l < 4."""
    return _mosaic("mm32", "probe_mosaic_mm32", ((v, torch.int32),),
                   lambda r: (r, 16), torch.int32)


def probe_mosaic_gather(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's lane_gather on CUDA (rows, 128) int8 lut and
    int32 idx -> (rows, 128) int8, out[r, j] = lut[r, idx[r, j] & 127]."""
    return _mosaic("gather", "probe_mosaic_gather",
                   ((lut, torch.int8), (idx, torch.int32)),
                   lambda r: (r, 128), torch.int8)


def probe_mosaic_cmp8(a: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's cmp8 on CUDA (rows, 128) uint8 -> (rows, 128)
    int32, a == 0x2C."""
    return _mosaic("cmp8", "probe_mosaic_cmp8", ((a, torch.uint8),),
                   lambda r: (r, 128), torch.int32)


def probe_mosaic_select8(a: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's select8 on CUDA (rows, 128) uint8 -> (rows,
    128) uint8, where(a > 127, a, 7)."""
    return _mosaic("select8", "probe_mosaic_select8", ((a, torch.uint8),),
                   lambda r: (r, 128), torch.uint8)


def probe_mosaic_shift_add(x: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's shift_add on CUDA (rows, 128) int32 -> (rows,
    128) int32, x[r] + x[r - 1] with row -1 = 0, wrapping."""
    return _mosaic("shift_add", "probe_mosaic_shift_add", ((x, torch.int32),),
                   lambda r: (r, 128), torch.int32)


def probe_mosaic_usum(a: torch.Tensor) -> torch.Tensor:
    """csrc/probe_mosaic.cu's usum on CUDA (rows, 128) int32 of uint32 bit
    patterns -> (1, 1) int32, the bits of their uint32 sum mod 2^32."""
    return _mosaic("usum", "probe_mosaic_usum", ((a, torch.int32),),
                   lambda r: (1, 1), torch.int32, with_sms=True)


def probe_concat_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/probe_concatmm.cu on CUDA (M, 1024) int32 and (1024, 128) int8
    -> (M, 128) int32: int8(x + (col >> 7)) @ w, summed over all 1024
    columns in int32, on the int8 tensor cores (mma.sync)."""
    _check_words(x, "probe_concat_mm")
    m = check_wide(x, "probe_concat_mm")
    _check_words(w, "probe_concat_mm weights", torch.int8)
    check_pack_weights(w, x, "probe_concat_mm")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = lib.csv_probe_concat_mm(
            x.data_ptr(), m, w.data_ptr(), out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "probe_concat_mm")
    LAUNCHES["probe_concat_mm"] += 1
    return out
