"""Bind the measurement probes' CUDA kernels: the lab library.

Every `tools/csrc/*.cu` is built at first use into its own shared library
(`_build/libcsv_simd_lab-<hash>.so`, through `_compiled`, as the
product's kernels are), which includes `csrc/stage1_core.cuh` from the
product's sources, so its hash covers that header too. Only the tools,
`chip_smoke.py` and the card tests import this module: building or
serving a tape never does, and never compiles a probe.

The wrappers follow `_kernels`' rules (current stream, outputs from
`torch.empty`, checks before a pointer is passed, a raise on a launch
error) and count their launches in this module's own LAUNCHES. Some cuts
run the product's B1 one pass and relayouts through `_kernels`; those
launches count here, under the probe's name, and nowhere else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _compiled, _kernels
from .._kernels import (
    FOLD_ORDER_BITREV,
    _carry,
    _check_words,
    _launch_fold_words,
    _one_pass,
    _ptr,
    _raise_on,
    _stream,
    _v1,
    i32,
    ll,
    vp,
)
from ..config import DEFAULT_DIALECT

LAB_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIB = _compiled.Library("libcsv_simd_lab", LAB_CSRC, "*.cu", "nvcc",
                        _kernels.NVCC_FLAGS, include_dirs=(_kernels.CSRC,),
                        verbose_flags=_kernels.NVCC_VERBOSE)

# launches per probe wrapper
LAUNCHES = {"probe_stream_write": 0, "probe_stream_read": 0, "probe_alu": 0,
            "probe_ablate": 0, "probe_ablate2": 0, "probe_kbench": 0,
            "probe_vnext": 0, "probe_ws_gather": 0, "probe_ws_lanesum": 0,
            "probe_ws_packmm": 0, "probe_mosaic_mm32": 0,
            "probe_mosaic_gather": 0, "probe_mosaic_cmp8": 0,
            "probe_mosaic_select8": 0, "probe_mosaic_shift_add": 0,
            "probe_mosaic_usum": 0, "probe_concat_mm": 0}
_alu_op_counts = None
_alu_const_arrays = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def library_path() -> pathlib.Path:
    return LIB.path()


def build(verbose: bool = False) -> dict:
    """Compile the probes unless this source set is already built; as
    `_kernels.build`."""
    return LIB.build(verbose)


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


_c_probe_stream_write = LIB.fn("csv_probe_stream_write",
                               [i32, vp, ll, vp, i32, vp, vp, vp])


def probe_stream_write(words: torch.Tensor, mode: str, carry_in):
    """csrc/probe_stream.cu's write kernel on CUDA (rows, 128) int32, rows
    % 512 == 0 -> (out (rows, 16) int32 for narrow/tall2/tall8, (rows/8,
    128) for wide; side (rows/512,) int32, the XOR of each 512-row
    block)."""
    rows = _check_rows128(words, "probe_stream_write", 512)
    if mode not in STREAM_WRITE_MODES:
        raise ValueError(f"probe_stream_write: mode must be one of "
                         f"{STREAM_WRITE_MODES}, got {mode!r}")
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        shape = (rows // 8, 128) if mode == "wide" else (rows, 16)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        side = torch.empty(rows // 512, dtype=torch.int32, device=dev)
        err = _c_probe_stream_write(
            STREAM_WRITE_MODES.index(mode), words.data_ptr(), rows,
            carry_ptr, carry_int, out.data_ptr(), side.data_ptr(),
            _stream(dev))
    _raise_on(err, "probe_stream_write")
    LAUNCHES["probe_stream_write"] += 1
    return out, side


_c_probe_stream_read = LIB.fn("csv_probe_stream_read",
                              [vp, ll, vp, i32, vp, vp, vp])


def probe_stream_read(words: torch.Tensor, carry_in):
    """csrc/probe_stream.cu's read kernel on CUDA (R, 128) int32, R % 64
    == 0 -> (0-d int32: the wrapping sum of the last (64, 128) block plus
    the carry; side (R/64,) int32, each block's wrapping sum)."""
    rows = _check_rows128(words, "probe_stream_read", 64)
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty(1, dtype=torch.int32, device=dev)
        side = torch.empty(rows // 64, dtype=torch.int32, device=dev)
        err = _c_probe_stream_read(
            words.data_ptr(), rows, carry_ptr, carry_int, out.data_ptr(),
            side.data_ptr(), _stream(dev))
    _raise_on(err, "probe_stream_read")
    LAUNCHES["probe_stream_read"] += 1
    return out[0], side


_c_probe_alu_op_count = LIB.fn("csv_probe_alu_op_count", [i32])


def probe_alu_op_counts() -> tuple:
    """The op counts csrc/probe_alu.cu is built for (read once)."""
    global _alu_op_counts
    if _alu_op_counts is None:
        out, i = [], 0
        while (n := _c_probe_alu_op_count(i)) > 0:
            out.append(n)
            i += 1
        _alu_op_counts = tuple(out)
    return _alu_op_counts


def _alu_consts(consts) -> ctypes.Array:
    """The 256 constants as a C int array, made once per set."""
    key = tuple(int(c) for c in consts)
    if key not in _alu_const_arrays:
        _alu_const_arrays[key] = (i32 * len(key))(*key)
    return _alu_const_arrays[key]


_c_probe_alu = LIB.fn("csv_probe_alu", [vp, ll, ctypes.POINTER(i32), i32,
                                       i32, vp, i32, vp, i32, vp])


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
    dev = words.device
    k = _alu_consts(consts)
    with torch.cuda.device(dev):
        if isinstance(s, torch.Tensor):
            s_t = s.to(device=dev, dtype=torch.int32).reshape(1)
            s_ptr, s_int = s_t.data_ptr(), 0
        else:
            s_ptr, s_int = None, int(s)
        out = torch.empty_like(words)
        err = _c_probe_alu(
            words.data_ptr(), words.numel(), k, mix_index, n_ops, s_ptr,
            s_int, out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(dev))
    _raise_on(err, "probe_alu")
    LAUNCHES["probe_alu"] += 1
    return out


_c_probe_ablate_chunks = LIB.fn("csv_probe_ablate_chunks", [ll], ll)
_c_probe_ablate_relayout = LIB.fn("csv_probe_ablate_relayout", [i32, i32])
_c_probe_ablate = LIB.fn("csv_probe_ablate", [i32, vp, ll, i32, vp, i32, vp,
                                             vp, vp, vp, vp])


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
    index = ABLATE_MODES.index(mode)
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        relayout = _c_probe_ablate_relayout(index, tile)
        out = torch.empty((rows // 8, 128), dtype=torch.int32, device=dev)
        side = torch.empty(rows // tile, dtype=torch.int32, device=dev)
        scratch = torch.empty(_c_probe_ablate_chunks(rows) + 1,
                              dtype=torch.int32, device=dev)
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        first = torch.empty_like(out) if relayout else out
        err = _c_probe_ablate(
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


_c_probe_ablate2_chunks = LIB.fn("csv_probe_ablate2_chunks", [ll], ll)
_c_probe_ablate2 = LIB.fn("csv_probe_ablate2", [i32, vp, ll, i32, vp, i32,
                                               vp, vp, vp, vp, vp])


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
    dev = words.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        n_chunks = _c_probe_ablate2_chunks(rows)
        out = torch.empty((rows, 16), dtype=torch.int32, device=dev)
        side = torch.empty(n_chunks if cut in ABLATE2_SIDE else 0,
                           dtype=torch.int32, device=dev)
        scratch = torch.empty(2 * n_chunks, dtype=torch.int32, device=dev)
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        err = _c_probe_ablate2(
            ABLATE2_CUTS.index(cut), words.data_ptr(), rows, tile, carry_ptr,
            carry_int, out.data_ptr(), _ptr(side) if side.numel() else None,
            scratch.data_ptr(), scalars.data_ptr(), _stream(dev))
    _raise_on(err, "probe_ablate2")
    LAUNCHES["probe_ablate2"] += 1
    return out, side


_c_probe_kbench = LIB.fn("csv_probe_kbench", [i32, vp, ll, i32, vp, i32, vp,
                                             vp, vp])


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
    dev = b2d.device
    with torch.cuda.device(dev):
        carry_ptr, carry_int, _keep = _carry(carry_in, dev)
        out = torch.empty((rows // 32, 128), dtype=torch.int32, device=dev)
        count = torch.empty(1, dtype=torch.int32, device=dev)
        err = _c_probe_kbench(
            KBENCH_VARIANTS.index(variant), b2d.data_ptr(), rows, tile,
            carry_ptr, carry_int, out.data_ptr(), count.data_ptr(),
            _stream(dev))
    _raise_on(err, "probe_kbench")
    LAUNCHES["probe_kbench"] += 1
    return out, count[0]


_c_probe_vnext_direct = LIB.fn("csv_probe_vnext_direct", [i32])
_c_probe_vnext_chunks = LIB.fn("csv_probe_vnext_chunks", [ll], ll)
_c_probe_vnext = LIB.fn("csv_probe_vnext", [vp, ll, i32, vp, i32, vp, vp, vp,
                                           vp])


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
    dev = words.device
    with torch.cuda.device(dev):
        scalars = torch.empty(2, dtype=torch.int32, device=dev)
        if _c_probe_vnext_direct(tile):
            carry_ptr, carry_int, _keep = _carry(carry_in, dev)
            out = torch.empty((rows // 8, 128), dtype=torch.int32,
                              device=dev)
            scratch = torch.empty(_c_probe_vnext_chunks(rows) + 1,
                                  dtype=torch.int32, device=dev)
            _raise_on(_c_probe_vnext(
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


_c_probe_ws_gather = LIB.fn("csv_probe_ws_gather", [vp, ll, vp, vp])


def probe_ws_gather(words: torch.Tensor) -> torch.Tensor:
    """csrc/probe_widestore.cu's gather on CUDA (rows, 128) int32, rows %
    8 == 0 -> (rows/8, 128) int32, out[r, 16s + j] = words[8r + s, j] for
    s < 8, j < 16."""
    rows = _check_rows128(words, "probe_ws_gather", 8)
    dev = words.device
    with torch.cuda.device(dev):
        out = torch.empty((rows // 8, 128), dtype=torch.int32, device=dev)
        err = _c_probe_ws_gather(words.data_ptr(), rows, out.data_ptr(),
                                 _stream(dev))
    _raise_on(err, "probe_ws_gather")
    LAUNCHES["probe_ws_gather"] += 1
    return out


_c_probe_ws_lanesum = LIB.fn("csv_probe_ws_lanesum", [vp, ll, vp, vp])


def probe_ws_lanesum(x: torch.Tensor) -> torch.Tensor:
    """csrc/probe_widestore.cu's lane sum on CUDA (M, 1024) int32 -> (M,
    128) int32, the wrapping sum of the 8 lane windows."""
    _check_words(x, "probe_ws_lanesum")
    m = check_wide(x, "probe_ws_lanesum")
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = _c_probe_ws_lanesum(x.data_ptr(), m, out.data_ptr(),
                                  _stream(dev))
    _raise_on(err, "probe_ws_lanesum")
    LAUNCHES["probe_ws_lanesum"] += 1
    return out


_c_probe_ws_packmm = LIB.fn("csv_probe_ws_packmm",
                            [vp, ll, vp, vp, i32, vp])


def probe_ws_packmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/probe_concatmm.cu's pack product on CUDA (M, 1024) int32 and
    (1024, 128) int8 -> (M, 128) int32: the OR over k < 8 of
    int8(x[:, 128k:128k+128]) @ w[128k:128k+128], in int32, on the int8
    tensor cores (mma.sync)."""
    _check_words(x, "probe_ws_packmm")
    m = check_wide(x, "probe_ws_packmm")
    _check_words(w, "probe_ws_packmm weights", torch.int8)
    check_pack_weights(w, x, "probe_ws_packmm")
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = _c_probe_ws_packmm(
            x.data_ptr(), m, w.data_ptr(), out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(dev))
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


_c_probe_mosaic = {
    **{name: LIB.fn(f"csv_probe_mosaic_{name}", [vp, ll, vp, vp])
       for name in ("mm32", "cmp8", "select8", "shift_add")},
    "gather": LIB.fn("csv_probe_mosaic_gather", [vp, vp, ll, vp, vp]),
    "usum": LIB.fn("csv_probe_mosaic_usum", [vp, ll, vp, i32, vp])}


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
    with torch.cuda.device(dev):
        out = torch.empty(out_shape(rows), dtype=out_dtype, device=dev)
        extra = ((torch.cuda.get_device_properties(dev).multi_processor_count,)
                 if with_sms else ())
        err = _c_probe_mosaic[name](
            *(t.data_ptr() for t, _ in inputs), rows, out.data_ptr(), *extra,
            _stream(dev))
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


_c_probe_concat_mm = LIB.fn("csv_probe_concat_mm",
                            [vp, ll, vp, vp, i32, vp])


def probe_concat_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/probe_concatmm.cu on CUDA (M, 1024) int32 and (1024, 128) int8
    -> (M, 128) int32: int8(x + (col >> 7)) @ w, summed over all 1024
    columns in int32, on the int8 tensor cores (mma.sync)."""
    _check_words(x, "probe_concat_mm")
    m = check_wide(x, "probe_concat_mm")
    _check_words(w, "probe_concat_mm weights", torch.int8)
    check_pack_weights(w, x, "probe_concat_mm")
    dev = x.device
    with torch.cuda.device(dev):
        out = torch.empty((m, 128), dtype=torch.int32, device=dev)
        err = _c_probe_concat_mm(
            x.data_ptr(), m, w.data_ptr(), out.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _stream(dev))
    _raise_on(err, "probe_concat_mm")
    LAUNCHES["probe_concat_mm"] += 1
    return out
