"""Offsets-free serving: the packed bitmask IS the index
(csv_simd_tpu/offsetfree.py).

The index is the sequential packed structural bitmask (1 bit per input
byte, kernel B1) plus the inclusive popcount prefix over its 512-byte
rows (kernel B2). A tape slot lookup (the k-th structural byte) is a
searchsorted on the row prefix, a popcount scan of the hit row's 16
words, and a rank-select inside the hit word; serving then gathers the
bytes between two slots. Slot arithmetic is the reference's: slot =
(r+1)*jump + f, value = bytes[pos(slot-1)+1 : pos(slot)].
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .artifact import _fingerprint
from .config import DEFAULT_DIALECT, Dialect
from .device import resolve_device
from .device_tape import TypedColumnsMixin, as_int32
from .errors import InvalidCsvFormat
from .ops.stage1_v2 import ROW_BYTES, padded_rows
from .ops.stage1_v4 import stage1_fused_v4
from .ops.swar import popcount32, shift_right_logical
from .tape import Header, NewLine
from .utils import as_u8
from .utils.metrics import GLOBAL

_TWO_GIB_MSG = (
    "PackedDeviceTape uses int32 flat byte positions: inputs of 2 GiB or "
    "more need parallel.serving.ShardedPackedTape"
)


def prefix_for_packed(packed: torch.Tensor) -> torch.Tensor:
    """Inclusive row-granularity popcount prefix over the packed words,
    (rows, 16) narrow or (rows/8, 128) wide (the same word order):
    (rows,) int32, out[r] = set bits in rows 0..r. Kernel B2 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if packed.dim() != 2 or packed.shape[1] not in (16, 128):
        raise ValueError(f"expected (rows, 16) or (rows/8, 128) words, got "
                         f"{tuple(packed.shape)}")
    if packed.device.type == "cuda":
        from . import _kernels

        return _kernels.row_prefix(packed)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    return _prefix_for_packed_xla(packed)


def _prefix_for_packed_xla(packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B2 (the JAX package's XLA twin),
    on any device."""
    row_counts = popcount32(packed.reshape(-1, 16)).sum(
        dim=1, dtype=torch.int32)
    return torch.cumsum(row_counts, dim=0, dtype=torch.int32)


def _select_bit(w: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Position (0..31) of the j-th (0-indexed) set bit of each int32
    word: a 5-step binary search over half popcounts."""
    pos = torch.zeros_like(j)
    cur = w
    jj = j
    for width in (16, 8, 4, 2, 1):
        low = cur & ((1 << width) - 1)
        c = popcount32(low)
        go_high = jj >= c
        jj = jj - torch.where(go_high, c, 0)
        pos = pos + go_high.to(torch.int32) * width
        cur = torch.where(go_high, shift_right_logical(cur, width), low)
    return pos


def _kth_positions(words2d: torch.Tensor, row_cum_incl: torch.Tensor,
                   ks: torch.Tensor) -> torch.Tensor:
    """Flat byte positions of the k-th set bits (0 <= k < total bits).

    A searchsorted on the row prefix finds the row; that row's 16 words
    are gathered by flat index (narrow and wide layouts alike) and
    scanned per query. Positions for k outside the index are unspecified,
    as in the JAX package, whose out-of-range gathers clamp."""
    rows = row_cum_incl.shape[0]
    row, j = _row_and_rank(row_cum_incl, ks)
    cols = torch.arange(16, dtype=torch.int32, device=ks.device)
    flat = words2d.reshape(-1)
    wrow = flat[row.clamp(max=rows - 1)[:, None] * 16 + cols]  # (Q, 16)
    return row * 512 + _bit_in_row(wrow, j)


def _row_and_rank(row_cum_incl: torch.Tensor, ks: torch.Tensor) -> tuple:
    """(row holding the k-th set bit, k's rank within that row), int32:
    a searchsorted on the inclusive row prefix."""
    row = torch.searchsorted(row_cum_incl, ks, right=True, out_int32=True)
    excl_row = torch.where(row > 0, row_cum_incl[(row - 1).clamp(min=0)], 0)
    return row, ks - excl_row


def _bit_in_row(wrow: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Position (0..511) of the j-th set bit of each query's row, given
    the row's 16 words (Q, 16): a popcount scan of the words, then a
    rank-select inside the hit word."""
    cum = torch.cumsum(popcount32(wrow), dim=1, dtype=torch.int32)
    g = (cum <= j[:, None]).sum(dim=1, dtype=torch.int32)
    prev = torch.gather(cum, 1, (g - 1).clamp(min=0).long()[:, None])[:, 0]
    jj = j - torch.where(g > 0, prev, 0)
    w = torch.gather(wrow, 1, g.clamp(max=15).long()[:, None])[:, 0]
    return g * 32 + _select_bit(w, jj)


def _serve(data, words2d, cum_incl, records, fields, jump: int,
           field_cnt: int, record_cnt: int, max_len: int):
    GLOBAL.count("offsetfree.lookups", records.shape[0])
    with GLOBAL.span("offsetfree.serve"):
        valid = ((records >= 0) & (records + 1 < record_cnt)
                 & (fields >= 0) & (fields < field_cnt))
        r = torch.where(valid, records, 0)
        f = torch.where(valid, fields, 0)
        slots = (r + 1) * jump + f  # >= 1 for all valid queries
        ks = torch.cat([slots - 1, slots])  # start bit, end bit
        with GLOBAL.span("offsetfree.rank_select"):
            pos = _kth_positions(words2d, cum_incl, ks)
        n = slots.shape[0]
        starts = pos[:n] + 1
        ends = pos[n:]
        lengths = torch.where(valid, ends - starts, 0)
        grid = starts[:, None] + torch.arange(max_len, dtype=torch.int32,
                                              device=data.device)[None, :]
        in_range = grid < ends[:, None]
        grid = grid.clamp(0, data.shape[0] - 1)
        out = torch.where(in_range & valid[:, None], data[grid], 0)
        return out, lengths, valid


def packed_seq_meta(header, n_bytes: int, fingerprint: str) -> dict:
    """The packed_seq artifact meta dict, field for field the JAX
    package's, so either package loads what the other saved."""
    return dict(
        magic="csv-simd-tpu-index", version=1, encoding="packed_seq",
        names=header.names, new_line=header.new_line.value,
        field_cnt=header.field_cnt, delimiter=header.delimiter,
        record_offset=header.record_offset, n_bytes=n_bytes,
        fingerprint=fingerprint,
    )


def _own_header(header) -> Header:
    """A Header-like object (for example the JAX package's) as the
    port's own Header."""
    return Header(
        names=list(header.names), new_line=NewLine(header.new_line.value),
        field_cnt=header.field_cnt, delimiter=header.delimiter,
        record_offset=header.record_offset,
    )


def _to_device(arr: np.ndarray, n_bytes: int,
               device: torch.device) -> torch.Tensor:
    """`arr` zero-padded to n_bytes, as one uint8 tensor on `device`.
    The host buffer is written once; for a card it is pinned and copied
    without blocking (the caching host allocator keeps it alive until
    the copy is done)."""
    with GLOBAL.span("offsetfree.pad", n_bytes):
        pin = device.type == "cuda"
        with GLOBAL.span("offsetfree.pin_alloc"):
            host = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=pin)
        h = host.numpy()
        h[: arr.size] = arr
        h[arr.size:] = 0
        return host.to(device, non_blocking=True) if pin else host


class PackedDeviceTape(TypedColumnsMixin):
    """Device tape whose index is the sequential packed bitmask plus the
    row popcount prefix: built at scan speed, with no compaction pass.
    The typed serving surface comes from TypedColumnsMixin on top of
    `gather_fields`."""

    def __init__(self, data: bytes | np.ndarray,
                 dialect: Dialect = DEFAULT_DIALECT,
                 validate_utf8: bool = False, device="cuda"):
        arr = as_u8(data)
        if arr.size >= 2**31:
            raise ValueError(_TWO_GIB_MSG)
        self.device = resolve_device(device)
        self.n_bytes = arr.size
        self.header = Header.parse(arr, delimiter=dialect.delimiter,
                                   quote_aware=dialect.header_quotes,
                                   quote=dialect.quote)
        padded = _to_device(arr, padded_rows(arr.size) * ROW_BYTES,
                            self.device)
        # the wide (rows/8, 128) layout end to end; it is the narrow
        # layout's buffer, so the saved artifact is a host reshape
        packed, _par, na = stage1_fused_v4(
            padded.view(torch.int32).view(-1, 8 * 128), 0, dialect,
            count_nonascii=validate_utf8, out_mode="wide_native")
        self.nonascii_count = na if validate_utf8 else None
        self.words = packed
        self.cum_incl = prefix_for_packed(packed)
        self.data = padded[: arr.size]
        # only input in which the build counted a byte >= 0x80 pays for the
        # validator, which reads the bytes already on the device
        if validate_utf8 and int(na):
            from .ops.utf8 import validate_utf8_device

            if not validate_utf8_device(self.data):
                raise InvalidCsvFormat("input is not valid UTF-8")
        self._set_stride()

    def _set_stride(self) -> None:
        """Record geometry from the structural count, which must be a
        whole number of record strides (the reference's uniform-stride
        invariant)."""
        count = int(self.cum_incl[-1])
        self.field_cnt = self.header.field_cnt
        self.jump = self.field_cnt + (
            1 if self.header.new_line is NewLine.CRLF else 0)
        self.record_cnt, rem = divmod(count, self.jump)
        if rem != 0:
            raise InvalidCsvFormat(
                f"non-uniform record stride: {count} structural entries "
                f"not divisible by jump {self.jump}"
            )
        self.num_data_records = max(self.record_cnt - 1, 0)

    def gather_fields(self, records, fields, max_len: int = 64):
        """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE
        lengths (N,) int32, valid (N,) bool), all on the tape's device."""
        return _serve(
            self.data, self.words, self.cum_incl,
            as_int32(records, self.device), as_int32(fields, self.device),
            self.jump, self.field_cnt, self.record_cnt, max_len,
        )

    # -- persistence: the packed words ARE the artifact (1 bit/byte); the
    #    prefix is recomputed on load --

    def save(self, path) -> None:
        """Write the narrow (rows, 16) packed_seq npz with the JAX
        package's meta and fingerprint."""
        meta = packed_seq_meta(self.header, self.n_bytes,
                               _fingerprint(self.data.cpu().numpy()))
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            packed=self.words.cpu().numpy().reshape(-1, 16),
        )

    @classmethod
    def load(cls, path, data: bytes | np.ndarray,
             dialect: Dialect = DEFAULT_DIALECT,
             device="cuda") -> "PackedDeviceTape":
        """Rebuild a serving tape from a saved artifact and the original
        bytes: no re-scan, only the row prefix is recomputed."""
        try:
            z = np.load(path, allow_pickle=False)
        except OSError:
            # np.savez_compressed appends '.npz' to suffix-less paths
            p = os.fspath(path)
            if not p.endswith(".npz") and os.path.exists(p + ".npz"):
                z = np.load(p + ".npz", allow_pickle=False)
            else:
                raise
        with z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("encoding") != "packed_seq":
                raise InvalidCsvFormat(
                    f"not a packed_seq artifact: {meta.get('encoding')}")
            arr = as_u8(data)
            if meta["n_bytes"] != arr.size:
                raise InvalidCsvFormat("artifact does not match these bytes")
            if meta.get("fingerprint") != _fingerprint(arr):
                raise InvalidCsvFormat(
                    "index artifact does not match these bytes (fingerprint)")
            header = Header(
                names=list(meta["names"]), new_line=NewLine(meta["new_line"]),
                field_cnt=meta["field_cnt"], delimiter=meta["delimiter"],
                record_offset=meta["record_offset"],
            )
            words = np.asarray(z["packed"])
        return cls._from_parts(words, header, arr, device)

    @classmethod
    def from_numpy_state(cls, words: np.ndarray, header, data,
                         device="cuda") -> "PackedDeviceTape":
        """Build a tape from another tape's state as numpy (for example
        the JAX PackedDeviceTape's words, header and bytes): packed words
        in either layout, a Header-like object and the original bytes."""
        return cls._from_parts(np.asarray(words), _own_header(header),
                               as_u8(data), device)

    @classmethod
    def _from_parts(cls, words: np.ndarray, header: Header, arr: np.ndarray,
                    device) -> "PackedDeviceTape":
        if arr.size >= 2**31:
            raise ValueError(_TWO_GIB_MSG)
        # a copy: the caller's array may be read-only (a JAX export)
        w = np.array(words, dtype=np.int32, order="C").reshape(-1, 16)
        if w.shape[0] * ROW_BYTES < arr.size:
            raise InvalidCsvFormat(
                f"{w.shape[0]} packed rows cover fewer than {arr.size} bytes")
        if w.shape[0] % 8 == 0:
            w = w.reshape(-1, 128)  # serve wide
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.n_bytes = arr.size
        self.header = header
        self.words = torch.from_numpy(w).to(self.device)
        self.cum_incl = prefix_for_packed(self.words)
        self.data = _to_device(arr, arr.size, self.device)
        self.nonascii_count = None  # not recorded in the artifact
        self._set_stride()
        return self
