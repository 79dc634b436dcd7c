"""Device-resident tapes and their typed columns
(csv_simd_tpu/device_tape.py): `DeviceTape`, which serves batched
(record, field) gathers from the bytes and an int32 offsets index on the
device, and the typed-column surface that it and the offsets-free tape
share.

Serving is slot arithmetic and gathers, as torch ops:

  slot  = (record + 1) * jump + field
  start = index[slot] + 1; end = index[slot + 1]
  out[i, j] = bytes[start_i + j] masked to j < end_i - start_i

Everything typed derives from one primitive the concrete tape provides:
`gather_fields(records, fields, max_len)` -> (bytes (N, max_len) uint8,
TRUE lengths (N,) int32, valid (N,) bool) tensors on the tape's device.
The JAX package's `lax.scan` digit loops are Python loops over the
`max_len` axis here; each step is the same elementwise float32 or int32
arithmetic, in the same order, so results are bit-identical. One step
needs care: XLA compiles the float parse's `v * 10.0 + d` into a fused
multiply-add, rounded once, so `_fma10` computes exactly that (plain
torch float32 rounds twice and differs in the last bit for long fields).

The other typed columns (decimal, exponent floats, dates, datetimes,
decode, filter) are not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .utils import as_u8

_INT32_MIN = -(2**31)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def as_int32(x, device: torch.device) -> torch.Tensor:
    """Query ids (list, numpy array or tensor) -> int32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x).astype(np.int32))).to(device)


def _fma10(v: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """float32 v * 10 + d with one rounding, as a fused multiply-add.

    v * 10 is exact in float64 (24-bit by 4-bit significands). The sum
    with d is rounded to odd in float64 (TwoSum gives the exact error; an
    inexact sum with an even last bit steps one unit toward it), and
    rounding that to float32 is then the correctly rounded result, since
    53 >= 24 + 2 bits."""
    p = v.double() * 10.0
    dd = d.double()
    s = p + dd
    bp = s - p
    err = (p - (s - bp)) + (dd - bp)  # s + err == p + dd exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _take_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for 2-D int32 x, INT32_MIN where idx[i] is past the
    end: jnp.take_along_axis's default fill for out-of-range indices."""
    width = x.shape[1]
    got = torch.gather(x, 1, idx.clamp(0, width - 1).long()[:, None])[:, 0]
    return torch.where(idx < width, got, _INT32_MIN)


def _gather_fields(data: torch.Tensor, index: torch.Tensor,
                   records: torch.Tensor, fields: torch.Tensor, jump: int,
                   field_cnt: int, record_cnt: int, max_len: int):
    """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE lengths
    (N,) int32, valid (N,) bool) from the bytes and an int32 index on one
    device. Index reads clamp to the last entry, as the JAX gathers do,
    so an invalid query reads something harmless and is masked out."""
    valid = ((records >= 0) & (records + 1 < record_cnt)
             & (fields >= 0) & (fields < field_cnt))
    r = torch.where(valid, records, 0)
    f = torch.where(valid, fields, 0)
    slots = (r + 1) * jump + f
    last = index.shape[0] - 1
    starts = index[slots.clamp(max=last)] + 1
    ends = index[(slots + 1).clamp(max=last)]
    lengths = torch.where(valid, ends - starts, 0)
    pos = starts[:, None] + torch.arange(max_len, dtype=torch.int32,
                                         device=data.device)[None, :]
    in_range = pos < ends[:, None]
    pos = pos.clamp(0, data.shape[0] - 1)
    out = torch.where(in_range & valid[:, None], data[pos], 0)
    return out, lengths, valid


class TypedColumnsMixin:
    """Batched serving surface on top of `gather_fields`."""

    def _num_data(self) -> int:
        n = getattr(self, "num_data_records", None)
        if n is not None:
            return int(n)
        return max(int(self.record_cnt) - 1, 0)

    def gather_column(self, field: int, max_len: int = 64):
        """One whole column in a single device gather."""
        n = self._num_data()
        return self.gather_fields(
            torch.arange(n, dtype=torch.int32, device=self.device),
            torch.full((n,), field, dtype=torch.int32, device=self.device),
            max_len,
        )

    def _column_gather(self, field: int, max_len: int, records=None):
        """gather_column, optionally restricted to `records` (int32 ids)."""
        if records is None:
            return self.gather_column(field, max_len)
        recs = as_int32(records, self.device)
        return self.gather_fields(
            recs, torch.full(recs.shape, field, dtype=torch.int32,
                             device=self.device), max_len
        )

    def to_host_lists(self, out, lengths, valid,
                      allow_truncated=False) -> list:
        """Decode a gather result into a list of bytes (None if invalid).
        A TRUE length beyond max_len raises unless allow_truncated=True
        (then the gathered prefix is returned)."""
        return _to_host_lists(out, lengths, valid, allow_truncated)

    def column_int32(self, field: int, max_len: int = 20, records=None):
        """Parse a column as int32 on the device. Grammar
        `[spaces][+|-]digits` to the end of the field; returns (values
        (N,) int32, ok (N,) bool), values 0 where not ok (empty or
        sign-only fields, stray characters, values outside int32)."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_int32(out, lengths, valid)

    def column_float32(self, field: int, max_len: int = 24, records=None):
        """Parse a column as float32 on the device. Grammar
        `[spaces][+|-]digits[.digits]` and `[spaces][+|-][digits].digits`,
        no exponent; values 0.0 where not ok."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_float32(out, lengths, valid)


class DeviceTape(TypedColumnsMixin):
    """Tape with bytes and index resident on a device for batched
    serving. Construct from a host Tape (`DeviceTape.from_tape`) or from
    raw parts; lookups return (bytes (N, max_len) uint8, lengths (N,),
    valid (N,)) tensors on the tape's device."""

    def __init__(self, data, index, jump: int, field_cnt: int,
                 record_cnt: int, header=None, device="cuda"):
        self.device = resolve_device(device)
        self.header = header  # optional Header (column names)
        # guard before any int32 conversion: the host backends emit int64
        # indexes for inputs of 2 GiB or more, and a wrapped offset would
        # silently mis-serve
        idx_host = (index.detach().cpu().numpy()
                    if isinstance(index, torch.Tensor) else np.asarray(index))
        if idx_host.size and int(idx_host[-1]) >= 2**31:
            raise ValueError(
                "device tape uses int32 offsets: this index addresses "
                ">= 2 GiB; serve it from the host Tape (the sharded tape "
                "is not ported yet)")
        if isinstance(data, torch.Tensor):
            self.data = data.to(device=self.device, dtype=torch.uint8)
        else:
            from .offsetfree import _to_device

            host = as_u8(data)
            self.data = _to_device(host, host.size, self.device)
        self.index = torch.from_numpy(
            np.ascontiguousarray(idx_host, dtype=np.int32)).to(self.device)
        self.jump = int(jump)
        self.field_cnt = int(field_cnt)
        self.record_cnt = int(record_cnt)

    @classmethod
    def from_tape(cls, tape, device="cuda") -> "DeviceTape":
        return cls(tape.data_bytes, np.asarray(tape.index),
                   tape.record_jump_size, tape.field_cnt, tape.record_cnt,
                   header=tape.header, device=device)

    def gather_fields(self, records, fields, max_len: int = 64):
        """Batched (record, field) -> (bytes, lengths, valid)."""
        return _gather_fields(
            self.data, self.index, as_int32(records, self.device),
            as_int32(fields, self.device), self.jump, self.field_cnt,
            self.record_cnt, max_len)


def _check_not_truncated(lengths, valid, max_len: int) -> None:
    """Raise if any valid field's true length exceeds the gathered
    window (for decode paths, where a cut window gives wrong output)."""
    ln = _host(lengths)
    v = _host(valid)
    cut = np.flatnonzero(v & (ln > max_len))
    if cut.size:
        raise ValueError(
            f"gather window truncates {cut.size} field(s) (first at row "
            f"{int(cut[0])}: length {int(ln[cut[0]])} > max_len {max_len}); "
            "decode needs the whole field — re-gather with a larger max_len"
        )


def _to_host_lists(out, lengths, valid, allow_truncated=False) -> list:
    o = _host(out)
    ln = _host(lengths)
    v = _host(valid)
    if not allow_truncated:
        cut = np.flatnonzero(v & (ln > o.shape[1]))
        if cut.size:
            raise ValueError(
                f"gather truncated {cut.size} field(s) (first at row "
                f"{int(cut[0])}: length {int(ln[cut[0]])} > max_len "
                f"{o.shape[1]}); re-gather with a larger max_len or pass "
                "allow_truncated=True"
            )
    return [
        bytes(o[i, : min(ln[i], o.shape[1])]) if v[i] else None
        for i in range(o.shape[0])
    ]


def _field_preamble(out: torch.Tensor, lengths: torch.Tensor):
    """Shared numeric preamble: skip leading spaces, take one optional
    sign. Returns (b int32 bytes, pos grid, in_field mask, neg, dstart)."""
    max_len = out.shape[1]
    pos = torch.arange(max_len, dtype=torch.int32, device=out.device)[None, :]
    b = out.to(torch.int32)
    in_field = pos < lengths[:, None]
    is_space = (b == 0x20) & in_field
    lead_sp = torch.cumprod(is_space.to(torch.int32), dim=1,
                            dtype=torch.int32)  # 1 while in the lead run
    start = lead_sp.sum(dim=1, dtype=torch.int32)
    first = _take_fill(b, start)
    has_sign = (first == 0x2D) | (first == 0x2B)
    neg = first == 0x2D
    dstart = start + has_sign.to(torch.int32)
    return b, pos, in_field, neg, dstart


def _parse_int32(out, lengths, valid):
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    is_digit_pos = (pos >= dstart[:, None]) & in_field
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    ok = (valid & (lengths > dstart) & (lengths <= max_len)
          & torch.all(~is_digit_pos | good_digit, dim=1))
    # v = v*10 + d, flagging int32 overflow as it goes (v*10+d wraps iff
    # v > 214748364, or v == 214748364 and d > 7)
    val = torch.zeros(n, dtype=torch.int32, device=out.device)
    overflow = torch.zeros(n, dtype=torch.bool, device=out.device)
    for j in range(max_len):
        d = digit[:, j]
        use = is_digit_pos[:, j]
        wraps = (val > 214748364) | ((val == 214748364) & (d > 7))
        val = torch.where(use, val * 10 + d, val)
        overflow = overflow | (use & wraps)
    # exactly INT32_MIN wraps during the positive accumulation but
    # negates back to itself; digit count and leading digit keep a
    # larger alias (2^31 + 2^32) out
    digit_cnt = lengths - dstart
    first_digit = _take_fill(b, dstart)
    int_min = (overflow & neg & (val == _INT32_MIN)
               & (digit_cnt == 10) & (first_digit == 0x32))
    ok = ok & (~overflow | int_min)
    val = torch.where(neg, -val, val)
    return torch.where(ok, val, 0), ok


def _parse_float32(out, lengths, valid):
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    dot_count = (is_dot & in_field).sum(dim=1, dtype=torch.int32)
    dot_pos = torch.where(is_dot & in_field, pos, max_len).amin(dim=1)
    body = (pos >= dstart[:, None]) & in_field
    # at least one digit: '.', '-.', '+.' are not numbers
    n_digits = (body & good_digit).sum(dim=1, dtype=torch.int32)
    ok = (valid & (lengths > dstart) & (lengths <= max_len)
          & (dot_count <= 1) & (n_digits >= 1)
          & torch.all(~body | good_digit
                      | (is_dot & (dot_count[:, None] == 1)), dim=1))
    digit_f = digit.to(torch.float32)
    val = torch.zeros(n, dtype=torch.float32, device=out.device)
    scale = torch.ones(n, dtype=torch.float32, device=out.device)
    for j in range(max_len):
        d = digit_f[:, j]
        is_d = body[:, j] & good_digit[:, j]
        after_dot = j > dot_pos
        val = torch.where(is_d, _fma10(val, d), val)
        scale = torch.where(is_d & after_dot, scale * 10.0, scale)
    val = val / scale
    val = torch.where(neg, -val, val)
    return torch.where(ok, val, 0.0), ok
