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
Two more differences between XLA and torch are undone here: XLA flushes
float32 results below 2**-126 to zero on the CPU and the TPU, where torch
keeps them as subnormals on both devices (`_ftz`), and its power of ten
is correctly rounded where torch's float32 `pow` is not (`_pow10`, a
table).

The typed columns: int32, int64, float32 with and without an exponent, exact
decimals in three base-1e8 int32 limbs, ISO dates and datetimes, the
decoded (trimmed, unquoted, unescaped) bytes, and an equality filter.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .device import resolve_device
from .utils import as_u8
from .utils.metrics import GLOBAL

_INT32_MIN = -(2**31)
_FLT_MIN = 2.0**-126  # the least normal float32
_UNIT_DIGITS = {"s": 0, "ms": 3, "us": 6}
_MONTH_DAYS = (0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


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


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """float32 x with the values XLA flushes set to zero: 0 < |x| < 2**-126
    becomes a zero of x's sign. Elementwise, the same on every device (no
    process-wide flush mode)."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _pow10_table() -> np.ndarray:
    """float32 10**k for k = -38..39, as XLA's float32 power gives them:
    correctly rounded for k in -37..38, 0 at -38 (a subnormal, flushed)
    and inf at 39."""
    table = [np.float32(0.0)]
    for k in range(-37, 39):
        exact = Fraction(10) ** k
        f = np.float32(float(exact))  # within one float32 step of exact
        near = (np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf)))
        table.append(min(near, key=lambda c: abs(Fraction(float(c)) - exact)))
    table.append(np.float32(np.inf))
    return np.array(table, dtype=np.float32)


_POW10 = _pow10_table()
_POW10_LO = -38


def _pow10(k: torch.Tensor) -> torch.Tensor:
    """float32 10**k for int32 k, from the table: 0 below -37, inf above
    38."""
    table = torch.from_numpy(_POW10).to(k.device)
    idx = k.clamp(_POW10_LO, _POW10_LO + _POW10.size - 1) - _POW10_LO
    return table[idx.long()]


def _take_fill(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for 2-D int32 x, INT32_MIN where idx[i] is past the
    end: jnp.take_along_axis's default fill for out-of-range indices."""
    width = x.shape[1]
    got = torch.gather(x, 1, idx.clamp(0, width - 1).long()[:, None])[:, 0]
    return torch.where(idx < width, got, _INT32_MIN)


def _position_dtype(n_bytes: int) -> torch.dtype:
    """The dtype of flat byte positions into `n_bytes` bytes: int32 under
    2 GiB, int64 from 2**31 bytes on. Every device tape's byte positions
    take their type from here."""
    return torch.int32 if n_bytes < 2**31 else torch.int64


def _slots(records: torch.Tensor, fields: torch.Tensor, jump: int,
           field_cnt: int, record_cnt: int) -> tuple:
    """The reference's slot arithmetic for batched (record, field)
    queries: (slots (N,) int32, valid (N,) bool), slot = (r + 1) * jump +
    f, with an invalid query's record and field taken as 0, so its slot
    lies inside the index and its read is harmless."""
    valid = ((records >= 0) & (records + 1 < record_cnt)
             & (fields >= 0) & (fields < field_cnt))
    r = torch.where(valid, records, 0)
    f = torch.where(valid, fields, 0)
    return (r + 1) * jump + f, valid


def _masked_take(data: torch.Tensor, pos: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
    """data[pos] where keep, 0 elsewhere: a window's bytes from one flat
    uint8 tensor, pos clamped into it (in place)."""
    return torch.where(keep, data[pos.clamp_(0, data.shape[0] - 1)], 0)


def _byte_window(data, starts: torch.Tensor, ends: torch.Tensor,
                 valid: torch.Tensor, max_len: int,
                 take=_masked_take) -> tuple:
    """The bytes of each query's field [start, end), at most max_len of
    them: (out (N, max_len) uint8, zero past the field and for an invalid
    query; TRUE lengths (N,) int32, 0 for an invalid query; valid).
    starts and ends are int32, or int64 past 2 GiB (`_position_dtype`).
    `take(data, pos, keep)` reads the flat positions `pos` (of the starts'
    dtype) where `keep`, and may overwrite `pos`, which nothing reads
    after it; by default `data` is the flat bytes on one device."""
    lengths = torch.where(valid, ends - starts, 0).to(torch.int32)
    pos = starts[:, None] + torch.arange(max_len, dtype=torch.int32,
                                         device=starts.device)[None, :]
    keep = (pos < ends[:, None]) & valid[:, None]
    return take(data, pos, keep), lengths, valid


def _field_bounds(index: torch.Tensor, records: torch.Tensor,
                  fields: torch.Tensor, jump: int, field_cnt: int,
                  record_cnt: int) -> tuple:
    """(starts, ends, valid) of batched queries from an int32 index: start
    = index[slot] + 1, end = index[slot + 1]. Index reads clamp to the
    last entry, as the JAX gathers do, so an invalid query reads something
    harmless and is masked out."""
    slots, valid = _slots(records, fields, jump, field_cnt, record_cnt)
    last = index.shape[0] - 1
    starts = index[slots.clamp(max=last)] + 1
    ends = index[(slots + 1).clamp(max=last)]
    return starts, ends, valid


def _gather_fields(data: torch.Tensor, index: torch.Tensor,
                   records: torch.Tensor, fields: torch.Tensor, jump: int,
                   field_cnt: int, record_cnt: int, max_len: int):
    """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE lengths
    (N,) int32, valid (N,) bool) from the bytes and an int32 index on one
    device."""
    return _byte_window(data, *_field_bounds(index, records, fields, jump,
                                             field_cnt, record_cnt), max_len)


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

    def column_int64(self, field: int, max_len: int = 24, records=None):
        """Parse a column as int64 on the device, exact over the whole
        range (19 digits of either sign, -2**63 included). Grammar
        `[spaces][+|-]digits` to the end of the field; returns (values (N,)
        int64, ok (N,) bool) on the device, values 0 where not ok (empty
        or sign-only fields, stray characters, values outside int64)."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_int64(out, lengths, valid)

    def column_float32(self, field: int, max_len: int = 24, records=None):
        """Parse a column as float32 on the device. Grammar
        `[spaces][+|-]digits[.digits]` and `[spaces][+|-][digits].digits`,
        no exponent; values 0.0 where not ok."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_float32(out, lengths, valid)

    def gather_decoded(self, records, fields, max_len: int = 64,
                       dialect=None, trim: bool = True):
        """Batched gather, then the decode on the device: trim, unquote and
        `""` unescape as a compaction gather, decode.decode_field's
        semantics. Returns (bytes, lengths, valid). Raises if a requested
        field is longer than max_len: a cut window would decode wrong (its
        closing quote may lie outside it)."""
        from .config import DEFAULT_DIALECT

        d = dialect or DEFAULT_DIALECT
        out, lengths, valid = self.gather_fields(records, fields, max_len)
        _check_not_truncated(lengths, valid, max_len)
        spaces = (d.space, 0x09) if trim else ()
        return _decode_fields(out, lengths, valid, d.quote, spaces)

    def column_decoded(self, field: int, max_len: int = 64,
                       dialect=None, trim: bool = True) -> list:
        """A whole decoded column as host bytes, byte-equal to
        decode.DecodedView.column on the same tape."""
        n = self._num_data()
        out, ln, v = self.gather_decoded(
            torch.arange(n, dtype=torch.int32, device=self.device),
            torch.full((n,), field, dtype=torch.int32, device=self.device),
            max_len, dialect, trim)
        return self.to_host_lists(out, ln, v)

    def column_float32_exp(self, field: int, max_len: int = 32,
                           records=None):
        """Float column parse with exponent notation (`1.5e-3`); see
        _parse_float32_exp for the precision contract."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_float32_exp(out, lengths, valid)

    def column_date_days(self, field: int, max_len: int = 12, records=None):
        """ISO `YYYY-MM-DD` column -> int32 days since 1970-01-01 on the
        device (see _parse_date_days for the ok contract)."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _parse_date_days(out, lengths, valid)

    def column_datetime64(self, field: int, unit: str = "s",
                          max_len: int = 32, records=None):
        """ISO timestamp column -> host int64 epoch values in `unit` ("s",
        "ms" or "us"). Grammar `YYYY-MM-DD[ T]HH:MM:SS[.frac][Z]`: dates as
        column_date_days, hours < 24, minutes and seconds < 60, fraction
        digits that fit the unit (ok=False for `.123` at unit="s"), no
        offsets but `Z`. Returns (values (N,) int64, ok (N,) bool), values
        0 where not ok."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _combine_datetime(
            _parse_datetime_parts(out, lengths, valid, unit), unit)

    def column_decimal64(self, field: int, scale: int = 2,
                         max_len: int = 32, records=None):
        """Exact fixed-point decimal column -> host int64 scaled by
        10^scale (scale=2: b"12.34" -> 1234). The digits are parsed on the
        device in three base-1e8 int32 limbs, the JAX package's contract,
        and combined on the host. Returns (values (N,) int64, ok (N,)
        bool): ok is False for more than `scale` fractional digits, more
        than 18 significant digits, exponents and bad grammar; values 0
        where not ok."""
        out, lengths, valid = self._column_gather(field, max_len, records)
        return _combine_decimal(_parse_decimal_limbs(out, lengths, valid,
                                                     scale))

    def filter_equals(self, field: int, value: bytes, max_len: int = 64,
                      records=None) -> np.ndarray:
        """Record ids whose `field` equals `value` byte for byte, compared
        on the device. Returns a host int32 array (ids from `records` when
        given, else global)."""
        if len(value) > max_len:
            # a cut needle would equal any field that shares the gathered
            # window's prefix and the true length
            raise ValueError(
                f"filter_equals value is {len(value)} bytes but "
                f"max_len={max_len}; pass max_len >= len(value)")
        out, lengths, valid = self._column_gather(field, max_len, records)
        v = np.zeros(max_len, dtype=np.uint8)
        raw = np.frombuffer(value, dtype=np.uint8)
        v[: raw.size] = raw
        hits = np.flatnonzero(_host(_filter_equals(
            out, lengths, valid, torch.from_numpy(v).to(out.device),
            len(value)))).astype(np.int32)
        if records is None:
            return hits
        return np.asarray(_host(records), np.int32)[hits]


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
        # silently mis-serve. The index ascends, so its last entry is its
        # largest: one entry is read, never a whole copy.
        if isinstance(index, torch.Tensor):
            n = index.numel()
        else:
            index = np.asarray(index)
            n = index.size
        if n and int(index.reshape(-1)[-1]) >= 2**31:
            raise ValueError(
                "device tape uses int32 offsets: this index addresses "
                ">= 2 GiB; serve such a file from create_packed's "
                "PackedDeviceTape (64-bit byte positions), the host Tape or "
                "a parallel.serving.ShardedPackedTape")
        if isinstance(data, torch.Tensor):
            self.data = data.to(device=self.device, dtype=torch.uint8)
        else:
            from .offsetfree import _to_device

            host = as_u8(data)
            self.data = _to_device(host, host.size, self.device)
        with GLOBAL.span("device_tape.index_upload"):
            if isinstance(index, torch.Tensor):
                # as it is when it already is a contiguous int32 tensor on
                # this device
                self.index = index.to(device=self.device,
                                      dtype=torch.int32).contiguous()
            else:
                self.index = torch.from_numpy(np.ascontiguousarray(
                    index, dtype=np.int32)).to(self.device)
        self.jump = int(jump)
        self.field_cnt = int(field_cnt)
        self.record_cnt = int(record_cnt)

    @classmethod
    def from_tape(cls, tape, device="cuda") -> "DeviceTape":
        """The tape's bytes and index on `device`. A Tape that `create`
        built on that card holds its index there already (int32, the
        sentinel included), and the DeviceTape serves from that tensor
        itself; any other Tape's host index is cast and uploaded."""
        index = getattr(tape, "_device_index", None)
        if index is not None and index.device == resolve_device(device):
            GLOBAL.count("device_tape.index_shared", 1)
        else:
            index = np.asarray(tape.index)
        return cls(tape.data_bytes, index, tape.record_jump_size,
                   tape.field_cnt, tape.record_cnt, header=tape.header,
                   device=device)

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


_INT64_MIN = -(2**63)
_INT64_LOW10 = _INT64_MIN // 10 + 1  # -922337203685477580


def _parse_int64(out, lengths, valid):
    """int64 parse with the int32 grammar. The magnitude accumulates
    negated, v = v * 10 - d, which reaches -2**63 without wrapping; a step
    wraps iff v < -922337203685477580, or v equals it and d > 8. A
    positive value of 2**63 then fails on the final negation."""
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    is_digit_pos = (pos >= dstart[:, None]) & in_field
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    ok = (valid & (lengths > dstart) & (lengths <= max_len)
          & torch.all(~is_digit_pos | good_digit, dim=1))
    digit = digit.to(torch.int64)
    val = torch.zeros(n, dtype=torch.int64, device=out.device)
    overflow = torch.zeros(n, dtype=torch.bool, device=out.device)
    for j in range(max_len):
        d = digit[:, j]
        use = is_digit_pos[:, j]
        wraps = (val < _INT64_LOW10) | ((val == _INT64_LOW10) & (d > 8))
        overflow = overflow | (use & wraps)
        val = torch.where(use & ~wraps, val * 10 - d, val)
    ok = ok & ~overflow & (neg | (val != _INT64_MIN))
    val = torch.where(neg, val, -val)
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
    val = _ftz(val / scale)
    val = torch.where(neg, -val, val)
    return torch.where(ok, val, 0.0), ok


def _combine_decimal(limbs):
    """(hi, mid, lo, neg, ok) limbs on the device -> (host int64 values,
    ok)."""
    h, m, l, neg, ok = (_host(x) for x in limbs)
    v = h.astype(np.int64) * 10**16 + m.astype(np.int64) * 10**8 + l
    v = np.where(neg, -v, v)
    ok = np.asarray(ok, bool)
    return np.where(ok, v, 0), ok


def _parse_decimal_limbs(out, lengths, valid, scale: int):
    """Exact fixed-point decimal parse in three base-1e8 int32 limbs (each
    intermediate stays below 2**31). Grammar `[spaces][+|-]digits[.digits]`
    (also `.5`, `5.`), no exponent; the number times 10^scale must be an
    integer of at most 18 significant digits. Returns (hi, mid, lo, neg,
    ok): value = sign * (hi * 1e16 + mid * 1e8 + lo)."""
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)
    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    dot_count = (is_dot & in_field).sum(dim=1, dtype=torch.int32)
    dot_pos = torch.where(is_dot & in_field, pos, max_len).amin(dim=1)
    body = (pos >= dstart[:, None]) & in_field
    digit_at = body & good_digit
    n_digits = digit_at.sum(dim=1, dtype=torch.int32)
    frac_cnt = torch.where(dot_count == 1, lengths - dot_pos - 1, 0)
    ok = (valid & (lengths > dstart) & (lengths <= max_len)
          & (dot_count <= 1) & (n_digits >= 1) & (frac_cnt <= scale)
          & (dot_pos >= dstart)
          & torch.all(~body | good_digit
                      | (is_dot & (dot_count[:, None] == 1)), dim=1))
    base = 10**8

    def mul10_add(h, m, l, of, d, use):
        l2 = l * 10 + d
        m2 = m * 10 + torch.div(l2, base, rounding_mode="floor")
        h2 = h * 10 + torch.div(m2, base, rounding_mode="floor")
        # h is clamped at 1000 so h * 10 stays far below 2**31; anything
        # past 18 integer digits flags overflow
        of = of | (use & (h2 > 999))
        h2 = torch.clamp(h2, max=1000)
        return (torch.where(use, h2, h), torch.where(use, m2 % base, m),
                torch.where(use, l2 % base, l), of)

    zero = torch.zeros(n, dtype=torch.int32, device=out.device)
    h, m, l = zero, zero, zero
    of = torch.zeros(n, dtype=torch.bool, device=out.device)
    for j in range(max_len):
        h, m, l, of = mul10_add(h, m, l, of, digit[:, j], digit_at[:, j])
    # scale up by 10^(scale - frac_cnt): `scale` masked x10 steps
    pad = scale - frac_cnt
    for k in range(scale):
        h, m, l, of = mul10_add(h, m, l, of, zero, k < pad)
    # h <= 99 means |value| <= 1e18 - 1, inside int64 either sign
    ok = ok & ~of & (h <= 99)
    return h, m, l, neg, ok


def _decode_fields(out, lengths, valid, quote: int, spaces: tuple):
    """Trim, unquote and `""` unescape a gathered batch (N, L) as a
    fixed-shape compaction gather, byte-equal to decode.decode_field: trim
    strips the space bytes outside the quotes first; a field is unquoted
    iff the trimmed span has >= 2 bytes with a quote at each end; doubled
    quotes collapse left to right, only inside a quoted field."""
    n, L = out.shape
    pos = torch.arange(L, dtype=torch.int32, device=out.device)[None, :]
    b = out.to(torch.int32)
    in_field = pos < lengths[:, None]
    is_sp = torch.zeros_like(in_field)
    for sp in spaces:
        is_sp = is_sp | (b == sp)
    is_sp = is_sp & in_field

    lead = torch.cumprod(is_sp.to(torch.int32), dim=1, dtype=torch.int32)
    start = lead.sum(dim=1, dtype=torch.int32)
    tail_run = torch.cumprod(
        torch.flip((is_sp | ~in_field).to(torch.int32), dims=(1,)), dim=1,
        dtype=torch.int32)
    trail = tail_run.sum(dim=1, dtype=torch.int32) - (L - lengths)
    end = lengths - trail
    start = torch.minimum(start, end)  # an all-space field is empty

    first = torch.gather(b, 1, start.clamp(0, L - 1).long()[:, None])[:, 0]
    last = torch.gather(b, 1, (end - 1).clamp(0, L - 1).long()[:, None])[:, 0]
    has_q = (end - start >= 2) & (first == quote) & (last == quote)
    start = start + has_q.to(torch.int32)
    end = end - has_q.to(torch.int32)

    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    q = in_span & (b == quote)
    prev_q = torch.cat([torch.zeros_like(q[:, :1]), q[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(q & ~prev_q, pos, -1), dim=1).values
    drop = q & (((pos - run_start) & 1) == 1) & has_q[:, None]
    keep = in_span & ~drop

    order = torch.argsort(torch.where(keep, pos, L + pos), dim=1,
                          stable=True)
    gathered = torch.gather(out, 1, order)
    new_len = keep.sum(dim=1, dtype=torch.int32)
    gathered = torch.where(pos < new_len[:, None], gathered, 0)
    return gathered, new_len, valid


def _parse_float32_exp(out, lengths, valid):
    """Float parse with exponent notation:
    `[spaces][+|-]digits[.digits][(e|E)[+|-]digits]` (also `.5`, `5.`).
    The mantissa accumulates in float32 (one rounding a digit, as XLA's
    fused multiply-add), so more than 7 significant digits round unlike a
    correctly rounded parse; the scale is two float32 multiplies by
    powers of ten, each result flushed below 2**-126 as XLA does. Limits
    of the reference, kept: an exponent overflow gives +/-inf and `0e999`
    NaN (0 * inf), both with ok=True for well-formed text."""
    n, max_len = out.shape
    b, pos, in_field, neg, dstart = _field_preamble(out, lengths)

    is_e = ((b == 0x65) | (b == 0x45)) & in_field
    e_cnt = is_e.sum(dim=1, dtype=torch.int32)
    epos = torch.where(is_e, pos, max_len).amin(dim=1)
    mant_end = torch.minimum(epos, lengths)

    digit = b - 0x30
    good_digit = (digit >= 0) & (digit <= 9)
    is_dot = b == 0x2E
    mant_body = (pos >= dstart[:, None]) & (pos < mant_end[:, None])
    dot_count = (is_dot & mant_body).sum(dim=1, dtype=torch.int32)
    dot_pos = torch.where(is_dot & mant_body, pos, max_len).amin(dim=1)
    mant_digits = (mant_body & good_digit).sum(dim=1, dtype=torch.int32)
    mant_ok = ((dot_count <= 1) & (mant_digits >= 1)
               & torch.all(~mant_body | good_digit | is_dot, dim=1))

    # the exponent part (optional)
    has_e = epos < lengths
    es = epos + 1
    efirst = torch.gather(b, 1, es.clamp(0, max_len - 1).long()[:, None])[:, 0]
    e_sign = (efirst == 0x2D) | (efirst == 0x2B)
    e_neg = (efirst == 0x2D) & has_e
    eds = es + e_sign.to(torch.int32)
    e_body = (pos >= eds[:, None]) & in_field
    e_ok = ~has_e | ((e_cnt == 1) & (lengths > eds)
                     & torch.all(~e_body | good_digit, dim=1))
    # a field longer than the window would parse its prefix cleanly (the
    # exponent cut off): never ok
    ok = valid & mant_ok & e_ok & (lengths <= max_len)

    digit_f = digit.to(torch.float32)
    val = torch.zeros(n, dtype=torch.float32, device=out.device)
    frac = torch.zeros(n, dtype=torch.int32, device=out.device)
    ev = torch.zeros(n, dtype=torch.int32, device=out.device)
    for j in range(max_len):
        is_d = mant_body[:, j] & good_digit[:, j]
        val = torch.where(is_d, _fma10(val, digit_f[:, j]), val)
        frac = torch.where(is_d & (j > dot_pos), frac + 1, frac)
        is_ed = e_body[:, j] & good_digit[:, j]
        ev = torch.where(is_ed, torch.clamp(ev * 10 + digit[:, j], max=9999),
                         ev)
    exp10 = torch.where(e_neg, -ev, ev) - frac
    # split the scale to keep intermediates finite for moderate values
    half = torch.div(exp10, 2, rounding_mode="floor")
    val = _ftz(val * _pow10(half))
    val = _ftz(val * _pow10(exp10 - half))
    val = torch.where(neg, -val, val)
    return torch.where(ok, val, 0.0), ok


def _ymd_to_days(y, m, day):
    """Hinnant's days_from_civil: (year, month, day) -> days since
    1970-01-01, proleptic Gregorian, exact integer arithmetic."""
    yy = y - (m <= 2).to(torch.int32)
    era = torch.div(yy, 400, rounding_mode="floor")
    yoe = yy - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = torch.div(153 * mp + 2, 5, rounding_mode="floor") + day - 1
    doe = (yoe * 365 + torch.div(yoe, 4, rounding_mode="floor")
           - torch.div(yoe, 100, rounding_mode="floor") + doy)
    return era * 146097 + doe - 719468


def _month_days(y, m):
    """Days in month m (clipped to 0..12; 0 for month 0) of year y."""
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    mdays = torch.tensor(_MONTH_DAYS, dtype=torch.int32, device=y.device)
    return mdays[m.clamp(0, 12).long()] + (leap & (m == 2)).to(torch.int32)


def _parse_datetime_parts(out, lengths, valid, unit: str):
    """ISO `YYYY-MM-DD[ T]HH:MM:SS[.frac][Z]` -> (days, seconds of the day,
    fraction scaled to `unit`, ok), all int32, combined on the host
    (_combine_datetime). Every position is fixed by the format. ok is
    False for bad digits or separators, invalid civil dates, hh > 23, mm
    or ss > 59, offsets other than Z, and more fraction digits than the
    unit holds."""
    n, max_len = out.shape
    if max_len < 21:
        # a ValueError, not an assert: the fraction reads below need 21
        # columns, and it must survive python -O
        raise ValueError(
            f"datetime parse needs a gather window >= 21, got {max_len}")
    udig = _UNIT_DIGITS[unit]
    pos = torch.arange(max_len, dtype=torch.int32, device=out.device)[None, :]
    b = out.to(torch.int32)
    d = b - 0x30

    ok = (valid & (lengths >= 19) & (lengths <= max_len)
          & (b[:, 4] == 0x2D) & (b[:, 7] == 0x2D)
          & ((b[:, 10] == 0x20) | (b[:, 10] == 0x54))
          & (b[:, 13] == 0x3A) & (b[:, 16] == 0x3A))
    for i in (0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15, 17, 18):
        ok = ok & (d[:, i] >= 0) & (d[:, i] <= 9)
    y = d[:, 0] * 1000 + d[:, 1] * 100 + d[:, 2] * 10 + d[:, 3]
    m = d[:, 5] * 10 + d[:, 6]
    day = d[:, 8] * 10 + d[:, 9]
    ok = (ok & (m >= 1) & (m <= 12) & (day >= 1)
          & (day <= _month_days(y, m)))

    hh = d[:, 11] * 10 + d[:, 12]
    mm = d[:, 14] * 10 + d[:, 15]
    ss = d[:, 17] * 10 + d[:, 18]
    ok = ok & (hh <= 23) & (mm <= 59) & (ss <= 59)

    last = torch.gather(
        b, 1, (lengths - 1).clamp(0, max_len - 1).long()[:, None])[:, 0]
    has_z = (last == 0x5A) & (lengths >= 20)
    end = lengths - has_z.to(torch.int32)  # the fraction ends here
    has_frac = end > 19
    ok = ok & (~has_frac | ((b[:, 19] == 0x2E) & (end >= 21)))
    n_frac = torch.where(has_frac, end - 20, 0)
    ok = ok & (n_frac <= udig)
    good_digit = (d >= 0) & (d <= 9)
    frac_pos = (pos >= 20) & (pos < end[:, None])
    ok = ok & torch.all(~frac_pos | good_digit, dim=1)

    frac = torch.zeros(n, dtype=torch.int32, device=out.device)
    for k in range(udig):
        p = 20 + k
        if p < max_len:
            dk = torch.where(p < end, d[:, p], 0)
        else:
            dk = torch.zeros_like(frac)
        frac = frac * 10 + dk  # the digits, then zeros to the unit

    days = _ymd_to_days(y, m, day)
    sod = hh * 3600 + mm * 60 + ss
    return (torch.where(ok, days, 0), torch.where(ok, sod, 0),
            torch.where(ok, frac, 0), ok)


def _combine_datetime(parts, unit: str):
    """(days, sod, frac, ok) int32 parts on the device -> (host int64
    epoch values in `unit`, ok)."""
    days, sod, frac, ok = (_host(x) for x in parts)
    mult = 10 ** _UNIT_DIGITS[unit]
    v = (days.astype(np.int64) * 86400 + sod) * mult + frac
    ok = np.asarray(ok, bool)
    return np.where(ok, v, 0), ok


def _parse_date_days(out, lengths, valid):
    """`YYYY-MM-DD` -> int32 days since 1970-01-01 (proleptic Gregorian).
    ok is False for any other shape or length, a month outside 1..12, or
    a day outside the month's length (leap years counted); values 0 where
    not ok."""
    b = out.to(torch.int32)
    d = b - 0x30
    ok = (valid & (lengths == 10) & (b[:, 4] == 0x2D) & (b[:, 7] == 0x2D))
    for i in (0, 1, 2, 3, 5, 6, 8, 9):
        ok = ok & (d[:, i] >= 0) & (d[:, i] <= 9)
    y = d[:, 0] * 1000 + d[:, 1] * 100 + d[:, 2] * 10 + d[:, 3]
    m = d[:, 5] * 10 + d[:, 6]
    day = d[:, 8] * 10 + d[:, 9]
    ok = (ok & (m >= 1) & (m <= 12) & (day >= 1)
          & (day <= _month_days(y, m)))
    return torch.where(ok, _ymd_to_days(y, m, day), 0), ok


def _filter_equals(out, lengths, valid, needle, needle_len: int):
    """(N,) bool: valid fields of exactly needle_len bytes equal to the
    first needle_len bytes of needle ((max_len,) uint8, zero-padded)."""
    max_len = out.shape[1]
    pos = torch.arange(max_len, dtype=torch.int32, device=out.device)
    in_field = pos[None, :] < lengths[:, None]
    same = (out == needle[None, :]) | ~in_field
    return valid & (lengths == needle_len) & torch.all(same, dim=1)
