"""UTF-8 validation (csv_simd_tpu/ops/utf8.py).

- `is_ascii`: every byte < 0x80 (the fast path);
- `validate_utf8`: full RFC 3629 validation on the host, the Keiser-Lemire
  three-nibble-LUT construction ("Validating UTF-8 In Less Than One
  Instruction Per Byte", the one simdjson uses): an error bitset per
  position from
      sc  = T1H[prev1 >> 4] & T1L[prev1 & 0xF] & T2H[cur >> 4]
      err = sc XOR (0x80 where a 3rd/4th continuation byte is required)
  is zero everywhere iff the (non-truncated) stream is valid; a final
  check rejects a truncated multi-byte sequence at the buffer end;
- `validate_utf8_device`: the same answer from an error count over the
  bytes on a device, RFC 3629's byte ranges compared directly. On a CUDA
  tensor the count is the hand-written validator kernel
  (csrc/utf8.cu, `_kernels.utf8_errs`); on a CPU tensor it is the plain
  PyTorch version, `_utf8_errs_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import as_u8

TOO_SHORT = 1 << 0
TOO_LONG = 1 << 1
OVERLONG_3 = 1 << 2
TOO_LARGE = 1 << 3
SURROGATE = 1 << 4
OVERLONG_2 = 1 << 5
TOO_LARGE_1000 = 1 << 6
OVERLONG_4 = 1 << 6  # shared bit, disjoint trigger patterns
TWO_CONTS = 1 << 7

CARRY = TOO_SHORT | TOO_LONG | TWO_CONTS


def _tables():
    t1h = np.zeros(16, np.uint8)
    t1h[0:8] = TOO_LONG
    t1h[8:12] = TWO_CONTS
    t1h[12] = TOO_SHORT | OVERLONG_2
    t1h[13] = TOO_SHORT
    t1h[14] = TOO_SHORT | OVERLONG_3 | SURROGATE
    t1h[15] = TOO_SHORT | TOO_LARGE | TOO_LARGE_1000 | OVERLONG_4

    t1l = np.full(16, CARRY, np.uint8)
    t1l[0] |= OVERLONG_3 | OVERLONG_2 | OVERLONG_4
    t1l[1] |= OVERLONG_2
    t1l[4] |= TOO_LARGE
    t1l[5:16] |= TOO_LARGE | TOO_LARGE_1000
    t1l[13] |= SURROGATE

    t2h = np.zeros(16, np.uint8)
    t2h[0:8] = TOO_SHORT
    t2h[8] = TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE_1000 | OVERLONG_4
    t2h[9] = TOO_LONG | OVERLONG_2 | TWO_CONTS | OVERLONG_3 | TOO_LARGE
    t2h[10] = TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE
    t2h[11] = TOO_LONG | OVERLONG_2 | TWO_CONTS | SURROGATE | TOO_LARGE
    t2h[12:16] = TOO_SHORT
    return t1h, t1l, t2h


_T1H, _T1L, _T2H = _tables()


def is_ascii(data: bytes | np.ndarray) -> bool:
    arr = as_u8(data)
    return bool((arr < 0x80).all())


def validate_utf8_device(data, device="cuda") -> bool:
    """Full UTF-8 validation of bytes on a device; returns a host bool.

    `data` is a uint8 tensor (validated where it lies) or host bytes,
    which are uploaded to `device` first. A CUDA tensor goes through the
    validator kernel; a tensor that is not contiguous or not 16-byte
    aligned is copied first. A CPU tensor goes through the plain
    version. Used by the validate_utf8 flag of create and PackedDeviceTape
    (the tape calls it only when its build counted a byte >= 0x80)."""
    if isinstance(data, torch.Tensor):
        t = data.reshape(-1)
        if t.dtype != torch.uint8:
            raise ValueError(f"expected uint8 bytes, got {t.dtype}")
    else:
        from ..device import resolve_device
        from ..offsetfree import _to_device

        arr = as_u8(data)
        t = _to_device(arr, arr.size, resolve_device(device))
    if t.numel() == 0:
        return True
    if t.device.type == "cuda":
        from .. import _kernels

        if not t.is_contiguous() or t.data_ptr() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        return int(_kernels.utf8_errs(t)) == 0
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return _utf8_errs_plain(t) == 0


def _utf8_errs_plain(a: torch.Tensor) -> int:
    """The error count of the device UTF-8 check (the JAX package's
    `_utf8_errs_jit`), as plain PyTorch ops on flat uint8 `a` on any
    device: the positions where a continuation byte is missing or
    unexpected, or a first continuation makes an overlong form, a
    surrogate or a code point past U+10FFFF, or the previous byte is no
    UTF-8 byte at all; plus one for each kind of multi-byte sequence cut
    off by the end. Zero iff the bytes are valid UTF-8."""
    n = a.numel()
    if n == 0:
        return 0
    cur = a.reshape(-1).to(torch.int32)

    def shift(k):
        return torch.cat([cur.new_zeros(k), cur])[:n]

    p1, p2, p3 = shift(1), shift(2), shift(3)
    is_cont = (cur & 0xC0) == 0x80
    lead2 = (p1 & 0xE0) == 0xC0
    lead3 = (p1 & 0xF0) == 0xE0
    lead4 = (p1 & 0xF8) == 0xF0
    lead3_2 = (p2 & 0xF0) == 0xE0
    lead4_2 = (p2 & 0xF8) == 0xF0
    lead4_3 = (p3 & 0xF8) == 0xF0
    must_cont = lead2 | lead3 | lead4 | lead3_2 | lead4_2 | lead4_3
    bad_cont = is_cont != must_cont
    # overlong / surrogate / out of range at the first continuation
    bad_first = (
        ((p1 == 0xC0) | (p1 == 0xC1))                      # overlong 2B
        | ((p1 == 0xE0) & (cur < 0xA0) & is_cont)          # overlong 3B
        | ((p1 == 0xED) & (cur >= 0xA0) & is_cont)         # surrogate
        | ((p1 == 0xF0) & (cur < 0x90) & is_cont)          # overlong 4B
        | ((p1 == 0xF4) & (cur >= 0x90) & is_cont)         # > U+10FFFF
        | (p1 >= 0xF5)                                     # invalid lead
    )
    errs = int((bad_cont | bad_first).sum())
    # a truncated multi-byte sequence at the buffer end
    tail = int(cur[n - 1] >= 0xC0)
    if n >= 2:
        tail += int(cur[n - 2] >= 0xE0)
    if n >= 3:
        tail += int(cur[n - 3] >= 0xF0)
    return errs + tail


def validate_utf8(data: bytes | np.ndarray) -> bool:
    """True iff the buffer is valid UTF-8 (RFC 3629)."""
    arr = as_u8(data)
    n = arr.size
    if n == 0:
        return True
    if (arr < 0x80).all():
        return True
    cur = arr.astype(np.int32)

    def shift(k: int) -> np.ndarray:
        return np.concatenate([np.zeros(k, np.int32), cur])[:n]

    prev1, prev2, prev3 = shift(1), shift(2), shift(3)

    sc = (
        _T1H[prev1 >> 4].astype(np.int32)
        & _T1L[prev1 & 0xF].astype(np.int32)
        & _T2H[cur >> 4].astype(np.int32)
    )
    # positions that MUST be a continuation because of a 3-byte lead two
    # back or a 4-byte lead three back; XOR cancels the legitimate
    # TWO_CONTS flags and raises an error where a required continuation
    # is missing
    must23 = ((prev2 >= 0xE0) | (prev3 >= 0xF0)).astype(np.int32) * TWO_CONTS
    if ((sc ^ must23) != 0).any():
        return False
    # truncated multi-byte sequence at the very end
    if arr[-1] >= 0xC0:
        return False
    if n >= 2 and arr[-2] >= 0xE0:
        return False
    if n >= 3 and arr[-3] >= 0xF0:
        return False
    return True
