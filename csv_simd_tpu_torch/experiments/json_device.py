"""Device JSON stage-1: escape-aware structural masking and nesting
depths (the port of csv_simd_tpu/experiments/json_device.py).

classify -> odd-backslash-run escape resolution -> escape-aware quote
parity -> structural mask -> depth, over the flat byte stream. On a CUDA
device `json_structural_mask_device` and `json_depths_device` run kernel
J1 (csrc/json_stage1.cu, `_kernels.json_stage1`), which computes both in
three launches: a table a segment of how it maps the carried state
(backslash-run parity, in-string parity, depth), a scan of the tables,
and an emit that re-reads the bytes with each segment's state. On the
CPU they run the plain PyTorch version, a step-for-step twin of the JAX
functions: run starts by `torch.cummax`, the quote parity and the depth
by int32 `torch.cumsum`, which wraps as XLA's does.

The outputs keep the JAX contract: `mask` is (n,) int32 0/1, `depth`
(n,) int32 at every position, an opener reporting the depth it opens
from. Inputs of 2**31 bytes or more raise ValueError: the JAX function's
int32 positions cannot index them either.

Reference analog: json_test.rs (a 16-byte fixture experiment, never
live); simdjson stage 1 is the published construction both follow.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils import as_u8

_STRUCTURAL = tuple(b"{}[]:,")
_TOO_BIG = ("the JSON stage-1 uses int32 byte positions, as the JAX "
            "package's does: inputs of 2 GiB or more are not supported")


def fast_cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-MAX of a 1-D int32 tensor (the JAX function's
    hierarchical construction gives the same values)."""
    return torch.cummax(x, 0).values


def _bytes_on(arr, device) -> torch.Tensor:
    """Bytes (host bytes or array, or a uint8 tensor) as one flat uint8
    tensor on `device`; host bytes are uploaded."""
    dev = resolve_device(device)
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.uint8:
            raise ValueError(f"expected uint8 bytes, got {arr.dtype}")
        n = arr.numel()
    else:
        arr = as_u8(arr).reshape(-1)
        n = arr.size
    if n >= 2**31:
        raise ValueError(_TOO_BIG)
    if isinstance(arr, torch.Tensor):
        return arr.reshape(-1).to(dev)
    from ..offsetfree import _to_device

    return _to_device(arr, n, dev)


def _mask_plain(b: torch.Tensor) -> torch.Tensor:
    """json_structural_mask_device's steps on an int32 byte tensor."""
    n = b.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=b.device)
    neg = torch.full((1,), -1, dtype=torch.int32, device=b.device)

    is_bs = b == 0x5C
    prev_bs = torch.cat([torch.zeros(1, dtype=torch.bool, device=b.device),
                         is_bs[:-1]])
    run_start = fast_cummax_i32(torch.where(is_bs & ~prev_bs, pos, neg))
    rs_prev = torch.cat([neg, run_start[:-1]])
    # escaped iff the previous byte ends a backslash run of odd length:
    # length = (i-1) - run_start + 1 odd  <=>  (i-1 - run_start) even
    escaped = prev_bs & (((pos - 1 - rs_prev) & 1) == 0)

    q_eff = (b == 0x22) & ~escaped
    in_string = torch.cumsum(q_eff.to(torch.int32), 0, dtype=torch.int32) & 1

    structural = torch.zeros(n, dtype=torch.bool, device=b.device)
    for c in _STRUCTURAL:
        structural = structural | (b == c)
    # structural chars are never quotes, so the inclusive string mask
    # equals the exclusive one at these positions (clmul semantics)
    return (structural & (in_string == 0)).to(torch.int32)


def _depths_plain(arr: torch.Tensor) -> tuple:
    """json_depths_device's steps in PyTorch ops on any device."""
    b = arr.to(torch.int32)
    mask = _mask_plain(b)
    opens = ((b == 0x7B) | (b == 0x5B)) & (mask == 1)
    closes = ((b == 0x7D) | (b == 0x5D)) & (mask == 1)
    delta = opens.to(torch.int32) - closes.to(torch.int32)
    incl = torch.cumsum(delta, 0, dtype=torch.int32)
    # openers: depth before the char (incl - 1); closers: depth after
    # (incl); others: current depth (incl)
    depth = torch.where(opens, incl - 1, incl)
    return mask, depth


def _run(t: torch.Tensor) -> tuple:
    """(mask, depth) of the bytes t: kernel J1 on a CUDA tensor, the
    plain version on a CPU one."""
    if t.numel() == 0:
        empty = torch.empty(0, dtype=torch.int32, device=t.device)
        return empty, empty.clone()
    if t.device.type == "cuda":
        from .. import _kernels

        return _kernels.json_stage1(t)
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return _depths_plain(t)


def json_structural_mask_device(arr, device="cuda") -> torch.Tensor:
    """(n,) uint8 -> (n,) int32 0/1 mask of JSON structural characters
    outside strings (escape-aware), on `device`. Bit-identical to the
    golden json_levels.json_structural_index support."""
    return _run(_bytes_on(arr, device))[0]


def json_structural_index_device(data, device="cuda") -> np.ndarray:
    """Offsets of JSON structural chars outside strings, computed on
    `device`, as host int64: compacted where the mask lies, so only the
    offsets are copied back."""
    mask = json_structural_mask_device(data, device=device)
    return torch.nonzero(mask).reshape(-1).cpu().numpy().astype(np.int64)


def json_depths_device(arr, device="cuda") -> tuple:
    """(n,) uint8 -> (mask, depth), both (n,) int32 on `device`: depth[i]
    is the container nesting depth AT each structural char (level_sets
    semantics: an opener reports the depth it opens FROM, a closer the
    depth it closes TO), and the running depth elsewhere. Depth is a
    cumsum of +/-1 over openers/closers outside strings: the 'level set'
    computation on device."""
    return _run(_bytes_on(arr, device))
