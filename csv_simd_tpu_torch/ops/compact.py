"""Offset extraction on the device (csv_simd_tpu/ops/compact.py): a
structural 0/1 mask -> ascending byte offsets in a fixed-capacity array,
as torch ops on the mask's device."""

from __future__ import annotations

import torch


def extract_offsets_device(mask2d: torch.Tensor, capacity: int):
    """Compact the set positions of a (rows, lanes) 0/1 mask into a
    fixed-capacity int32 offsets array (flat byte order).

    Returns (offsets[capacity], count 0-d int32). Slots past `count` hold
    the PADDED flat size rows*lanes (the JAX package's nonzero fill
    value), not the input byte count. If count > capacity the result is
    truncated; callers check and run again with a larger capacity."""
    flat = mask2d.reshape(-1)
    count = flat.sum(dtype=torch.int32)
    nz = torch.nonzero(flat).view(-1)
    offsets = torch.full((capacity,), flat.numel(), dtype=torch.int32,
                         device=flat.device)
    k = min(nz.numel(), capacity)
    offsets[:k] = nz[:k].to(torch.int32)
    return offsets, count


def count_set(mask2d: torch.Tensor) -> torch.Tensor:
    return mask2d.sum(dtype=torch.int32)
