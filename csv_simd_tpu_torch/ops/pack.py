"""Bitmask packing (csv_simd_tpu/ops/pack.py), the v1 sublane-major
layout: for a (rows, 128) mask, bit k of word (s, lane) covers flat byte
(s*32 + k) * 128 + lane. The words are int32 bit patterns."""

from __future__ import annotations

import numpy as np
import torch


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """(rows, 128) 0/1 int32 mask -> (rows//32, 128) int32 sublane-major
    packed words."""
    rows, lanes = mask.shape
    if rows % 32:
        raise ValueError(f"rows must be a multiple of 32, got {rows}")
    m = mask.to(torch.int32).view(rows // 32, 32, lanes)
    words = m[:, 0].clone()
    for k in range(1, 32):
        words |= m[:, k] << k
    return words


def unpack_words_host(words: np.ndarray, n_bytes: int) -> np.ndarray:
    """Host inverse: (rows//32, 128) int32 words -> 0/1 uint8 flat mask of
    length n_bytes (row-major flat byte order)."""
    s, lanes = words.shape
    bits = (words[:, None, :] >> np.arange(32)[None, :, None]) & 1
    return bits.reshape(s * 32, lanes).reshape(-1)[:n_bytes].astype(np.uint8)


def unpack_words_device(words: torch.Tensor) -> torch.Tensor:
    """Device inverse -> (rows, 128) int32 0/1 mask."""
    s, lanes = words.shape
    shifts = torch.arange(32, dtype=torch.int32,
                          device=words.device)[None, :, None]
    bits = (words[:, None, :] >> shifts) & 1
    return bits.reshape(s * 32, lanes).to(torch.int32)
