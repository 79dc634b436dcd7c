"""Byte classification (csv_simd_tpu/ops/classify.py `classify_masks`)."""

from __future__ import annotations

import torch

from ..config import Dialect


def classify_masks(b: torch.Tensor, dialect: Dialect):
    """uint8 bytes -> (structural, quote) boolean masks.

    structural = delimiter or any newline byte; quote = the dialect
    quote byte."""
    nl = b == dialect.newlines[0]
    for extra in dialect.newlines[1:]:
        nl = nl | (b == extra)
    delim = b == dialect.delimiter
    quote = b == dialect.quote
    return nl | delim, quote
