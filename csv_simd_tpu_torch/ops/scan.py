"""Quote-parity propagation as prefix scans (csv_simd_tpu/ops/scan.py).

Inclusive parity at flat position r*L + c of a (rows, lanes) layout is
(cumsum of quotes within row r up to c + exclusive cumsum of the row
totals at r + carry_in) mod 2.
"""

from __future__ import annotations

import torch


def inclusive_scan_lanes(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum along the lane (last) axis."""
    return torch.cumsum(x, dim=-1, dtype=torch.int32)


def in_quote_parity(quote: torch.Tensor, carry_in) -> torch.Tensor:
    """Inclusive quote parity over a (rows, lanes) 0/1 quote mask, row-major
    flat order: int32 0/1 of the same shape, 1 = inside quotes (opening
    quote included, closing excluded). carry_in: 0/1 int or 0-d tensor."""
    q = quote.to(torch.int32)
    within = inclusive_scan_lanes(q)  # inclusive, per row
    row_tot = within[:, -1]
    row_excl = torch.cumsum(row_tot, dim=0, dtype=torch.int32) - row_tot
    return (within + row_excl[:, None] + carry_in) & 1


def parity_out(quote: torch.Tensor, carry_in) -> torch.Tensor:
    """0-d int32 parity after consuming the whole buffer."""
    return (quote.to(torch.int32).sum(dtype=torch.int32) + carry_in) & 1
