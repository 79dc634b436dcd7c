"""The int32 op rate of the card, measured rather than taken from a data
sheet (tools/vpu_roofline.py).

`probe` applies n_ops chained int32 ops to every element of (rows, 128)
int32 in: x = w + s, four chains from x, x ^ 17, x + 5 and x ^ -7, one op
a step cycling the mix's kinds with constants _CONSTS[(4k + j) % 256],
and out = (c0 ^ c1) + (c2 ^ c3) (the TPU tool's `_probe_kernel`). Mixes:
alu (add, xor), shift (logical shift right by 1, add, xor), mul (mul by
the constant | 1, xor). On a CUDA tensor it launches csrc/probe_alu.cu,
on a CPU tensor its plain version.

The rate is elements x (ops_hi - ops_lo) / (t_hi - t_lo), T int32 ops/s.
At the TPU tool's 16 and 48 ops an element is still bound by its 8 bytes
of memory traffic on the card, so the rate is read between the two
largest op counts the kernel is built for, from CUDA-graph times (the
kernels alone; `eager_ms` beside them). Every count and mix is held bit
for bit against the plain version, at the gate's sizes and on the timed
input.

    python -m csv_simd_tpu_torch.tools.vpu_roofline [mb]   (default 64)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.swar import shift_right_logical
from ._common import (
    card,
    check_all,
    emit,
    interleaved_ms,
    kernel_ms,
    merge,
    need_card,
    random_words,
)
from ._lab_kernels import check_rows128

TILE = 512
_CONSTS = np.random.default_rng(11).integers(1, 2**31 - 1,
                                             size=256).tolist()
MIXES = {
    "alu": ("add", "xor"),
    "shift": ("lsr", "add", "xor"),
    "mul": ("mul", "xor"),
}


def _apply(v: torch.Tensor, kind: str, k: int) -> torch.Tensor:
    c = _CONSTS[k % len(_CONSTS)]
    if kind == "add":
        return v + c
    if kind == "xor":
        return v ^ c
    if kind == "lsr":
        return shift_right_logical(v, 1)
    if kind == "mul":
        return v * (c | 1)
    raise ValueError(kind)


def _probe_plain(words: torch.Tensor, n_ops: int, mix: str, s):
    """Plain version of the kernel (the TPU tool's `_probe_kernel`)."""
    kinds = MIXES[mix]
    x = words + s
    chains = [x, x ^ 17, x + 5, x ^ -7]
    for j in range(4):
        v = chains[j]
        for k in range(n_ops // 4):
            v = _apply(v, kinds[k % len(kinds)], 4 * k + j)
        chains[j] = v
    return (chains[0] ^ chains[1]) + (chains[2] ^ chains[3])


def probe(words: torch.Tensor, n_ops: int, mix: str, s=0) -> torch.Tensor:
    """(rows, 128) int32 -> (rows, 128) int32 after n_ops chained ops of
    `mix`; s is an int32 value or a 0-d int32 tensor."""
    check_rows128(words, "probe", 1)
    if mix not in MIXES:
        raise ValueError(f"mix must be one of {tuple(MIXES)}: {mix!r}")
    if n_ops <= 0 or n_ops % 4:
        raise ValueError(f"n_ops must be a positive multiple of 4: {n_ops}")
    if words.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_alu(words, n_ops, list(MIXES).index(mix),
                                      _CONSTS, s)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return _probe_plain(words, n_ops, mix, s)


def check(words: torch.Tensor, s=1) -> dict:
    """Every built op count and mix against the plain version on words:
    {checks, max_abs_err}."""
    from . import _lab_kernels

    return check_all(
        (probe(words, n_ops, mix, s), _probe_plain(words, n_ops, mix, s),
         f"{mix} {n_ops} ops rows={words.shape[0]}")
        for n_ops in _lab_kernels.probe_alu_op_counts() for mix in MIXES)


def gate(device) -> dict:
    """check at 4 sizes, the largest past one pass of the kernel's
    grid-stride loop, and two values of s (one a device scalar)."""
    results = []
    for rows in (TILE, 4 * TILE, 2 * 1024, 32 * 1024):
        w = random_words(rows, device, 7 + rows)
        for s in (0, torch.tensor(-123_456_789, dtype=torch.int32,
                                  device=device)):
            results.append(check(w, s))
    torch.cuda.synchronize()
    return merge(*results)


def run(words: torch.Tensor, reps: int = 20) -> dict:
    """Times of every built op count per mix, in turns, and the rate
    between the two largest counts: {mix: {"ms": {ops: ms}, "eager_ms":
    {ops: ms}, "ops": [lo, hi], "t_ops_per_s": rate / 1e12}}."""
    from . import _lab_kernels

    counts = _lab_kernels.probe_alu_op_counts()
    lo, hi = counts[-2], counts[-1]
    fns = {(mix, n): (lambda mix=mix, n=n: probe(words, n, mix, 1))
           for mix in MIXES for n in counts}
    ms = kernel_ms(fns, reps)
    out = {}
    for mix in MIXES:
        dt = (ms[(mix, hi)]["ms"] - ms[(mix, lo)]["ms"]) / 1e3
        rate = words.numel() * (hi - lo) / dt if dt > 0 else float("nan")
        out[mix] = {"ms": {n: ms[(mix, n)]["ms"] for n in counts},
                    "eager_ms": {n: ms[(mix, n)]["eager_ms"] for n in counts},
                    "ops": [lo, hi], "t_ops_per_s": rate / 1e12}
    return out


def plain_ms(words: torch.Tensor, n_ops: int, mix: str,
             reps: int = 3) -> float:
    return interleaved_ms({0: lambda: _probe_plain(words, n_ops, mix, 1)},
                          reps, rounds=1)[0]


def main(argv) -> int:
    device = need_card("vpu_roofline")
    mb = int(argv[0]) if argv else 64
    rows = mb * 1024 * 1024 // (128 * 4)
    rows -= rows % TILE
    words = random_words(rows, device, 3)
    result = {**card(), "gate": gate(device), "check": check(words),
              "elements": words.numel(), "mixes": run(words)}
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
