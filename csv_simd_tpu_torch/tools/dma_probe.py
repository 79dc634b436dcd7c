"""The memory-stream probe: the card's ceiling for the stage-1 kernels'
read-N / write-N/8 stream (tools/dma_probe.py and tools/dma_probe2.py).

`mk_write` reads (rows, 128) int32 and writes 1/8 of it in one of four
layouts, block i of 512 rows plus (carry + i) & 1:
- "narrow": out[r, :16] = in[r, :16] + a, (rows, 16) (dma_probe.py `mk`
  and dma_probe2.py `mk_write`);
- "tall2", "tall8": the same values (dma_probe2.py); on the TPU the out
  block was revisited over 2 or 8 grid steps, a Mosaic DMA schedule with
  no counterpart, so here a CUDA block owns 2 or 8 of the 512-row blocks;
- "wide": out[64i + r, :] = in[512i + r, :] + a for r < 64, (rows/8, 128)
  (both tools).
`mk_read` sums a (R, 128) int32 buffer read as (64, 128) blocks and
returns the last block's wrapping sum plus the carry (dma_probe2.py
`mk_read`). A (rows, 16) array and its (rows/8, 128) view are the same
memory on the card, so the TPU's "reshape" and "native" reads are one.

Each also returns side words (the XOR of each 512-row block, the sum of
each 64-row block) that make the kernel read all of its input, as the
TPU probe did; they are checked like the outputs, on the timed input as
well as at the gate's sizes. On a CUDA tensor each launches
csrc/probe_stream.cu, on a CPU tensor its plain version. Kernel times
come from CUDA graphs (`ms`) and from eager launches (`eager_ms`).

    python -m csv_simd_tpu_torch.tools.dma_probe [mb ...]   (default 64 1024)
"""

from __future__ import annotations

import sys

import torch

from ..ops.stage1_v3 import _as_carry
from ._common import (
    card,
    check_all,
    emit,
    interleaved_ms,
    kernel_ms,
    merge,
    need_card,
    random_words,
    wrap_sum,
    xor_reduce,
)
from ._lab_kernels import STREAM_WRITE_MODES as WRITE_MODES
from ._lab_kernels import check_rows128

DMA_PROBE_MODES = ("narrow", "wide")  # tools/dma_probe.py's two
BLOCK = 512
READ_BLOCK = 64


def _write_plain(words: torch.Tensor, mode: str, carry_in):
    rows = words.shape[0]
    c = _as_carry(carry_in, words.device)
    blocks = words.view(rows // BLOCK, BLOCK, 128)
    i = torch.arange(rows // BLOCK, dtype=torch.int32, device=words.device)
    add = ((i + c) & 1)[:, None, None]
    if mode == "wide":
        out = (blocks[:, :BLOCK // 8, :] + add).reshape(rows // 8, 128)
    else:
        out = (blocks[:, :, :16] + add).reshape(rows, 16)
    return out, xor_reduce(blocks.reshape(rows // BLOCK, -1))


def _read_plain(words: torch.Tensor, carry_in):
    rows = words.shape[0]
    side = wrap_sum(words.view(rows // READ_BLOCK, -1), 1)
    return side[-1] + _as_carry(carry_in, words.device), side


def mk_write(words: torch.Tensor, mode: str, carry_in=0):
    """(rows, 128) int32, rows % 512 == 0 -> (out, side (rows/512,)
    int32): see the module docstring."""
    check_rows128(words, "mk_write", BLOCK)
    if mode not in WRITE_MODES:
        raise ValueError(f"mode must be one of {WRITE_MODES}: {mode!r}")
    if words.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_stream_write(words, mode, carry_in)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return _write_plain(words, mode, carry_in)


def mk_read(words: torch.Tensor, carry_in=0):
    """(R, 128) int32, R % 64 == 0 -> (0-d int32: the wrapping sum of the
    last (64, 128) block plus the carry bit, side (R/64,) int32)."""
    check_rows128(words, "mk_read", READ_BLOCK)
    if words.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_stream_read(words, carry_in)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return _read_plain(words, carry_in)


def check_write(words: torch.Tensor, modes=WRITE_MODES, carry=1) -> dict:
    """The write kernel in each of `modes` against its plain version on
    words, outputs and side words: {checks, max_abs_err}."""
    return check_all(
        (g, x, f"{mode} rows={words.shape[0]} {part}")
        for mode in modes
        for g, x, part in zip(mk_write(words, mode, carry),
                              _write_plain(words, mode, carry),
                              ("out", "side")))


def check_read(words: torch.Tensor, carry=1) -> dict:
    """The read kernel against its plain version on words."""
    return check_all(
        (g, x, f"read rows={words.shape[0]} {part}")
        for g, x, part in zip(mk_read(words, carry),
                              _read_plain(words, carry), ("out", "side")))


def gate(device) -> dict:
    """Every mode against its plain version on the card, outputs and
    side words, at 4 sizes and carries 0, 1 and a device 1."""
    results = []
    for rows in (512, 1536, 8192, 65_536):
        w = random_words(rows, device, rows)
        for carry in (0, 1, torch.ones((), dtype=torch.int32, device=device)):
            results += [check_write(w, carry=carry), check_read(w, carry)]
    torch.cuda.synchronize()
    return merge(*results)


def _gbps(words: torch.Tensor, ms: float) -> float:
    return words.numel() * 4 / ms / 1e6


def run_write(words: torch.Tensor, modes=WRITE_MODES, reps: int = 20,
              plain_reps: int = 3) -> dict:
    """{mode: {ms, eager_ms, gbps (GB/s of input read, from ms),
    plain_ms}} for mk_write on the card; kernel times are taken in
    turns. check_write holds the same calls against the plain version."""
    ms = kernel_ms({m: (lambda m=m: mk_write(words, m, 1)) for m in modes},
                   reps)
    out = {}
    for m in modes:
        plain = interleaved_ms({m: lambda m=m: _write_plain(words, m, 1)},
                               plain_reps, rounds=1)[m]
        out[m] = {**ms[m], "gbps": _gbps(words, ms[m]["ms"]),
                  "plain_ms": plain}
    return out


def run_read(words: torch.Tensor, reps: int = 20, plain_reps: int = 3) -> dict:
    """{ms, eager_ms, gbps, plain_ms} for mk_read on the card."""
    ms = kernel_ms({"read": lambda: mk_read(words, 1)}, reps)["read"]
    plain = interleaved_ms({"read": lambda: _read_plain(words, 1)},
                           plain_reps, rounds=1)["read"]
    return {**ms, "gbps": _gbps(words, ms["ms"]), "plain_ms": plain}


def main(argv) -> int:
    device = need_card("dma_probe")
    result = {**card(), "gate": gate(device), "sizes": {}}
    for mb in [int(a) for a in argv] or (64, 1024):
        words = random_words(mb * 1024 * 1024 // 512, device, mb)
        result["sizes"][f"{mb}MiB"] = {
            "check": merge(check_write(words), check_read(words)),
            "write": run_write(words), "read": run_read(words)}
        del words
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
