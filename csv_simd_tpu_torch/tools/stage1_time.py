"""Kernels B1 and B5 on the card for each of their two classify branches:
the default dialect (all bytes < 0x80: the SWAR classify) and one with a
byte >= 0x80 (quote 0xA2: the __vcmpeq4 classify).

    python -m csv_simd_tpu_torch.tools.stage1_time [mb]
        B1 (`stage1_fused_v4`, wide_native, no non-ASCII count) and B5
        (`stage1_pallas_v2`, the v2 layout, under "v2") on mb MiB (default
        1024) of CSV-ish words from seed 7: for each dialect and kernel the
        outputs checked against the plain version with carry 1, then the
        build with carry 0 timed by CUDA events and from CUDA graphs, the
        least of three rounds of 20 calls each; one JSON line.
"""

from __future__ import annotations

import sys

import torch

from ..config import DEFAULT_DIALECT, Dialect
from ..ops.stage1_v2 import stage1_pallas_v2, stage1_swar_jnp
from ..ops.stage1_v4 import _stage1_v4_plain, stage1_fused_v4
from ._common import card, check_all, csv_words, cuda_ms, emit, graph_ms, \
    need_card

DIALECTS = {"default": DEFAULT_DIALECT, "quote_a2": Dialect(quote=0xA2)}


def _build(words: torch.Tensor, carry, dialect: Dialect):
    return stage1_fused_v4(words.view(-1, 1024), carry, dialect,
                           count_nonascii=False, out_mode="wide_native")


def check(words: torch.Tensor, dialect: Dialect) -> dict:
    """{checks, max_abs_err}: B1's words and parity against the plain
    version on (rows, 128) words, rows % 8 == 0, carry 1."""
    got = _build(words, 1, dialect)
    want = _stage1_v4_plain(words.view(-1), 1, dialect, False)
    return check_all([(got[0].reshape(-1), want[0], "words"),
                      (got[1], want[1], "parity")])


def check_v2(words: torch.Tensor, dialect: Dialect) -> dict:
    """{checks, max_abs_err}: B5's v2 words, count and parity against the
    plain version on (rows, 128) words, rows % 8 == 0, carry 1."""
    got = stage1_pallas_v2(words, 1, dialect, row_tile=8)
    want = stage1_swar_jnp(words, 1, dialect)
    return check_all([(got[0], want[0], "v2 words"),
                      (got[1], want[1], "v2 count"),
                      (got[2], want[2], "v2 parity")])


def run(words: torch.Tensor, dialect: Dialect, reps: int = 20,
        rounds: int = 3, v2: bool = False) -> dict:
    """{events_ms, graph_ms}: ms a build (B5's with v2, else B1's), the
    least of `rounds` means."""
    def build():
        if v2:
            return stage1_pallas_v2(words, 0, dialect, row_tile=8)
        return _build(words, 0, dialect)

    return {"events_ms": min(cuda_ms(build, reps) for _ in range(rounds)),
            "graph_ms": min(graph_ms(build, reps) for _ in range(rounds))}


def main(argv) -> int:
    device = need_card("stage1_time")
    mb = int(argv[0]) if argv else 1024
    words = csv_words(mb * 2048, device, 7)
    result = {**card(), "mb": mb}
    for name, dialect in DIALECTS.items():
        result[name] = {"check": check(words, dialect),
                        **run(words, dialect),
                        "v2": {"check": check_v2(words, dialect),
                               **run(words, dialect, v2=True)}}
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
