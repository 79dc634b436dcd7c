"""The two builds end to end on the card, warm: `create_packed` (B1, B2)
and `create(backend="cuda")` (B3, the words to the host, native
extraction, `Tape`) on one CSV file, host clock from the call to its
synchronised result.

    python -m csv_simd_tpu_torch.tools.e2e_time FILE.csv [rounds]
        one untimed call of each, then `rounds` (default 5) rounds of one
        create_packed and one create; the two tapes' record counts are
        checked against each other; one JSON line with every call's
        seconds and the card.

To compare two trees, run it in each in turns (A B B A ...): a process
runs one tree.
"""

from __future__ import annotations

import sys
import time

import torch

from ..api import create, create_packed
from ._common import card, emit, need_card


def _timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run(path: str, device, rounds: int = 5) -> dict:
    """{create_packed_s, create_s}: the seconds of each timed call, after
    one untimed call of each."""
    def packed():
        return create_packed(path, device=device)

    def offsets():
        return create(path, backend="cuda", device=device)

    tape, _ = _timed(packed)
    host_tape, _ = _timed(offsets)
    if host_tape.record_cnt != tape.num_data_records + 1:
        raise AssertionError(f"create has {host_tape.record_cnt} records, "
                             f"create_packed {tape.num_data_records} + 1")
    del tape, host_tape
    out = {"create_packed_s": [], "create_s": []}
    for _ in range(rounds):
        out["create_packed_s"].append(_timed(packed)[1])
        out["create_s"].append(_timed(offsets)[1])
    return out


def main(argv) -> int:
    device = need_card("e2e_time")
    if not argv:
        print("usage: python -m csv_simd_tpu_torch.tools.e2e_time FILE.csv "
              "[rounds]", file=sys.stderr)
        return 2
    rounds = int(argv[1]) if len(argv) > 1 else 5
    emit({**card(), "file": argv[0], **run(argv[0], device, rounds)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
