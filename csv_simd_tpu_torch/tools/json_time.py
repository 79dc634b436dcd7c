"""Kernel J1, the JSON stage-1 (csrc/json_stage1.cu), on the card: its
time and its three launches' time.

    python -m csv_simd_tpu_torch.tools.json_time [mb]
        on mb MiB (default 1024) of JSON: a seeded 64 MiB block of
        newline-delimited records (tests/json_cases.py `json_lines`,
        escaped quotes and backslash runs in their strings) tiled; J1
        checked against its plain version on the block, and on the whole
        input against that result tiled; then J1 timed by CUDA events (the
        least of three rounds of 10 calls) and from a CUDA graph, and one
        torch.profiler trace of 5 calls giving each launch's device ms a
        call (json_tables, json_scan, json_emit) beside the bound (9 bytes
        a byte: the bytes read once, the int32 mask and depth written
        once); one JSON line with the card. Exit 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

from .. import _kernels
from ..experiments.json_device import _depths_plain
from ..utils import profiling
from ._common import card, cuda_ms, emit, graph_ms, need_card

BLOCK = 64 << 20
SEED = 1515
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM data sheet
LAUNCHES = ("json_tables", "json_scan", "json_emit")


def json_block(n_bytes: int = BLOCK, seed: int = SEED) -> bytes:
    """tests/json_cases.py's seeded newline-delimited records."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        from json_cases import json_lines
    finally:
        sys.path.pop(0)
    return json_lines(n_bytes, seed)


def launch_ms(data: torch.Tensor, calls: int = 5) -> dict:
    """{launch: device ms a call} of J1 on data, from one trace."""
    _kernels.json_stage1(data)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            for _ in range(calls):
                _kernels.json_stage1(data)
            torch.cuda.synchronize()
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
    out = dict.fromkeys(LAUNCHES, 0.0)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            for name in LAUNCHES:
                if name in e.get("name", ""):
                    out[name] += e["dur"] / 1e3 / calls
    return out


def run(mb: float, device) -> dict:
    block = torch.frombuffer(bytearray(json_block()), dtype=torch.uint8)
    block = block.to(device)
    want = _depths_plain(block)
    got = _kernels.json_stage1(block)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("J1 differs from its plain version on the block")
    copies = max(1, int(mb * (1 << 20)) // block.numel())
    data = block.repeat(copies)
    got = _kernels.json_stage1(data)
    for g, w in zip(got, want):
        if not torch.equal(g.view(copies, -1), w.expand(copies, -1)):
            raise AssertionError("J1 on the tiled input differs from the "
                                 "plain version on the block, tiled")
    del got, want
    n = data.numel()
    events = min(cuda_ms(lambda: _kernels.json_stage1(data), 10)
                 for _ in range(3))
    graph = graph_ms(lambda: _kernels.json_stage1(data), 10)
    return {"bytes": n, "events_ms": events, "graph_ms": graph,
            "gbps": n / events / 1e6, "launch_ms": launch_ms(data),
            "bound_ms": 9 * n / HBM_BYTES_PER_S * 1e3,
            "bound_reread_ms": 10 * n / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = need_card("json_time")
    mb = float(argv[0]) if argv else 1024.0
    emit({**card(), "json_stage1": run(mb, device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
