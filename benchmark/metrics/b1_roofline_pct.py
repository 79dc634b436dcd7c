"""Kernel B1 (`mask_pack`, csrc/stage1_v4.cu) against HBM: the padded
file read once and its bitmask written once at 3.35 TB/s, over B1's
device time an ingest, in %. The card's power limit is printed beside
it in the run's device line."""

from benchmark import work

READS = ("mask_pack",)


def read(trace):
    steps = trace.counts["steps"]
    us = trace.kernel_us(*READS) / steps
    if us <= 0:
        return None
    return work.roofline_pct(work.stage1_bytes(trace.counts["file_bytes"]),
                             us * 1e-6)
