"""Kernel B3 (B1's pass `mask_pack`, then csrc/relayout.cu `fold_words`)
against HBM: the padded file read once and its bitmask written once at
3.35 TB/s, over both launches' device time an ingest, in %."""

from benchmark import work

READS = ("mask_pack", "fold_words")


def read(trace):
    steps = trace.counts["steps"]
    us = trace.kernel_us(*READS) / steps
    if us <= 0:
        return None
    return work.roofline_pct(work.stage1_bytes(trace.counts["file_bytes"]),
                             us * 1e-6)
