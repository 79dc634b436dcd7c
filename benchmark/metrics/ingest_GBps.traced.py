"""The ingest rate over the traced steps: the file bytes they ingested
over the sum of their lengths (the benchmark's span around each step,
on the host clock), in GB/s. It is ingest_GBps read per layer, for a
cell whose window rate the host's state swings too far between runs to
hold to an end-to-end bound."""

from benchmark.trace import ITER_SPAN

READS = (ITER_SPAN,)


def read(trace):
    spans = trace.host_spans(READS[0])
    if not spans:
        return None
    return trace.counts["units"] / (sum(b - a for a, b in spans) * 1e-6) / 1e9
