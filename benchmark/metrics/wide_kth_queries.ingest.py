"""The k that rank-select answered with int64 byte positions, the
program's counter `offsetfree.kth_wide_queries` (offsetfree._kth_positions
on words that cover 2**31 bytes or more), an ingest: 1,024 records x 19
fields x 2 = 38,912 when the wide path served the batch. A counter present
at 0 reads 0; a program without it reads None."""

READS = ("offsetfree.kth_wide_queries",)


def read(trace):
    if READS[0] not in trace.spans:
        return None
    return trace.spans[READS[0]][1] / trace.counts["steps"]
