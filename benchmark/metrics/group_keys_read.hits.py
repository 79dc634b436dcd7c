"""Group keys decoded to the host: the program's counter
`query.group_keys_read` (query.py: every group key value or text that a
GROUP BY reads back) a step, a round of the traffic's statements. A
counter present at 0 reads 0."""

READS = ("query.group_keys_read",)


def read(trace):
    if READS[0] not in trace.spans:
        return None
    return trace.spans[READS[0]][1] / trace.counts["steps"]
