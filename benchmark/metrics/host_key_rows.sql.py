"""The program's counter `query.host_key_rows` (query._prepare_group_keys:
the rows whose GROUP BY key went to the host as Python bytes) a step, a
round of the traffic's statements. A counter present at 0 reads 0."""

READS = ("query.host_key_rows",)


def read(trace):
    if READS[0] not in trace.spans:
        return None
    return trace.spans[READS[0]][1] / trace.counts["steps"]
