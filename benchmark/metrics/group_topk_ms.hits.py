"""The device choice of the k groups an ORDER BY <aggregate> LIMIT k
keeps: the program's span `query.group_topk` (query.group_topk) summed
over a step, a round of the traffic's statements, in ms."""

READS = ("query.group_topk",)


def read(trace):
    if READS[0] not in trace.spans:
        return None
    return trace.spans[READS[0]][0] * 1e3 / trace.counts["steps"]
