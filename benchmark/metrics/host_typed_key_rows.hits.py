"""Typed GROUP BY key rows still grouped on the host: the program's
counter `query.host_typed_key_rows` (query.py: the rows of a decimal or
datetime key that np.unique groups) a step, a round of the traffic's
statements. A counter present at 0 reads 0."""

READS = ("query.host_typed_key_rows",)


def read(trace):
    if READS[0] not in trace.spans:
        return None
    return trace.spans[READS[0]][1] / trace.counts["steps"]
