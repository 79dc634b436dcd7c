"""Statement Q6's seconds on the host clock: the mean length of the
benchmark's span `sql.q6` around each sql() call of the traced steps,
from the call to the result on the host."""

READS = ("sql.q6",)


def read(trace):
    spans = trace.host_spans(READS[0])
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e-6
