"""Statement Q6's device time: the card's busy time (every kernel and
copy) inside the benchmark's span `sql.q6`, a statement, in ms. sql()
hands its result to the host, so a statement's device work ends inside
its span."""

READS = ("sql.q6",)


def read(trace):
    spans = trace.host_spans(READS[0])
    if not spans:
        return None
    return trace.busy_in_us(spans) * 1e-3 / len(spans)
