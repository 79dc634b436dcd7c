"""The relational executors' device time (every kernel and copy of the
traced statements: typed parse, predicates, sorts, segment reduces) a
statement, in ms. A traced SQL step is a round of statements; its units
count them."""


def read(trace):
    return trace.busy_us() * 1e-3 / trace.counts["units"]
